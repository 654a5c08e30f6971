"""Shared spectral-element discretization: device-side geometry factors,
facet blocks, and host-side (float64) assembly of diagonal operators.

Plays the role of the per-demo setup blocks in the reference
(cuda/demo_nonlinear_bowl.py:252-469): precompute detJ/G, build facet
dofmaps + facet detJ, assemble the steady diagonal LHS once.

Key structural difference from the reference: with GLL collocation every
mass-type operator (cell or facet) is *globally diagonal*, so each fixed
coefficient field yields a precomputed diagonal vector and an apply is one
elementwise multiply (`mass_diag_host` / `facet_diag_host`).  The reference
instead re-runs a gather/scale/atomic-scatter kernel per apply
(cuda/operators.py:18-70).  The stiffness operator has one path per mesh
class (resolve_stiffness_impl).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from fustpu.mesh.box import BoxMesh
from fustpu.ops import precompute as pre
from fustpu.ops import spectral_mm as mm


class FacetBlock(NamedTuple):
    """A set of boundary facets with geometry factors (indexed form, for the
    generic facet-mass operator; models with fixed coefficients use
    facet_diag_host instead)."""

    dofmap: jnp.ndarray        # (nf, n^2) int32 flat node indices (device)
    detJ: jnp.ndarray          # (nf, n^2) dtype (device)
    cells: np.ndarray          # (nf,) owning cell (host, for coefficients)
    dofmap_host: np.ndarray    # host copy for f64 setup assembly
    detJ_host: np.ndarray      # host copy (float64)

    @property
    def num_facets(self) -> int:
        return self.cells.shape[0]


class Discretization:
    """Geometry factors + facet machinery for one mesh, one dtype.

    Works for structured BoxMesh (node-grid fast paths) and
    UnstructuredHexMesh (explicit-dofmap indexed path) alike; the mesh
    class selects the stiffness path (resolve_stiffness_impl)."""

    def __init__(self, mesh, dtype=jnp.float32):
        self.mesh = mesh
        self.dtype = dtype
        self.P = mesh.degree
        self.structured = hasattr(mesh, "nc")
        elem = mesh.element
        self._detJ_host = pre.cell_detJ(mesh)              # (cells, n^3)
        self._D_host = elem.deriv_1d

    @functools.cached_property
    def _G_host(self):
        """(cells, n^3, 6) metric factors, float64 host — computed lazily
        on the first operator build (6 f64/quad-point = 12.5 GB host at
        134M DOF, the dominant setup allocation)."""
        return pre.cell_geometry_factors(self.mesh)[1]

    # ---- device operators (built on first use) ---------------------------
    @functools.cached_property
    def mm_op(self) -> mm.MMStiffness:
        """Unit-coefficient structured stiffness operator (box and mapped
        meshes)."""
        return mm.build_stiffness(self.mesh.nc, self.P, self._D_host,
                                  self._G_host, self.dtype)

    @functools.cached_property
    def extruded_op(self):
        """Factorized stiffness operator for prismatic-topology meshes
        (fustpu.mesh.extruded.ExtrudedHexMesh): row gather/scatter with
        the structured z axis contiguous — the path for imported
        piston-class meshes."""
        from fustpu.ops import operators as ops

        return ops.build_extruded_stiffness(self.mesh, self._G_host,
                                            self._D_host, self.dtype)

    @functools.cached_property
    def indexed_op(self) -> tuple:
        """(G, dofmap, D) device arrays for the explicit-dofmap stiffness
        (fustpu.ops.operators.stiffness_apply_indexed) — the path for
        non-prismatic unstructured meshes."""
        return (jnp.asarray(
                    np.ascontiguousarray(np.moveaxis(self._G_host, 2, 0)),
                    self.dtype),
                jnp.asarray(self.mesh.dofmap),
                jnp.asarray(self._D_host, self.dtype))

    # legacy/structured-layout device arrays (tests, generic API)
    @functools.cached_property
    def detJ_s(self):
        return jnp.asarray(
            pre.to_structured_layout(self._detJ_host, self.mesh), self.dtype)

    @functools.cached_property
    def G_s(self):
        return jnp.asarray(
            pre.to_structured_layout(self._G_host, self.mesh), self.dtype)

    @functools.cached_property
    def D(self):
        return jnp.asarray(self._D_host, self.dtype)

    # ---- facets -----------------------------------------------------------
    def facet_block(self, boundary_data: np.ndarray) -> FacetBlock:
        mesh = self.mesh
        fdm = mesh.facet_dofmap(boundary_data)
        detJ_f = pre.facet_geometry_factors(mesh, boundary_data)
        return FacetBlock(
            dofmap=jnp.asarray(fdm),
            detJ=jnp.asarray(detJ_f, self.dtype),
            cells=boundary_data[:, 0].copy(),
            dofmap_host=fdm,
            detJ_host=detJ_f,
        )

    # ---- host-side float64 diagonal assembly ------------------------------
    def mass_diag_host(self, cell_coeff: np.ndarray | None = None
                       ) -> np.ndarray:
        """Global diagonal of the mass operator for a per-cell coefficient
        field, float64 on host (the steady LHS of the reference,
        cuda/demo_nonlinear_bowl.py:459-469, but reusable for every mass
        term since applies are elementwise)."""
        if not self.structured:
            vals = self._detJ_host
            if cell_coeff is not None:
                vals = vals * np.asarray(
                    cell_coeff, np.float64).reshape(-1)[:, None]
            y = np.zeros(self.mesh.ndofs)
            np.add.at(y, self.mesh.dofmap.ravel(), vals.ravel())
            return y
        coeff = None if cell_coeff is None else np.asarray(
            cell_coeff).reshape(self.mesh.nc)
        return mm.mass_diagonal(self.mesh.nc, self.P, self._detJ_host, coeff)

    def facet_diag_host(self, block: FacetBlock, facet_coeff: np.ndarray,
                        node_weights: np.ndarray | None = None) -> np.ndarray:
        """Global diagonal of a facet-mass operator (float64 host).  Also
        the precomputed source vector: because the reference's source fields
        are spatially constant scalars g(t) (demo_nonlinear_bowl.py:597-598),
        the per-stage source assembly is g(t) * this vector.  Optional
        per-facet-node `node_weights` (nf, n^2) support apodised / phased
        (focused) apertures."""
        vals = block.detJ_host * np.asarray(facet_coeff)[:, None]
        if node_weights is not None:
            vals = vals * node_weights
        y = np.zeros(self.mesh.ndofs)
        np.add.at(y, block.dofmap_host.ravel(), vals.ravel())
        return y.reshape(self.mesh.grid_shape)

    def facet_points(self, block: FacetBlock) -> np.ndarray:
        """(nf, n^2, 3) physical coordinates of facet nodes (for delay /
        apodisation profiles)."""
        return self.mesh.node_coords.reshape(-1, 3)[block.dofmap_host]

    def to_grid(self, flat: np.ndarray) -> jnp.ndarray:
        return jnp.asarray(
            np.asarray(flat).reshape(self.mesh.grid_shape), self.dtype)


# Stiffness path per mesh class.  Every path is plain jax.numpy/lax at
# Precision.HIGHEST (on Hopper: plain f32, no TF32).
STIFFNESS_IMPLS = ("auto", "mm", "extruded", "indexed")


def stiffness_path(mesh) -> str:
    """'mm' for box and mapped meshes, 'extruded' for prismatic imports,
    'indexed' for every other (non-prismatic) unstructured mesh."""
    from fustpu.mesh.extruded import ExtrudedHexMesh

    if hasattr(mesh, "nc"):
        return "mm"
    return "extruded" if isinstance(mesh, ExtrudedHexMesh) else "indexed"


def resolve_stiffness_impl(impl: str, disc: Discretization) -> str:
    """The stiffness path of `disc`'s mesh class (stiffness_path).
    'auto' and the mesh class's own path name resolve to it; any other
    string raises ValueError naming the accepted ones."""
    path = stiffness_path(disc.mesh)
    if impl not in STIFFNESS_IMPLS:
        raise ValueError(f"stiffness_impl={impl!r}: accepted values are "
                         f"{', '.join(STIFFNESS_IMPLS)}")
    if impl not in ("auto", path):
        raise ValueError(f"stiffness_impl={impl!r} does not apply to a "
                         f"{type(disc.mesh).__name__}: accepted values are "
                         f"'auto' and {path!r}")
    return path
