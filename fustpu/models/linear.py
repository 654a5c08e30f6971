"""Linear second-order wave equation with windowed velocity source and
first-order absorbing boundary.

Weak form (reference cpp forms, /root/reference/cpp/demo_linear_box/forms.py
:44-48, and coefficient recipes numba-cpu/demo_linear_box.py:250-268):

    LHS  m  = (1/(rho c^2)) u v dx                        (diagonal)
    RHS  b  = -(1/rho) grad(u_n).grad(v) dx
              + (g(t)/rho) v ds(Gamma_src)
              - (v_n/(rho c)) v ds(Gamma_abs)
    du/dt = v ;  dv/dt = b / m

Per RK stage: ONE stiffness apply + three
elementwise multiplies (the mass LHS, the source vector, and the absorbing
facet term are all precomputed diagonals — see
fustpu.models.discretization).  The reference launches a stiffness kernel,
two facet-mass kernels and ~10 vector kernels per stage instead
(numba-cpu/demo_linear_box.py:361-382).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from fustpu.config import Material, Source
from fustpu.mesh.box import BoxMesh
from fustpu.models import sources
from fustpu.models.base import WaveModelBase
from fustpu.models.discretization import Discretization, resolve_stiffness_impl
from fustpu.ops import spectral_mm as mm


class LinearWaveModel(WaveModelBase):
    DEFAULT_CFL = 0.65

    def __init__(
        self,
        mesh: BoxMesh,
        material: Material,
        source: Source,
        source_facets: np.ndarray,
        absorbing_facets: np.ndarray | None,
        dtype=jnp.float32,
        source_delays=None,
        source_apodization=None,
        stiffness_impl: str = "auto",
    ):
        """`source_delays`: optional per-node delay profile tau(x) for a
        phased (focused) aperture — a callable(points (N,3)) -> tau (N,) or
        an (nf, n^2) array.  `source_apodization`: optional amplitude
        profile, same convention.  See fustpu.models.sources.
        `stiffness_impl`: 'auto' | 'mm' | 'extruded' | 'indexed' — see
        fustpu.models.discretization.resolve_stiffness_impl."""
        self.mesh = mesh
        self.material = material
        self.source = source
        self.dtype = dtype
        disc = Discretization(mesh, dtype)
        self.disc = disc

        cshape = mesh.nc if disc.structured else (mesh.num_cells,)
        c, rho, _, _ = material.cell_fields(cshape)
        self.uniform = material.is_uniform
        # steady diagonal LHS: mass diag with coeff 1/(rho c^2), f64 host
        # (all diagonal vectors are stored FLAT, like the solver state)
        to_flat = lambda a: disc.to_grid(a).reshape(-1)
        self.m = to_flat(disc.mass_diag_host(1.0 / (rho * c * c)))
        # stiffness coefficient -1/rho: a scalar for uniform media, a
        # per-cell field otherwise
        self.impl = resolve_stiffness_impl(stiffness_impl, disc)
        self.c2_scalar = self.c2_e = self.c2_cells = self.c2_x = None
        if self.uniform:
            self.c2_scalar = dtype(-1.0 / float(rho.flat[0]))
        if self.impl == "extruded":
            # prismatic imported mesh: factorized row-gather path
            from fustpu.ops import operators as ops

            self._stiff_op = disc.extruded_op
            if not self.uniform:
                self.c2_x = ops.expand_coeff_extruded(
                    mesh, np.broadcast_to(-1.0 / rho,
                                          (mesh.num_cells,)), dtype)
        elif self.impl == "indexed":
            # unstructured: explicit dofmap, per-cell coefficient array
            self.c2_cells = jnp.asarray((-1.0 / rho).reshape(-1), dtype)
            self._stiff_op = disc.indexed_op
        else:
            self._stiff_op = disc.mm_op
            if not self.uniform:
                # heterogeneous: expanded coefficient field (also consumed
                # by the sharded wrapper)
                self.c2_e = jnp.asarray(
                    mm.expand_cell_field(-1.0 / rho, mesh.degree + 1),
                    dtype)

        # source boundary: the g(t) facet term reduces to precomputed
        # diagonal vector(s): one for a plain aperture, a cos/sin pair for a
        # phased (focused) one (see fustpu.models.sources).
        self.src_block = disc.facet_block(source_facets)
        fcoeff = 1.0 / rho.reshape(-1)[self.src_block.cells]
        # scalar sound speed at the source (enters the source amplitude)
        self.c_src = float(np.mean(c.reshape(-1)[self.src_block.cells])) \
            if self.src_block.num_facets else float(np.max(c))
        apod, phi = sources.resolve_profiles(
            disc, self.src_block, source.angular_frequency,
            source_delays, source_apodization)
        if phi is None:
            self.s_cos = to_flat(disc.facet_diag_host(
                self.src_block, fcoeff, apod))
            self.s_sin = None
        else:
            cw = np.cos(phi) if apod is None else apod * np.cos(phi)
            sw = np.sin(phi) if apod is None else apod * np.sin(phi)
            self.s_cos = to_flat(disc.facet_diag_host(
                self.src_block, fcoeff, cw))
            self.s_sin = to_flat(disc.facet_diag_host(
                self.src_block, fcoeff, sw))

        # absorbing boundary: -(1/(rho c)) v_n v ds — a facet diagonal
        self.fvec_abs = None
        if absorbing_facets is not None and len(absorbing_facets) > 0:
            blk = disc.facet_block(absorbing_facets)
            self.abs_block = blk
            rc = (rho * c).reshape(-1)[blk.cells]
            self.fvec_abs = to_flat(disc.facet_diag_host(
                blk, -1.0 / rc))
        else:
            self.abs_block = None
        self._solver_cache = {}

    # ------------------------------------------------------------------
    @property
    def params(self):
        """All device arrays, threaded explicitly through jit (never
        closure-captured — large constants wreck compile times)."""
        p = {"m": self.m, "s_cos": self.s_cos, "stiff": self._stiff_op}
        if self.c2_e is not None:
            p["c2_e"] = self.c2_e
        if self.c2_cells is not None:
            p["c2_c"] = self.c2_cells
        if self.c2_x is not None:
            p["c2_x"] = self.c2_x
        if self.s_sin is not None:
            p["s_sin"] = self.s_sin
        if self.fvec_abs is not None:
            p["fvec"] = self.fvec_abs
        return p

    def _rhs(self, params, t, u, v):
        """kv = M^{-1} b(t, u, v) on the node grid."""
        b = self._apply_stiffness(params, u)
        a_c, a_s = sources.linear_source_coeffs(t, self.source, self.c_src)
        b = b + a_c.astype(self.dtype) * params["s_cos"]
        if "s_sin" in params:
            b = b + a_s.astype(self.dtype) * params["s_sin"]
        if "fvec" in params:
            b = b + v * params["fvec"]
        from fustpu.ops import vector as vec

        return vec.pointwise_divide(b, params["m"])  # the diagonal solve

    def _apply_stiffness(self, params, u_flat):
        if self.impl == "extruded":
            from fustpu.ops import operators as ops

            b = ops.stiffness_apply_extruded(
                u_flat, params["stiff"], self.mesh.ndofs,
                coeff_e=params.get("c2_x"))
            return self.c2_scalar * b if self.uniform else b
        if self.impl == "indexed":
            from fustpu.ops import operators as ops

            G, dofmap, D = params["stiff"]
            return ops.stiffness_apply_indexed(
                u_flat, G, params["c2_c"], dofmap, D, self.mesh.ndofs)
        u = u_flat.reshape(self.mesh.grid_shape)
        if self.uniform:
            b = self.c2_scalar * mm.stiffness_apply_mm(params["stiff"], u)
        else:
            b = mm.stiffness_apply_mm(params["stiff"], u,
                                      coeff_e=params["c2_e"])
        return b.reshape(-1)
