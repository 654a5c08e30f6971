"""The one stiffness path per mesh class ('mm' for box and mapped meshes,
'extruded' for prismatic imports, 'indexed' for the rest): how the path is
chosen, each path's uniform and heterogeneous-pair apply against the dense
oracle over P = 2..6, and the float32 apply against float64."""

import jax.numpy as jnp
import numpy as np
import pytest

from fustpu.config import Material, Source
from fustpu.elements.hex import HexElement
from fustpu.mesh import msh_io
from fustpu.mesh.box import build_box_mesh, build_mapped_mesh
from fustpu.mesh.extruded import ExtrudedHexMesh, as_extruded
from fustpu.mesh.shapes import cylinder_mesh
from fustpu.mesh.unstructured import from_box
from fustpu.models.discretization import (Discretization,
                                          resolve_stiffness_impl,
                                          stiffness_path)
from fustpu.models.linear import LinearWaveModel
from fustpu.models.westervelt import WesterveltModel
from fustpu.ops import operators as ops
from fustpu.ops import precompute as pre
from fustpu.ops import spectral_mm as mm
from fustpu.oracle import assemble as oracle

PATHS = ("mm", "extruded", "indexed")


def _cylinder(P, tmp_dir):
    v, c, t = cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1, nz=2)
    return msh_io.read_msh(
        msh_io.write_msh(str(tmp_dir / f"cyl_{P}.msh"), v, c, t), P)


def _mesh(path, P, tmp_dir):
    """A small perturbed mesh of the class that runs `path`."""
    if path == "mm":
        return build_box_mesh((3, 2, 2), P, hi=(1.0, 0.8, 1.3),
                              perturb=0.15, seed=P)
    if path == "extruded":
        return _cylinder(P, tmp_dir)
    um = from_box(build_box_mesh((3, 2, 2), P, hi=(1.0, 0.8, 1.3),
                                 perturb=0.15, seed=4), shuffle_seed=9)
    assert as_extruded(um) is None
    return um


def _applies(disc, path, c1, c2):
    """(uniform, pair) applies of `path` on flat vectors: A x with unit
    coefficients, and A_c1 x1 + A_c2 x2 with per-cell c1, c2."""
    mesh, dt = disc.mesh, disc.dtype
    nd = mesh.ndofs
    if path == "mm":
        g, n, op = mesh.grid_shape, mesh.degree + 1, disc.mm_op
        ce = [jnp.asarray(mm.expand_cell_field(c.reshape(mesh.nc), n), dt)
              for c in (c1, c2)]
        return (lambda x: mm.stiffness_apply_mm(op, x.reshape(g)).ravel(),
                lambda x1, x2: mm.stiffness_apply_mm_pair(
                    op, x1.reshape(g), x2.reshape(g), *ce).ravel())
    if path == "extruded":
        op = disc.extruded_op
        ce = [ops.expand_coeff_extruded(mesh, c, dt) for c in (c1, c2)]
        return (lambda x: ops.stiffness_apply_extruded(x, op, nd),
                lambda x1, x2: ops.stiffness_apply_extruded_pair(
                    x1, x2, op, nd, *ce))
    G, dm, D = disc.indexed_op
    cj = [jnp.asarray(c, dt) for c in (c1, c2)]
    return (lambda x: ops.stiffness_apply_indexed(x, G, None, dm, D, nd),
            lambda x1, x2: ops.stiffness_apply_indexed_pair(
                x1, cj[0], x2, cj[1], G, dm, D, nd))


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# path choice
# ---------------------------------------------------------------------------

def _mapped():
    return build_mapped_mesh(
        (3, 2, 2), 2, lambda p: p + 0.05 * np.sin(3.0 * p[:, ::-1]))


@pytest.mark.parametrize("kind,want", [
    ("box", "mm"), ("mapped", "mm"), ("prismatic", "extruded"),
    ("nonprismatic", "indexed")])
def test_path_for_mesh_class(kind, want, tmp_path):
    """Each mesh class maps to its one path, from the mesh alone; 'auto'
    and the path's own name resolve to it, and models take it."""
    mesh = {"box": lambda: build_box_mesh((3, 2, 2), 2),
            "mapped": _mapped,
            "prismatic": lambda: _cylinder(2, tmp_path),
            "nonprismatic": lambda: _mesh("indexed", 2, tmp_path)}[kind]()
    assert (kind == "prismatic") == isinstance(mesh, ExtrudedHexMesh)
    assert stiffness_path(mesh) == want
    disc = Discretization(mesh)
    assert resolve_stiffness_impl("auto", disc) == want
    assert resolve_stiffness_impl(want, disc) == want


@pytest.mark.parametrize("impl", [
    "pallas", "pallas_corner", "extruded_pallas", "extruded_pallas_corner",
    "indexed_engine"])
def test_removed_impl_raises(impl):
    """The removed kernel names are rejected, naming the accepted ones."""
    mesh = build_box_mesh((2, 2, 2), 2)
    with pytest.raises(ValueError, match="accepted values are auto, mm, "
                                         "extruded, indexed"):
        resolve_stiffness_impl(impl, Discretization(mesh))
    mat = Material(sound_speed=1500.0, density=1000.0)
    src = Source(frequency=1e6, amplitude=1.0)
    with pytest.raises(ValueError):
        LinearWaveModel(mesh, mat, src, mesh.boundary_facets("x-"),
                        mesh.all_boundary_facets(), stiffness_impl=impl)


@pytest.mark.parametrize("impl,kind", [
    ("extruded", "box"), ("indexed", "box"), ("mm", "prismatic"),
    ("indexed", "prismatic"), ("mm", "nonprismatic"),
    ("extruded", "nonprismatic")])
def test_other_class_path_raises(impl, kind, tmp_path):
    """Naming another mesh class's path raises: one path per class."""
    mesh = {"box": lambda: build_box_mesh((2, 2, 2), 2),
            "prismatic": lambda: _cylinder(2, tmp_path),
            "nonprismatic": lambda: _mesh("indexed", 2, tmp_path)}[kind]()
    with pytest.raises(ValueError, match="does not apply"):
        resolve_stiffness_impl(impl, Discretization(mesh))
    mat = Material(sound_speed=1500.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.3)
    src = Source(frequency=1e6, amplitude=1.0)
    facets = (mesh.all_boundary_facets() if kind == "box"
              else mesh.boundary_facets())
    with pytest.raises(ValueError, match="does not apply"):
        WesterveltModel(mesh, mat, src, facets[:1], facets,
                        stiffness_impl=impl)


# ---------------------------------------------------------------------------
# each path vs the dense oracle (f64, the reference's 1e-12 gate)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("form", ["uniform", "pair"])
@pytest.mark.parametrize("path", PATHS)
def test_path_matches_oracle(path, form, P, tmp_path):
    mesh = _mesh(path, P, tmp_path)
    assert stiffness_path(mesh) == path
    disc = Discretization(mesh, jnp.float64)
    rng = np.random.default_rng(P)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
    x1 = rng.standard_normal(mesh.ndofs)
    x2 = rng.standard_normal(mesh.ndofs)
    uni, pair = _applies(disc, path, c1, c2)
    Ke = oracle.element_stiffness_matrices(mesh)
    dm = np.asarray(mesh.dofmap)
    if form == "uniform":
        y = uni(jnp.asarray(x1))
        want = oracle.apply_elementwise(Ke, dm, np.ones(mesh.num_cells),
                                        x1, mesh.ndofs)
    else:
        y = pair(jnp.asarray(x1), jnp.asarray(x2))
        want = (oracle.apply_elementwise(Ke, dm, c1, x1, mesh.ndofs)
                + oracle.apply_elementwise(Ke, dm, c2, x2, mesh.ndofs))
    err = _rel(y, want)
    assert err < 1e-12, err


@pytest.mark.parametrize("P", [5, 6])
def test_einsum_matches_oracle_high_degree(P):
    """The structured einsum reference (operators.stiffness_apply) at the
    reference's P=5..6 (test_operators covers P=2..4)."""
    mesh = build_box_mesh((2, 2, 3), P, hi=(1.0, 0.8, 1.3), perturb=0.15,
                          seed=P)
    _, G = pre.cell_geometry_factors(mesh)
    rng = np.random.default_rng(P)
    coeff = rng.uniform(0.5, 2.0, mesh.num_cells)
    x = rng.standard_normal(mesh.ndofs)
    y = ops.stiffness_apply(
        jnp.asarray(x.reshape(mesh.grid_shape)),
        jnp.asarray(pre.to_structured_layout(G, mesh)),
        jnp.asarray(coeff.reshape(mesh.nc)),
        jnp.asarray(HexElement(P).deriv_1d), P)
    Ke = oracle.element_stiffness_matrices(mesh)
    want = oracle.apply_elementwise(Ke, mesh.dofmap, coeff, x, mesh.ndofs)
    err = _rel(y, want)
    assert err < 1e-12, err


# ---------------------------------------------------------------------------
# float32 (the production dtype) vs float64: every contraction runs at
# Precision.HIGHEST, so the f32 apply stays at f32 roundoff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 4, 6])
@pytest.mark.parametrize("form", ["uniform", "pair"])
@pytest.mark.parametrize("path", PATHS)
def test_f32_apply_matches_f64(path, form, P, tmp_path):
    mesh = _mesh(path, P, tmp_path)
    rng = np.random.default_rng(10 + P)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
    x1 = rng.standard_normal(mesh.ndofs).astype(np.float32)
    x2 = rng.standard_normal(mesh.ndofs).astype(np.float32)
    out = {}
    for dt in (jnp.float32, jnp.float64):
        uni, pair = _applies(Discretization(mesh, dt), path, c1, c2)
        a1, a2 = jnp.asarray(x1, dt), jnp.asarray(x2, dt)
        out[dt] = uni(a1) if form == "uniform" else pair(a1, a2)
    assert out[jnp.float32].dtype == jnp.float32
    err = _rel(out[jnp.float32], out[jnp.float64])
    assert err < 1e-5, err
