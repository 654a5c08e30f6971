"""Degree P=6..10 coverage — the reference's quadrature table spans
P=2..10 (/root/reference/numba-cpu/demo_linear_box.py:46-56).

The dense oracle is O(n^9) per cell and impractical above P~6, so high
degrees are gated by (a) an EXACT analytic patch test — on an affine box
the GLL rule (2P-1 exact) integrates v^T A u = int grad u . grad v
exactly for tensor polynomials of degree <= P, so the matrix-free apply
must match closed-form 1D integrals to roundoff, on every stiffness path
— and (b) cross-path consistency between the independent operator
formulations (the 'mm' structured apply, the einsum reference on the
structured layout, the explicit-dofmap indexed apply) on a perturbed
mesh."""

import jax.numpy as jnp
import numpy as np
import pytest

from fustpu.elements.hex import HexElement
from fustpu.mesh.box import build_box_mesh
from fustpu.ops import operators as ops
from fustpu.ops import precompute as pre
from fustpu.ops import spectral_mm as mm


def _poly_vals(mesh, cx, cy, cz):
    """Tensor polynomial u(x,y,z) = px(x) py(y) pz(z) on the node grid."""
    xyz = mesh.node_coords
    return (np.polyval(cx, xyz[..., 0]) * np.polyval(cy, xyz[..., 1])
            * np.polyval(cz, xyz[..., 2]))


def _exact_stiffness_bilinear(cx, cy, cz, dx, dy, dz, hi):
    """int_box grad(u).grad(v) for u = px py pz, v = qx qy qz: sum of three
    separable products of 1D integrals, each computed exactly via
    polynomial antiderivatives."""
    def I(p, q):  # int p*q over [0, h]
        r = np.polymul(p, q)
        R = np.polyint(r)
        return np.polyval(R, hi) - np.polyval(R, 0.0)

    d = np.polyder
    return (I(d(cx), d(dx)) * I(cy, dy) * I(cz, dz)
            + I(cx, dx) * I(d(cy), d(dy)) * I(cz, dz)
            + I(cx, dx) * I(cy, dy) * I(d(cz), d(dz)))


@pytest.mark.parametrize("P", [6, 7, 8, 9, 10])
def test_patch_test_exact_energy(P):
    """v^T A u == analytic int grad u . grad v on an affine box, with u of
    degree P and v of degree P-1: every 1D factor then has degree
    <= 2P-1, which the (P+1)-point GLL rule integrates EXACTLY — so the
    matrix-free apply must match closed-form integrals to roundoff."""
    h = 1.3
    mesh = build_box_mesh((2, 2, 2), P, hi=(h, h, h))
    elem = HexElement(P)
    _, G = pre.cell_geometry_factors(mesh)
    rng = np.random.default_rng(P)
    cs = ([rng.standard_normal(P + 1) for _ in range(3)]
          + [rng.standard_normal(P) for _ in range(3)])
    u = _poly_vals(mesh, *cs[:3])
    v = _poly_vals(mesh, *cs[3:])
    op = mm.build_stiffness(mesh.nc, P, elem.deriv_1d, G, jnp.float64)
    Au = np.asarray(mm.stiffness_apply_mm(op, jnp.asarray(u)))
    got = float(np.vdot(v, Au))
    want = _exact_stiffness_bilinear(*cs, hi=h)
    assert abs(got - want) / abs(want) < 1e-11, (got, want)


@pytest.mark.parametrize("P", [
    7, 8,
    pytest.param(9, marks=pytest.mark.slow),
    pytest.param(10, marks=pytest.mark.slow)])
def test_cross_path_consistency(P):
    """mm vs the structured einsum reference vs indexed on a perturbed
    mesh: three independent codes agree to roundoff at high degree."""
    mesh = build_box_mesh((2, 2, 2), P, hi=(1.0, 0.8, 1.3),
                          perturb=0.15, seed=P)
    elem = HexElement(P)
    _, G = pre.cell_geometry_factors(mesh)
    rng = np.random.default_rng(0)
    coeff = rng.uniform(0.5, 2.0, mesh.nc)
    x = rng.standard_normal(mesh.grid_shape)

    op = mm.build_stiffness(mesh.nc, P, elem.deriv_1d, G, jnp.float64,
                            coeff=coeff)
    y_mm = np.asarray(mm.stiffness_apply_mm(op, jnp.asarray(x)))

    G_s = pre.to_structured_layout(G, mesh)
    y_st = np.asarray(ops.stiffness_apply(
        jnp.asarray(x), jnp.asarray(G_s), jnp.asarray(coeff),
        jnp.asarray(elem.deriv_1d), P))

    y_ix = np.asarray(ops.stiffness_apply_indexed(
        jnp.asarray(x.reshape(-1)), jnp.asarray(np.moveaxis(G, 2, 0)),
        jnp.asarray(coeff.reshape(-1)), jnp.asarray(mesh.dofmap),
        jnp.asarray(elem.deriv_1d), mesh.ndofs)).reshape(mesh.grid_shape)

    for other in (y_st, y_ix):
        err = np.linalg.norm(other - y_mm) / np.linalg.norm(y_mm)
        assert err < 1e-12, err


@pytest.mark.parametrize("P", [6, 7, 8])
@pytest.mark.parametrize("path", ["extruded", "indexed"])
def test_patch_test_unstructured_paths(path, P):
    """The analytic patch test on the imported-mesh paths: the box as a
    prismatic ExtrudedHexMesh ('extruded') and as a plain
    UnstructuredHexMesh with shuffled, rotated cells ('indexed')."""
    from fustpu.mesh.extruded import as_extruded
    from fustpu.mesh.unstructured import from_box
    from fustpu.models.discretization import Discretization, stiffness_path

    h = 1.3
    bm = build_box_mesh((2, 2, 2), P, hi=(h, h, h))
    um = from_box(bm, shuffle_seed=11)
    mesh = as_extruded(um) if path == "extruded" else um
    assert stiffness_path(mesh) == path
    rng = np.random.default_rng(P)
    cs = ([rng.standard_normal(P + 1) for _ in range(3)]
          + [rng.standard_normal(P) for _ in range(3)])
    xyz = mesh.node_coords
    poly = lambda c: (np.polyval(c[0], xyz[:, 0]) * np.polyval(c[1], xyz[:, 1])
                      * np.polyval(c[2], xyz[:, 2]))
    u, v = poly(cs[:3]), poly(cs[3:])
    disc = Discretization(mesh, jnp.float64)
    if path == "extruded":
        Au = ops.stiffness_apply_extruded(jnp.asarray(u), disc.extruded_op,
                                          mesh.ndofs)
    else:
        G, dm, D = disc.indexed_op
        Au = ops.stiffness_apply_indexed(jnp.asarray(u), G, None, dm, D,
                                         mesh.ndofs)
    got = float(np.vdot(v, np.asarray(Au)))
    want = _exact_stiffness_bilinear(*cs, hi=h)
    assert abs(got - want) / abs(want) < 1e-11, (got, want)
