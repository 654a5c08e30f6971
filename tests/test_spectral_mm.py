"""The structured ('mm') apply must agree with the (already
oracle-verified) einsum reference on the structured layout to roundoff,
and its expanded-grid layout must line up with the element windows."""

import jax.numpy as jnp
import numpy as np
import pytest

from fustpu.elements.hex import HexElement
from fustpu.mesh.box import build_box_mesh
from fustpu.ops import operators as ops
from fustpu.ops import precompute as pre
from fustpu.ops import spectral_mm as mm


@pytest.fixture(scope="module", params=[2, 4])
def setup(request):
    P = request.param
    mesh = build_box_mesh((4, 3, 5), P, hi=(1.0, 0.8, 1.3),
                          perturb=0.15, seed=7)
    detJ, G = pre.cell_geometry_factors(mesh)
    return mesh, detJ, G


def test_expand_fold_match_windows(setup):
    """The expanded-grid layout the operator stores G in
    (to_expanded_layout, expand_cell_field) reshapes to exactly the
    element batch windows3d gathers, and folding it back with fold3d is
    the indexed scatter-add."""
    from fustpu.ops import gather_scatter as gs

    mesh, detJ, G = setup
    P = mesh.degree
    n = P + 1
    rng = np.random.default_rng(0)
    x = rng.standard_normal(mesh.grid_shape)
    cells = x.ravel()[mesh.dofmap]                   # (cells, n^3)
    ue = mm.to_expanded_layout(cells, mesh.nc, n)    # (ex, ey, ez)
    win = np.asarray(gs.windows3d(jnp.asarray(x), P))
    assert np.array_equal(ue.reshape(win.shape), win)
    op = mm.build_stiffness(mesh.nc, P, HexElement(P).deriv_1d, G,
                            jnp.float64)
    assert np.allclose(np.asarray(op.G),
                       np.moveaxis(mm.to_expanded_layout(G, mesh.nc, n),
                                   -1, 0))
    coeff = rng.uniform(0.5, 2.0, mesh.nc)
    ce = mm.expand_cell_field(coeff, n)
    assert np.array_equal(
        ce, mm.to_expanded_layout(
            np.repeat(coeff.reshape(-1, 1), n ** 3, axis=1), mesh.nc, n))
    y = np.asarray(gs.fold3d(jnp.asarray(ue.reshape(win.shape)), P))
    y_ref = np.zeros(mesh.ndofs)
    np.add.at(y_ref, mesh.dofmap.ravel(), cells.ravel())
    assert np.allclose(y.ravel(), y_ref, atol=1e-12)


def test_stiffness_mm_matches_structured(setup):
    mesh, detJ, G = setup
    P = mesh.degree
    elem = HexElement(P)
    rng = np.random.default_rng(1)
    coeff = rng.uniform(0.5, 2.0, mesh.nc)
    x = rng.standard_normal(mesh.grid_shape)

    y_ref = ops.stiffness_apply(
        jnp.asarray(x), jnp.asarray(pre.to_structured_layout(G, mesh)),
        jnp.asarray(coeff), jnp.asarray(elem.deriv_1d), P)

    # coeff folded into G at build time
    op = mm.build_stiffness(mesh.nc, P, elem.deriv_1d, G, jnp.float64,
                            coeff=coeff)
    y1 = mm.stiffness_apply_mm(op, jnp.asarray(x))
    assert np.allclose(np.asarray(y1), np.asarray(y_ref), atol=1e-10)

    # coeff applied at run time
    op2 = mm.build_stiffness(mesh.nc, P, elem.deriv_1d, G, jnp.float64)
    ce = jnp.asarray(mm.expand_cell_field(coeff, P + 1))
    y2 = mm.stiffness_apply_mm(op2, jnp.asarray(x), coeff_e=ce)
    assert np.allclose(np.asarray(y2), np.asarray(y_ref), atol=1e-10)


def test_mass_diagonal_matches_operator(setup):
    mesh, detJ, G = setup
    P = mesh.degree
    rng = np.random.default_rng(2)
    coeff = rng.uniform(0.5, 2.0, mesh.nc)
    x = rng.standard_normal(mesh.grid_shape)
    y_ref = ops.mass_apply(
        jnp.asarray(x), jnp.asarray(pre.to_structured_layout(detJ, mesh)),
        jnp.asarray(coeff), P)
    diag = mm.mass_diagonal(mesh.nc, P, detJ, coeff)
    assert np.allclose(x * diag, np.asarray(y_ref), atol=1e-12)
