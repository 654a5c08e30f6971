"""Native C++ runtime vs numpy reference equivalence (and availability).

The native library is built from source by `make -C native` (it is never
committed); the module builds it first and skips when no compiler can
(the package has full numpy fallbacks)."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from fustpu import native_bindings as nb
from fustpu.mesh.box import build_box_mesh
from fustpu.ops import precompute as pre


@pytest.fixture(scope="module", autouse=True)
def native_lib():
    """Build and load the library; skip the module if it cannot be built."""
    native = Path(__file__).resolve().parent.parent / "native"
    r = subprocess.run(["make", "-C", str(native)], capture_output=True,
                       text=True)
    nb._TRIED, nb._LIB = False, None      # retry the load after the build
    if r.returncode != 0 or not nb.available():
        pytest.skip(f"native library not built: {r.stderr[-300:]}")


@pytest.fixture(scope="module")
def mesh():
    return build_box_mesh((4, 3, 2), 4, hi=(1.0, 0.7, 0.5),
                          perturb=0.2, seed=11)


def test_cell_geometry_matches_numpy(mesh):
    elem = mesh.element
    dn, Gn = nb.cell_geometry(mesh.cell_corners_flat, elem.quad_points,
                              elem.quad_weights)
    dp, Gp = pre.cell_geometry_factors(mesh, use_native=False)
    assert np.allclose(dn, dp, rtol=1e-14, atol=1e-16)
    assert np.allclose(Gn, Gp, rtol=1e-13, atol=1e-14)


def test_facet_geometry_matches_numpy(mesh):
    elem = mesh.element
    bd = mesh.all_boundary_facets()
    qpts_f = np.stack([elem.facet_quad_points(f) for f in range(6)])
    dn = nb.facet_geometry(mesh.cell_corners_flat, qpts_f,
                           elem.facet_quad_weights, bd)
    dp = pre.facet_geometry_factors(mesh, bd, use_native=False)
    assert np.allclose(dn, dp, rtol=1e-14, atol=1e-16)


def test_box_dofmap_matches(mesh):
    dm = nb.box_dofmap(mesh.nc, mesh.degree)
    assert np.array_equal(dm, mesh.dofmap)


def test_mass_diagonal_matches(mesh):
    detJ, _ = pre.cell_geometry_factors(mesh, use_native=False)
    rng = np.random.default_rng(0)
    coeff = rng.uniform(0.5, 2.0, mesh.num_cells)
    m = nb.mass_diagonal(detJ, coeff, mesh.dofmap, mesh.ndofs)
    ref = np.zeros(mesh.ndofs)
    np.add.at(ref, mesh.dofmap.ravel(),
              (detJ * coeff[:, None]).ravel())
    assert np.allclose(m, ref, rtol=1e-14)
    m1 = nb.mass_diagonal(detJ, None, mesh.dofmap, mesh.ndofs)
    ref1 = np.zeros(mesh.ndofs)
    np.add.at(ref1, mesh.dofmap.ravel(), detJ.ravel())
    assert np.allclose(m1, ref1, rtol=1e-14)
