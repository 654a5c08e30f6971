"""Extruded (prismatic-topology) fast path: detection, canonicalization,
operator and model equality against the generic indexed path.

The factorized path must be bit-compatible physics: same mesh, same
operators to roundoff, facet tags preserved — only the DOF numbering and
the gather/scatter mechanism differ (fustpu/mesh/extruded.py,
fustpu/ops/operators.py:stiffness_apply_extruded).  Plays the role the
reference's layout experiment assigns to DOF ordering
(/root/reference/cuda/exp_kernel_speed.py): layout is a first-order
performance knob that must not change the math.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from fustpu.config import Material, Source
from fustpu.mesh import msh_io
from fustpu.mesh.box import build_box_mesh
from fustpu.mesh.extruded import ExtrudedHexMesh, as_extruded
from fustpu.mesh.shapes import cylinder_mesh
from fustpu.mesh.unstructured import from_box
from fustpu.models.discretization import Discretization
from fustpu.models.linear import LinearWaveModel
from fustpu.models.westervelt import WesterveltModel
from fustpu.ops import operators as ops


def _cyl(P=3, nz=4):
    v, c, t = cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1, nz=nz)
    p = msh_io.write_msh("/tmp/_ext_cyl.msh", v, c, t)
    return (msh_io.read_msh(p, P),
            msh_io.read_msh(p, P, detect_extrusion=False))


def test_detection_and_structure():
    mex, mun = _cyl()
    assert isinstance(mex, ExtrudedHexMesh)
    assert not isinstance(mun, ExtrudedHexMesh)
    assert mex.ndofs == mun.ndofs
    assert mex.n2d * mex.gz == mex.ndofs
    assert mex.nstacks * mex.nz == mex.num_cells
    # facet tags preserved through canonicalization (same physical sets)
    for tag in (1, 2):
        ce = np.sort(mex.facet_centroids(mex.boundary_facets(tag)), axis=0)
        cu = np.sort(mun.facet_centroids(mun.boundary_facets(tag)), axis=0)
        assert np.allclose(ce, cu)
    # canonical cells are ascending-z prisms: c-bit pairs share (x, y)
    cc = mex.vertices[mex.cells].reshape(-1, 2, 2, 2, 3)
    assert np.allclose(cc[:, :, :, 0, :2], cc[:, :, :, 1, :2])
    assert np.all(cc[:, :, :, 1, 2] > cc[:, :, :, 0, 2])


def test_detection_orientation_free():
    """Shuffled/rotated cells of a box still detect and match."""
    bm = build_box_mesh((3, 2, 4), 3)
    ex = as_extruded(from_box(bm, shuffle_seed=11))
    assert ex is not None
    d = Discretization(ex, jnp.float64)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(ex.ndofs))
    G, dm, D = d.indexed_op
    y1 = ops.stiffness_apply_indexed(x, G, jnp.ones(ex.num_cells), dm, D,
                                     ex.ndofs)
    y2 = ops.stiffness_apply_extruded(x, d.extruded_op, ex.ndofs)
    err = float(jnp.linalg.norm(y2 - y1) / jnp.linalg.norm(y1))
    assert err < 1e-12, err


def test_non_extruded_returns_none():
    """A fully-3D-perturbed mesh has no vertical vertex columns."""
    bm = build_box_mesh((3, 3, 3), 2, perturb=0.2, seed=4)
    assert as_extruded(from_box(bm)) is None


@pytest.mark.parametrize("P", [2, 3, 5])
def test_operator_matches_indexed_with_coeff(P):
    mex, _ = _cyl(P=P)
    d = Discretization(mex, jnp.float64)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(mex.ndofs))
    coeff = rng.uniform(0.5, 2.0, mex.num_cells)
    G, dm, D = d.indexed_op
    y1 = ops.stiffness_apply_indexed(x, G, jnp.asarray(coeff), dm, D,
                                     mex.ndofs)
    ce = ops.expand_coeff_extruded(mex, coeff, jnp.float64)
    y2 = ops.stiffness_apply_extruded(x, d.extruded_op, mex.ndofs,
                                      coeff_e=ce)
    err = float(jnp.linalg.norm(y2 - y1) / jnp.linalg.norm(y1))
    assert err < 1e-12, err


@pytest.mark.parametrize("cls,hetero", [
    (LinearWaveModel, False), (WesterveltModel, False),
    (WesterveltModel, True)])
def test_model_matches_indexed(cls, hetero):
    """25 RK4 steps on the tagged cylinder: extruded == indexed to
    roundoff (fields matched through physical node coordinates)."""
    mex, mun = _cyl()
    if hetero:
        # two-material column: sound speed varies per cell (exercises the
        # per-cell coefficient path c3_x/c4_x)
        zc = np.array([mex.vertices[c].mean(axis=0)[2]
                       for c in mex.cells])
        c_cells = np.where(zc < 0.01, 1500.0, 1650.0)
        # the indexed mesh has its own cell ordering: same rule applies
        zcu = np.array([mun.vertices[c].mean(axis=0)[2]
                        for c in mun.cells])
        cu_cells = np.where(zcu < 0.01, 1500.0, 1650.0)
        mats = [Material(sound_speed=c_cells, density=1000.0,
                         nonlinearity=3.5, attenuation_dB=0.3),
                Material(sound_speed=cu_cells, density=1000.0,
                         nonlinearity=3.5, attenuation_dB=0.3)]
    else:
        mats = [Material(sound_speed=1500.0, density=1000.0,
                         nonlinearity=3.5, attenuation_dB=0.3)] * 2
    src = Source(frequency=0.5e6, amplitude=1e5)
    outs = []
    for mesh, mat in zip((mex, mun), mats):
        m = cls(mesh, mat, src, mesh.boundary_facets(1),
                mesh.boundary_facets(2), dtype=jnp.float64)
        dt, _ = m.cfl_dt(0.4)
        s, _ = m.solve(m.init_state(), dt, 25)
        outs.append(np.asarray(s.u).ravel())
    key = lambda p: np.round(p * 1e9).astype(np.int64)
    lut = {tuple(k): i for i, k in enumerate(key(mun.node_coords))}
    perm = np.array([lut[tuple(k)] for k in key(mex.node_coords)])
    err = (np.linalg.norm(outs[0] - outs[1][perm])
           / max(np.linalg.norm(outs[1]), 1e-300))
    assert err < 1e-11, err


def test_detection_any_axis():
    """Extrusion along x (the bowl's conformal-cap map displaces only x)
    must detect with axis=0 and match the indexed path; curved layer
    surfaces are allowed — only the transverse coordinates must be
    constant along columns."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from demos.demo_nonlinear_bowl import bowl_mapping
    from fustpu.mesh.box import build_mapped_mesh

    L = 0.05
    mp = bowl_mapping(0.0632, 0.016, L / 2, L / 2, 2 * L)
    bm = build_mapped_mesh((6, 4, 4), 3, hi=(2 * L, L, L), mapping=mp)
    ex = as_extruded(from_box(bm, shuffle_seed=3))
    assert ex is not None and ex.axis == 0
    d = Discretization(ex, jnp.float64)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(ex.ndofs))
    G, dm, D = d.indexed_op
    y1 = ops.stiffness_apply_indexed(x, G, jnp.ones(ex.num_cells), dm, D,
                                     ex.ndofs)
    y2 = ops.stiffness_apply_extruded(x, d.extruded_op, ex.ndofs)
    err = float(jnp.linalg.norm(y2 - y1) / jnp.linalg.norm(y1))
    assert err < 1e-12, err


def test_detection_ignores_orphan_vertices():
    """Imported files can carry nodes referenced only by point/line
    elements; they must not break the vertex-column structure."""
    import dataclasses

    bm = build_box_mesh((3, 2, 4), 3)
    um = from_box(bm, shuffle_seed=11)
    verts2 = np.vstack([um.vertices, [[9.9, 9.9, 9.9], [1.2, 4.5, 6.7]]])
    ex = as_extruded(dataclasses.replace(um, vertices=verts2))
    assert ex is not None


def test_curved_hex27_prismatic_detects_and_matches():
    """A curved (triquadratic hex27) mesh with PRISMATIC topology must
    detect as extruded — with the quadratic map re-expressed under the
    canonical corner relabeling — and the fast extruded apply must match
    the generic indexed apply and the dense oracle on the same curved
    geometry.  This is what routes real Gmsh 2nd-order body-fitted
    prisms onto the fast kernel (reference cmap-generality,
    cpp/common/precompute.hpp:33-94)."""
    import dataclasses

    from fustpu.elements.hex import hex8_tabulate
    from fustpu.oracle import assemble as oracle

    lat3 = np.array([[i / 2, j / 2, k / 2] for i in range(3)
                     for j in range(3) for k in range(3)])

    def phi(x):
        # prismatic curvature: transverse shift depends on (x, y) only
        # (vertex columns survive); layers curved AND graded in z
        x = np.asarray(x, np.float64)
        out = x.copy()
        out[..., 0] = x[..., 0] + 0.04 * np.sin(1.3 * x[..., 1])
        out[..., 1] = x[..., 1] + 0.05 * np.sin(1.1 * x[..., 0] + 0.4)
        out[..., 2] = x[..., 2] * (1.0 + 0.1 * x[..., 2]) \
            + 0.06 * np.sin(1.7 * x[..., 0] + 0.5 * x[..., 1])
        return out

    bm = build_box_mesh((3, 2, 4), 3)
    um = from_box(bm, shuffle_seed=11)      # rotated corner orderings
    vals, _ = hex8_tabulate(lat3)           # (27, 8)
    gl = np.einsum("qv,cvd->cqd", vals, um.vertices[um.cells])
    curved = dataclasses.replace(um, vertices=phi(um.vertices),
                                 geom_nodes=phi(gl))
    ex = as_extruded(curved)
    assert isinstance(ex, ExtrudedHexMesh)
    assert ex.geom_nodes is not None and ex.geom_degree == 2
    # canonical corner shadow must agree with the permuted lattice's
    # corner positions (a wrong permutation scrambles them)
    corners_lat = ex.geom_nodes[:, [0, 2, 6, 8, 18, 20, 24, 26], :]
    assert np.allclose(corners_lat, ex.vertices[ex.cells], atol=1e-12)

    d = Discretization(ex, jnp.float64)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(ex.ndofs))
    coeff = rng.uniform(0.5, 2.0, ex.num_cells)
    G, dm, D = d.indexed_op
    y1 = ops.stiffness_apply_indexed(x, G, jnp.asarray(coeff), dm, D,
                                     ex.ndofs)
    ce = ops.expand_coeff_extruded(ex, coeff, jnp.float64)
    y2 = ops.stiffness_apply_extruded(x, d.extruded_op, ex.ndofs,
                                      coeff_e=ce)
    err = float(jnp.linalg.norm(y2 - y1) / jnp.linalg.norm(y1))
    assert err < 1e-12, err
    # non-circular: against the dense oracle on the same curved mesh
    mats = oracle.element_stiffness_matrices(ex)
    y_ref = oracle.apply_elementwise(mats, ex.dofmap, coeff,
                                     np.asarray(x), ex.ndofs)
    err = np.linalg.norm(np.asarray(y2) - y_ref) / np.linalg.norm(y_ref)
    assert err < 1e-12, err
