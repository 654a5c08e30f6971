"""Multi-device tests on the 8-virtual-CPU-device mesh — the analogue of the
reference's `mpirun -n k` scatter/operator tests
(/root/reference/numba-cpu/test_scatterer.py, cuda/test_scatterer.py):
sharded solves must match the single-device solve to roundoff."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fustpu.config import Material, Source
from fustpu.mesh.box import build_box_mesh
from fustpu.models.linear import LinearWaveModel
from fustpu.models.westervelt import WesterveltModel
from fustpu.parallel import sharding as sh
from fustpu.parallel.models import ShardedModel


def _build(model_cls, nc=(8, 4, 4), degree=3, L=0.006):
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    mesh = build_box_mesh(nc, degree, hi=(L, L, L))
    return model_cls(mesh, mat, src, mesh.boundary_facets("x-"),
                     mesh.all_boundary_facets(), dtype=jnp.float64), mat, src


def test_split_merge_roundtrip():
    mesh = build_box_mesh((4, 2, 2), 3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(mesh.grid_shape)
    st = sh.split_node_field(x, mesh.nc, (2, 2, 1), 3)
    assert st.shape == (2, 2, 1, 7, 4, 7)
    back = sh.merge_node_field(st, mesh.nc, (2, 2, 1), 3)
    assert np.array_equal(back, x)


@pytest.mark.parametrize("S", [(8, 1, 1), (2, 2, 2), (1, 4, 2)])
@pytest.mark.parametrize("model_cls", [LinearWaveModel, WesterveltModel])
def test_sharded_solve_matches_single(S, model_cls):
    model, mat, src = _build(model_cls)
    grid = sh.DeviceGrid.create(S)
    smodel = ShardedModel(model, grid)
    dt, _ = model.cfl_dt(0.4)
    nsteps = 8

    final, _ = model.solve(model.init_state(), dt, nsteps)
    u_ref = np.asarray(final.u)

    dstate = smodel.init_state()
    ds, _ = smodel.solve(dstate, dt, nsteps)
    du = ds.u
    u_dist = smodel.collect(du)

    err = np.linalg.norm(u_dist - u_ref) / np.linalg.norm(u_ref)
    assert err < 1e-12, err
    # shared planes must be bitwise consistent across devices
    st = np.asarray(du)
    Pd = model.mesh.degree
    if S[0] > 1:
        assert np.array_equal(st[0, 0, 0, -1], st[1, 0, 0, 0])


def test_halo_sum_plane_consistency():
    """After a sharded assembly, duplicated planes hold identical values."""
    model, *_ = _build(WesterveltModel, nc=(4, 2, 2))
    grid = sh.DeviceGrid.create((2, 2, 1))
    smodel = ShardedModel(model, grid)
    dt, _ = model.cfl_dt(0.4)
    ds, _ = smodel.solve(smodel.init_state(), dt, 3)
    kv = np.asarray(ds.kv)
    assert np.array_equal(kv[0, 0, 0][-1, :, :], kv[1, 0, 0][0, :, :])
    assert np.array_equal(kv[0, 0, 0][:, -1, :], kv[0, 1, 0][:, 0, :])


def test_sharded_probe_matches_single():
    """Per-step hydrophone traces recorded inside the sharded scan match
    the single-device traces to roundoff (each probe's interpolation
    window is owned by one device; psum replicates)."""
    from fustpu.utils.eval import PointSampler

    model, *_ = _build(WesterveltModel, nc=(4, 4, 2), degree=3)
    grid = sh.DeviceGrid.create((2, 2, 2))
    smodel = ShardedModel(model, grid)
    dt, _ = model.cfl_dt(0.4)
    L = 0.006
    pts = np.array([[0.31 * L, 0.52 * L, 0.5 * L],
                    [0.87 * L, 0.13 * L, 0.77 * L]])
    pfn = PointSampler(model.mesh, pts).jax_probe()
    _, ys = model.solve(model.init_state(), dt, 5,
                        probe=lambda s: pfn(s.u))
    _, dys = smodel.solve(smodel.init_state(), dt, 5,
                          probe=smodel.probe_fn(pts))
    ys, dys = np.asarray(ys), np.asarray(dys)
    assert ys.shape == dys.shape == (5, 2)
    err = np.linalg.norm(ys - dys) / max(np.linalg.norm(ys), 1e-300)
    assert err < 1e-12, err


def test_multihost_two_processes():
    """2 jax.distributed processes x 4 virtual CPU devices: sharded
    Westervelt == single-device across the process group (the reference's
    `mpirun -n k` test, without MPI; SURVEY §7 step 7)."""
    from fustpu.parallel.multihost import run_multiprocess_check

    # 2 procs x 2 devices: the multi-host properties under test
    # (process_count=2, collectives spanning the process boundary,
    # per-process addressable shards) are independent of the local
    # device count, and 2x2 halves the suite cost of the two workers
    run_multiprocess_check(nprocs=2, devices_per_proc=2,
                           grid_shape=(2, 2, 1))


def test_global_reductions_match_single():
    """Distributed multiplicity-weighted dot/norm == the merged-field
    value (shared cut planes counted exactly once)."""
    try:
        shard_map = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map

    from jax.sharding import PartitionSpec as P

    mesh = build_box_mesh((4, 4, 2), 3)
    S = (2, 2, 2)
    grid = sh.DeviceGrid.create(S)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(mesh.grid_shape)
    y = rng.standard_normal(mesh.grid_shape)
    dx = grid.put(sh.split_node_field(x, mesh.nc, S, 3), jnp.float64)
    dy = grid.put(sh.split_node_field(y, mesh.nc, S, 3), jnp.float64)

    def fn(a, b):
        sq = lambda v: v.reshape(v.shape[3:])
        return sh.global_dot(sq(a), sq(b), S)

    mapped = jax.jit(shard_map(fn, mesh=grid.mesh,
                               in_specs=(P(*sh.AXES), P(*sh.AXES)),
                               out_specs=P(), check_vma=False))
    got = float(mapped(dx, dy))
    want = float(np.vdot(x, y))
    assert abs(got - want) / abs(want) < 1e-12


def test_sharded_heterogeneous_matches_single():
    """Heterogeneous media (per-cell c, rho, beta) through the sharded
    path: the expanded coefficient fields are split per device and the
    solve must match single-device to roundoff."""
    rng = np.random.default_rng(7)
    nc = (4, 4, 2)
    mat = Material(
        sound_speed=1400.0 + 200.0 * rng.random(nc),
        density=900.0 + 200.0 * rng.random(nc),
        nonlinearity=3.0 + rng.random(nc),
        attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    L = 0.004
    mesh = build_box_mesh(nc, 3, hi=(L, L, L))
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.all_boundary_facets(), dtype=jnp.float64,
                            stiffness_impl="mm")
    assert not model.uniform
    grid = sh.DeviceGrid.create((2, 2, 2))
    smodel = ShardedModel(model, grid)
    dt, _ = model.cfl_dt(0.4)
    final, _ = model.solve(model.init_state(), dt, 6)
    ds, _ = smodel.solve(smodel.init_state(), dt, 6)
    u = smodel.collect(ds.u)
    err = (np.linalg.norm(u - np.asarray(final.u))
           / np.linalg.norm(np.asarray(final.u)))
    assert err < 1e-12, err


# ---------------------------------------------------------------------------
# Unstructured (imported-mesh) sharding: ExtrudedShardedModel — RCB stack
# partition + one shared-row psum per stage (the analogue of the
# reference's partition-any-mesh + IndexMap scatterers,
# /root/reference/cuda/utils.py:8-78, cuda/scatterer.py:104-277)
# ---------------------------------------------------------------------------


def _cyl_model(model_cls, P=3):
    from fustpu.mesh import msh_io
    from fustpu.mesh.shapes import cylinder_mesh

    v, c, t = cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1, nz=4)
    p = msh_io.write_msh("/tmp/_shard_cyl.msh", v, c, t)
    mesh = msh_io.read_msh(p, P)
    mat = Material(sound_speed=1500.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.3)
    src = Source(frequency=0.5e6, amplitude=1.0e5)
    return model_cls(mesh, mat, src, mesh.boundary_facets(1),
                     mesh.boundary_facets(2), dtype=jnp.float64)


@pytest.mark.parametrize("k", [8, 3])
@pytest.mark.parametrize("model_cls", [LinearWaveModel, WesterveltModel])
def test_sharded_unstructured_matches_single(k, model_cls):
    """Imported tagged cylinder, sharded over k devices (incl a
    non-power-of-2 count) == single-device solve at 1e-12."""
    from fustpu.parallel.extruded import ExtrudedShardedModel

    model = _cyl_model(model_cls)
    dt, _ = model.cfl_dt(0.4)
    s, _ = model.solve(model.init_state(), dt, 20)
    sm = ExtrudedShardedModel(model, num_devices=k)
    assert sm.num_shared > 0          # the partition genuinely cuts rows
    ss, _ = sm.solve(sm.init_state(), dt, 20)
    u = sm.collect(ss.u)
    ref = np.asarray(s.u).ravel()
    err = np.linalg.norm(u - ref) / np.linalg.norm(ref)
    assert err < 1e-12, err


def test_sharded_unstructured_probe_matches_single():
    """In-scan hydrophone traces on the sharded cylinder match the
    single-device UPointSampler traces."""
    from fustpu.mesh.unstructured import UPointSampler
    from fustpu.parallel.extruded import ExtrudedShardedModel

    model = _cyl_model(LinearWaveModel)
    mesh = model.mesh
    dt, _ = model.cfl_dt(0.4)
    pts = np.array([[0.0, 0.0, 0.25 * 0.02],
                    [0.003, -0.002, 0.6 * 0.02]])
    pfn = UPointSampler(mesh, pts).jax_probe()
    _, ys = model.solve(model.init_state(), dt, 12,
                        probe=lambda s: pfn(s.u))
    sm = ExtrudedShardedModel(model, num_devices=8)
    _, dys = sm.solve(sm.init_state(), dt, 12, probe=sm.probe_fn(pts))
    ys, dys = np.asarray(ys), np.asarray(dys)
    assert ys.shape == dys.shape == (12, 2)
    err = np.linalg.norm(ys - dys) / max(np.linalg.norm(ys), 1e-300)
    assert err < 1e-12, err


def test_sharded_unstructured_heterogeneous():
    """Per-cell material (two-layer sound speed) through the sharded
    extruded path == single device (exercises the c3_x/c4_x coefficient
    distribution)."""
    from fustpu.mesh import msh_io
    from fustpu.mesh.shapes import cylinder_mesh
    from fustpu.parallel.extruded import ExtrudedShardedModel

    v, c, t = cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1, nz=4)
    p = msh_io.write_msh("/tmp/_shard_cyl2.msh", v, c, t)
    mesh = msh_io.read_msh(p, 3)
    zc = np.array([mesh.vertices[cc].mean(axis=0)[2] for cc in mesh.cells])
    cs = np.where(zc < 0.01, 1500.0, 1650.0)
    mat = Material(sound_speed=cs, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.3)
    src = Source(frequency=0.5e6, amplitude=1.0e5)
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets(1),
                            mesh.boundary_facets(2), dtype=jnp.float64)
    dt, _ = model.cfl_dt(0.4)
    s, _ = model.solve(model.init_state(), dt, 15)
    sm = ExtrudedShardedModel(model, num_devices=8)
    ss, _ = sm.solve(sm.init_state(), dt, 15)
    err = (np.linalg.norm(sm.collect(ss.u) - np.asarray(s.u).ravel())
           / np.linalg.norm(np.asarray(s.u)))
    assert err < 1e-12, err


@pytest.mark.parametrize("S", [(2, 2, 2), (3, 2, 1)])
@pytest.mark.parametrize("impl", ["mm"])
def test_sharded_nondivisible_cells(S, impl):
    """(7,5,3) cells on non-dividing device grids: ghost-padded equal
    blocks (zero-stiffness cells) make any mesh run on any device count,
    like `mpirun -n k` (VERDICT r2 item 6)."""
    model, *_ = _build(WesterveltModel, nc=(7, 5, 3), degree=3)
    model = WesterveltModel(model.mesh, model.material, model.source,
                            model.mesh.boundary_facets("x-"),
                            model.mesh.all_boundary_facets(),
                            dtype=jnp.float64, stiffness_impl=impl)
    dt, _ = model.cfl_dt(0.4)
    ref, _ = model.solve(model.init_state(), dt, 12)
    sm = ShardedModel(model, sh.DeviceGrid.create(S))
    assert sm.impl == impl and any(sm.cell_pad)
    ss, _ = sm.solve(sm.init_state(), dt, 12)
    err = (np.linalg.norm(sm.collect(ss.u) - np.asarray(ref.u))
           / np.linalg.norm(np.asarray(ref.u)))
    assert err < 1e-12, err


@pytest.mark.parametrize("k", [8, 3, 5, 2])
def test_sharded_nonprismatic_unstructured(k):
    """GENERAL unstructured sharding: a fully-3D-perturbed shuffled mesh
    (no extrusion exists) distributes via RCB cell partition + shared-DOF
    psum and matches single-device at 1e-12 — any mesh, any device
    count, like the reference's read-time partition."""
    from fustpu.mesh.extruded import as_extruded
    from fustpu.mesh.unstructured import from_box
    from fustpu.parallel.extruded import (IndexedShardedModel,
                                          shard_unstructured)

    bm = build_box_mesh((4, 3, 3), 3, perturb=0.15, seed=4,
                        hi=(0.006,) * 3)
    um = from_box(bm, shuffle_seed=9)
    assert as_extruded(um) is None
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    ext = um.boundary_facets()
    cen = um.facet_centroids(ext)
    model = WesterveltModel(um, mat, src, ext[cen[:, 0] < 1e-9],
                            ext[cen[:, 0] >= 1e-9], dtype=jnp.float64)
    assert model.impl == "indexed"
    dt, _ = model.cfl_dt(0.4)
    ref, _ = model.solve(model.init_state(), dt, 15)
    sm = shard_unstructured(model, num_devices=k)
    assert isinstance(sm, IndexedShardedModel) and sm.num_shared > 0
    ss, _ = sm.solve(sm.init_state(), dt, 15)
    err = (np.linalg.norm(sm.collect(ss.u) - np.asarray(ref.u).ravel())
           / np.linalg.norm(np.asarray(ref.u)))
    assert err < 1e-12, err


def test_sharded_nonprismatic_probe():
    """In-scan probes on the generic indexed sharded model match the
    single-device UPointSampler traces."""
    from fustpu.mesh.unstructured import UPointSampler, from_box
    from fustpu.parallel.extruded import shard_unstructured

    bm = build_box_mesh((4, 3, 3), 3, perturb=0.15, seed=4,
                        hi=(0.006,) * 3)
    um = from_box(bm, shuffle_seed=9)
    mat = Material(sound_speed=1480.0, density=1000.0)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    ext = um.boundary_facets()
    cen = um.facet_centroids(ext)
    m = LinearWaveModel(um, mat, src, ext[cen[:, 0] < 1e-9],
                        ext[cen[:, 0] >= 1e-9], dtype=jnp.float64)
    dt, _ = m.cfl_dt(0.4)
    pts = np.array([[0.002, 0.003, 0.003], [0.004, 0.002, 0.004]])
    pfn = UPointSampler(um, pts).jax_probe()
    _, ys = m.solve(m.init_state(), dt, 10, probe=lambda s: pfn(s.u))
    sm = shard_unstructured(m, num_devices=8)
    _, dys = sm.solve(sm.init_state(), dt, 10, probe=sm.probe_fn(pts))
    err = (np.linalg.norm(np.asarray(ys) - np.asarray(dys))
           / max(np.linalg.norm(np.asarray(ys)), 1e-300))
    assert err < 1e-12, err


def test_sharded_unstructured_reductions_and_checkpoint(tmp_path):
    """Multiplicity-weighted reductions and exact checkpoint restart on
    the sharded imported mesh (the reference's Allreduce-norm and — a
    capability it lacks — resume)."""
    from fustpu.models.timestepping import RKState
    from fustpu.parallel.extruded import shard_unstructured
    from fustpu.utils.io import load_checkpoint, save_checkpoint

    model = _cyl_model(LinearWaveModel)
    dt, _ = model.cfl_dt(0.4)
    ref, _ = model.solve(model.init_state(), dt, 15)
    sm = shard_unstructured(model, num_devices=8)
    ss, _ = sm.solve(sm.init_state(), dt, 15)
    n_sh = sm.global_norm(ss.u)
    n_si = float(np.linalg.norm(np.asarray(ref.u)))
    assert abs(n_sh - n_si) / n_si < 1e-12
    ck = save_checkpoint(str(tmp_path / "ck"), RKState(
        u=sm.collect(ss.u), v=sm.collect(ss.v), ku=sm.collect(ss.ku),
        kv=sm.collect(ss.kv), t=np.asarray(ss.t)), step=15)
    arrs, step, _ = load_checkpoint(ck)
    assert step == 15
    s2 = sm.init_state(t0=float(arrs["t"]), u0=arrs["u"], v0=arrs["v"])
    s3, _ = sm.solve(s2, dt, 5)
    s4, _ = sm.solve(ss, dt, 5)
    err = (np.linalg.norm(sm.collect(s3.u) - sm.collect(s4.u))
           / np.linalg.norm(sm.collect(s4.u)))
    assert err < 1e-12, err


def test_unstructured_traced_reductions():
    """Traced multiplicity-weighted global_dot/global_norm (shard_map
    psum — the reference's MPI Allreduce norm checks) match a host-side
    gather-and-sum at 1e-12, and the in-scan norm_probe records the same
    values as post-hoc norms."""
    from fustpu.parallel.extruded import (ExtrudedShardedModel,
                                          IndexedShardedModel)

    model = _cyl_model(LinearWaveModel)
    dt, _ = model.cfl_dt(0.4)
    for cls, mesh_kind in ((ExtrudedShardedModel, "ext"),
                           (IndexedShardedModel, "idx")):
        if mesh_kind == "idx":
            from fustpu.mesh import msh_io

            mesh = msh_io.read_msh("/tmp/_shard_cyl.msh", 3,
                                   detect_extrusion=False)
            mat = Material(sound_speed=1500.0, density=1000.0,
                           nonlinearity=3.5, attenuation_dB=0.3)
            src = Source(frequency=0.5e6, amplitude=1.0e5)
            m = LinearWaveModel(mesh, mat, src, mesh.boundary_facets(1),
                                mesh.boundary_facets(2),
                                dtype=jnp.float64)
        else:
            m = model
        sm = cls(m, num_devices=8)
        ss, _ = sm.solve(sm.init_state(), dt, 10)
        # host reference: collect the global field, plain dot
        u = sm.collect(ss.u)
        ref = float(np.dot(u, u))
        got = sm.global_dot(ss.u, ss.u)
        assert abs(got - ref) <= 1e-12 * abs(ref), (mesh_kind, got, ref)
        assert abs(sm.global_norm(ss.u) - np.sqrt(ref)) \
            <= 1e-12 * np.sqrt(ref)
        # in-scan probe
        s2, ys = sm.solve(sm.init_state(), dt, 10, probe=sm.norm_probe())
        ys = np.asarray(ys)
        assert ys.shape == (10,)
        assert abs(ys[-1] - np.sqrt(ref)) <= 1e-11 * np.sqrt(ref)


def test_sharded_nonprismatic_hetero_pair():
    """HETEROGENEOUS Westervelt on the sharded indexed path: per-cell
    material routes through the shared-scatter pair (stiff_pair under
    shard_map) and must match single-device at 1e-12 over a ragged
    5-device partition — padded cells carry zero coefficients, not the
    uniform fold's cpad."""
    from fustpu.mesh.extruded import as_extruded
    from fustpu.mesh.unstructured import from_box
    from fustpu.parallel.extruded import shard_unstructured

    bm = build_box_mesh((4, 3, 3), 3, perturb=0.15, seed=4,
                        hi=(0.006,) * 3)
    um = from_box(bm, shuffle_seed=9)
    assert as_extruded(um) is None
    rng = np.random.default_rng(3)
    nc = um.num_cells
    mat = Material(sound_speed=rng.uniform(1400, 1600, nc),
                   density=rng.uniform(950, 1100, nc),
                   nonlinearity=3.5, attenuation_dB=0.2)
    assert not mat.is_uniform
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    ext = um.boundary_facets()
    cen = um.facet_centroids(ext)
    model = WesterveltModel(um, mat, src, ext[cen[:, 0] < 1e-9],
                            ext[cen[:, 0] >= 1e-9], dtype=jnp.float64)
    assert model.uniform is False
    dt, _ = model.cfl_dt(0.4)
    ref, _ = model.solve(model.init_state(), dt, 6)
    sm = shard_unstructured(model, num_devices=5)
    ss, _ = sm.solve(sm.init_state(), dt, 6)
    err = (np.linalg.norm(sm.collect(ss.u) - np.asarray(ref.u).ravel())
           / np.linalg.norm(np.asarray(ref.u)))
    assert err < 1e-12, err


# ---------------------------------------------------------------------------
# Distributed snapshot output: per-shard files, no host gather — the
# analogue of the reference's parallel VTXWriter output on every rank
# (/root/reference/numba-cpu/demo_linear_box.py:479-480)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [(2, 2, 2), (2, 1, 1)])
def test_dist_snapshot_box(tmp_path, S):
    """Per-shard writer on the box grid reassembles to collect() exactly
    (incl. size-1 device axes, where shard.index holds slice(None))."""
    from fustpu.utils.dist_io import ShardSnapshotWriter, assemble_snapshot

    model, *_ = _build(WesterveltModel, nc=(4, 2, 2))
    smodel = ShardedModel(model, sh.DeviceGrid.create(S))
    dt, _ = model.cfl_dt(0.4)
    ds, _ = smodel.solve(smodel.init_state(), dt, 2)
    w = ShardSnapshotWriter(str(tmp_path), smodel)
    paths = w.write("u", ds.u)
    assert len(paths) == int(np.prod(S))
    u = assemble_snapshot(str(tmp_path), "u")
    ref = smodel.collect(ds.u)
    assert u.shape == ref.shape
    assert np.array_equal(u, ref)


def test_dist_snapshot_unstructured(tmp_path):
    """Per-shard writer on imported meshes (both the extruded-rows and the
    general indexed layouts) reassembles to collect() exactly."""
    from fustpu.mesh.extruded import as_extruded
    from fustpu.mesh.unstructured import from_box
    from fustpu.parallel.extruded import (ExtrudedShardedModel,
                                          shard_unstructured)
    from fustpu.utils.dist_io import ShardSnapshotWriter, assemble_snapshot

    # extruded rows layout
    model = _cyl_model(LinearWaveModel)
    sm = ExtrudedShardedModel(model, num_devices=3)
    dt, _ = model.cfl_dt(0.4)
    ss, _ = sm.solve(sm.init_state(), dt, 2)
    d1 = str(tmp_path / "rows")
    w = ShardSnapshotWriter(d1, sm)
    w.write("u", ss.u)
    w.write("v", ss.v)
    assert np.array_equal(assemble_snapshot(d1, "u"), sm.collect(ss.u))
    assert np.array_equal(assemble_snapshot(d1, "v"), sm.collect(ss.v))

    # general indexed (non-prismatic) layout
    bm = build_box_mesh((4, 3, 3), 3, perturb=0.15, seed=4,
                        hi=(0.006,) * 3)
    um = from_box(bm, shuffle_seed=9)
    assert as_extruded(um) is None
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    ext = um.boundary_facets()
    cen = um.facet_centroids(ext)
    model = WesterveltModel(um, mat, src, ext[cen[:, 0] < 1e-9],
                            ext[cen[:, 0] >= 1e-9], dtype=jnp.float64)
    sm = shard_unstructured(model, num_devices=5)
    dt, _ = model.cfl_dt(0.4)
    ss, _ = sm.solve(sm.init_state(), dt, 2)
    d2 = str(tmp_path / "dofs")
    w = ShardSnapshotWriter(d2, sm)
    w.write("u", ss.u)
    assert np.array_equal(assemble_snapshot(d2, "u"), sm.collect(ss.u))


# ---------------------------------------------------------------------------
# Box shapes that once exercised per-device kernel variants (y-split
# slabs, single-slab pair, ghost padding), on the per-device 'mm' path
# ---------------------------------------------------------------------------

def _two_layer(nc):
    cs = np.where(np.arange(nc[0])[:, None, None] < nc[0] // 2, 1480.0,
                  1650.0)
    rho = np.where(np.arange(nc[0])[:, None, None] < nc[0] // 2, 1000.0,
                   1060.0)
    return Material(sound_speed=np.broadcast_to(cs, nc),
                    density=np.broadcast_to(rho, nc), nonlinearity=3.5,
                    attenuation_dB=0.2)


@pytest.mark.parametrize("model_cls,nc,degree,S,hetero", [
    (WesterveltModel, (4, 4, 4), 2, (2, 2, 1), False),
    (LinearWaveModel, (4, 6, 4), 2, (1, 2, 1), False),
    (LinearWaveModel, (4, 6, 4), 2, (2, 1, 1), False),
    (WesterveltModel, (7, 5, 3), 2, (2, 2, 2), False),
    (WesterveltModel, (5, 4, 2), 3, (2, 2, 2), True),
    (WesterveltModel, (4, 4, 4), 2, (2, 2, 1), True),
    (LinearWaveModel, (5, 4, 2), 3, (2, 2, 2), True),
], ids=["west-444-p2", "lin-464-ysplit", "lin-464-xsplit",
        "west-753-p2-ghost", "west-hetero-542-ghost", "west-hetero-444",
        "lin-hetero-542-ghost"])
def test_sharded_box_shapes_match_single(model_cls, nc, degree, S,
                                         hetero):
    L = 0.006
    mesh = build_box_mesh(nc, degree, hi=(L, L, L))
    mat = (_two_layer(nc) if hetero else
           Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                    attenuation_dB=0.2))
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    model = model_cls(mesh, mat, src, mesh.boundary_facets("x-"),
                      mesh.all_boundary_facets(), dtype=jnp.float64)
    assert model.uniform is not hetero
    dt, _ = model.cfl_dt(0.4)
    ref, _ = model.solve(model.init_state(), dt, 6)
    sm = ShardedModel(model, sh.DeviceGrid.create(S))
    ss, _ = sm.solve(sm.init_state(), dt, 6)
    err = (np.linalg.norm(sm.collect(ss.u) - np.asarray(ref.u))
           / np.linalg.norm(np.asarray(ref.u)))
    assert err < 1e-12, err


@pytest.mark.parametrize("model_cls,k", [
    (LinearWaveModel, 8), (LinearWaveModel, 3), (WesterveltModel, 3)])
def test_sharded_extruded_heterogeneous(model_cls, k):
    """Two-layer media on the sharded extruded path for both models and
    a non-power-of-2 device count (the linear model folds one
    coefficient, Westervelt runs the pair)."""
    from fustpu.parallel.extruded import ExtrudedShardedModel

    base = _cyl_model(model_cls)
    mesh = base.mesh
    zc = np.array([mesh.vertices[cc].mean(axis=0)[2] for cc in mesh.cells])
    mat = Material(sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
                   density=np.where(zc < 0.01, 1000.0, 1100.0),
                   nonlinearity=3.5, attenuation_dB=0.3)
    model = model_cls(mesh, mat, base.source, mesh.boundary_facets(1),
                      mesh.boundary_facets(2), dtype=jnp.float64)
    assert not model.uniform
    dt, _ = model.cfl_dt(0.4)
    s, _ = model.solve(model.init_state(), dt, 10)
    sm = ExtrudedShardedModel(model, num_devices=k)
    ss, _ = sm.solve(sm.init_state(), dt, 10)
    err = (np.linalg.norm(sm.collect(ss.u) - np.asarray(s.u).ravel())
           / np.linalg.norm(np.asarray(s.u)))
    assert err < 1e-12, err


def test_sharded_extruded_hex27():
    """Curved (hex27) prisms through the sharded extruded path: per-device
    z-expanded G blocks of the quadratic geometry == the single-device
    solve at 1e-12."""
    import dataclasses

    from fustpu.elements.hex import hex8_tabulate
    from fustpu.mesh.extruded import as_extruded
    from fustpu.mesh.unstructured import from_box
    from fustpu.parallel.extruded import ExtrudedShardedModel

    lat3 = np.array([[i / 2, j / 2, k / 2] for i in range(3)
                     for j in range(3) for k in range(3)])

    def phi(x):
        # prismatic curvature (vertex columns survive; layers curved and
        # graded), scaled to a mm-class domain
        x = np.asarray(x, np.float64)
        out = x.copy()
        out[..., 0] = x[..., 0] + 0.04 * np.sin(1.3 * x[..., 1])
        out[..., 1] = x[..., 1] + 0.05 * np.sin(1.1 * x[..., 0] + 0.4)
        out[..., 2] = x[..., 2] * (1.0 + 0.1 * x[..., 2]) \
            + 0.06 * np.sin(1.7 * x[..., 0] + 0.5 * x[..., 1])
        return out * 2e-3

    bm = build_box_mesh((3, 2, 4), 3)
    um = from_box(bm, shuffle_seed=11)
    vals, _ = hex8_tabulate(lat3)
    gl = np.einsum("qv,cvd->cqd", vals, um.vertices[um.cells])
    curved = as_extruded(dataclasses.replace(
        um, vertices=phi(um.vertices), geom_nodes=phi(gl)))
    assert curved is not None and curved.geom_nodes is not None
    mat = Material(sound_speed=1500.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.3)
    src = Source(frequency=1.0e6, amplitude=1.0e5)
    ext = curved.boundary_facets()
    cen = curved.facet_centroids(ext)
    xmin = cen[:, 0].min()
    model = WesterveltModel(curved, mat, src, ext[cen[:, 0] < xmin + 1e-6],
                            ext[cen[:, 0] >= xmin + 1e-6],
                            dtype=jnp.float64)
    assert model.impl == "extruded"
    dt, _ = model.cfl_dt(0.4)
    s0, _ = model.solve(model.init_state(), dt, 6)
    sm = ExtrudedShardedModel(model, num_devices=3)
    ss, _ = sm.solve(sm.init_state(), dt, 6)
    err = (np.linalg.norm(sm.collect(ss.u) - np.asarray(s0.u).ravel())
           / np.linalg.norm(np.asarray(s0.u)))
    assert err < 1e-12, err
