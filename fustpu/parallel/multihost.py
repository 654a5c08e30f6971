"""Multi-host (multi-process) distribution.

The reference runs on any number of MPI ranks across nodes
(/root/reference/cuda/scatterer.py:104-277, CUDA-aware Isend/Irecv).  The
JAX-native equivalent: `jax.distributed` forms the process group, every
process runs the same SPMD program, and the SAME shard_map solve works
unchanged — XLA routes the halo ppermute over the links within a host and
over the network across hosts.  What multi-host changes is only (a)
initialization, (b) how global arrays are materialised (per-process
addressable shards), and (c) device ordering: the device grid must keep
intra-host axes innermost so cross-host traffic rides the partition axis
with the fewest exchanged planes.

Run `python -m fustpu.parallel.multihost --nprocs 2 --devices-per-proc 4`
to self-spawn a 2-process x 4-virtual-CPU-device check (the CI analogue of
`mpirun -n 2`); each worker asserts its local shards of a sharded solve
match the single-device solution.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator: str, num_processes: int, process_id: int):
    """Join the jax.distributed process group (the local device count is
    set by the platform / XLA_FLAGS before import)."""
    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def dcn_device_grid(shape: tuple[int, int, int], dcn_axis: int = 0):
    """DeviceGrid over all processes' devices with the process (cross-host
    network) dimension spanning `dcn_axis` blocks-of-hosts and intra-host
    axes innermost:
    devices are ordered (process, local) so a contiguous reshape keeps
    each host's devices adjacent along the leading axis."""
    import jax

    from fustpu.parallel.sharding import DeviceGrid

    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = int(np.prod(shape))
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    if dcn_axis != 0:
        # fill the cross-host axis slowest: reshape with it leading, then move
        # each source axis k (holding shape[order[k]]) to position order[k]
        order = [dcn_axis] + [a for a in range(3) if a != dcn_axis]
        perm_shape = tuple(shape[a] for a in order)
        arr = np.asarray(devs[:n]).reshape(perm_shape)
        arr = np.moveaxis(arr, [0, 1, 2], order)
    else:
        arr = np.asarray(devs[:n]).reshape(shape)
    assert arr.shape == tuple(shape), (arr.shape, shape)
    from jax.sharding import Mesh

    from fustpu.parallel.sharding import AXES

    return DeviceGrid(shape=tuple(shape), mesh=Mesh(arr, AXES))


# ---------------------------------------------------------------------------
# Self-contained multi-process correctness check (CPU, CI-friendly)
# ---------------------------------------------------------------------------

def _worker(coordinator: str, nprocs: int, pid: int, devices: int,
            grid_shape: tuple[int, int, int]) -> None:
    import os
    import time

    _t0 = time.time()

    def _hb(msg):
        print(f"[worker {pid} +{time.time() - _t0:5.1f}s] {msg}",
              flush=True)

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count="
                                 f"{devices}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _hb("jax imported; joining process group")
    initialize(coordinator, nprocs, pid)
    assert jax.process_count() == nprocs, jax.process_count()

    import jax.numpy as jnp

    from fustpu.config import Material, Source
    from fustpu.mesh.box import build_box_mesh
    from fustpu.models.westervelt import WesterveltModel
    from fustpu.parallel import sharding as sh
    from fustpu.parallel.models import ShardedModel

    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    L = 0.006
    mesh = build_box_mesh((8, 4, 2), 3, hi=(L, L, L))
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.all_boundary_facets(), dtype=jnp.float64,
                            stiffness_impl="mm")
    grid = dcn_device_grid(grid_shape)
    smodel = ShardedModel(model, grid)
    dt, _ = model.cfl_dt(0.4)
    nsteps = 4

    _hb("phase 1: box model built")
    final, _ = model.solve(model.init_state(), dt, nsteps)
    u_ref = np.asarray(final.u)

    _hb("phase 1: ref solved")
    ds, _ = smodel.solve(smodel.init_state(), dt, nsteps)
    # compare this process's addressable shards against the reference
    Pd = mesh.degree
    lc = smodel.lc
    checked = 0
    for db in ds.u.addressable_shards:
        i, j, k = (int(x.start or 0) if isinstance(x, slice) else int(x)
                   for x in db.index[:3])
        blk = np.asarray(db.data).reshape(db.data.shape[-3:])
        ref = u_ref[i * lc[0] * Pd: i * lc[0] * Pd + blk.shape[0],
                    j * lc[1] * Pd: j * lc[1] * Pd + blk.shape[1],
                    k * lc[2] * Pd: k * lc[2] * Pd + blk.shape[2]]
        err = np.linalg.norm(blk - ref) / max(np.linalg.norm(ref), 1e-300)
        assert err < 1e-12, (pid, db.index, err)
        checked += 1
    assert checked > 0

    _hb("phase 1 done")
    # ---- phase 2: IMPORTED extruded mesh across the process group ------
    # (the reference's flagship multi-rank workload is `mpirun` on an
    # imported piston/bowl mesh, cuda/demo_linear_piston.py:83-118)
    from fustpu.mesh import msh_io
    from fustpu.mesh.shapes import cylinder_mesh
    from fustpu.models.linear import LinearWaveModel
    from fustpu.parallel.extruded import (ExtrudedShardedModel,
                                          shard_unstructured)

    v, c, t = cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1,
                            nz=4)
    path = f"/tmp/_mh_cyl_{pid}.msh"     # per-process file: no write race
    msh_io.write_msh(path, v, c, t)
    mesh2 = msh_io.read_msh(path, 3)
    mat2 = Material(sound_speed=1500.0, density=1000.0)
    src2 = Source(frequency=0.5e6, amplitude=1.0e5)
    model2 = LinearWaveModel(mesh2, mat2, src2, mesh2.boundary_facets(1),
                             mesh2.boundary_facets(2), dtype=jnp.float64)
    dt2, _ = model2.cfl_dt(0.4)
    _hb("phase 2: extruded model built")
    ref2, _ = model2.solve(model2.init_state(), dt2, nsteps)
    u2 = np.asarray(ref2.u).ravel()
    sm2 = shard_unstructured(model2, num_devices=nprocs * devices)
    assert isinstance(sm2, ExtrudedShardedModel)
    _hb("phase 2: ref solved; sharded solve")
    ds2, ys2 = sm2.solve(sm2.init_state(), dt2, nsteps,
                         probe=sm2.norm_probe())
    ref_norm = np.linalg.norm(u2)
    assert abs(float(np.asarray(ys2)[-1]) - ref_norm) < 1e-11 * ref_norm
    f2 = u2.reshape(sm2.mesh.n2d, sm2.gz)
    checked2 = 0
    for db in ds2.u.addressable_shards:
        d = int(db.index[0].start or 0)
        blk = np.asarray(db.data)[0]                 # (nloc, gz)
        m = sm2.rowmask[d]
        ref_rows = f2[sm2.rowsg[d][m]]
        err = (np.linalg.norm(blk[m] - ref_rows)
               / max(np.linalg.norm(ref_rows), 1e-300))
        assert err < 1e-12, (pid, d, err)
        checked2 += 1
    assert checked2 > 0

    # ---- phase 2b: per-shard snapshot output across the process group
    # (the reference's parallel VTXWriter: every rank writes only its
    # piece, numba-cpu/demo_linear_box.py:479-480).  Every process dumps
    # its addressable shards into a SHARED directory; process 0
    # reassembles offline and checks against the single-device field.
    from jax.experimental import multihost_utils

    from fustpu.utils.dist_io import ShardSnapshotWriter, assemble_snapshot

    snap_dir = "/tmp/_mh_snap"
    if pid == 0:
        import shutil

        shutil.rmtree(snap_dir, ignore_errors=True)
    multihost_utils.sync_global_devices("snapdir-clean")
    w2 = ShardSnapshotWriter(snap_dir, sm2)
    w2.write("u", ds2.u)
    multihost_utils.sync_global_devices("snapshots-written")
    if pid == 0:
        back = assemble_snapshot(snap_dir, "u")
        errs = (np.linalg.norm(back - u2)
                / max(np.linalg.norm(u2), 1e-300))
        assert errs < 1e-12, errs

    _hb("phase 2 + snapshots done")
    # ---- phase 3: NON-PRISMATIC mesh, per-device indexed path,
    # heterogeneous Westervelt pair, traced global-norm probe ------------
    from fustpu.mesh.extruded import as_extruded
    from fustpu.mesh.unstructured import from_box

    bm = build_box_mesh((4, 3, 3), 3, perturb=0.15, seed=4,
                        hi=(L, L, L))
    um = from_box(bm, shuffle_seed=9)
    assert as_extruded(um) is None
    rng = np.random.default_rng(3)
    mat3 = Material(sound_speed=rng.uniform(1400, 1600, um.num_cells),
                    density=rng.uniform(950, 1100, um.num_cells),
                    nonlinearity=3.5, attenuation_dB=0.2)
    ext = um.boundary_facets()
    cen = um.facet_centroids(ext)
    model3 = WesterveltModel(um, mat3, src, ext[cen[:, 0] < 1e-9],
                             ext[cen[:, 0] >= 1e-9], dtype=jnp.float64)
    dt3, _ = model3.cfl_dt(0.4)
    _hb("phase 3: non-prismatic model built")
    # 2 steps: step-to-step carry plus all 4 RK stage couplings
    nsteps3 = 2
    ref3, _ = model3.solve(model3.init_state(), dt3, nsteps3)
    sm3 = shard_unstructured(model3, num_devices=nprocs * devices)
    assert not isinstance(sm3, ExtrudedShardedModel)
    _hb("phase 3: ref solved; sharded indexed solve")
    ds3, ys3 = sm3.solve(sm3.init_state(), dt3, nsteps3,
                         probe=sm3.norm_probe())
    ref_norm3 = np.linalg.norm(np.asarray(ref3.u).ravel())
    assert abs(float(np.asarray(ys3)[-1]) - ref_norm3) \
        < 1e-11 * ref_norm3

    print(f"multihost worker {pid}/{nprocs} OK "
          f"({checked} local shards verified; imported extruded "
          f"{checked2} shards; non-prismatic indexed norm ok)",
          flush=True)


def run_multiprocess_check(nprocs: int = 2, devices_per_proc: int = 4,
                           grid_shape=(4, 2, 1), timeout: int = 600) -> None:
    """Spawn `nprocs` worker processes on this machine (virtual CPU
    devices) and verify sharded == single across the process group —
    the `mpirun -n k` laptop test of the reference, without MPI."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "fustpu.parallel.multihost",
             "--coordinator", coord, "--nprocs", str(nprocs),
             "--pid", str(pid), "--devices-per-proc",
             str(devices_per_proc),
             "--grid", ",".join(map(str, grid_shape))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)
    ]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost worker {pid} failed:\n{out[-3000:]}")
        assert f"worker {pid}/{nprocs} OK" in out, out[-2000:]


def _main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--grid", default="4,2,1")
    a = ap.parse_args()
    _worker(a.coordinator, a.nprocs, a.pid, a.devices_per_proc,
            tuple(int(x) for x in a.grid.split(",")))


if __name__ == "__main__":
    _main()
