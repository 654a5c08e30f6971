"""Shared demo driver: chunked solve with progress prints (the reference
prints `t, step, u[0]` every 100 steps, numba-cpu/demo_linear_box.py:461),
per-section timings, optional checkpointing and field output.  Drives
single-device models and ShardedModel alike (the reference has one code
path for 1..N ranks; so does this driver)."""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from fustpu.utils import io as fio
from fustpu.utils import timing


def demo_argparser(**defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--elements", type=int,
                   default=defaults.get("elements", 0),
                   help="elements per axis (0 = reference default: "
                        "2 per wavelength)")
    p.add_argument("--degree", type=int, default=defaults.get("degree", 4))
    p.add_argument("--dtype", choices=["f32", "f64", "bf16"],
                   default=defaults.get("dtype", "f32"))
    p.add_argument("--periods", type=float,
                   default=defaults.get("periods", 2.0),
                   help="extra periods after first transit")
    p.add_argument("--output", default=defaults.get("output", ""),
                   help="VTK output path prefix ('' = no output)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint path prefix ('' = off)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="dump a pressure-plane point cloud every N steps "
                        "(reference's periodic snapshots, "
                        "cuda/demo_nonlinear_bowl.py:662-681)")
    p.add_argument("--dist-output", default="",
                   help="sharded runs: directory for PER-SHARD field "
                        "snapshots every --snapshot-every steps — no host "
                        "gather, each device dumps only its piece (the "
                        "reference's parallel VTXWriter output, "
                        "numba-cpu/demo_linear_box.py:479-480); reassemble "
                        "offline with fustpu.utils.dist_io"
                        ".assemble_snapshot")
    p.add_argument("--probe", type=float, nargs=3, action="append",
                   default=None, metavar=("X", "Y", "Z"),
                   help="record the pressure waveform at a point every step "
                        "(hydrophone trace; repeatable)")
    p.add_argument("--progress-every", type=int, default=100)
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="cpu = force the host backend (f64-capable, for "
                        "small verification runs)")
    return p


def pick_dtype(name: str):
    return {"f32": jnp.float32, "f64": jnp.float64,
            "bf16": jnp.bfloat16}[name]


def apply_platform(args):
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.dtype == "f64":
            jax.config.update("jax_enable_x64", True)


def force_host_devices(k: int):
    """Request k virtual CPU devices.  APPENDS to any pre-existing
    XLA_FLAGS (setdefault silently did nothing when the variable was
    already set, and `--devices k --platform cpu` then failed later with
    fewer host devices than requested).  Must run before the first JAX
    backend use."""
    import os

    flag = f"--xla_force_host_platform_device_count={k}"
    existing = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" in existing:
        import re

        existing = re.sub(
            r"--xla_force_host_platform_device_count=\d+", flag, existing)
        os.environ["XLA_FLAGS"] = existing
    else:
        os.environ["XLA_FLAGS"] = (existing + " " + flag).strip()


def _gcd_chunk(args) -> int:
    """Chunk size that hits every requested cadence exactly."""
    import math

    chunk = max(args.progress_every, 1)
    want_snaps = args.output or getattr(args, "dist_output", "")
    for c in (args.checkpoint_every if args.checkpoint else 0,
              args.snapshot_every if want_snaps else 0):
        if c:
            chunk = math.gcd(chunk, c)
    return max(chunk, 1)


def run_demo(model, dt: float, num_steps: int, args, name: str):
    """Chunked solve: one jitted scan per chunk, host progress in between.
    Diagnostics (checkpoints, snapshots) are excluded from the reported
    solve wall-clock and are never emitted for padded (post-tf no-op)
    steps.  Works for single-device models and ShardedModel (distributed
    fields are collected on the host only for diagnostics/output)."""
    from fustpu.utils.eval import PointSampler, plane_points

    def make_sampler(mesh, pts):
        if hasattr(mesh, "nc"):
            return PointSampler(mesh, pts)
        from fustpu.mesh.unstructured import UPointSampler

        return UPointSampler(mesh, pts)

    sharded = hasattr(model, "collect")
    to_host = (lambda a: model.collect(a)) if sharded \
        else (lambda a: np.asarray(a))
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", flush=True)

    state = model.init_state()
    chunk = _gcd_chunk(args)
    done = 0
    sampler = None
    dist_writer = None
    if getattr(args, "dist_output", ""):
        if not sharded:
            print("[fustpu] --dist-output ignored: model is not sharded "
                  "(use --output for single-device snapshots)",
                  flush=True)
        elif not args.snapshot_every:
            print("[fustpu] --dist-output set but --snapshot-every is 0 "
                  "— no per-shard snapshots will be written", flush=True)
    wall = 0.0
    chunk_walls = []
    probe = None
    traces = []
    if getattr(args, "probe", None):
        pts = np.asarray(args.probe)
        if sharded:
            probe = model.probe_fn(pts)
        else:
            pfn = make_sampler(model.mesh, pts).jax_probe()
            probe = lambda s: pfn(s.u)
    # A remainder chunk would have a different scan length, triggering a
    # second multi-minute XLA compile; padding it to a full chunk with
    # tf-clamped no-op steps costs at most `chunk` cheap steps, which is
    # always far less than a compile, so the remainder is always padded.
    rem = num_steps % chunk
    tf = float(num_steps) * dt
    total = num_steps + (chunk - rem if rem else 0)
    while done < total:
        k = min(chunk, total - done)
        with timing.timer("~ solve chunk"):
            t0 = time.perf_counter()
            state, ys = model.solve(state, dt, k, tf=tf, probe=probe)
            jax.block_until_ready(state)
            cw = time.perf_counter() - t0
            wall += cw
            chunk_walls.append((cw, k))
        if probe is not None:
            traces.append(np.asarray(ys))
        done += k
        shown = min(done, num_steps)
        if done % max(args.progress_every, 1) == 0 or done >= num_steps:
            print(f"t: {float(state.t):.5e}, steps: {shown}/{num_steps}, "
                  f"u[0] = {float(jnp.ravel(state.u)[0]):.6e}", flush=True)
        in_run = done <= num_steps      # no diagnostics for padded steps
        if args.checkpoint and args.checkpoint_every and in_run and \
                done % args.checkpoint_every == 0:
            with timing.timer("~ checkpoint"):
                cstate = state._replace(
                    u=to_host(state.u), v=to_host(state.v),
                    ku=to_host(state.ku), kv=to_host(state.kv)) \
                    if sharded else state
                fio.save_checkpoint(f"{args.checkpoint}_{done}", cstate, done)
        if getattr(args, "dist_output", "") and sharded and \
                args.snapshot_every and in_run and \
                done % args.snapshot_every == 0:
            with timing.timer("~ snapshot (per-shard)"):
                if dist_writer is None:
                    from fustpu.utils.dist_io import ShardSnapshotWriter

                    dist_writer = ShardSnapshotWriter(args.dist_output,
                                                      model)
                dist_writer.write(f"u_{done:06d}", state.u)
        if args.output and args.snapshot_every and in_run and \
                done % args.snapshot_every == 0:
            with timing.timer("~ snapshot (plane eval)"):
                if sampler is None:
                    zc = (model.mesh.lo[2] + model.mesh.hi[2]) / 2
                    pts = plane_points(model.mesh, axis=2, coord=zc,
                                       n0=179, n1=179)
                    sampler = make_sampler(model.mesh, pts)
                vals = sampler.sample(to_host(state.u))
                fio.save_point_cloud(
                    f"{args.output}_{name}_snap_{done}.txt",
                    sampler.points, vals, cols=(0, 1))
    pad = total - num_steps
    print(f"Solve time: {wall:.3f}")
    print(f"Solve time per step: {wall / total:.6f}"
          + (f" (over {total} executed steps incl. {pad} padding)"
             if pad else ""))
    if len(chunk_walls) > 1:
        # steady rate excluding the first chunk (it includes the compile)
        sw = sum(w for w, _ in chunk_walls[1:])
        sk = sum(k for _, k in chunk_walls[1:])
        print(f"Solve time per step (steady): {sw / sk:.6f}")

    if probe is not None and args.output:
        trace = np.concatenate(traces, axis=0)[:num_steps]
        ts = (np.arange(1, num_steps + 1) * dt)[:, None]
        path = f"{args.output}_{name}_probe.txt"
        np.savetxt(path, np.hstack([ts, trace]), delimiter=",",
                   header="t, p(probe_0), p(probe_1), ...")
        print(f"wrote {path}")

    if args.output:
        with timing.timer("~ output (vtk)"):
            if hasattr(model.mesh, "nc"):
                path = fio.write_vtk_structured(
                    f"{args.output}_{name}", model.mesh,
                    {"u": to_host(state.u), "v": to_host(state.v)})
            else:  # unstructured: full-GLL-resolution hex VTK
                path = fio.write_vtk_unstructured(
                    f"{args.output}_{name}", model.mesh,
                    {"u": to_host(state.u), "v": to_host(state.v)})
        print(f"wrote {path}")
    timing.list_timings()
    return state
