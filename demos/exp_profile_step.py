"""Profile one scanned Westervelt solve on the device and print where the
per-step microseconds go (per-kernel device-time table).

A `jax.profiler` trace of the production scan, aggregated per device op
(device events arrive in the trace dump), so the cost of the many small
kernels around the stiffness applies is measured, not inferred.

    python demos/exp_profile_step.py --elements 48 --degree 4 --steps 10
    python demos/exp_profile_step.py --geometry conformal --elements 52 ...
    python demos/exp_profile_step.py --mesh some.msh --steps 10

Reference analogue: NSight source-level profiling of the CUDA kernels
(/root/reference/cuda/operators.py:87, lineinfo=True).
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from demos.demo_nonlinear_bowl import bodyfit_mapping, bowl_mapping  # noqa: E402
from fustpu.config import Material, Source  # noqa: E402
from fustpu.mesh import msh_io  # noqa: E402
from fustpu.mesh.box import build_mapped_mesh  # noqa: E402
from fustpu.models.westervelt import WesterveltModel  # noqa: E402
from fustpu.utils import traceview  # noqa: E402
from fustpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from fustpu.utils.timing import profile_trace  # noqa: E402

enable_compile_cache()


def build_bowl_mesh(args):
    """The demo_nonlinear_bowl geometry at --elements/--degree, exported
    to a tagged .msh and re-imported (cached in /tmp keyed by config)."""
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    domain_length, Lt = 0.08, 0.05
    aperture_radius, focal_length = 0.016, 0.035
    yc = zc = Lt / 2
    nex = args.elements
    net = max(8, int(round(nex * Lt / domain_length / 8)) * 8)
    in_aperture = lambda c: ((c[:, 1] - yc) ** 2
                             + (c[:, 2] - zc) ** 2) < aperture_radius**2

    if args.mesh:
        mesh_file = args.mesh
    else:
        mesh_file = (f"/tmp/profile_bowl_{args.geometry}_{nex}x{net}"
                     f"_p{args.degree}_mesh.msh")
        if not os.path.exists(mesh_file):
            mapping = (bodyfit_mapping(focal_length, aperture_radius, yc,
                                       zc, domain_length, Lt)
                       if args.geometry == "bodyfit" else
                       bowl_mapping(focal_length, aperture_radius, yc, zc,
                                    domain_length))
            box = build_mapped_mesh((nex, net, net), args.degree, mapping,
                                    hi=(domain_length, Lt, Lt))
            cap = box.boundary_facets("x-", predicate=in_aperture)
            other = np.concatenate(
                [box.boundary_facets("x-",
                                     predicate=lambda c: ~in_aperture(c))]
                + [box.boundary_facets(p)
                   for p in ["x+", "y-", "y+", "z-", "z+"]])
            out = msh_io.export_box_msh(box, {1: cap, 2: other}, mesh_file)
            assert out == mesh_file, (out, mesh_file)
    mesh = msh_io.read_msh(mesh_file, degree=args.degree)
    return mesh, mat


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--elements", type=int, default=48)
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--geometry", choices=["bodyfit", "conformal"],
                   default="bodyfit")
    p.add_argument("--mesh", default="", help="pre-built tagged .msh")
    p.add_argument("--two-layer", action="store_true")
    p.add_argument("--logdir", default="/tmp/fustpu_step_trace")
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args()

    t0 = time.perf_counter()
    mesh, mat = build_bowl_mesh(args)
    print(f"mesh: {mesh.num_cells} cells, {mesh.ndofs/1e6:.2f}M dofs "
          f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    if args.two_layer:
        cent = np.asarray(mesh.cell_corners_flat).mean(axis=1)
        tissue = cent[:, 0] > 0.02
        mat = Material(
            sound_speed=np.where(tissue, 1560.0, 1480.0),
            density=np.where(tissue, 1045.0, 1000.0),
            nonlinearity=3.5, attenuation_dB=0.2)
    src = Source(frequency=1.1e6,
                 amplitude=1000.0 * 1480.0 * 0.38557513826589934)

    t0 = time.perf_counter()
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets(1),
                            mesh.boundary_facets(2))
    dt, _ = model.cfl_dt(0.4)
    state = model.init_state()
    print(f"model: impl={model.impl} "
          f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    # warm up with the SAME scan length that gets traced (a different
    # length is a different executable — CLAUDE.md invariant)
    t0 = time.perf_counter()
    state, _ = model.solve(state, dt, args.steps)
    jax.block_until_ready(state)
    print(f"first solve({args.steps}) incl. compile: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for rep in range(2):
        t0 = time.perf_counter()
        state, _ = model.solve(state, dt, args.steps)
        jax.block_until_ready(state)
        wall = time.perf_counter() - t0
        print(f"steady solve({args.steps}): {wall*1e3:.1f} ms "
              f"= {wall/args.steps*1e3:.2f} ms/step", flush=True)

    with profile_trace(args.logdir) as d:
        state, _ = model.solve(state, dt, args.steps)
        jax.block_until_ready(state)
    table = traceview.device_op_table(d)
    print(traceview.format_table(table, per_step=args.steps, top=args.top))


if __name__ == "__main__":
    main()
