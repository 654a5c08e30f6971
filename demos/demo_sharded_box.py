"""Multi-device Westervelt run over a sharded box — the analogue of the
reference's `mpirun -n k python demo_nonlinear_box.py` (domain decomposition
over MPI ranks; here a jax.sharding.Mesh with a ppermute halo exchange).

Driven by the SAME demo driver as the single-device demos (one code path
for 1..N devices, like the reference's rank-agnostic scripts): progress,
probes, checkpoints, snapshots and VTK output all work on the distributed
state.

On a CPU host this runs on virtual devices (functional check); on a
multi-GPU host the same code scales over the cards.

    python demos/demo_sharded_box.py [--devices 8] [--grid 2 2 2]
                                     [--elements 16] [--degree 4]
                                     [--probe X Y Z] [--output pfx] ...
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from demos.common import (demo_argparser, force_host_devices,  # noqa: E402
                          pick_dtype, run_demo)


def main():
    p = demo_argparser(degree=4, elements=16)
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--grid", type=int, nargs=3, default=None,
                   help="device grid (Sx Sy Sz); default (devices, 1, 1)")
    p.add_argument("--steps", type=int, default=50)
    args = p.parse_args()

    if args.platform != "default":
        force_host_devices(args.devices)
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        if args.dtype == "f64":
            jax.config.update("jax_enable_x64", True)

    from fustpu.config import Material, Source
    from fustpu.mesh.box import build_box_mesh
    from fustpu.models.westervelt import WesterveltModel
    from fustpu.parallel.models import ShardedModel
    from fustpu.parallel.sharding import DeviceGrid

    S = tuple(args.grid) if args.grid else (args.devices, 1, 1)
    ne = args.elements or 16
    L = 0.01
    mesh = build_box_mesh((ne, ne, ne), args.degree, hi=(L, L, L))
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1480.0 * 1000.0 * 0.3856)
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.all_boundary_facets(),
                            dtype=pick_dtype(args.dtype))
    grid = DeviceGrid.create(S)
    smodel = ShardedModel(model, grid)
    print(f"device grid {S}, dofs {mesh.ndofs}, impl {smodel.impl}")
    dt, _ = smodel.cfl_dt(0.4)
    run_demo(smodel, dt, args.steps, args, "sharded_box")


if __name__ == "__main__":
    main()
