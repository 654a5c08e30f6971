"""Halo-exchange micro-benchmark — the analogue of the reference's
time_scatterer.py (numba-cpu/time_scatterer.py: 50-rep scatter timings).

Times the sharded RK4 step with and without communication (halo_sum
replaced by identity) to isolate the exchange cost, on whatever device
mesh is available (virtual CPU devices by default; the cards of a
multi-GPU host when present).

    python demos/time_halo.py [--devices 8] [--elements 16] [--degree 4]
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from demos.common import force_host_devices  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--elements", type=int, default=16)
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--platform", choices=["default", "cpu"], default="cpu")
    args = p.parse_args()

    if args.platform == "cpu":
        force_host_devices(args.devices)
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from fustpu.config import Material, Source
    from fustpu.mesh.box import build_box_mesh
    from fustpu.models.westervelt import WesterveltModel
    from fustpu.parallel import sharding as sh
    from fustpu.parallel.models import ShardedModel

    S = (args.devices, 1, 1)
    ne = args.elements
    mesh = build_box_mesh((ne, ne, ne), args.degree, hi=(0.01,) * 3)
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1e5)
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.all_boundary_facets(),
                            stiffness_impl="mm")
    grid = sh.DeviceGrid.create(S)
    smodel = ShardedModel(model, grid)
    dt, _ = model.cfl_dt(0.4)
    print(f"dofs={mesh.ndofs}, device grid {S}")

    def run(disable_halo):
        if disable_halo:
            orig = sh.halo_sum
            sh.halo_sum = lambda y, s: y
        try:
            sm = ShardedModel(model, grid)
            st = sm.init_state()
            out, _ = sm.solve(st, dt, args.steps)
            float(np.asarray(out.t))
            t0 = time.perf_counter()
            out, _ = sm.solve(st, dt, args.steps)
            float(np.asarray(out.t))
            return (time.perf_counter() - t0) / args.steps
        finally:
            if disable_halo:
                sh.halo_sum = orig

    with_h = run(False)
    without = run(True)
    print(f"per step with halo:    {with_h*1e3:8.3f} ms")
    print(f"per step without halo: {without*1e3:8.3f} ms")
    print(f"exchange cost:         {(with_h-without)*1e3:8.3f} ms/step "
          f"({(with_h-without)/with_h*100:.1f}%)")


if __name__ == "__main__":
    main()
