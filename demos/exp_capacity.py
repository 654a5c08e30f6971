"""Single-card capacity experiment: how large a structured Westervelt
mesh fits ONE card.  The G stream (6 f32 per quadrature point: 6.2 GB at
134M DOF) is the model's dominant device allocation; the script builds
the model, times a few steps and prints the peak device memory.

    python demos/exp_capacity.py [--cells 664 56 56] [--degree 4]
                                 [--steps 10]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--cells", type=int, nargs=3, default=(664, 56, 56))
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from fustpu.config import Material, Source
    from fustpu.mesh.box import build_box_mesh
    from fustpu.models.westervelt import WesterveltModel

    nc = tuple(args.cells)
    mesh = build_box_mesh(nc, args.degree,
                          hi=tuple(0.0005 * c for c in nc))
    print(f"cells {nc} P={args.degree}: {mesh.ndofs/1e6:.1f}M DOF",
          flush=True)
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    t0 = time.perf_counter()
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.all_boundary_facets(),
                            dtype=jnp.float32)
    print(f"setup {time.perf_counter()-t0:.1f} s; impl={model.impl}",
          flush=True)
    dt, _ = model.cfl_dt(0.4)
    s = model.init_state()
    t0 = time.perf_counter()
    s, _ = model.solve(s, dt, args.steps)
    jax.block_until_ready(s)
    print(f"first solve ({args.steps} steps incl compile): "
          f"{time.perf_counter()-t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    s, _ = model.solve(s, dt, args.steps)
    jax.block_until_ready(s)
    per = (time.perf_counter() - t0) / args.steps
    print(f"steady: {per*1e3:.1f} ms/step "
          f"({mesh.ndofs/per/1e9:.2f} GDOF/s-step), peak_bytes_in_use "
          f"{(jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')}",
          flush=True)


if __name__ == "__main__":
    main()
