"""Degree sweep of the structured stiffness apply on the card — the
P-range of the reference's quadrature table
(numba-cpu/demo_linear_box.py:46-56).

    python demos/exp_degree_sweep.py [Pmin Pmax]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from fustpu.mesh.box import build_box_mesh  # noqa: E402
from fustpu.models.discretization import Discretization  # noqa: E402
from fustpu.ops import spectral_mm as mm  # noqa: E402
from fustpu.utils import benchmarks as B  # noqa: E402


def main():
    lo = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    hi = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    dev = B.require_gpu()
    print(f"device: {dev.device_kind} ({B.card_info()})", flush=True)
    dtype = jnp.float32
    for P in range(lo, hi + 1):
        nc = 16 if P <= 9 else 12
        mesh = build_box_mesh((nc, nc, nc), P)
        op = Discretization(mesh, dtype).mm_op
        x = jnp.asarray(np.random.default_rng(0).standard_normal(
            mesh.grid_shape), dtype)
        t, _ = B.time_apply(lambda p, v: mm.stiffness_apply_mm(p, v), op,
                            x, chain=30, reps=5)
        mb = B.min_bytes("stiffness", mesh, dtype)
        print(f"P={P} {nc}^3 dofs={mesh.ndofs:>8} {t*1e3:7.3f} ms  "
              f"{mesh.ndofs/t/1e9:5.2f} GDOF/s  "
              f"{mb/t/1e9:6.1f} GB/s-implied", flush=True)


if __name__ == "__main__":
    main()
