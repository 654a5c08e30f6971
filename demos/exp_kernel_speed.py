"""Stiffness-kernel layout/implementation A/B experiment — the analogue of
the reference's exp_kernel_speed.py (cuda/exp_kernel_speed.py: CLI dtype /
degree / elements-per-wavelength; compares tensor-product vs basix DOF
ordering to show global memory layout is a first-order performance knob).

Here the compared "layouts" are the framework's stiffness codes:
  mm         the structured path (G in the expanded-grid layout)
  windows    the einsum reference on the structured layout
             (G as (ncx, n, ncy, n, ncz, n, 6), per-cell coefficients)
  indexed    explicit-dofmap gather/scatter path

    python demos/exp_kernel_speed.py f32 4 2
                                   [dtype] [degree] [elements/wavelength]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    dtype = {"f32": jnp.float32, "f64": jnp.float64,
             "bf16": jnp.bfloat16}[sys.argv[1] if len(sys.argv) > 1
                                   else "f32"]
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    epw = float(sys.argv[3]) if len(sys.argv) > 3 else 2.0

    from fustpu.mesh.box import build_box_mesh
    from fustpu.models.discretization import Discretization
    from fustpu.ops import operators as ops
    from fustpu.utils import benchmarks as B

    # domain sized like the reference experiment: 10 wavelengths
    nc = max(int(10 * epw), 4)
    mesh = build_box_mesh((nc,) * 3, degree)
    print(f"mesh {nc}^3, degree {degree}, dofs {mesh.ndofs}")

    disc = Discretization(mesh, dtype)
    # materialize lazy device arrays eagerly (a cached_property first
    # touched inside a jit trace would cache a tracer)
    _ = disc.D, disc.G_s, disc.mm_op
    coeff = jnp.ones(mesh.nc, dtype)
    coeff_flat = jnp.ones(mesh.num_cells, dtype)
    dofmap = jnp.asarray(mesh.dofmap)
    G_idx = jnp.asarray(np.moveaxis(disc._G_host, 2, 0), dtype)
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(mesh.grid_shape), dtype)
    dev = B.require_gpu()
    print(f"device: {dev.device_kind} ({B.card_info()})", flush=True)

    variants = {
        "mm": (lambda p, v: __import__(
            "fustpu.ops.spectral_mm", fromlist=["x"]
        ).stiffness_apply_mm(p, v), disc.mm_op),
        "windows": (lambda p, v: ops.stiffness_apply(
            v, p, coeff, disc.D, disc.P), disc.G_s),
        "indexed": (lambda p, v: ops.stiffness_apply_indexed(
            v.reshape(-1), p, coeff_flat, dofmap, disc.D,
            mesh.ndofs).reshape(mesh.grid_shape), G_idx),
    }
    for name, (fn, p) in variants.items():
        mean, std = B.time_apply(fn, p, x, chain=20, reps=5)
        print(f"{name:8s}: {mean*1e3:8.3f} ms/apply "
              f"(+-{std*1e3:.3f})  {mesh.ndofs/mean/1e9:6.2f} GDOF/s",
              flush=True)


if __name__ == "__main__":
    main()
