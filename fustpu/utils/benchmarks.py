"""Operator micro-benchmarks — the `time_operators` analogue
(/root/reference/numba-cpu/time_operators.py, cuda/time_operators.py: 10-rep
wall-times of mass/stiffness/facet-mass apply at P=4 on a 32^3 box).

Reports wall time, DOF/s, and the bandwidth implied by the minimal-traffic
model (min_bytes).  Applies are chained k-deep inside one jit via lax.scan
and each timed call ends in jax.block_until_ready.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from fustpu.mesh.box import build_box_mesh
from fustpu.ops import precompute as pre
from fustpu.ops import spectral_mm as mm


def card_info() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (a child process that stays off JAX), or "" without nvidia-smi."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return r.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement that finds
    none fails instead of timing the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU found (first JAX device: {dev.platform} "
                         f"{dev.device_kind}); refusing to measure")
    return dev


def device_fields(dev) -> dict:
    """The device fields every measurement line carries."""
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


@dataclass
class OpBenchResult:
    name: str
    degree: int
    ncells: int
    ndofs: int
    mean_s: float
    std_s: float
    dof_per_s: float
    hbm_gb_s: float    # minimal-traffic model (see min_bytes)

    def row(self) -> str:
        return (f"{self.name:<10} P={self.degree} cells={self.ncells:<7} "
                f"dofs={self.ndofs:<9} {self.mean_s*1e3:8.3f} ms "
                f"(+-{self.std_s*1e3:.3f})  {self.dof_per_s/1e9:6.2f} GDOF/s "
                f"{self.hbm_gb_s:7.1f} GB/s")


def min_bytes(name: str, mesh, dtype) -> int:
    """Minimal HBM traffic for one apply: read x + write y + stream the
    geometry factors (mass: the assembled diagonal; stiffness: 6-component
    G per quadrature point)."""
    bs = jnp.dtype(dtype).itemsize
    n3 = mesh.element.ndofs
    vec = mesh.ndofs * bs
    if name == "mass":
        geom = vec                         # assembled diagonal
    else:
        geom = mesh.num_cells * n3 * 6 * bs
    return 2 * vec + geom


def _time(fn, *args, reps: int = 5, warmup: int = 2):
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.std(ts))


def measure_streaming_roofline(mbytes_per_array: int = 256,
                               iters: int = 300) -> float:
    """Measured device-memory streaming bandwidth (GB/s): a data-dependent
    triad c = c*d + e over arrays far larger than the caches, chained
    under one scan.  Per iteration traffic = 3 reads + 1 write of each
    element."""
    m = mbytes_per_array * 2**20 // 4
    c = jnp.zeros((m,), jnp.float32)
    d = jnp.full((m,), np.float32(0.5))
    e = jnp.full((m,), np.float32(1e-3))

    @jax.jit
    def run(c, d, e):
        return jax.lax.scan(lambda a, _: (a * d + e, None), c, None,
                            length=iters)[0]

    mean, _ = _time(run, c, d, e, reps=3)
    return 4 * m * 4 * iters / mean / 1e9


def _chain(fn, k: int):
    """k dependent applies of fn(params, x) inside one jit (lax.scan).
    The operators are linear in x, so XLA cannot algebraically collapse the
    chain (verified: synthetic multiply chains DO get folded; A^k x does
    not).  `params` is an explicit argument so operator arrays don't become
    giant HLO constants."""

    def f(params, x):
        return jax.lax.scan(lambda c, _: (fn(params, c), None), x, None,
                            length=k)[0]

    return jax.jit(f)


def time_apply(fn, params, x, chain: int = 50, reps: int = 5
               ) -> tuple[float, float]:
    """fn(params, x) -> y, timed per apply over a `chain`-deep scan."""
    mean, std = _time(_chain(fn, chain), params, x, reps=reps)
    return mean / chain, std / chain


def bench_operators(nc: int = 32, degree: int = 4, dtype=jnp.float32,
                    reps: int = 5, chain: int = 50, mesh=None):
    """Times the production mass apply (diagonal multiply) and the
    structured ('mm') stiffness apply."""
    from fustpu.models.discretization import Discretization

    if mesh is None:
        nc3 = nc if isinstance(nc, tuple) else (nc, nc, nc)
        mesh = build_box_mesh(nc3, degree)
    diag = jnp.asarray(
        mm.mass_diagonal(mesh.nc, degree, pre.cell_detJ(mesh)), dtype)
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(mesh.grid_shape), dtype)

    mass = lambda p, v: v * p
    op = Discretization(mesh, dtype).mm_op
    stiff = lambda p, v: mm.stiffness_apply_mm(p, v)

    out = []
    for name, fn, p, k in [("mass", mass, diag, chain * 10),
                           ("stiffness", stiff, op, chain)]:
        mean, std = time_apply(fn, p, x, k, reps)
        out.append(OpBenchResult(
            name=name, degree=degree, ncells=mesh.num_cells,
            ndofs=mesh.ndofs, mean_s=mean, std_s=std,
            dof_per_s=mesh.ndofs / mean,
            hbm_gb_s=min_bytes(name, mesh, dtype) / mean / 1e9))
    return out
