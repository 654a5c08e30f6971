"""Named timing scopes + aggregate table — the analogue of the reference's
DOLFINx `common.Timer` scopes and `list_timings` wall/average table
(/root/reference/numba-cpu/demo_linear_box.py:302,486;
cpp/common/Linear.hpp:171-176), plus a jax.profiler trace helper for
device profiling (the reference compiles CUDA kernels with lineinfo for
NSight, cuda/operators.py:87).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

_records: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def timer(name: str):
    """Accumulating named wall-clock scope."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _records[name].append(time.perf_counter() - t0)


def reset_timings():
    _records.clear()


def list_timings(out=print):
    """Print the aggregate table (name, reps, total wall, average)."""
    out(f"{'section':<40} {'reps':>5} {'wall [s]':>10} {'avg [s]':>10}")
    for name in sorted(_records):
        ts = _records[name]
        out(f"{name:<40} {len(ts):>5} {sum(ts):>10.4f} "
            f"{sum(ts)/len(ts):>10.4f}")


def get_timings() -> dict[str, list[float]]:
    return {k: list(v) for k, v in _records.items()}


@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/fustpu_trace"):
    """jax.profiler trace scope; view with tensorboard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


annotate = jax.profiler.TraceAnnotation  # named scopes inside host code
