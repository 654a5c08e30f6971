"""Parse a `jax.profiler` trace into a per-kernel device-time table.

The reference profiles its CUDA kernels with NSight (source-level,
`lineinfo=True` at /root/reference/cuda/operators.py:87) and aggregates
host timings with DOLFINx `list_timings`.  The equivalent here captures
a `jax.profiler` trace (device events arrive in the `*.trace.json.gz`
dump) and aggregates DEVICE-side op durations, so "where do the
microseconds of one RK step go" is one function call instead of a
tensorboard session.

Usage:
    from fustpu.utils.timing import profile_trace
    from fustpu.utils import traceview
    with profile_trace("/tmp/tr") as d:
        run_the_thing()
    table = traceview.device_op_table(d)
    print(traceview.format_table(table, per_step=num_steps))
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class OpRow:
    name: str
    count: int = 0
    total_us: float = 0.0

    @property
    def mean_us(self) -> float:
        return self.total_us / max(self.count, 1)


@dataclass
class OpTable:
    rows: list           # [OpRow] sorted by total desc
    module_us: float     # total time inside executable (jit_*) spans
    device_pid: int
    categories: dict = field(default_factory=dict)  # category -> total_us


_CATEGORY_PATTERNS = [
    ("copy", re.compile(r"^copy([-.]|$)|copy-start|copy-done")),
    ("fusion", re.compile(r"fusion")),
    ("convolution/dot", re.compile(r"convolution|dot")),
    ("dynamic-slice/update", re.compile(r"dynamic[-_](update[-_])?slice")),
    ("xla-scatter/gather", re.compile(r"scatter|gather")),
]

# parent spans that bracket their children (summing them into the op rows
# would double-count): the executable and the scan's while loop
_SPAN_RE = re.compile(r"^jit_.*\(-?\d+\)$|^while([._]|$)")


def categorize(name: str) -> str:
    for cat, pat in _CATEGORY_PATTERNS:
        if pat.search(name):
            return cat
    return "other"


def _latest_trace_file(logdir: str) -> str:
    files = glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no *.trace.json.gz under {logdir}")
    return max(files, key=os.path.getmtime)


def device_op_table(logdir: str) -> OpTable:
    """Aggregate device-side op durations from the newest trace in logdir.

    Device events are identified per-pid: the profiler emits the Python
    host as one pid (event names prefixed '$' / Python file spans) and
    each device as another.  We pick the non-host pid with the largest
    total duration.  Executable-level spans (`jit_<name>(fingerprint)`)
    bracket their child ops and are reported separately, not summed into
    the per-op rows.
    """
    path = _latest_trace_file(logdir)
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])

    by_pid = defaultdict(list)
    host_pids = set()
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        by_pid[e.get("pid")].append(e)
        if name.startswith("$") or name.startswith("PjitFunction") \
                or "PJRT" in name or "::" in name:
            host_pids.add(e.get("pid"))

    best_pid, best_total = None, -1.0
    for pid, evs in by_pid.items():
        if pid in host_pids:
            continue
        tot = sum(e.get("dur", 0.0) for e in evs)
        if tot > best_total:
            best_pid, best_total = pid, tot
    if best_pid is None:
        raise RuntimeError(
            f"no device-side pid found in {path} (host-only trace?)")

    rows = {}
    module_us = 0.0
    cats = defaultdict(float)
    for e in by_pid[best_pid]:
        name, dur = e.get("name", ""), float(e.get("dur", 0.0))
        if _SPAN_RE.match(name):
            module_us += dur
            continue
        r = rows.setdefault(name, OpRow(name))
        r.count += 1
        r.total_us += dur
        cats[categorize(name)] += dur
    out = sorted(rows.values(), key=lambda r: -r.total_us)
    return OpTable(rows=out, module_us=module_us, device_pid=best_pid,
                   categories=dict(cats))


def format_table(table: OpTable, per_step: int | None = None,
                 top: int = 40) -> str:
    """Render the aggregate.  `per_step`: divide totals by a step count so
    the table reads in ms/step (e.g. the scan length of the traced solve)."""
    div = per_step or 1
    unit = "ms/step" if per_step else "ms total"
    lines = [f"device pid {table.device_pid}; bracketing spans (jit+while, "
             f"overlapping) {table.module_us/1e3/div:.3f} {unit}"]
    lines.append(f"{'op':<64} {'count':>7} {unit:>10} {'mean us':>9}")
    for r in table.rows[:top]:
        lines.append(f"{r.name[:64]:<64} {r.count:>7} "
                     f"{r.total_us/1e3/div:>10.4f} {r.mean_us:>9.1f}")
    rest = table.rows[top:]
    if rest:
        t = sum(r.total_us for r in rest)
        lines.append(f"{'... +' + str(len(rest)) + ' more':<64} "
                     f"{sum(r.count for r in rest):>7} {t/1e3/div:>10.4f}")
    lines.append("-- by category --")
    for cat, us in sorted(table.categories.items(), key=lambda kv: -kv[1]):
        lines.append(f"{cat:<64} {'':>7} {us/1e3/div:>10.4f}")
    total = sum(r.total_us for r in table.rows)
    lines.append(f"{'TOTAL device op time':<64} {'':>7} "
                 f"{total/1e3/div:>10.4f}")
    return "\n".join(lines)
