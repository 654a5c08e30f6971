"""Headline benchmark: mass+stiffness operator application throughput
(DOF/s per card) at P=4 on a 32^3 hex box — the configuration of the
reference's time_operators harness (/root/reference/cuda/time_operators.py,
P=4, 32^3, 10 reps) and BASELINE.md's north-star metric.

Prints ONE JSON line naming the device (platform, device_kind, device
count) and the card's power limit.  `vs_baseline`: the reference publishes
no numbers (BASELINE.md), so the ratio is against the speed-of-light bound
measured on THIS card in THIS run — the device-memory streaming bandwidth
applied to the minimal-traffic model of the pair (read x, write y, stream
the assembled mass diagonal and the 6-component G once).  Fails without a
GPU.
"""

import json
import sys

from fustpu.utils.compile_cache import enable_compile_cache


def comment(msg):
    print("#", msg, file=sys.stderr, flush=True)


def main():
    enable_compile_cache()
    import jax.numpy as jnp

    from fustpu.mesh.box import build_box_mesh
    from fustpu.utils import benchmarks as B

    dev = B.require_gpu()
    card = B.card_info()
    comment(f"device: {dev.device_kind} ({card})")
    nc, degree, dtype = 32, 4, jnp.float32

    stream_gbs = max(B.measure_streaming_roofline() for _ in range(3))
    comment(f"measured streaming bandwidth (best of 3): {stream_gbs:.0f} GB/s")

    passes = [B.bench_operators(nc=nc, degree=degree, dtype=dtype, reps=10)
              for _ in range(3)]
    res = min(passes, key=lambda rs: sum(r.mean_s for r in rs))
    spread = max(sum(r.mean_s for r in rs) for rs in passes)
    comment(f"pair time best/worst of 3 passes: "
            f"{sum(r.mean_s for r in res)*1e3:.3f} / {spread*1e3:.3f} ms")
    for r in res:
        comment(r.row())

    total_t = sum(r.mean_s for r in res)
    ndofs = res[0].ndofs
    pair_dof_s = ndofs / total_t
    mesh = build_box_mesh((nc, nc, nc), degree)
    mbytes = (B.min_bytes("mass", mesh, dtype)
              + B.min_bytes("stiffness", mesh, dtype))
    sol_pair_dof_s = ndofs / (mbytes / (stream_gbs * 1e9))
    by_name = {r.name: r for r in res}
    print(json.dumps({
        "metric": "mass+stiffness apply throughput (P=4, 32^3 hex, f32)",
        "value": round(pair_dof_s / 1e9, 4),
        "unit": "GDOF/s per card",
        "vs_baseline": round(pair_dof_s / sol_pair_dof_s, 4),
        "roofline_gb_s": round(stream_gbs, 1),
        "stiffness_ms": round(by_name["stiffness"].mean_s * 1e3, 4),
        "mass_ms": round(by_name["mass"].mean_s * 1e3, 4),
        "device": B.device_fields(dev),
        "card": card,
    }))


if __name__ == "__main__":
    main()
