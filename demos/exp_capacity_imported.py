"""Single-card capacity experiment for IMPORTED (prismatic) meshes: how
large a Westervelt cylinder fits ONE card on the 'extruded' path, which
stores 6 f32 per quadrature point of geometry (4.1 GB at ~100M DOF, P=4)
— the imported-mesh configuration of the reference's 10^8+-DOF MPI runs
(BASELINE.md; /root/reference/cuda/scatterer.py:104-277).

    python demos/exp_capacity_imported.py [--m 48] [--nz 120]
        [--degree 4] [--steps 10]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=48,
                   help="butterfly sectors (2D footprint resolution)")
    p.add_argument("--mr", type=int, default=24)
    p.add_argument("--nr-ann", type=int, default=24)
    p.add_argument("--nz", type=int, default=120, help="layers")
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--radius", type=float, default=0.035)
    p.add_argument("--length", type=float, default=0.12)
    p.add_argument("--piston", type=float, default=0.01)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from fustpu.config import Material, Source
    from fustpu.mesh.extruded import as_extruded
    from fustpu.mesh.shapes import cylinder_mesh
    from fustpu.mesh.unstructured import UnstructuredHexMesh
    from fustpu.mesh.msh_io import _facets_from_quads
    from fustpu.models.westervelt import WesterveltModel

    t0 = time.perf_counter()
    v, c, tagged = cylinder_mesh(args.radius, args.length, args.piston,
                                 m=args.m, mr=args.mr,
                                 nr_ann=args.nr_ann, nz=args.nz)
    # skip the .msh file round trip (minutes at production sizes) —
    # match the tagged quads to (cell, facet) pairs directly
    um = UnstructuredHexMesh(degree=args.degree, vertices=v, cells=c,
                             facet_tag_map=_facets_from_quads(c, tagged))
    mesh = as_extruded(um)
    assert mesh is not None, "cylinder must detect as extruded"
    t_mesh = time.perf_counter() - t0
    print(f"mesh: {mesh.num_cells} cells, {mesh.ndofs/1e6:.1f}M dofs, "
          f"n2d={mesh.n2d}, gz={mesh.gz}  [{t_mesh:.1f}s]", flush=True)

    t0 = time.perf_counter()
    mat = Material(sound_speed=1500.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.3)
    src = Source(frequency=1.0e6, amplitude=1.0e5)
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets(1),
                            mesh.boundary_facets(2), dtype=jnp.float32)
    t_setup = time.perf_counter() - t0
    print(f"model: impl={model.impl}  setup {t_setup:.1f}s", flush=True)

    dt, _ = model.cfl_dt(0.35)

    state = model.init_state()
    # warm up with the SAME scan length that gets timed: solve(k) and
    # solve(1) are different scan lengths, i.e. different executables
    t0 = time.perf_counter()
    state, _ = model.solve(state, dt, args.steps)
    jax.block_until_ready(state)
    print(f"first solve({args.steps}) incl. compile: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    state, _ = model.solve(state, dt, args.steps)
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    per = wall / args.steps * 1e3
    print(f"{args.steps} steps: {wall:.2f}s -> {per:.1f} ms/step "
          f"({mesh.ndofs * 4 / per / 1e6:.2f} GDOF/s RK4-stage rate)",
          flush=True)
    print(f"|u| max (finite check): "
          f"{float(jnp.max(jnp.abs(state.u))):.3e}, peak_bytes_in_use "
          f"{(jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')}")


if __name__ == "__main__":
    main()
