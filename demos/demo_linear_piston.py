"""Linear wave from a circular piston transducer with absorbing far field —
Benchmark 1 Source 2 of the inter-code FUS benchmark suite, the physics of
/root/reference/numba-cpu/demo_linear_piston.py & cuda/demo_linear_piston.py.

Like the reference, the demo runs on an IMPORTED tagged mesh
(XDMFFile.read_mesh/read_meshtags there, a Gmsh .msh file here,
cuda/demo_linear_piston.py:83-90): a cylindrical water column with the
piston disk tagged 1 on the z=0 wall and the absorbing wall/far-cap tagged
2.  Pass --mesh to use your own file; otherwise a conforming all-hex
O-grid cylinder is generated, written to .msh, and read back through the
same importer.  The on-axis steady-state pressure amplitude is compared
against the O'Neil closed-form solution — the analytic anchor of the
BM1S2 claim.

    python demos/demo_linear_piston.py [--mesh file.msh] [--degree P] ...
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from demos.common import (apply_platform, demo_argparser, force_host_devices,  # noqa: E402
                          pick_dtype)
from fustpu.config import Material, Source  # noqa: E402
from fustpu.mesh import msh_io, shapes  # noqa: E402
from fustpu.mesh.unstructured import UPointSampler  # noqa: E402
from fustpu.models.linear import LinearWaveModel  # noqa: E402
from fustpu.utils import io as fio  # noqa: E402

RADIUS, LENGTH, PISTON_A = 0.015, 0.03, 0.01      # BM1 source-2 geometry [m]


def default_mesh_file(path: str, degree: int, refine: int) -> str:
    """Generate the tagged O-grid cylinder and write it as .msh."""
    verts, cells, tagged = shapes.cylinder_mesh(
        RADIUS, LENGTH, PISTON_A,
        m=4 * refine, mr=2 * refine, nr_ann=2 * refine, nz=15 * refine)
    return msh_io.write_msh(path, verts, cells, tagged)


def main():
    p = demo_argparser(degree=4, periods=3.0)
    p.add_argument("--mesh", default="", help=".msh file (generated if '')")
    p.add_argument("--refine", type=int, default=1,
                   help="refinement factor for the generated mesh")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the imported mesh over k devices "
                        "(RCB partition + shared-row exchange; on a CPU "
                        "host virtual devices are forced)")
    args = p.parse_args()
    if args.devices > 1 and args.platform == "cpu":
        force_host_devices(args.devices)
    apply_platform(args)
    mat = Material(sound_speed=1500.0, density=1000.0)
    src = Source(frequency=0.5e6, amplitude=60000.0)

    mesh_file = args.mesh or default_mesh_file(
        (args.output or "/tmp/piston") + "_cyl", args.degree, args.refine)
    mesh = msh_io.read_msh(mesh_file, degree=args.degree)
    print(f"mesh: {mesh_file} ({mesh.num_cells} hex cells)")
    print(f"Number of degrees-of-freedom: {mesh.ndofs}")
    piston = mesh.boundary_facets(1)
    absorbing = mesh.boundary_facets(2)
    print(f"piston facets: {len(piston)}, absorbing: {len(absorbing)}")

    model = LinearWaveModel(mesh, mat, src, piston, absorbing,
                            dtype=pick_dtype(args.dtype))
    # cylinder imports are prismatic -> the factorized fast path; the
    # per-element indexed path remains the generic fallback
    print(f"stiffness impl: {model.impl}")
    assert model.impl == "extruded"
    dt, spp = model.cfl_dt()
    tf = LENGTH / mat.sound_speed + args.periods / src.frequency
    nsteps = int(tf / dt) + 1
    print(f"Number of steps: {nsteps} (dt={dt:.3e}, {spp}/period)")

    # per-step on-axis hydrophone traces
    zs = np.linspace(0.15, 0.75, 13) * LENGTH
    pts = np.stack([np.zeros_like(zs), np.zeros_like(zs), zs], axis=1)
    if args.devices > 1:
        from fustpu.parallel.extruded import ExtrudedShardedModel

        model = ExtrudedShardedModel(model, num_devices=args.devices)
        print(f"sharded over {model.k} devices "
              f"({model.num_shared} shared interface rows)")
        probe = model.probe_fn(pts)
    else:
        pfn = UPointSampler(mesh, pts).jax_probe()
        probe = lambda s: pfn(s.u)   # one object: keyed solver cache

    state = model.init_state()
    chunk = max(args.progress_every, 100)
    total = -(-nsteps // chunk) * chunk        # pad to equal-length scans
    traces, done, wall, walls = [], 0, 0.0, []
    while done < total:
        t0 = time.perf_counter()
        state, ys = model.solve(state, dt, chunk, tf=nsteps * dt,
                                probe=probe)
        _ = float(jnp.ravel(state.u)[0])
        walls.append(time.perf_counter() - t0)
        wall += walls[-1]
        traces.append(np.asarray(ys))
        done += chunk
        print(f"t: {float(state.t):.5e}, steps: {min(done, nsteps)}"
              f"/{nsteps}, u[0] = {float(jnp.ravel(state.u)[0]):.4e}",
              flush=True)
    print(f"Solve time: {wall:.3f}")
    print(f"Solve time per step: {wall / total:.6f} (incl first-chunk "
          "compile)")
    if len(walls) > 1:
        steady = sum(walls[1:]) / (len(walls) - 1) / chunk
        print(f"Solve time per step (steady): {steady:.6f}")

    # steady-state on-axis amplitude over the final source period
    tr = np.concatenate(traces, axis=0)[:nsteps]
    amp = np.abs(tr[-spp:]).max(axis=0)
    ref = shapes.oneil_on_axis(zs, PISTON_A, src.frequency,
                               mat.sound_speed, src.amplitude)
    print("\n  z [mm]   |p| sim [kPa]   O'Neil [kPa]   dev")
    devs = []
    for z, a, r in zip(zs, amp, ref):
        d = abs(a - r) / max(ref.max(), 1e-300)
        devs.append(d)
        print(f"  {z*1e3:6.2f}   {a/1e3:12.2f}   {r/1e3:11.2f}   {d:6.2%}")
    print(f"max on-axis deviation vs O'Neil: {max(devs):.2%} "
          f"(of peak amplitude)")

    if args.output:
        path = fio.save_point_cloud(f"{args.output}_piston_axis.txt",
                                    pts, amp, cols=(2,))
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
