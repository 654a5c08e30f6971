"""Linear wave, plane source, homogeneous water box.

The counterpart of /root/reference/numba-cpu/demo_linear_box.py and
cuda/demo_linear_box.py: 0.5 MHz windowed velocity source on the x- face,
first-order absorbing boundary on x+, P=4 GLL hexes at 2 elements per
wavelength, CFL 0.65 RK4.

    python demos/demo_linear_box.py [--elements N] [--degree P]
                                    [--dtype f32] [--output out]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from demos.common import apply_platform, demo_argparser, pick_dtype, run_demo  # noqa: E402
from fustpu.config import Material, Source, TimeConfig  # noqa: E402
from fustpu.mesh.box import build_box_mesh  # noqa: E402
from fustpu.models.linear import LinearWaveModel  # noqa: E402


def main():
    args = demo_argparser(degree=4).parse_args()
    apply_platform(args)
    mat = Material(sound_speed=1500.0, density=1000.0)
    src = Source(frequency=0.5e6, amplitude=60000.0)
    L = 0.03
    wavelength = mat.sound_speed / src.frequency
    ne = args.elements or int(2 * L / wavelength)
    print(f"mesh: {ne}^3 hex cells, degree {args.degree}")
    mesh = build_box_mesh((ne,) * 3, args.degree, hi=(L, L, L))
    print(f"Number of degrees-of-freedom: {mesh.ndofs}")

    model = LinearWaveModel(mesh, mat, src,
                            mesh.boundary_facets("x-"),
                            mesh.boundary_facets("x+"),
                            dtype=pick_dtype(args.dtype))
    dt, _ = model.cfl_dt(TimeConfig(cfl=0.65).cfl)
    tf = L / mat.sound_speed + args.periods / src.frequency
    nsteps = int(tf / dt) + 1
    print(f"Number of steps: {nsteps}")
    run_demo(model, dt, nsteps, args, "linear_box")


if __name__ == "__main__":
    main()
