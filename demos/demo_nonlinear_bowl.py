"""Flagship: H131-class focused transducer at ~100 W in water, Westervelt
nonlinear propagation — the physics of
/root/reference/cuda/demo_nonlinear_bowl.py (1.1 MHz, beta=3.5,
alpha=0.2 dB/m, source velocity 0.3856 m/s, whole boundary absorbing,
periodic pressure-plane snapshots once the wave fills the domain).

Two bowl realisations (--geometry):
- `conformal` (default): a body-fitted spherical-cap mesh — the x- face of
  a deformed box is morphed onto the H131 cap (the same thing the
  reference's Gmsh mesh does, cuda/demo_nonlinear_bowl.py:98-105), and the
  transducer is a constant velocity source on the curved patch;
- `phased`: flat aperture with per-node focus delays (phased-array
  equivalent; see fustpu.models.sources).
H131 geometry: aperture radius 16 mm, focal length 35 mm.

    python demos/demo_nonlinear_bowl.py [--elements N] [--degree P]
                                        [--geometry conformal|phased] ...

`build_bowl` builds the model without running it (chip_smoke.py drives
it through the same code).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from demos.common import (apply_platform, demo_argparser, force_host_devices,  # noqa: E402
                          pick_dtype, run_demo)
from fustpu.config import Material, Source  # noqa: E402
from fustpu.mesh.box import build_box_mesh, build_mapped_mesh  # noqa: E402
from fustpu.models import sources  # noqa: E402
from fustpu.models.westervelt import WesterveltModel  # noqa: E402
from fustpu.utils import eval as fev  # noqa: E402
from fustpu.utils import io as fio  # noqa: E402


def bowl_mapping(focal_length, aperture_radius, yc, zc, Lx):
    """Morph the x- face onto the spherical cap x_s(r) = F - sqrt(F^2-r^2)
    (apex at the origin, rim towards the focus), tapering the displacement
    to zero by x = Lx/2 and beyond ~1.4 aperture radii."""
    import numpy as np

    def mapping(p):
        q = p.copy()
        r = np.sqrt((p[:, 1] - yc) ** 2 + (p[:, 2] - zc) ** 2)
        rc = np.minimum(r, aperture_radius)
        sag = focal_length - np.sqrt(focal_length**2 - rc**2)
        # smooth radial taper beyond the aperture
        t = np.clip((1.4 * aperture_radius - r) / (0.4 * aperture_radius),
                    0.0, 1.0)
        decay = np.clip(1.0 - 2.0 * p[:, 0] / Lx, 0.0, 1.0)
        q[:, 0] = p[:, 0] + sag * t * decay
        return q

    return mapping


def bodyfit_mapping(focal_length, aperture_radius, yc, zc, Lx, Lt):
    """GENUINELY NON-PRISMATIC body-fitted bowl: the cap sag of
    `bowl_mapping` composed with transverse node clustering toward the
    focal axis whose strength varies along x (peaked near the focus,
    zero at the cap plane and the domain end).  The domain, its boundary
    faces and the cap surface are identical to the conformal mesh —
    only interior node placement differs — but no lattice axis is a
    translation extrusion any more, so the import runs the explicit-
    dofmap ('indexed') path: the honest stand-in for an arbitrary Gmsh
    body-fitted mesh (the reference's
    transducer_3d_W workflow, cuda/demo_nonlinear_bowl.py:98-105)."""

    def mapping(p):
        # cluster first (vanishes on every boundary face), then sag
        q = p.copy()
        cx = np.sin(np.pi * np.clip(p[:, 0] / Lx, 0.0, 1.0)) ** 2
        for ax, c in ((1, yc), (2, zc)):
            s = np.sin(np.pi * np.clip(p[:, ax] / Lt, 0.0, 1.0)) ** 2
            q[:, ax] = p[:, ax] - 0.12 * (p[:, ax] - c) * s * cx
        return bowl_mapping(focal_length, aperture_radius, yc, zc,
                            Lx)(q)

    return mapping


H131_MATERIAL = dict(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                     attenuation_dB=0.2)
DOMAIN_LENGTH = 0.08                         # m (reference :82)
APERTURE_RADIUS = 0.016                      # H131: 32 mm aperture
FOCAL_LENGTH = 0.035                         # H131: 35 mm focus
LT = 0.05                                    # transverse extent
YC = ZC = LT / 2
FOCUS = np.array([FOCAL_LENGTH, YC, ZC])


def bowl_source() -> Source:
    mat = Material(**H131_MATERIAL)
    source_velocity = 0.38557513826589934        # m/s (100 W drive)
    return Source(frequency=1.1e6,
                  amplitude=mat.density * mat.sound_speed * source_velocity)


def bowl_cells(elements: int) -> tuple[int, int, int]:
    """(nex, net, net): `elements` along the axis (0 = the reference's 2
    per wavelength), the transverse count scaled to the 50 mm extent and
    rounded to a multiple of 8."""
    src = bowl_source()
    wavelength = H131_MATERIAL["sound_speed"] / src.frequency
    nex = elements or int(2 * DOMAIN_LENGTH / wavelength)
    net = max(8, int(round(nex * LT / DOMAIN_LENGTH / 8)) * 8)
    return nex, net, net


def build_bowl(elements: int = 0, degree: int = 6,
               geometry: str = "conformal", two_layer: bool = False,
               dtype=None, mesh_file: str = "",
               mesh_prefix: str = "/tmp/bowl", log=print):
    """The flagship WesterveltModel, built but not run.  `geometry`:
    conformal | phased | unstructured | bodyfit (see main's --geometry);
    `mesh_file`: a pre-built tagged .msh (implies unstructured);
    `mesh_prefix`: where the unstructured/bodyfit round trip writes its
    .msh.  Returns (model, tf): tf = one transit plus zero periods — add
    periods / source frequency for the run length."""
    import jax.numpy as jnp

    from fustpu.mesh import msh_io

    dtype = dtype or jnp.float32
    if mesh_file:
        geometry = "unstructured"
    mat = Material(**H131_MATERIAL)
    src = bowl_source()
    nex, net, _ = bowl_cells(elements)
    in_aperture = lambda c: ((c[:, 1] - YC) ** 2
                             + (c[:, 2] - ZC) ** 2) < APERTURE_RADIUS**2
    if geometry == "phased":
        mesh = build_box_mesh((nex, net, net), degree,
                              hi=(DOMAIN_LENGTH, LT, LT))
    elif not mesh_file:   # a supplied .msh needs no generated geometry
        mapping = (bodyfit_mapping(FOCAL_LENGTH, APERTURE_RADIUS, YC, ZC,
                                   DOMAIN_LENGTH, LT)
                   if geometry == "bodyfit" else
                   bowl_mapping(FOCAL_LENGTH, APERTURE_RADIUS, YC, ZC,
                                DOMAIN_LENGTH))
        mesh = build_mapped_mesh((nex, net, net), degree, mapping,
                                 hi=(DOMAIN_LENGTH, LT, LT))
    if geometry in ("unstructured", "bodyfit"):
        # export the body-fitted bowl as a tagged Gmsh mesh and re-import
        # it: the reference's XDMF read_mesh/read_meshtags workflow
        # (cuda/demo_nonlinear_bowl.py:98-105) through the .msh pipeline
        if not mesh_file:
            cap = mesh.boundary_facets("x-", predicate=in_aperture)
            rest = [mesh.boundary_facets(p) for p in
                    ["x+", "y-", "y+", "z-", "z+"]]
            other = np.concatenate(
                [mesh.boundary_facets(
                    "x-", predicate=lambda c: ~in_aperture(c))] + rest)
            mesh_file = msh_io.export_box_msh(
                mesh, {1: cap, 2: other}, mesh_prefix + "_mesh")
        mesh = msh_io.read_msh(mesh_file, degree=degree)
        if geometry == "bodyfit" and hasattr(mesh, "nstacks"):
            raise SystemExit("bodyfit mesh unexpectedly detected as an "
                             "extrusion — clustering too weak?")
        aperture = mesh.boundary_facets(1)
        absorbing = mesh.boundary_facets(2)
        kind = ("extruded" if hasattr(mesh, "nstacks")
                else "general (non-prismatic)")
        log(f"mesh: {mesh_file} ({mesh.num_cells} hex cells, "
            f"imported, {kind})")
    else:
        aperture = mesh.boundary_facets("x-", predicate=in_aperture)
        # absorbing on everything EXCEPT the source aperture — the
        # reference's ds(1)/ds(2) sets are disjoint
        # (cuda/demo_nonlinear_bowl.py:364-374); absorbing over the
        # aperture too damps the source (focal |p| reads ~2x low)
        absorbing = np.concatenate(
            [mesh.boundary_facets("x-",
                                  predicate=lambda c: ~in_aperture(c))]
            + [mesh.boundary_facets(p) for p in
               ["x+", "y-", "y+", "z-", "z+"]])
    log(f"degree {degree}, {geometry} bowl, "
        f"Number of degrees-of-freedom: {mesh.ndofs}")
    if len(aperture) == 0:
        raise SystemExit("aperture selected no facets — increase --elements "
                         "so facet centroids resolve the 16 mm radius")
    log(f"aperture facets: {len(aperture)}")

    c_water = float(np.min(mat.sound_speed))
    delays = (None if geometry != "phased" else
              (lambda pts: sources.focus_delays(pts, FOCUS, c_water)))
    if two_layer:
        # per-cell material from cell centroids of the FINAL mesh (order-
        # independent: survives import round trips and locality reorder)
        cent = np.asarray(mesh.cell_corners_flat).mean(axis=1)
        tissue = cent[:, 0] > 0.02
        shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
        mat = Material(
            sound_speed=np.where(tissue, 1560.0, 1480.0).reshape(shape),
            density=np.where(tissue, 1045.0, 1000.0).reshape(shape),
            nonlinearity=3.5, attenuation_dB=0.2)
        log(f"two-layer medium (interface x=20 mm, "
            f"{int(tissue.sum())} tissue cells)")
    model = WesterveltModel(mesh, mat, src, aperture, absorbing,
                            dtype=dtype, source_delays=delays)
    tf = DOMAIN_LENGTH / float(np.min(mat.sound_speed))
    return model, tf


def focal_pressure(model, u_host) -> float:
    """The pressure field `u_host` (host array) at the H131 focus."""
    mesh = model.mesh
    if hasattr(mesh, "nc"):
        return float(fev.evaluate(mesh, u_host, FOCUS[None, :])[0])
    return float(mesh.evaluate(u_host, FOCUS[None, :])[0])


def main():
    parser = demo_argparser(degree=6, periods=8.0)
    parser.add_argument("--geometry",
                        choices=["conformal", "phased", "unstructured",
                                 "bodyfit"],
                        default="conformal",
                        help="unstructured = export the body-fitted bowl "
                             "mesh to a tagged Gmsh .msh file, re-import "
                             "it, and run on the imported-mesh path "
                             "(the reference's workflow); bodyfit = same "
                             "round-trip on a GENUINELY non-prismatic "
                             "mesh (focal-axis node clustering breaks "
                             "every extrusion axis) — the general-mesh "
                             "indexed path")
    parser.add_argument("--mesh", default="",
                        help="pre-built tagged .msh (tag 1 = bowl cap, "
                             "tag 2 = absorbing); implies unstructured")
    parser.add_argument("--two-layer", action="store_true",
                        help="water -> soft-tissue layer (c=1560, "
                             "rho=1045) past x=20 mm: heterogeneous "
                             "Westervelt, exercising the pair stiffness "
                             "path on every mesh kind")
    parser.add_argument("--devices", type=int, default=1,
                        help="shard the flagship over k devices (box "
                             "partition for structured geometries, RCB "
                             "for imported meshes; on a CPU host virtual "
                             "devices are forced)")
    args = parser.parse_args()
    if args.devices > 1 and args.platform == "cpu":
        force_host_devices(args.devices)
    apply_platform(args)
    model, tf = build_bowl(args.elements, args.degree, args.geometry,
                           args.two_layer, pick_dtype(args.dtype),
                           mesh_file=args.mesh,
                           mesh_prefix=args.output or "/tmp/bowl")
    mesh = model.mesh
    src = model.source
    if args.devices > 1:
        if hasattr(mesh, "nc"):      # structured: box partition
            from fustpu.parallel.models import ShardedModel
            from fustpu.parallel.sharding import DeviceGrid

            S = [args.devices, 1, 1]
            for f in (2, 2):         # prefer 2D grids when divisible
                if S[0] % f == 0 and S[0] > f:
                    S = [S[0] // f, S[1] * f, S[2]]
            model = ShardedModel(model, DeviceGrid.create(tuple(S)))
            print(f"sharded over device grid {tuple(S)}")
        else:                        # imported mesh: RCB partition
            from fustpu.parallel.extruded import shard_unstructured

            model = shard_unstructured(model, args.devices)
            print(f"sharded over {model.k} devices "
                  f"({model.num_shared} shared interface entries)")
    dt, _ = model.cfl_dt(0.4)
    tf = tf + args.periods / src.frequency
    nsteps = int(tf / dt) + 1
    print(f"Number of steps: {nsteps}")
    state = run_demo(model, dt, nsteps, args, "nonlinear_bowl")

    if args.output:
        # axial pressure plane snapshot (reference 357 x 179 grid,
        # cuda/demo_nonlinear_bowl.py:136-141)
        u_host = (model.collect(state.u) if hasattr(model, "collect")
                  else np.asarray(state.u))
        structured = hasattr(mesh, "nc")
        if structured:
            pts, vals = fev.eval_plane(mesh, u_host, axis=2,
                                       coord=ZC, n0=357, n1=179)
        else:
            pts = fev.plane_points(mesh, axis=2, coord=ZC, n0=357, n1=179)
            vals = mesh.evaluate(u_host, pts)
        p = fio.save_point_cloud(f"{args.output}_pressure_plane.txt",
                                 pts, vals, cols=(0, 1))
        print(f"wrote {p}")
        print(f"pressure at focus: {focal_pressure(model, u_host):.1f} Pa")


if __name__ == "__main__":
    main()
