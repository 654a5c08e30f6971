"""Proof that fustpu runs on one NVIDIA GPU at the flagship's size.

    python chip_smoke.py                # one card: phases 1-5
    python chip_smoke.py --four-cards   # four cards: phase 6 only

Everything goes through the public API (mesh builders / read_msh ->
WesterveltModel -> solve; demos/demo_nonlinear_bowl.build_bowl builds the
flagship).  Phases, in the order they run:

1. operators: each stiffness path ('mm', 'extruded', 'indexed'), uniform
   and heterogeneous pair, in f32 on the card at real widths, against a
   float64 numpy sum-factorised reference on the host (relative l2 <= 1e-5;
   TF32 leaking into a contraction would show near 1e-3);
3. physics anchor: the conformal H131 bowl at 64 elements, P=4, run to
   t_final; the focal pressure must land in -6.9..-6.4 MPa;
4. imported meshes: the same bowl round-tripped through .msh ('extruded'
   path) must reproduce the conformal run's probe traces to 1e-4; the
   non-prismatic bodyfit bowl ('indexed' path) must stay finite;
5. heterogeneous media: two-layer conformal and bodyfit bowls (pair paths);
2. the flagship at its own size: the conformal bowl at P=6, 118x72x72
   cells (132,929,701 DOF), 20 timed steps, field finite.
6. (--four-cards) ShardedModel over a (2, 2, 1) device grid on the 6.66M
   conformal bowl and shard_unstructured over 4 cards on its import, each
   compared with the one-card solve on card 0 (relative l2 <= 1e-5; GPU
   scatter-adds use atomics, so the sums are not bitwise).

Solve phases print one line each: card, DOF and cells, set-up, compile,
steady ms/step over a window warmed up with the same scan length, MDOF
steps/s, the process's peak device memory, and compiled.memory_analysis()
of the step.  Every phase raises on failure.  Without a GPU the script
exits nonzero before any phase and prints no result.  The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
TOL_OPERATOR = 1e-5      # f32 apply vs f64 reference, relative l2
TOL_IMPORTED = 1e-4      # extruded import vs conformal probe traces
TOL_SHARDED = 1e-5       # sharded vs one-card solve, relative l2
FOCAL_BAND = (-6.9e6, -6.4e6)   # Pa, conformal bowl 64 el. P=4, 8 periods
CFL = 0.4                # the demos' Courant number


def log(msg: str):
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ---------------------------------------------------------------------------
# float64 host reference: per-cell sum factorisation in numpy
# ---------------------------------------------------------------------------

def reference_stiffness(G_cells, dofmap, D, ndofs, x, coeff=None):
    """y = A x in float64 numpy, independent of the device paths: gather
    x[dofmap], three 1D derivative contractions per cell, the symmetric
    metric G (cells, n^3, 6), three transposed contractions, and a
    bincount scatter-add.  `coeff`: optional per-cell coefficient."""
    D = np.asarray(D, np.float64)
    n = D.shape[0]
    dofmap = np.asarray(dofmap)
    cells = dofmap.shape[0]
    u = np.asarray(x, np.float64).ravel()[dofmap].reshape(cells, n, n, n)
    ein = lambda sub, a: np.einsum(sub, D, a, optimize=True)
    w = (ein("qi,cijk->cqjk", u), ein("qj,cijk->ciqk", u),
         ein("qk,cijk->cijq", u))
    g = np.asarray(G_cells, np.float64).reshape(cells, n, n, n, 6)
    f = [g[..., a] * w[0] + g[..., b] * w[1] + g[..., c] * w[2]
         for a, b, c in ((0, 1, 2), (1, 3, 4), (2, 4, 5))]
    if coeff is not None:
        cf = np.asarray(coeff, np.float64).reshape(cells, 1, 1, 1)
        f = [fi * cf for fi in f]
    y = (ein("qi,cqjk->cijk", f[0]) + ein("qj,ciqk->cijk", f[1])
         + ein("qk,cijq->cijk", f[2]))
    return np.bincount(dofmap.ravel(), weights=y.ravel(), minlength=ndofs)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def _jitted_solver(model, k):
    """(jitted fn, args) that model.solve(state, dt, k) ran last."""
    if hasattr(model, "_solver_cache"):                 # one device
        return model._solver_cache[(k, False, None)], \
            lambda s, dt_, tf_: (model.params, model._flat_state(s), dt_,
                                 tf_)
    fn = (model.solver_fn(k) if hasattr(model, "solver_fn")
          else model._solve_cache[("solve", k, False, None)])
    return fn, lambda s, dt_, tf_: (model.ctx, tuple(s), dt_, tf_)


def memory_line(model, state, dt, k) -> str:
    """compiled.memory_analysis() of the k-step solve."""
    import jax.numpy as jnp

    fn, args = _jitted_solver(model, k)
    dtype = model.dtype
    m = fn.lower(*args(state, jnp.asarray(dt, dtype),
                       jnp.asarray(0.0, dtype))).compile().memory_analysis()
    gb = lambda b: f"{b / 1e9:.3f}"
    return (f"args {gb(m.argument_size_in_bytes)} GB, out "
            f"{gb(m.output_size_in_bytes)} GB, temp "
            f"{gb(m.temp_size_in_bytes)} GB, alias "
            f"{gb(m.alias_size_in_bytes)} GB")


def peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", -1))


def timed_steps(model, k: int):
    """Warm up with a k-step solve (compiles), then time a k-step window
    ending in block_until_ready.  Returns (state, compile_s, window_s)."""
    import jax

    dt, _ = model.cfl_dt(CFL)
    s = model.init_state()
    t = time.perf_counter()
    s, _ = model.solve(s, dt, k)
    jax.block_until_ready(s)
    first = time.perf_counter() - t
    t = time.perf_counter()
    s, _ = model.solve(s, dt, k)
    jax.block_until_ready(s)
    window = time.perf_counter() - t
    return s, max(first - window, 0.0), window


def solve_line(phase: str, name: str, model, card: str, setup_s: float,
               k: int) -> dict:
    """Run timed_steps and print the phase line; returns the numbers and
    the final state."""
    import jax.numpy as jnp

    s, compile_s, window = timed_steps(model, k)
    finite = bool(jnp.isfinite(s.u).all()) and bool(
        jnp.isfinite(s.v).all())
    mesh = model.mesh
    ndofs, cells = mesh.ndofs, mesh.num_cells
    ms = window / k * 1e3
    mdof = ndofs * k / window / 1e6
    dt, _ = model.cfl_dt(CFL)
    mem = memory_line(model, s, dt, k)
    log(f"phase {phase} {name}: card [{card}] dofs {ndofs} cells {cells} "
        f"set-up {setup_s:.1f} s compile {compile_s:.1f} s "
        f"steady {ms:.3f} ms/step over {k} steps "
        f"{mdof:.1f} MDOF-steps/s peak_bytes_in_use {peak_bytes()} "
        f"memory_analysis [{mem}] finite {finite}")
    if not finite:
        raise RuntimeError(f"phase {phase} {name}: field not finite")
    return dict(state=s, ms_per_step=ms, mdof_steps_s=mdof,
                compile_s=compile_s, setup_s=setup_s)


def bowl(elements, degree, geometry, two_layer=False, mesh_dir=None):
    """(model, transit time, set-up seconds) through the demo's builder."""
    from demos.demo_nonlinear_bowl import build_bowl

    t = time.perf_counter()
    prefix = os.path.join(mesh_dir or tempfile.gettempdir(),
                          f"bowl_{geometry}_{elements}_{degree}")
    model, tf = build_bowl(elements, degree, geometry, two_layer,
                           mesh_prefix=prefix, log=lambda m: None)
    return model, tf, time.perf_counter() - t


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

OPERATOR_CASES = (
    ("box", dict(nc=(32, 32, 32), degree=4)),        # 2,146,689 DOF
    ("box", dict(nc=(24, 24, 24), degree=6)),        # 3,048,625 DOF
    ("piston", dict(refine=2, degree=4)),            # 627,385 DOF
    ("bodyfit", dict(elements=32, degree=4)),        # 545,025 DOF
)


def _operator_mesh(kind, spec, mesh_dir):
    from fustpu.mesh import msh_io
    from fustpu.mesh.box import build_box_mesh

    if kind == "box":
        return (f"box P={spec['degree']} {spec['nc']}",
                build_box_mesh(spec["nc"], spec["degree"], perturb=0.1,
                               seed=1))
    if kind == "piston":
        from demos.demo_linear_piston import default_mesh_file

        f = default_mesh_file(os.path.join(mesh_dir, "piston.msh"),
                              spec["degree"], spec["refine"])
        return (f"piston cylinder refine {spec['refine']} "
                f"P={spec['degree']}", msh_io.read_msh(f, spec["degree"]))
    model, _, _ = bowl(spec["elements"], spec["degree"], "bodyfit",
                       mesh_dir=mesh_dir)
    return (f"bodyfit bowl {spec['elements']} el. P={spec['degree']}",
            model.mesh)


def phase_operators(cases=OPERATOR_CASES, mesh_dir=None, reps=10) -> dict:
    """Phase 1: every path's uniform and pair apply in f32 on the device
    vs reference_stiffness in f64.  Returns {label: rel_l2}."""
    import jax
    import jax.numpy as jnp

    from fustpu.models.discretization import Discretization, stiffness_path
    from fustpu.ops import operators as ops
    from fustpu.ops import spectral_mm as mm

    mesh_dir = mesh_dir or tempfile.gettempdir()
    out = {}
    for kind, spec in cases:
        name, mesh = _operator_mesh(kind, spec, mesh_dir)
        path = stiffness_path(mesh)
        disc = Discretization(mesh, jnp.float32)
        n = mesh.degree + 1
        nd = mesh.ndofs
        rng = np.random.default_rng(0)
        x1 = rng.standard_normal(nd).astype(np.float32)
        x2 = rng.standard_normal(nd).astype(np.float32)
        c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
        c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
        dm = np.asarray(mesh.dofmap)
        # operator arrays go in as jit arguments: closure-captured they
        # would compile in as constants
        if path == "mm":
            g = mesh.grid_shape
            ops_ = (disc.mm_op,
                    *[jnp.asarray(mm.expand_cell_field(c.reshape(mesh.nc),
                                                       n), jnp.float32)
                      for c in (c1, c2)])
            uni = lambda o, a: mm.stiffness_apply_mm(
                o[0], a.reshape(g)).reshape(-1)
            pair = lambda o, a, b: mm.stiffness_apply_mm_pair(
                o[0], a.reshape(g), b.reshape(g), o[1], o[2]).reshape(-1)
        elif path == "extruded":
            ops_ = (disc.extruded_op,
                    *[ops.expand_coeff_extruded(mesh, c, jnp.float32)
                      for c in (c1, c2)])
            uni = lambda o, a: ops.stiffness_apply_extruded(a, o[0], nd)
            pair = lambda o, a, b: ops.stiffness_apply_extruded_pair(
                a, b, o[0], nd, o[1], o[2])
        else:
            ops_ = (disc.indexed_op,
                    *[jnp.asarray(c, jnp.float32) for c in (c1, c2)])
            uni = lambda o, a: ops.stiffness_apply_indexed(
                a, o[0][0], None, o[0][1], o[0][2], nd)
            pair = lambda o, a, b: ops.stiffness_apply_indexed_pair(
                a, o[1], b, o[2], o[0][0], o[0][1], o[0][2], nd)
        xs = (jnp.asarray(x1), jnp.asarray(x2))
        G_host, D_host = disc._G_host, disc._D_host
        refs = {
            "uniform": lambda: reference_stiffness(G_host, dm, D_host, nd,
                                                   x1),
            "pair": lambda: (
                reference_stiffness(G_host, dm, D_host, nd, x1, c1)
                + reference_stiffness(G_host, dm, D_host, nd, x2, c2)),
        }
        for form, fn, args in (("uniform", jax.jit(uni), (ops_, *xs[:1])),
                               ("pair", jax.jit(pair), (ops_, *xs))):
            t = time.perf_counter()
            y = jax.block_until_ready(fn(*args))
            compile_s = time.perf_counter() - t
            ts = []
            for _ in range(reps):
                t = time.perf_counter()
                jax.block_until_ready(fn(*args))
                ts.append(time.perf_counter() - t)
            err = rel_l2(y, refs[form]())
            label = f"{name} {path} {form}"
            out[label] = err
            log(f"phase 1 operators: {label}: dofs {nd} cells "
                f"{mesh.num_cells} f32 vs f64 reference rel_l2 {err:.3e} "
                f"(tol {TOL_OPERATOR:g}) apply median "
                f"{np.median(ts) * 1e3:.3f} ms (first call {compile_s:.1f} "
                f"s)")
            if not err <= TOL_OPERATOR:
                raise RuntimeError(f"phase 1: {label} rel_l2 {err:.3e} > "
                                   f"{TOL_OPERATOR:g}")
        del disc, ops_
        gc.collect()
    return out


def phase_anchor(card="", elements=64, degree=4, periods=8.0,
                 band=FOCAL_BAND, mesh_dir=None) -> float:
    """Phase 3: conformal bowl to t_final (the demo's run length,
    nsteps * dt); the focal pressure must land in `band` (Pa)."""
    import jax

    model, transit, setup_s = bowl(elements, degree, "conformal",
                                   mesh_dir=mesh_dir)
    from demos.demo_nonlinear_bowl import focal_pressure

    dt, _ = model.cfl_dt(CFL)
    tf = transit + periods / model.source.frequency
    nsteps = int(tf / dt) + 1
    t = time.perf_counter()
    s, _ = model.solve(model.init_state(), dt, nsteps)
    jax.block_until_ready(s)
    wall = time.perf_counter() - t
    p = focal_pressure(model, np.asarray(s.u))
    log(f"phase 3 physics anchor: card [{card}] conformal bowl "
        f"{elements} el. P={degree}: dofs {model.mesh.ndofs} cells "
        f"{model.mesh.num_cells} set-up {setup_s:.1f} s, {nsteps} steps to "
        f"t_final {nsteps * dt:.4e} s in {wall:.1f} s (incl. compile); "
        f"focal pressure {p / 1e6:.4f} MPa (band {band[0] / 1e6:g} .. "
        f"{band[1] / 1e6:g} MPa)")
    if not band[0] <= p <= band[1]:
        raise RuntimeError(f"phase 3: focal pressure {p:.1f} Pa outside "
                           f"{band}")
    return p


def _probe(model, points):
    """Per-step probe at `points` for model.solve (structured or
    unstructured mesh)."""
    from fustpu.mesh.unstructured import UPointSampler
    from fustpu.utils.eval import PointSampler

    mesh = model.mesh
    smp = (PointSampler(mesh, points) if hasattr(mesh, "nc")
           else UPointSampler(mesh, points))
    pfn = smp.jax_probe()
    return lambda s: pfn(s.u)


def phase_imported(card="", elements=64, degree=4, steps=20,
                   trace_steps=300, mesh_dir=None) -> dict:
    """Phase 4: the conformal bowl and its .msh round trip ('extruded')
    must record the same probe traces over `trace_steps` (rel l2 <=
    TOL_IMPORTED); the bodyfit import ('indexed') must stay finite."""
    from demos.demo_nonlinear_bowl import APERTURE_RADIUS, YC, ZC

    a = APERTURE_RADIUS
    pts = np.array([[0.010, YC, ZC], [0.012, YC + 0.3 * a, ZC],
                    [0.008, YC, ZC + 0.5 * a]])
    traces, out = {}, {}
    for geometry in ("conformal", "unstructured", "bodyfit"):
        model, _, setup_s = bowl(elements, degree, geometry,
                                 mesh_dir=mesh_dir)
        r = solve_line("4", f"{geometry} bowl ({model.impl}) {elements} "
                       f"el. P={degree}", model, card, setup_s, steps)
        out[geometry] = r["ms_per_step"]
        if geometry != "bodyfit":
            dt, _ = model.cfl_dt(CFL)
            _, ys = model.solve(model.init_state(), dt, trace_steps,
                                probe=_probe(model, pts))
            traces[geometry] = np.asarray(ys, np.float64)
        del model, r
        gc.collect()
    err = rel_l2(traces["unstructured"], traces["conformal"])
    amp = float(np.abs(traces["conformal"]).max())
    log(f"phase 4 imported vs conformal: probe traces over {trace_steps} "
        f"steps at {len(pts)} points rel_l2 {err:.3e} (tol "
        f"{TOL_IMPORTED:g}), max |p| {amp:.4e} Pa")
    if not (err <= TOL_IMPORTED and amp > 0):
        raise RuntimeError(f"phase 4: imported vs conformal rel_l2 "
                           f"{err:.3e} (max |p| {amp})")
    out["trace_rel_l2"] = err
    return out


def phase_two_layer(card="", elements=64, degree=4, steps=20,
                    mesh_dir=None) -> dict:
    """Phase 5: two-layer (heterogeneous) Westervelt on the conformal and
    bodyfit bowls: the pair paths, timed and finite."""
    out = {}
    for geometry in ("conformal", "bodyfit"):
        model, _, setup_s = bowl(elements, degree, geometry,
                                 two_layer=True, mesh_dir=mesh_dir)
        if model.uniform:
            raise RuntimeError("phase 5: two-layer medium came out uniform")
        r = solve_line("5", f"two-layer {geometry} bowl ({model.impl}) "
                       f"{elements} el. P={degree}", model, card, setup_s,
                       steps)
        out[geometry] = r["ms_per_step"]
        del model, r
        gc.collect()
    return out


def phase_flagship(card="", elements=0, degree=6, steps=20,
                   mesh_dir=None) -> dict:
    """Phase 2: demo_nonlinear_bowl at its defaults (P=6, 2 elements per
    wavelength = 118x72x72 cells), `steps` timed steps, field finite."""
    model, _, setup_s = bowl(elements, degree, "conformal",
                             mesh_dir=mesh_dir)
    r = solve_line("2", f"flagship conformal bowl ({model.impl}) "
                   f"{tuple(model.mesh.nc)} cells P={degree}", model, card,
                   setup_s, steps)
    r.pop("state")
    r["ndofs"] = model.mesh.ndofs
    return r


def phase_four_cards(card="", elements=64, degree=4, steps=20,
                     grid=(2, 2, 1), mesh_dir=None) -> dict:
    """Phase 6: ShardedModel over `grid` on the conformal bowl and
    shard_unstructured over the same device count on its .msh import,
    each against the one-card solve on device 0 after the same 2 * steps
    steps (warm-up + timed window)."""
    import jax

    from fustpu.parallel.extruded import shard_unstructured
    from fustpu.parallel.models import ShardedModel
    from fustpu.parallel.sharding import DeviceGrid

    k = int(np.prod(grid))
    if len(jax.devices()) < k:
        raise RuntimeError(f"phase 6 needs {k} devices, have "
                           f"{len(jax.devices())}")
    out = {}
    for geometry in ("conformal", "unstructured"):
        model, _, setup_s = bowl(elements, degree, geometry,
                                 mesh_dir=mesh_dir)
        one = solve_line("6", f"one card: {geometry} bowl ({model.impl}) "
                         f"{elements} el. P={degree}", model, card,
                         setup_s, steps)
        t = time.perf_counter()
        sm = (ShardedModel(model, DeviceGrid.create(grid))
              if geometry == "conformal" else shard_unstructured(model, k))
        shard_setup = time.perf_counter() - t
        many = solve_line("6", f"{k} cards ({type(sm).__name__}"
                          + (f" grid {tuple(grid)}" if geometry ==
                             "conformal" else "") + f"): {geometry} bowl",
                          sm, card, shard_setup, steps)
        err = rel_l2(sm.collect(many["state"].u), one["state"].u)
        log(f"phase 6 {geometry}: {k}-card vs one-card u after {2 * steps} "
            f"steps rel_l2 {err:.3e} (tol {TOL_SHARDED:g}; atomic "
            f"scatter-adds and halo sums reorder f32 additions, so not "
            f"bitwise); ms/step one card {one['ms_per_step']:.3f}, {k} "
            f"cards {many['ms_per_step']:.3f}")
        if not err <= TOL_SHARDED:
            raise RuntimeError(f"phase 6 {geometry}: rel_l2 {err:.3e} > "
                               f"{TOL_SHARDED:g}")
        out[geometry] = dict(rel_l2=err, one_ms=one["ms_per_step"],
                             many_ms=many["ms_per_step"])
        del model, sm, one, many
        gc.collect()
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 6 (needs four GPUs)")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from fustpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from fustpu.utils import benchmarks as B

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (first JAX device is {dev.platform} "
              f"{dev.device_kind}); nothing run", file=sys.stderr)
        return 1
    smi = B.card_info()
    print(smi, flush=True)
    card = "; ".join(sorted(set(smi.splitlines())))   # one entry per kind
    log(f"device {dev.device_kind} x{len(jax.devices())}, jax "
        f"{jax.__version__}, compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    t = time.perf_counter()
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{r.stderr[-2000:]}")
    log(f"set-up: make -C native {time.perf_counter() - t:.1f} s")

    with tempfile.TemporaryDirectory() as mesh_dir:
        if args.four_cards:
            phase_four_cards(card, mesh_dir=mesh_dir)
        else:
            phase_operators(mesh_dir=mesh_dir)
            phase_anchor(card, mesh_dir=mesh_dir)
            phase_imported(card, mesh_dir=mesh_dir)
            phase_two_layer(card, mesh_dir=mesh_dir)
            phase_flagship(card, mesh_dir=mesh_dir)
    print(json.dumps({"ok": True, "device": B.device_fields(dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
