"""Physics-level model tests.

The reference validates physics only through demos against an external
benchmark suite (SURVEY.md §4); here we add executable validation:
- standing-wave convergence of the linear model against the analytic
  solution (Neumann box mode),
- Westervelt reduces exactly to the linear model when beta = delta = 0,
- source demos run and produce finite, causal fields.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fustpu.config import Material, Source
from fustpu.mesh.box import build_box_mesh
from fustpu.models.linear import LinearWaveModel
from fustpu.models.westervelt import WesterveltModel

EMPTY = np.zeros((0, 2), dtype=np.int32)


def standing_wave_error(ncells, degree, c=1.0):
    """u(x,t) = cos(pi x) cos(pi c t) solves u_tt = c^2 lap u with Neumann
    BCs on the unit box; integrate to t = 0.5 period and compare."""
    mesh = build_box_mesh((ncells, ncells, ncells), degree)
    mat = Material(sound_speed=c, density=1.0)
    src = Source(frequency=c / 2.0, amplitude=0.0)
    model = LinearWaveModel(mesh, mat, src, EMPTY, None, dtype=jnp.float64)
    x = mesh.node_coords[..., 0]
    u0 = np.cos(np.pi * x)
    omega = np.pi * c
    T = 1.0  # half temporal period (omega T = pi): u(T) = -u0
    dt = 0.4 * mesh.hmin() / (c * degree**2)
    nsteps = int(np.ceil(T / dt))
    dt = T / nsteps
    state = model.init_state(0.0, u0=u0)
    final, _ = model.solve(state, dt, nsteps)
    u_exact = u0 * np.cos(omega * T)
    err = np.linalg.norm(np.asarray(final.u) - u_exact)
    return err / np.linalg.norm(u_exact)


def test_standing_wave_accuracy():
    # spectral accuracy: errors should be tiny and drop fast with degree
    e3 = standing_wave_error(3, 3)
    e4 = standing_wave_error(3, 4)
    assert e3 < 2e-4, e3
    assert e4 < 2e-6, e4
    assert e4 < e3 / 10


def test_standing_wave_h_convergence():
    # GLL spectral elements superconverge in dispersion; pre-asymptotic
    # meshes (nc=2,3) are non-monotone, so test the asymptotic pair.
    e4 = standing_wave_error(4, 2)
    e6 = standing_wave_error(6, 2)
    assert e4 < 2e-3, e4
    assert e6 < e4 / 10, (e4, e6)


def test_westervelt_reduces_to_linear():
    mesh = build_box_mesh((3, 3, 3), 3, hi=(0.01, 0.01, 0.01))
    mat = Material(sound_speed=1500.0, density=1000.0,
                   nonlinearity=0.0, attenuation_dB=0.0)
    src = Source(frequency=0.5e6, amplitude=60000.0)
    s_facets = mesh.boundary_facets("x-")
    a_facets = mesh.boundary_facets("x+")
    lin = LinearWaveModel(mesh, mat, src, s_facets, a_facets,
                          dtype=jnp.float64)
    non = WesterveltModel(mesh, mat, src, s_facets, a_facets,
                          dtype=jnp.float64)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(mesh.grid_shape))
    v = jnp.asarray(rng.standard_normal(mesh.grid_shape))
    t = jnp.asarray(1.3e-7)
    kl = lin.rhs(t, u, v)
    # Westervelt source has an extra factor 2 (reference demo convention);
    # compare with amplitude halved on the nonlinear side.
    src_half = Source(frequency=src.frequency, amplitude=src.amplitude / 2)
    non2 = WesterveltModel(mesh, mat, src_half, s_facets, a_facets,
                           dtype=jnp.float64)
    kn = non2.rhs(t, u, v)
    assert np.allclose(np.asarray(kl), np.asarray(kn), rtol=1e-12)


def test_linear_demo_smoke():
    """Miniature of the reference linear box demo: source at x-, absorbing
    at x+ (numba-cpu/demo_linear_box.py)."""
    mat = Material(sound_speed=1500.0, density=1000.0)
    src = Source(frequency=0.5e6, amplitude=60000.0)
    wavelength = mat.sound_speed / src.frequency
    L = 2 * wavelength
    mesh = build_box_mesh((4, 4, 4), 3, hi=(L, L, L))
    model = LinearWaveModel(mesh, mat, src,
                            mesh.boundary_facets("x-"),
                            mesh.boundary_facets("x+"), dtype=jnp.float64)
    dt, _ = model.cfl_dt(0.65)
    nsteps = 12
    final, _ = model.solve(model.init_state(), dt, nsteps)
    u = np.asarray(final.u)
    assert np.all(np.isfinite(u))
    assert np.abs(u[0]).max() > 0.0         # source plane excited
    # causality: wave cannot have reached farther than c*t (+ one cell)
    t_end = dt * nsteps
    reach = mat.sound_speed * t_end + L / 4
    xgrid = mesh.node_coords[..., 0]
    beyond = np.abs(u[xgrid > reach])
    assert beyond.size > 0, "causality check must cover part of the domain"
    # discrete leakage only (the RK4/stiffness stencil moves information a
    # cell per stage, so exact zeros aren't expected on a 4-cell mesh)
    assert beyond.max() < 1e-3 * np.abs(u).max()


def test_westervelt_demo_smoke():
    """Miniature nonlinear bowl-style run: source patch on x-, absorbing
    everywhere (cuda/demo_nonlinear_bowl.py)."""
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1480.0 * 1000.0 * 0.385)
    wavelength = mat.sound_speed / src.frequency
    L = 2 * wavelength
    mesh = build_box_mesh((4, 4, 4), 3, hi=(L, L, L))
    aperture = L / 3
    cyx, cyz = L / 2, L / 2
    patch = mesh.boundary_facets(
        "x-", predicate=lambda c: ((c[:, 1] - cyx) ** 2
                                   + (c[:, 2] - cyz) ** 2) < aperture**2)
    assert 0 < len(patch) < len(mesh.boundary_facets("x-"))
    model = WesterveltModel(mesh, mat, src, patch,
                            mesh.all_boundary_facets(), dtype=jnp.float64)
    dt, _ = model.cfl_dt(0.4)
    final, _ = model.solve(model.init_state(), dt, 30)
    u = np.asarray(final.u)
    assert np.all(np.isfinite(u)) and np.abs(u).max() > 0.0


def test_solve_probe_records():
    mesh = build_box_mesh((2, 2, 2), 2)
    mat = Material(sound_speed=1.0, density=1.0)
    src = Source(frequency=0.5, amplitude=1.0)
    model = LinearWaveModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            None, dtype=jnp.float64)
    final, ys = model.solve(model.init_state(), 1e-3, 5,
                            probe=lambda s: s.u[0, 0, 0])
    assert ys.shape == (5,)


def test_phased_source_focuses():
    """A flat aperture with focus delays concentrates pressure near the
    focal point (the phased-array equivalent of the reference's curved-bowl
    transducer)."""
    from fustpu.models import sources as src_mod

    mat = Material(sound_speed=1500.0, density=1000.0)
    src = Source(frequency=1.0e6, amplitude=1.0, window_periods=1.0)
    wavelength = mat.sound_speed / src.frequency      # 1.5 mm
    L = 8 * wavelength
    mesh = build_box_mesh((12, 12, 12), 3, hi=(L, L, L))
    focus = np.array([0.6 * L, L / 2, L / 2])
    s_facets = mesh.boundary_facets("x-")

    def delays(pts):
        return src_mod.focus_delays(pts, focus, mat.sound_speed)

    kw = dict(dtype=jnp.float64)
    m_foc = LinearWaveModel(mesh, mat, src, s_facets,
                            mesh.all_boundary_facets(),
                            source_delays=delays, **kw)
    m_flat = LinearWaveModel(mesh, mat, src, s_facets,
                             mesh.all_boundary_facets(), **kw)
    dt, _ = m_foc.cfl_dt(0.5)
    # run until the focused wavefront reaches the focus
    tmax = (np.max(np.linalg.norm(
        np.array([[0, 0, 0], [0, L, L]]) - focus, axis=1))
        / mat.sound_speed + 1.5 / src.frequency)
    nsteps = int(tmax / dt) + 1
    uf, _ = m_foc.solve(m_foc.init_state(), dt, nsteps)
    ul, _ = m_flat.solve(m_flat.init_state(), dt, nsteps)

    from fustpu.utils.eval import evaluate
    probe_pts = np.array([focus, [0.6 * L, 0.15 * L, 0.15 * L]])
    pf = evaluate(mesh, np.asarray(uf.u), probe_pts)
    # focused run: strong at focus, weak off axis
    assert abs(pf[0]) > 3 * abs(pf[1]), pf
    # focal pressure of the focused run beats the flat aperture's there
    pl = evaluate(mesh, np.asarray(ul.u), probe_pts)
    assert abs(pf[0]) > 1.2 * abs(pl[0]), (pf[0], pl[0])


def test_heterogeneous_fields_match_uniform():
    """Per-cell material arrays filled with constants must reproduce the
    uniform-material path exactly (wiring check for the heterogeneous
    branch), for both models."""
    mesh = build_box_mesh((3, 3, 3), 3, hi=(0.01,) * 3)
    src = Source(frequency=0.5e6, amplitude=60000.0)
    s_f, a_f = mesh.boundary_facets("x-"), mesh.all_boundary_facets()
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(mesh.grid_shape))
    v = jnp.asarray(rng.standard_normal(mesh.grid_shape))
    t = jnp.asarray(2.1e-7)
    for cls, mat_kw in [
        (LinearWaveModel, dict(sound_speed=1500.0, density=1000.0)),
        (WesterveltModel, dict(sound_speed=1480.0, density=990.0,
                               nonlinearity=3.5, attenuation_dB=0.2)),
    ]:
        m_u = cls(mesh, Material(**mat_kw), src, s_f, a_f,
                  dtype=jnp.float64)
        arr_kw = {k: np.full(mesh.nc, val) for k, val in mat_kw.items()}
        m_h = cls(mesh, Material(**arr_kw), src, s_f, a_f,
                  dtype=jnp.float64)
        assert m_u.uniform and not m_h.uniform
        ku = np.asarray(m_u.rhs(t, u, v))
        kh = np.asarray(m_h.rhs(t, u, v))
        assert np.allclose(ku, kh, rtol=1e-12), cls.__name__


def test_heterogeneous_two_layer_physics():
    """Wave slows down in a slower second layer: arrival at the far plane
    is later than in a uniform fast medium."""
    src = Source(frequency=1.0e6, amplitude=1.0e4)
    L = 0.006
    mesh = build_box_mesh((8, 4, 4), 3, hi=(L, L / 2, L / 2))
    c2 = np.full(mesh.nc, 1500.0)
    c2[4:] = 750.0                      # slow half
    mat_fast = Material(sound_speed=1500.0, density=1000.0)
    mat_layer = Material(sound_speed=c2, density=1000.0)
    dtm = None
    arrivals = []
    for mat in (mat_fast, mat_layer):
        model = LinearWaveModel(mesh, mat, src, mesh.boundary_facets("x-"),
                                mesh.boundary_facets("x+"),
                                dtype=jnp.float64)
        dt, _ = model.cfl_dt(0.5)
        dtm = dt if dtm is None else min(dtm, dt)
    for mat in (mat_fast, mat_layer):
        model = LinearWaveModel(mesh, mat, src, mesh.boundary_facets("x-"),
                                mesh.boundary_facets("x+"),
                                dtype=jnp.float64)
        nsteps = int(1.2 * (L / 1500.0 + L / 750.0) / dtm)
        _, ys = model.solve(model.init_state(), dtm, nsteps,
                            probe=lambda s: s.u[-1, s.u.shape[1] // 2,
                                                s.u.shape[2] // 2])
        ys = np.asarray(ys)
        thresh = 0.05 * np.abs(ys).max()
        arrivals.append(np.argmax(np.abs(ys) > thresh))
    # transit through the slow half delays arrival (ideal ratio 1.5; the
    # 5%-of-own-max threshold and coarse resolution in the slow half make
    # the measured ratio smaller)
    assert arrivals[1] > 1.15 * arrivals[0], arrivals


def test_tf_clamp_no_backward_integration():
    """Steps past tf are no-ops (dt clamps to 0, never negative): running
    extra steps beyond tf must leave the state bitwise unchanged."""
    mesh = build_box_mesh((2, 2, 2), 2)
    mat = Material(sound_speed=1.0, density=1.0)
    src = Source(frequency=0.5, amplitude=1.0)
    model = LinearWaveModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            None, dtype=jnp.float64)
    dt = 1e-3
    tf = 5.5 * dt
    s6, _ = model.solve(model.init_state(), dt, 6, tf=tf)
    s20, _ = model.solve(model.init_state(), dt, 20, tf=tf)
    assert abs(float(s20.t) - tf) < 1e-15 * 100
    assert np.array_equal(np.asarray(s6.u), np.asarray(s20.u))
    assert np.array_equal(np.asarray(s6.v), np.asarray(s20.v))
