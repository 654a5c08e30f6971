"""Shared model machinery: state handling, the RK4 step/solve drivers and
CFL step selection used by both physics models (and re-used by the sharded
wrapper) — ONE implementation of the solve path.

The physics subclasses provide `_rhs(params, t, u, v) -> kv` on FLAT
vectors plus the `params` pytree; everything else (flat<->grid state
views, scan construction, probe wiring, tf clamping, dt selection) lives
here.  The reference duplicates this loop per demo script
(/root/reference/cuda/demo_nonlinear_bowl.py:529-654 and siblings)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from fustpu.models import timestepping


class WaveModelBase:
    """Requires subclasses to set: mesh, dtype, source, material, and to
    implement `_rhs(params, t, u, v)` and the `params` property."""

    DEFAULT_CFL = 0.65

    # ------------------------------------------------------------------
    def init_state(self, t0: float = 0.0, u0=None, v0=None
                   ) -> timestepping.RKState:
        z = jnp.zeros(self.mesh.grid_shape, self.dtype)
        u0 = z if u0 is None else jnp.asarray(u0, self.dtype).reshape(z.shape)
        v0 = z if v0 is None else jnp.asarray(v0, self.dtype).reshape(z.shape)
        return timestepping.init_state(u0, v0, t0)

    def _flat_state(self, s):
        r = lambda a: a.reshape(-1)
        return timestepping.RKState(r(s.u), r(s.v), r(s.ku), r(s.kv), s.t)

    def _grid_state(self, s):
        g = self.mesh.grid_shape
        r = lambda a: a.reshape(g)
        return timestepping.RKState(r(s.u), r(s.v), r(s.ku), r(s.kv), s.t)

    def rhs(self, t, u, v):
        """Grid-shaped public entry point."""
        kv = self._rhs(self.params, t, u.reshape(-1), v.reshape(-1))
        return kv.reshape(self.mesh.grid_shape)

    def step(self, state, dt, tf=None):
        s = timestepping.rk4_step(self._rhs, self.params,
                                  self._flat_state(state), dt, tf)
        return self._grid_state(s)

    def solve(self, state, dt: float, num_steps: int, tf=None, probe=None):
        """State fields are (gx, gy, gz) at the API; the scan runs on flat
        vectors internally (odd 3D grid dims tile badly for the
        elementwise passes; flat vectors tile perfectly).  Probes
        observe a 3D view."""
        key = (num_steps, tf is not None, probe)
        if key not in self._solver_cache:
            wrapped = (None if probe is None
                       else (lambda s: probe(self._grid_state(s))))
            self._solver_cache[key] = timestepping.make_solver(
                self._rhs, num_steps, wrapped, clamp_tf=tf is not None)
        dt_ = jnp.asarray(float(dt), self.dtype)
        tf_ = jnp.asarray(0.0 if tf is None else float(tf), self.dtype)
        out, ys = self._solver_cache[key](self.params,
                                          self._flat_state(state), dt_, tf_)
        return self._grid_state(out), ys

    def cfl_dt(self, cfl: float | None = None) -> tuple[float, int]:
        """dt = CFL h / (c P^2), snapped to an integer number of steps per
        source period (reference numba-cpu/demo_linear_box.py:94-100)."""
        cfl = self.DEFAULT_CFL if cfl is None else cfl
        c_max = float(np.max(self.material.sound_speed))
        # h_cfl == hmin (the diameter) on cube cells, but binds on the
        # thin direction of anisotropic cells — the diameter convention
        # overestimates the stable dt by the aspect ratio there (NaN on
        # high-aspect imported cylinders, BENCH_NOTES r5)
        h = getattr(self.mesh, "h_cfl", self.mesh.hmin)()
        dt = cfl * h / (c_max * self.mesh.degree**2)
        spp = int(self.source.period / dt) + 1
        return self.source.period / spp, spp
