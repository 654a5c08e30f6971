"""Sharded (multi-chip) wave models.

Wraps a single-device LinearWaveModel / WesterveltModel and distributes its
state and geometry over a DeviceGrid.  The full RK4 solve runs inside one
`shard_map`-wrapped `lax.scan`.

Communication structure per RK stage: exactly ONE `halo_sum` (a ppermute
pair per sharded axis) — only the stiffness apply couples neighbouring
cells.  Every mass-type term (unsteady LHS, v^2 term, sources, absorbing
boundary) is a globally-diagonal elementwise multiply by a *consistent*
distributed vector
(shared planes hold full sums on every owner), so it commutes with the
exchange and is added after it.  The reference needs 3 scatter_forward + 2
scatter_reverse MPI rounds per stage instead
(/root/reference/cuda/demo_nonlinear_bowl.py:604-615,640).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from fustpu.models import sources, timestepping
from fustpu.models.westervelt import WesterveltModel
from fustpu.ops import spectral_mm as mm
from fustpu.parallel import sharding as sh

try:  # jax >= 0.6 exports shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore


def split_expanded_field(arr: np.ndarray, nc, S, n: int) -> np.ndarray:
    """Expanded-layout array (..., ex, ey, ez) with leading extra dims ->
    (Sx, Sy, Sz, ..., lex, ley, lez)."""
    lead = arr.shape[:-3]
    lc = [c // s for c, s in zip(nc, S)]
    le = [c * n for c in lc]
    a = arr.reshape(*lead, S[0], le[0], S[1], le[1], S[2], le[2])
    k = len(lead)
    perm = (k, k + 2, k + 4, *range(k), k + 1, k + 3, k + 5)
    return np.ascontiguousarray(a.transpose(perm))


class ShardedModel:
    """Distributes a built single-device model on a box or mapped mesh over
    `grid` and exposes step/solve running under shard_map; each device
    applies the structured ('mm') stiffness to its block."""

    def __init__(self, model, grid: sh.DeviceGrid):
        self.model = model
        self.grid = grid
        self.kind = ("westervelt" if isinstance(model, WesterveltModel)
                     else "linear")
        mesh = model.mesh
        self.mesh = mesh
        S = grid.shape
        self.S = S
        Pd = mesh.degree
        n = Pd + 1
        # ghost padding: cell counts that don't divide the device grid are
        # padded up with zero-stiffness cells (G = 0, mass diag 1, sources
        # 0) — the pad region stays identically zero and never couples
        # back, so ANY mesh runs on ANY device count, like the
        # reference's `mpirun -n k` (numba-cpu/demo_linear_box.py:68-75)
        nc = tuple(-(-c // s) * s for c, s in zip(mesh.nc, S))
        self.nc_pad = nc
        self.cell_pad = tuple(p - c for p, c in zip(nc, mesh.nc))
        self.grid_pad = tuple(pc * Pd for pc in self.cell_pad)
        if any(self.cell_pad):
            print(f"[fustpu] ShardedModel: padding cells {mesh.nc} -> "
                  f"{nc} for device grid {S} (zero-coefficient ghosts)",
                  flush=True)
        self.lc = tuple(c // s for c, s in zip(nc, S))
        self.lgrid = tuple(c * Pd + 1 for c in self.lc)
        dtype = model.dtype
        self.dtype = dtype
        disc = model.disc

        dist = {}     # leading-device-axes arrays, spec P('x','y','z')
        repl = {}     # replicated arrays, spec P()

        def pad_node(a, val=0.0):
            a = np.asarray(a).reshape(mesh.grid_shape)
            if not any(self.grid_pad):
                return a
            return np.pad(a, [(0, p) for p in self.grid_pad],
                          constant_values=val)

        def pad_cell3(a):
            """(ncx, ncy, ncz[, ...]) cell field -> zero-padded."""
            a = np.asarray(a)
            width = [(0, p) for p in self.cell_pad]
            width += [(0, 0)] * (a.ndim - 3)
            return np.pad(a, width)

        def pad_cells_flat(a):
            """(cells, ...) flat cell array -> padded, zero rows."""
            a = np.asarray(a)
            trail = a.shape[1:]
            a = a.reshape(*mesh.nc, *trail)
            return pad_cell3(a).reshape(-1, *trail)

        def put_node(a, val=0.0):
            # model diagonals are stored flat; restore the grid shape
            return grid.put(sh.split_node_field(pad_node(a, val), nc, S,
                                                Pd), dtype)

        self.impl = model.impl

        def repl_put(a):
            return grid.replicate(a, dtype)

        repl["D"] = repl_put(disc._D_host)
        G_exp = mm.to_expanded_layout(
            pad_cells_flat(disc._G_host), nc, n)           # (ex,ey,ez,6)
        dist["G"] = grid.put(split_expanded_field(
            np.moveaxis(G_exp, -1, 0), nc, S, n), dtype)

        def put_exp(a):
            # expanded (ex, ey, ez) coefficient field -> zero-padded tiles
            a = np.asarray(a, np.float64)
            epad = [(0, pc * n) for pc in self.cell_pad]
            a = np.pad(a, [(0, 0)] * (a.ndim - 3) + epad)
            return grid.put(split_expanded_field(a, nc, S, n), dtype)

        if self.kind == "linear":
            dist["m"] = put_node(model.m, val=1.0)   # divisor: pad 1
            dist["s_cos"] = put_node(model.s_cos)
            if model.s_sin is not None:
                dist["s_sin"] = put_node(model.s_sin)
            if model.c2_e is not None:
                dist["c2_e"] = put_exp(model.c2_e)
        else:
            dist["m0"] = put_node(model.m0, val=1.0)  # divisor: pad 1
            dist["mvec2"] = put_node(model.mvec2)
            dist["s1_cos"] = put_node(model.s1_cos)
            dist["s2_cos"] = put_node(model.s2_cos)
            if model.s1_sin is not None:
                dist["s1_sin"] = put_node(model.s1_sin)
                dist["s2_sin"] = put_node(model.s2_sin)
            if model.c3_e is not None:
                dist["c3_e"] = put_exp(model.c3_e)
                dist["c4_e"] = put_exp(model.c4_e)
        if model.fvec_abs is not None:
            dist["fvec"] = put_node(model.fvec_abs)
        self.has_abs = model.fvec_abs is not None

        self.ctx = {"dist": dist, "repl": repl}
        self.ctx_spec = {
            "dist": {k: P(*sh.AXES) for k in dist},
            "repl": jax.tree.map(lambda _: P(), repl),
        }
        self._solve_cache = {}

    # ---------------- local physics (inside shard_map) -------------------
    def _local_stiffness(self, ctx, x, coeff_e=None):
        op = mm.MMStiffness(D=ctx["repl"]["D"], G=ctx["dist"]["G"])
        return mm.stiffness_apply_mm(op, x, coeff_e=coeff_e)

    def _local_rhs(self, ctx, t, u, v):
        d = ctx["dist"]
        model = self.model
        if self.kind == "linear":
            if model.uniform:
                b = model.c2_scalar * self._local_stiffness(ctx, u)
            else:
                b = self._local_stiffness(ctx, u, d["c2_e"])
            b = sh.halo_sum(b, self.S)
            a_c, a_s = sources.linear_source_coeffs(
                t, model.source, model.c_src)
            b = b + a_c.astype(self.dtype) * d["s_cos"]
            if "s_sin" in d:
                b = b + a_s.astype(self.dtype) * d["s_sin"]
            if self.has_abs:
                b = b + v * d["fvec"]
            return b / d["m"]

        m = d["m0"] + u * d["mvec2"]
        if model.uniform:
            b = self._local_stiffness(
                ctx, model.c3_scalar * u + model.c4_scalar * v)
        else:
            # one contraction pass for both terms (see
            # spectral_mm.stiffness_apply_mm_pair)
            op = mm.MMStiffness(D=ctx["repl"]["D"], G=d["G"])
            b = mm.stiffness_apply_mm_pair(op, u, v, d["c3_e"], d["c4_e"])
        b = sh.halo_sum(b, self.S)
        b = b - (v * v) * d["mvec2"]
        (g_c, g_s), (dg_c, dg_s) = sources.westervelt_source_coeffs(
            t, model.source, model.c_src)
        b = b + g_c.astype(self.dtype) * d["s1_cos"]
        b = b + dg_c.astype(self.dtype) * d["s2_cos"]
        if "s1_sin" in d:
            b = b + g_s.astype(self.dtype) * d["s1_sin"]
            b = b + dg_s.astype(self.dtype) * d["s2_sin"]
        if self.has_abs:
            b = b + v * d["fvec"]
        return b / m

    # ---------------- public API ------------------------------------------
    def init_state(self, t0: float = 0.0, u0=None, v0=None
                   ) -> timestepping.RKState:
        """Distributed RKState (leading (Sx, Sy, Sz) device axes)."""
        nc, S, Pd = self.nc_pad, self.S, self.mesh.degree

        def dist_field(f):
            if f is None:
                f = np.zeros(self.mesh.grid_shape)
            f = np.asarray(f).reshape(self.mesh.grid_shape)
            if any(self.grid_pad):
                f = np.pad(f, [(0, p) for p in self.grid_pad])
            return self.grid.put(sh.split_node_field(f, nc, S, Pd),
                                 self.dtype)

        t = self.grid.replicate(np.asarray(t0, jnp.dtype(self.dtype)))
        return timestepping.RKState(
            u=dist_field(u0), v=dist_field(v0), ku=dist_field(None),
            kv=dist_field(None), t=t)

    def probe_fn(self, points):
        """Traced per-step sampler for `solve(probe=...)`: each point's
        (n,n,n) interpolation window lives inside one cell, hence on one
        device block; non-owning devices contribute zero and a psum over
        the grid axes replicates the full trace (the distributed analogue
        of the reference's compute_eval_params + Function.eval,
        /root/reference/cuda/utils.py:117-154)."""
        from fustpu.utils.eval import PointSampler

        smp = PointSampler(self.mesh, points)
        Pd = self.mesh.degree
        lgc = [c * Pd for c in self.lc]          # block stride per axis
        block = [idx[:, 0] // g for idx, g in
                 zip((smp._I, smp._J, smp._K), lgc)]
        Il, Jl, Kl = [jnp.asarray(idx - (b * g)[:, None]) for idx, b, g in
                      zip((smp._I, smp._J, smp._K), block, lgc)]
        bi, bj, bk = [jnp.asarray(b) for b in block]
        w = jnp.asarray(smp._w)

        def probe(s: timestepping.RKState):
            f = s.u
            own = ((bi == jax.lax.axis_index("x"))
                   & (bj == jax.lax.axis_index("y"))
                   & (bk == jax.lax.axis_index("z")))
            vals = f[Il[:, :, None, None], Jl[:, None, :, None],
                     Kl[:, None, None, :]]
            p = jnp.einsum("pijk,pijk->p", vals, w.astype(f.dtype))
            p = jnp.where(own, p, 0.0)
            return jax.lax.psum(p, sh.AXES)

        return probe

    def solve(self, state: timestepping.RKState, dt: float, num_steps: int,
              tf=None, probe=None):
        """Run num_steps RK4 steps; the whole scan executes inside one
        shard_map (one XLA program, collectives between devices).  Same
        API as the single-device models: returns (RKState, ys); `probe`
        (built by `probe_fn`) records per-step traces, replicated on every
        device."""
        key = ("solve", num_steps, tf is not None, probe)
        if key not in self._solve_cache:
            vec = P(*sh.AXES)
            clamp_tf = tf is not None

            def fn(ctx, u, v, ku, kv, t, dt_, tf_):
                # strip the leading (1,1,1) device-block axes (distributed
                # leaves only; replicated leaves arrive full)
                sq = lambda a: a.reshape(a.shape[3:])
                ctx = {"dist": jax.tree.map(sq, ctx["dist"]),
                       "repl": ctx["repl"]}
                s = timestepping.RKState(sq(u), sq(v), sq(ku), sq(kv), t)
                t0 = t

                def body(s, k):
                    tk = t0 + k.astype(t0.dtype) * dt_
                    if clamp_tf:
                        tk = jnp.minimum(tk, tf_)
                    s = s._replace(t=tk)
                    s = timestepping.rk4_step(
                        self._local_rhs, ctx, s, dt_,
                        tf_ if clamp_tf else None)
                    return s, (probe(s) if probe is not None else None)

                s, ys = jax.lax.scan(body, s, jnp.arange(num_steps))
                ex = lambda a: a.reshape((1, 1, 1) + a.shape)
                return (ex(s.u), ex(s.v), ex(s.ku), ex(s.kv), s.t), ys

            mapped = shard_map(
                fn, mesh=self.grid.mesh,
                in_specs=(self.ctx_spec, vec, vec, vec, vec, P(), P(), P()),
                out_specs=((vec, vec, vec, vec, P()), P()),
                check_vma=False)
            self._solve_cache[key] = jax.jit(
                lambda ctx, st, dt_, tf_: mapped(ctx, *st, dt_, tf_))
        dt_ = jnp.asarray(float(dt), self.dtype)
        tf_ = jnp.asarray(0.0 if tf is None else float(tf), self.dtype)
        (u, v, ku, kv, t), ys = self._solve_cache[key](
            self.ctx, tuple(state), dt_, tf_)
        return timestepping.RKState(u, v, ku, kv, t), ys

    def step(self, state: timestepping.RKState, dt, tf=None
             ) -> timestepping.RKState:
        s, _ = self.solve(state, dt, 1, tf=tf)
        return s

    def cfl_dt(self, cfl: float | None = None) -> tuple[float, int]:
        return self.model.cfl_dt(cfl)

    def collect(self, dist_field) -> np.ndarray:
        """Distributed node field -> global (gx, gy, gz) numpy array.
        Multi-process: gathers non-addressable shards over the process
        group first."""
        if not dist_field.is_fully_addressable:
            from jax.experimental import multihost_utils

            dist_field = multihost_utils.process_allgather(
                dist_field, tiled=True)
        full = sh.merge_node_field(np.asarray(dist_field), self.nc_pad,
                                   self.S, self.mesh.degree)
        gx, gy, gz = self.mesh.grid_shape
        return full[:gx, :gy, :gz]
