"""Sharded (multi-chip) models for unstructured extruded meshes.

The reference partitions ANY mesh across ranks at read time (DOLFINx
GhostMode + IndexMap) and scatters ghost DOFs over MPI
(/root/reference/cuda/utils.py:8-78, cuda/scatterer.py:104-277).  The
equivalent here: cell STACKS of an ExtrudedHexMesh are partitioned by
recursive coordinate bisection of their 2D footprints; each device gets a
padded local row space (its stacks' 2D rows, z structured on the lanes);
rows cut by the partition live on every touching device and are summed
once per RK stage with a single psum over a compact shared-row buffer —
the interface fraction is small, so a replicated (S, gz) exchange buffer
beats a neighbour graph while staying partition-agnostic (any k, any
mesh).  As in fustpu.parallel.sharding, the exchange leaves shared rows
CONSISTENT on every owner, so all diagonal mass-type terms commute with
it: ONE collective per stage.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fustpu.models import sources, timestepping
from fustpu.models.westervelt import WesterveltModel
from fustpu.ops import operators as xops

try:  # jax >= 0.6 exports shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

AXIS = "d"


def rcb_partition(points: np.ndarray, k: int) -> np.ndarray:
    """Recursive coordinate bisection into k near-equal parts (any k):
    split along the widest axis at the proportional quantile."""
    points = np.asarray(points, np.float64)
    part = np.zeros(points.shape[0], np.int64)

    def rec(idx, k0, base):
        if k0 == 1:
            part[idx] = base
            return
        k1 = k0 // 2
        pts = points[idx]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, ax], kind="stable")
        cut = int(round(len(idx) * k1 / k0))
        rec(idx[order[:cut]], k1, base)
        rec(idx[order[cut:]], k0 - k1, base + k1)

    rec(np.arange(points.shape[0]), k, 0)
    return part


class ExtrudedShardedModel:
    """Distributes a built LinearWaveModel/WesterveltModel on an
    ExtrudedHexMesh over a 1D device mesh.  Same (RKState, ys) solve API
    as the single-device models and ShardedModel."""

    def __init__(self, model, num_devices: int | None = None, devices=None):
        from fustpu.mesh.extruded import ExtrudedHexMesh

        mesh = model.mesh
        if not isinstance(mesh, ExtrudedHexMesh):
            raise TypeError(
                "ExtrudedShardedModel needs an ExtrudedHexMesh; "
                "non-prismatic unstructured meshes are single-device "
                "(indexed path)")
        self.model = model
        self.mesh = mesh
        self.kind = ("westervelt" if isinstance(model, WesterveltModel)
                     else "linear")
        self.dtype = model.dtype
        devices = list(jax.devices() if devices is None else devices)
        k = num_devices or len(devices)
        self.k = k
        self.device_mesh = Mesh(np.asarray(devices[:k]), (AXIS,))

        n = mesh.degree + 1
        gz = mesh.gz
        self.gz = gz
        ns = mesh.nstacks
        disc = model.disc

        # ---- partition stacks by footprint centroid ----------------------
        tr = [d for d in range(3) if d != mesh.axis]   # transverse axes
        cent = mesh.vertices[mesh.cells[mesh.stack_cells[:, 0]]][
            :, :, tr].mean(axis=1)                     # (ns, 2)
        part = rcb_partition(cent, k)
        stacks_of = [np.nonzero(part == d)[0] for d in range(k)]
        if min(len(s) for s in stacks_of) == 0:
            raise ValueError(f"empty partition with {k} devices")
        smax = max(len(s) for s in stacks_of)

        # ---- per-device local rows + padded arrays ------------------------
        rows_g, rows2d_loc = [], []
        for d in range(k):
            sub = mesh.rows2d[stacks_of[d]]            # (sd, n^2)
            uniq, inv = np.unique(sub, return_inverse=True)
            rows_g.append(uniq)
            rows2d_loc.append(inv.reshape(sub.shape))
        nloc = max(len(r) for r in rows_g)
        self.nloc = nloc
        rowsg_pad = np.zeros((k, nloc), np.int64)
        rowmask = np.zeros((k, nloc), bool)
        loc_rows = np.zeros((k, smax, n * n), np.int32)
        for d in range(k):
            rowsg_pad[d, :len(rows_g[d])] = rows_g[d]
            rowmask[d, :len(rows_g[d])] = True
            loc_rows[d, :len(stacks_of[d])] = rows2d_loc[d]
        self.rowsg = rowsg_pad
        self.rowmask = rowmask

        # ---- shared rows -> exchange slots --------------------------------
        counts = np.zeros(mesh.n2d, np.int64)
        for r in rows_g:
            counts[r] += 1
        shared = np.nonzero(counts > 1)[0]
        S = len(shared)
        slot_of = np.full(mesh.n2d, -1, np.int64)
        slot_of[shared] = np.arange(S)
        shl = np.full((k, max(S, 1)), nloc, np.int32)  # nloc = pad row
        shm = np.zeros((k, max(S, 1)), bool)
        for d in range(k):
            sl = slot_of[rows_g[d]]
            own = np.nonzero(sl >= 0)[0]
            shl[d, sl[own]] = own
            shm[d, sl[own]] = True
        self.num_shared = S

        # ---- per-device geometry ------------------------------------------
        ez = mesh.nz * n

        G_host = disc._G_host                          # (cells, n^3, 6)
        G6 = np.zeros((k, 6, smax, n, n, ez))          # per-device blocks
        for d in range(k):
            sc = mesh.stack_cells[stacks_of[d]]        # (sd, nz)
            Gs = G_host[sc].reshape(len(sc), mesh.nz, n, n, n, 6)
            G6[d, :, :len(sc)] = Gs.transpose(
                5, 0, 2, 3, 1, 4).reshape(6, len(sc), n, n, ez)

        # ---- distributed context ------------------------------------------
        put = self._put
        dist = {
            "shl": put(shl, np.int32),
            "shm": put(shm[..., None].astype(self.dtype)),
        }
        eop = disc.extruded_op
        dist["G6"] = put(G6)
        dist["rows"] = put(loc_rows.reshape(k, -1), np.int32)
        repl = {"Wz": self._repl(eop.Wz), "Dz": self._repl(eop.Dz),
                "D": self._repl(eop.D)}

        def put_vec(a):
            # global flat diagonal -> per-device (nloc, gz) rows; pad rows
            # get 1 (safe divisor) for m-type, 0 otherwise via pad arg
            return put(self._local_rows(np.asarray(a), pad=0.0))

        def put_m(a):
            return put(self._local_rows(np.asarray(a), pad=1.0))

        m = model
        if self.kind == "linear":
            dist["m"] = put_m(m.m)
            dist["s_cos"] = put_vec(m.s_cos)
            if m.s_sin is not None:
                dist["s_sin"] = put_vec(m.s_sin)
        else:
            dist["m0"] = put_m(m.m0)
            dist["mvec2"] = put_vec(m.mvec2)
            dist["s1_cos"] = put_vec(m.s1_cos)
            dist["s2_cos"] = put_vec(m.s2_cos)
            if m.s1_sin is not None:
                dist["s1_sin"] = put_vec(m.s1_sin)
                dist["s2_sin"] = put_vec(m.s2_sin)
        if m.fvec_abs is not None:
            dist["fvec"] = put_vec(m.fvec_abs)
        self.has_abs = m.fvec_abs is not None

        def put_coeff(cx):
            # (ns, 1, 1, ez) per-stack coefficient -> per-device slices
            c = np.asarray(cx)
            out = np.zeros((k, smax, 1, 1, ez))
            for d in range(k):
                out[d, :len(stacks_of[d])] = c[stacks_of[d]]
            return put(out)

        cx = getattr(m, "c2_x" if self.kind == "linear" else "c3_x", None)
        if cx is not None:
            dist["c2_x" if self.kind == "linear" else "c3_x"] = put_coeff(cx)
        if self.kind == "westervelt" and m.c4_x is not None:
            dist["c4_x"] = put_coeff(m.c4_x)

        # multiplicity weights for traced reductions (shared rows live on
        # every owner; weight them down so sums count once)
        dist["rw"] = put(self._mult_weights()[..., None])
        self.ctx = {"dist": dist, "repl": repl}
        self.ctx_spec = {
            "dist": {key: P(AXIS) for key in dist},
            "repl": jax.tree.map(lambda _: P(), repl),
        }
        self._solve_cache = {}

    # ---------------- host-side data movement ------------------------------
    def _put(self, stacked, dtype=None):
        sharding = NamedSharding(self.device_mesh, P(AXIS))
        arr = np.asarray(stacked, jnp.dtype(dtype or self.dtype))
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])

    def _repl(self, arr):
        sharding = NamedSharding(self.device_mesh, P())
        arr = np.asarray(arr)
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])

    def _local_rows(self, flat: np.ndarray, pad: float) -> np.ndarray:
        """Global flat field -> (k, nloc, gz) per-device row blocks."""
        f2 = flat.reshape(self.mesh.n2d, self.gz)
        out = np.full((self.k, self.nloc, self.gz), pad, f2.dtype)
        out[self.rowmask] = f2[self.rowsg[self.rowmask]]
        return out

    # ---------------- in-shard physics --------------------------------------
    def _exchange(self, ctx, y2):
        """Sum shared rows across owners; afterwards every owner holds the
        full sum (consistent) — the reference's scatter_rev+fwd round trip
        in ONE psum (cuda/demo_nonlinear_bowl.py:604-615,640)."""
        if self.num_shared == 0:
            return y2
        d = ctx["dist"]
        shl, shm = d["shl"], d["shm"]
        ye = jnp.concatenate(
            [y2, jnp.zeros((1, y2.shape[1]), y2.dtype)], axis=0)
        contrib = ye[shl] * shm                        # (S, gz)
        tot = jax.lax.psum(contrib, AXIS)
        ye = ye.at[shl].set(jnp.where(shm > 0, tot, ye[shl]))
        return ye[:-1]

    def _local_op(self, ctx):
        return xops.ExtrudedStiffness(
            rows=ctx["dist"]["rows"], G6=ctx["dist"]["G6"],
            Wz=ctx["repl"]["Wz"], Dz=ctx["repl"]["Dz"], D=ctx["repl"]["D"])

    def _local_stiffness(self, ctx, x_flat, coeff_e=None):
        return xops.stiffness_apply_extruded(
            x_flat, self._local_op(ctx), self.nloc * self.gz,
            coeff_e=coeff_e)

    def _local_pair_stiffness(self, ctx, u_flat, v_flat):
        d = ctx["dist"]
        return xops.stiffness_apply_extruded_pair(
            u_flat, v_flat, self._local_op(ctx), self.nloc * self.gz,
            d["c3_x"], d["c4_x"])

    def _local_rhs(self, ctx, t, u2, v2):
        """u2, v2: (nloc, gz) device-local row blocks (consistent)."""
        d = ctx["dist"]
        m = self.model
        flat = lambda a: a.reshape(-1)
        shp = (self.nloc, self.gz)
        if self.kind == "linear":
            if m.uniform:
                b = m.c2_scalar * self._local_stiffness(ctx, flat(u2))
            else:
                b = self._local_stiffness(ctx, flat(u2),
                                          coeff_e=d.get("c2_x"))
            b = self._exchange(ctx, b.reshape(shp))
            a_c, a_s = sources.linear_source_coeffs(t, m.source, m.c_src)
            b = b + a_c.astype(self.dtype) * d["s_cos"]
            if "s_sin" in d:
                b = b + a_s.astype(self.dtype) * d["s_sin"]
            if self.has_abs:
                b = b + v2 * d["fvec"]
            return b / d["m"]

        mm_ = d["m0"] + u2 * d["mvec2"]
        if m.uniform:
            x = m.c3_scalar * u2 + m.c4_scalar * v2
            b = self._local_stiffness(ctx, flat(x))
        else:
            b = self._local_pair_stiffness(ctx, flat(u2), flat(v2))
        b = self._exchange(ctx, b.reshape(shp))
        b = b - (v2 * v2) * d["mvec2"]
        (g_c, g_s), (dg_c, dg_s) = sources.westervelt_source_coeffs(
            t, m.source, m.c_src)
        b = b + g_c.astype(self.dtype) * d["s1_cos"]
        b = b + dg_c.astype(self.dtype) * d["s2_cos"]
        if "s1_sin" in d:
            b = b + g_s.astype(self.dtype) * d["s1_sin"]
            b = b + dg_s.astype(self.dtype) * d["s2_sin"]
        if self.has_abs:
            b = b + v2 * d["fvec"]
        return b / mm_

    # ---------------- distributed reductions ------------------------------
    def _mult_weights(self) -> np.ndarray:
        """(k, nloc) 1/multiplicity weights (0 on pad entries): shared
        rows/DOFs are stored on every owner, so global reductions weight
        them down — the unstructured analogue of
        sharding.ownership_weights."""
        ids, mask = self._ids_mask()
        counts = np.zeros(int(ids.max()) + 1, np.int64)
        for d in range(self.k):
            counts[ids[d][mask[d]]] += 1
        w = np.zeros(ids.shape)
        w[mask] = 1.0 / counts[ids[mask]]
        return w

    def _ids_mask(self):
        return self.rowsg, self.rowmask

    def global_dot(self, x, y) -> float:
        """Distributed dot product of device-sharded fields: a TRACED
        shard_map psum over the multiplicity-weighted local blocks (the
        role of the reference's MPI Allreduce norm checks) — works on
        multi-process arrays too, no host gather."""
        if "gdot" not in self._solve_cache:
            vec = P(AXIS)

            def fn(w, a, b):
                wl = w.reshape(w.shape[1:])
                al = a.reshape(a.shape[1:])
                bl = b.reshape(b.shape[1:])
                wl = wl.reshape(wl.shape + (1,) * (al.ndim - wl.ndim))
                return jax.lax.psum(jnp.sum(al * bl * wl), AXIS)

            self._solve_cache["gdot"] = jax.jit(shard_map(
                fn, mesh=self.device_mesh, in_specs=(vec, vec, vec),
                out_specs=P(), check_vma=False))
        return float(self._solve_cache["gdot"](
            self.ctx["dist"]["rw"], x, y))

    def global_norm(self, x) -> float:
        return float(np.sqrt(self.global_dot(x, x)))

    def norm_probe(self):
        """A per-step probe recording the weighted global l2 norm of u
        INSIDE the jitted scan (in-run energy diagnostics at scale).
        Pass to solve(..., probe=...)."""

        def probe(ctx, u2):
            w = ctx["dist"]["rw"]
            w = w.reshape(w.shape + (1,) * (u2.ndim - w.ndim))
            return jnp.sqrt(jax.lax.psum(jnp.sum(u2 * u2 * w), AXIS))

        probe.needs_ctx = True
        return probe

    # ---------------- public API ---------------------------------------------
    def init_state(self, t0: float = 0.0, u0=None, v0=None
                   ) -> timestepping.RKState:
        z = np.zeros(self.mesh.ndofs)

        def dist_field(f):
            f = z if f is None else np.asarray(f).reshape(-1)
            return self._put(self._local_rows(f, pad=0.0))

        t = self._repl(np.asarray(t0, jnp.dtype(self.dtype)))
        return timestepping.RKState(
            u=dist_field(u0), v=dist_field(v0), ku=dist_field(None),
            kv=dist_field(None), t=t)

    def probe_fn(self, points):
        """Traced per-step sampler (UPointSampler semantics): each point
        lives in one cell, hence on >=1 device; exactly one owner
        contributes (the lowest device id owning the cell's stack)."""
        from fustpu.mesh.unstructured import UPointSampler

        smp = UPointSampler(self.mesh, points)
        gdofs = smp._dofs                              # (npts, n^3) global
        grows, gzidx = gdofs // self.gz, gdofs % self.gz
        npts = gdofs.shape[0]
        # global row -> local row per device (or -1)
        g2l = np.full((self.k, self.mesh.n2d), -1, np.int64)
        for d in range(self.k):
            g2l[d, self.rowsg[d][self.rowmask[d]]] = np.nonzero(
                self.rowmask[d])[0]
        owner = np.full(npts, -1, np.int64)
        ldofs = np.zeros((self.k, npts, gdofs.shape[1]), np.int32)
        for d in range(self.k):
            lr = g2l[d, grows]                         # (npts, n^3)
            ok = (lr >= 0).all(axis=1)
            newly = ok & (owner < 0)
            owner[newly] = d
            ldofs[d][ok] = (lr[ok] * self.gz + gzidx[ok]).astype(np.int32)
        if (owner < 0).any():
            raise ValueError("probe point spans no single device")
        own_d = jnp.asarray(owner)
        ld = jnp.asarray(ldofs)
        w = jnp.asarray(smp._w)

        def probe(u2):
            f = u2.reshape(-1)
            mine = jax.lax.axis_index(AXIS)
            vals = jnp.einsum("pq,pq->p", f[ld[mine]], w.astype(f.dtype))
            vals = jnp.where(own_d == mine, vals, 0.0)
            return jax.lax.psum(vals, AXIS)

        return probe

    def solver_fn(self, num_steps: int, clamp_tf: bool = False,
                  probe=None):
        """The jitted sharded solver `fn(ctx, state_tuple, dt, tf)` for
        `num_steps` scan steps, WITHOUT executing it (lowerable against
        ShapeDtypeStruct avals for a compile-only memory check)."""
        key = ("solve", num_steps, clamp_tf, probe)
        if key not in self._solve_cache:
            vec = P(AXIS)

            def fn(ctx, u, v, ku, kv, t, dt_, tf_):
                sq = lambda a: a.reshape(a.shape[1:])
                ctx = {"dist": jax.tree.map(sq, ctx["dist"]),
                       "repl": ctx["repl"]}
                s = timestepping.RKState(sq(u), sq(v), sq(ku), sq(kv), t)
                t0 = t

                def body(s, kk):
                    tk = t0 + kk.astype(t0.dtype) * dt_
                    if clamp_tf:
                        tk = jnp.minimum(tk, tf_)
                    s = s._replace(t=tk)
                    s = timestepping.rk4_step(
                        self._local_rhs, ctx, s, dt_,
                        tf_ if clamp_tf else None)
                    if probe is None:
                        ys = None
                    elif getattr(probe, "needs_ctx", False):
                        ys = probe(ctx, s.u)   # e.g. norm_probe
                    else:
                        ys = probe(s.u)
                    return s, ys

                s, ys = jax.lax.scan(body, s, jnp.arange(num_steps))
                ex = lambda a: a.reshape((1,) + a.shape)
                return (ex(s.u), ex(s.v), ex(s.ku), ex(s.kv), s.t), ys

            mapped = shard_map(
                fn, mesh=self.device_mesh,
                in_specs=(self.ctx_spec, vec, vec, vec, vec, P(), P(), P()),
                out_specs=((vec, vec, vec, vec, P()), P()),
                check_vma=False)
            self._solve_cache[key] = jax.jit(
                lambda ctx, st, dt_, tf_: mapped(ctx, *st, dt_, tf_))
        return self._solve_cache[key]

    def solve(self, state: timestepping.RKState, dt: float, num_steps: int,
              tf=None, probe=None):
        fn = self.solver_fn(num_steps, clamp_tf=tf is not None,
                            probe=probe)
        dt_ = jnp.asarray(float(dt), self.dtype)
        tf_ = jnp.asarray(0.0 if tf is None else float(tf), self.dtype)
        (u, v, ku, kv, t), ys = fn(self.ctx, tuple(state), dt_, tf_)
        return timestepping.RKState(u, v, ku, kv, t), ys

    def step(self, state, dt, tf=None):
        s, _ = self.solve(state, dt, 1, tf=tf)
        return s

    def cfl_dt(self, cfl: float | None = None):
        return self.model.cfl_dt(cfl)

    def collect(self, dist_field) -> np.ndarray:
        """Distributed (k, nloc, gz) field -> global flat numpy array
        (shared rows are consistent; any owner's copy is the value)."""
        if not dist_field.is_fully_addressable:
            from jax.experimental import multihost_utils

            dist_field = multihost_utils.process_allgather(
                dist_field, tiled=True)
        arr = np.asarray(dist_field)
        out = np.zeros((self.mesh.n2d, self.gz), arr.dtype)
        for d in range(self.k):
            out[self.rowsg[d][self.rowmask[d]]] = arr[d][self.rowmask[d]]
        return out.reshape(-1)


class IndexedShardedModel:
    """Sharded model for GENERAL (non-prismatic) unstructured meshes:
    RCB cell partition, per-device local dofmaps over padded local DOF
    spaces, and one shared-DOF psum per RK stage.  The per-device apply
    is the explicit-dofmap indexed path — slower per DOF than the
    factorized extruded path (use `shard_unstructured` to pick), but it
    distributes ANY conforming hex mesh over any device count, like the
    reference's read-time partition + IndexMap scatterers
    (/root/reference/cuda/utils.py:8-78)."""

    def __init__(self, model, num_devices: int | None = None, devices=None):
        from fustpu.mesh.unstructured import UnstructuredHexMesh

        mesh = model.mesh
        if not isinstance(mesh, UnstructuredHexMesh):
            raise TypeError("IndexedShardedModel needs an unstructured "
                            "mesh (use ShardedModel for box meshes)")
        self.model = model
        self.mesh = mesh
        self.kind = ("westervelt" if isinstance(model, WesterveltModel)
                     else "linear")
        self.dtype = model.dtype
        devices = list(jax.devices() if devices is None else devices)
        k = num_devices or len(devices)
        self.k = k
        self.device_mesh = Mesh(np.asarray(devices[:k]), (AXIS,))

        cent = mesh.cell_corners_flat.mean(axis=1)     # (ncells, 3)
        part = rcb_partition(cent, k)
        cells_of = [np.nonzero(part == d)[0] for d in range(k)]
        if min(len(c) for c in cells_of) == 0:
            raise ValueError(f"empty partition with {k} devices")
        cmax = max(len(c) for c in cells_of)

        dofmap = mesh.dofmap                            # (ncells, n^3)
        nd = dofmap.shape[1]
        gids, ldm = [], np.zeros((k, cmax, nd), np.int32)
        for d in range(k):
            sub = dofmap[cells_of[d]]
            uniq, inv = np.unique(sub, return_inverse=True)
            gids.append(uniq)
            ldm[d, :len(cells_of[d])] = inv.reshape(sub.shape)
        nloc = max(len(g) for g in gids)
        self.nloc = nloc
        gids_pad = np.zeros((k, nloc), np.int64)
        gmask = np.zeros((k, nloc), bool)
        for d in range(k):
            gids_pad[d, :len(gids[d])] = gids[d]
            gmask[d, :len(gids[d])] = True
        self.gids = gids_pad
        self.gmask = gmask

        counts = np.zeros(mesh.ndofs, np.int64)
        for g in gids:
            counts[g] += 1
        shared = np.nonzero(counts > 1)[0]
        S = len(shared)
        slot_of = np.full(mesh.ndofs, -1, np.int64)
        slot_of[shared] = np.arange(S)
        shl = np.full((k, max(S, 1)), nloc, np.int32)
        shm = np.zeros((k, max(S, 1)), bool)
        for d in range(k):
            sl = slot_of[gids[d]]
            own = np.nonzero(sl >= 0)[0]
            shl[d, sl[own]] = own
            shm[d, sl[own]] = True
        self.num_shared = S

        disc = model.disc
        G_host = disc._G_host
        # component-major per-device blocks (operators
        # .stiffness_apply_indexed layout)
        Gd = np.zeros((k, 6, cmax, nd))
        for d in range(k):
            Gd[d, :, :len(cells_of[d])] = np.moveaxis(
                G_host[cells_of[d]], 2, 0)

        def cellvec(c):
            out = np.zeros((k, cmax))
            c = np.asarray(c).reshape(-1)
            for d in range(k):
                out[d, :len(cells_of[d])] = c[cells_of[d]]
            return out

        def locvec(v, pad):
            v = np.asarray(v).reshape(-1)
            out = np.full((k, nloc), pad, np.float64)
            out[gmask] = v[gids_pad[gmask]]
            return out

        put = self._put
        dist = {
            "shl": put(shl, np.int32),
            "shm": put(shm.astype(self.dtype)),
        }
        repl = {"D": self._repl(np.asarray(disc._D_host))}
        m = model
        if self.kind == "linear":
            dist["m"] = put(locvec(m.m, 1.0))
            dist["s_cos"] = put(locvec(m.s_cos, 0.0))
            if m.s_sin is not None:
                dist["s_sin"] = put(locvec(m.s_sin, 0.0))
            dist["c2"] = put(cellvec(np.asarray(m.c2_cells)))
        else:
            dist["m0"] = put(locvec(m.m0, 1.0))
            dist["mvec2"] = put(locvec(m.mvec2, 0.0))
            dist["s1_cos"] = put(locvec(m.s1_cos, 0.0))
            dist["s2_cos"] = put(locvec(m.s2_cos, 0.0))
            if m.s1_sin is not None:
                dist["s1_sin"] = put(locvec(m.s1_sin, 0.0))
                dist["s2_sin"] = put(locvec(m.s2_sin, 0.0))
            dist["c3"] = put(cellvec(np.asarray(m.c3_cells)))
            dist["c4"] = put(cellvec(np.asarray(m.c4_cells)))
            if m.uniform:
                # uniform fold: ONE stiffness apply per stage on the
                # combined field; 1 on real cells, 0 on padding (padded
                # ldm rows alias dof 0 — the coefficient must kill them)
                dist["cpad"] = put(cellvec(np.ones(mesh.num_cells)))
        if m.fvec_abs is not None:
            dist["fvec"] = put(locvec(m.fvec_abs, 0.0))
        self.has_abs = m.fvec_abs is not None
        dist["rw"] = put(self._mult_weights())

        dist["G"] = put(Gd)
        dist["ldm"] = put(ldm.reshape(k, -1), np.int32)
        self.ctx = {"dist": dist, "repl": repl}
        self.ctx_spec = {
            "dist": {key: P(AXIS) for key in dist},
            "repl": jax.tree.map(lambda _: P(), repl),
        }
        self._solve_cache = {}

    _put = ExtrudedShardedModel._put
    _repl = ExtrudedShardedModel._repl
    solver_fn = ExtrudedShardedModel.solver_fn
    solve = ExtrudedShardedModel.solve
    step = ExtrudedShardedModel.step
    cfl_dt = ExtrudedShardedModel.cfl_dt
    _mult_weights = ExtrudedShardedModel._mult_weights
    global_dot = ExtrudedShardedModel.global_dot
    global_norm = ExtrudedShardedModel.global_norm
    norm_probe = ExtrudedShardedModel.norm_probe

    def _ids_mask(self):
        return self.gids, self.gmask

    def _local_rows(self, flat: np.ndarray, pad: float) -> np.ndarray:
        """Global flat field -> (k, nloc) per-device DOF blocks (the
        ExtrudedShardedModel init_state/collect contract, scalar DOFs)."""
        f = np.asarray(flat).reshape(-1)
        out = np.full((self.k, self.nloc), pad, f.dtype)
        out[self.gmask] = f[self.gids[self.gmask]]
        return out

    init_state = ExtrudedShardedModel.init_state

    def _exchange(self, ctx, y):
        if self.num_shared == 0:
            return y
        d = ctx["dist"]
        shl, shm = d["shl"], d["shm"]
        ye = jnp.concatenate([y, jnp.zeros((1,), y.dtype)])
        contrib = ye[shl] * shm
        tot = jax.lax.psum(contrib, AXIS)
        ye = ye.at[shl].set(jnp.where(shm > 0, tot, ye[shl]))
        return ye[:-1]

    def _local_rhs(self, ctx, t, u, v):
        d = ctx["dist"]
        m = self.model
        n3 = self.mesh.element.ndofs
        ldm = d["ldm"].reshape(-1, n3)
        D = ctx["repl"]["D"]
        stiff = lambda x, c: xops.stiffness_apply_indexed(
            x, d["G"], c, ldm, D, self.nloc)
        stiff_pair = lambda x1, c1, x2, c2: \
            xops.stiffness_apply_indexed_pair(
                x1, c1, x2, c2, d["G"], ldm, D, self.nloc)
        if self.kind == "linear":
            b = self._exchange(ctx, stiff(u, d["c2"]))
            a_c, a_s = sources.linear_source_coeffs(t, m.source, m.c_src)
            b = b + a_c.astype(self.dtype) * d["s_cos"]
            if "s_sin" in d:
                b = b + a_s.astype(self.dtype) * d["s_sin"]
            if self.has_abs:
                b = b + v * d["fvec"]
            return b / d["m"]
        mm_ = d["m0"] + u * d["mvec2"]
        if m.uniform:
            x = m.c3_scalar * u + m.c4_scalar * v
            b = self._exchange(ctx, stiff(x, d["cpad"]))
        else:
            b = self._exchange(ctx,
                               stiff_pair(u, d["c3"], v, d["c4"]))
        b = b - (v * v) * d["mvec2"]
        (g_c, g_s), (dg_c, dg_s) = sources.westervelt_source_coeffs(
            t, m.source, m.c_src)
        b = b + g_c.astype(self.dtype) * d["s1_cos"]
        b = b + dg_c.astype(self.dtype) * d["s2_cos"]
        if "s1_sin" in d:
            b = b + g_s.astype(self.dtype) * d["s1_sin"]
            b = b + dg_s.astype(self.dtype) * d["s2_sin"]
        if self.has_abs:
            b = b + v * d["fvec"]
        return b / mm_

    def probe_fn(self, points):
        """Traced per-step sampler: the lowest device owning ALL of a
        point's cell DOFs contributes; psum replicates the trace."""
        from fustpu.mesh.unstructured import UPointSampler

        smp = UPointSampler(self.mesh, points)
        gdofs = smp._dofs                              # (npts, n^3) global
        npts = gdofs.shape[0]
        g2l = np.full((self.k, self.mesh.ndofs), -1, np.int64)
        for d in range(self.k):
            g2l[d, self.gids[d][self.gmask[d]]] = np.nonzero(
                self.gmask[d])[0]
        owner = np.full(npts, -1, np.int64)
        ldofs = np.zeros((self.k, npts, gdofs.shape[1]), np.int32)
        for d in range(self.k):
            ld = g2l[d, gdofs]
            ok = (ld >= 0).all(axis=1)
            newly = ok & (owner < 0)
            owner[newly] = d
            ldofs[d][ok] = ld[ok].astype(np.int32)
        if (owner < 0).any():
            raise ValueError("probe point spans no single device")
        own_d = jnp.asarray(owner)
        ld = jnp.asarray(ldofs)
        w = jnp.asarray(smp._w)

        def probe(u_loc):
            mine = jax.lax.axis_index(AXIS)
            vals = jnp.einsum("pq,pq->p", u_loc[ld[mine]],
                              w.astype(u_loc.dtype))
            vals = jnp.where(own_d == mine, vals, 0.0)
            return jax.lax.psum(vals, AXIS)

        return probe

    def collect(self, dist_field) -> np.ndarray:
        if not dist_field.is_fully_addressable:
            from jax.experimental import multihost_utils

            dist_field = multihost_utils.process_allgather(
                dist_field, tiled=True)
        arr = np.asarray(dist_field)
        out = np.zeros(self.mesh.ndofs, arr.dtype)
        for d in range(self.k):
            out[self.gids[d][self.gmask[d]]] = arr[d][self.gmask[d]]
        return out


def shard_unstructured(model, num_devices: int | None = None, devices=None):
    """Distribute a model on ANY unstructured mesh: the factorized
    extruded sharding for prismatic meshes, the generic indexed sharding
    otherwise."""
    from fustpu.mesh.extruded import ExtrudedHexMesh

    if isinstance(model.mesh, ExtrudedHexMesh):
        return ExtrudedShardedModel(model, num_devices=num_devices,
                                    devices=devices)
    return IndexedShardedModel(model, num_devices=num_devices,
                               devices=devices)
