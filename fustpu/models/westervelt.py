"""Westervelt nonlinear wave equation (the reference's flagship physics,
cuda/demo_nonlinear_bowl.py / demo_nonlinear_box.py).

Coefficient recipes (cuda/demo_nonlinear_bowl.py:357-374):

    steady LHS    m0 = (1/(rho c^2)) u v dx + (delta/(rho c^3)) u v ds(abs)
    unsteady LHS  m  = m0 - (2 beta/(rho^2 c^4)) u_n u v dx     (per stage!)
    RHS b = -(1/rho) grad(u_n).grad(v) dx
            - (delta/(rho c^2)) grad(v_n).grad(v) dx
            + (2 beta/(rho^2 c^4)) v_n^2 v dx
            + (g(t)/rho) v ds(src) + (delta dg(t)/(rho c^2)) v ds(src)
            - (v_n/(rho c)) v ds(abs)
    dv/dt = b / m

Per RK stage (uniform media): ONE stiffness apply — the two stiffness
terms fuse into A(c3 u + c4 v) since the operator is linear and the
coefficients are scalars — plus elementwise multiplies
for every mass-type term (all globally diagonal under GLL collocation: the
unsteady LHS update, the v^2 term, both source vectors, and the absorbing
term).  The reference instead launches 2 stiffness + 4 mass kernels and 5
MPI scatters per stage (cuda/demo_nonlinear_bowl.py:529-654).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from fustpu.config import Material, Source
from fustpu.mesh.box import BoxMesh
from fustpu.models import sources
from fustpu.models.base import WaveModelBase
from fustpu.models.discretization import Discretization, resolve_stiffness_impl
from fustpu.ops import spectral_mm as mm


class WesterveltModel(WaveModelBase):
    DEFAULT_CFL = 0.4

    def __init__(
        self,
        mesh: BoxMesh,
        material: Material,
        source: Source,
        source_facets: np.ndarray,
        absorbing_facets: np.ndarray | None,
        dtype=jnp.float32,
        source_delays=None,
        source_apodization=None,
        stiffness_impl: str = "auto",
    ):
        """`source_delays` / `source_apodization`: optional per-node phased-
        aperture profiles (callable(points)->array or (nf, n^2) arrays) —
        the flat phased-array equivalent of the reference's curved H131
        bowl mesh (see fustpu.models.sources).  `stiffness_impl`: as in
        LinearWaveModel."""
        self.mesh = mesh
        self.material = material
        self.source = source
        self.dtype = dtype
        disc = Discretization(mesh, dtype)
        self.disc = disc

        cshape = mesh.nc if disc.structured else (mesh.num_cells,)
        c, rho, beta, _ = material.cell_fields(cshape)
        delta = np.broadcast_to(np.asarray(
            material.diffusivity_of_sound(source.angular_frequency),
            np.float64), cshape)
        self.delta = delta if np.ptp(delta) else float(delta.flat[0])
        self.uniform = material.is_uniform

        # cell coefficients (cuda/demo_nonlinear_bowl.py:357-362)
        nl = 2.0 * beta / (rho * rho * c**4)
        self.impl = resolve_stiffness_impl(stiffness_impl, disc)
        self.c3_scalar = self.c4_scalar = None
        self.c3_e = self.c4_e = self.c3_cells = self.c4_cells = None
        self.c3_x = self.c4_x = None
        if self.uniform:      # the one-apply fold coefficients, any path
            self.c3_scalar = dtype(-1.0 / float(rho.flat[0]))
            self.c4_scalar = dtype(-float(delta.flat[0])
                                   / float((rho * c * c).flat[0]))
        if self.impl == "extruded":
            from fustpu.ops import operators as ops

            self._stiff_op = disc.extruded_op
            if not self.uniform:
                nc_ = (mesh.num_cells,)
                self.c3_x = ops.expand_coeff_extruded(
                    mesh, np.broadcast_to(-1.0 / rho, nc_), dtype)
                self.c4_x = ops.expand_coeff_extruded(
                    mesh, np.broadcast_to(-delta / (rho * c * c), nc_),
                    dtype)
        elif self.impl == "indexed":
            self.c3_cells = jnp.asarray((-1.0 / rho).reshape(-1), dtype)
            self.c4_cells = jnp.asarray(
                (-delta / (rho * c * c)).reshape(-1), dtype)
            self._stiff_op = disc.indexed_op
        else:
            self._stiff_op = disc.mm_op
            if not self.uniform:
                n = mesh.degree + 1
                self.c3_e = jnp.asarray(mm.expand_cell_field(-1.0 / rho, n),
                                        dtype)
                self.c4_e = jnp.asarray(
                    mm.expand_cell_field(-delta / (rho * c * c), n), dtype)

        # unsteady mass diagonal: mass(u; -nl) = u * mvec2 (and the v^2 RHS
        # term uses +nl, i.e. exactly -mvec2).  All diagonal vectors are
        # stored FLAT, like the solver state.
        to_flat = lambda a: disc.to_grid(a).reshape(-1)
        self.mvec2 = to_flat(disc.mass_diag_host(-nl))

        # steady LHS m0 (+ absorbing-facet delta term), f64 host
        m0 = disc.mass_diag_host(1.0 / (rho * c * c))
        self.fvec_abs = None
        if absorbing_facets is not None and len(absorbing_facets) > 0:
            blk = disc.facet_block(absorbing_facets)
            self.abs_block = blk
            cells = blk.cells
            m0 = m0 + disc.facet_diag_host(
                blk, (delta / (rho * c**3)).reshape(-1)[cells])
            self.fvec_abs = to_flat(disc.facet_diag_host(
                blk, (-1.0 / (rho * c)).reshape(-1)[cells]))
        else:
            self.abs_block = None
        self.m0 = to_flat(m0)

        # source boundary: g/dg time-separable -> precomputed vectors (a
        # cos/sin pair each for phased apertures)
        self.src_block = disc.facet_block(source_facets)
        nfs = self.src_block.num_facets
        self.c_src = float(np.mean(c.reshape(-1)[self.src_block.cells])) \
            if nfs else float(np.max(c))
        apod, phi = sources.resolve_profiles(
            disc, self.src_block, source.angular_frequency,
            source_delays, source_apodization)
        scells = self.src_block.cells
        f1 = (1.0 / rho).reshape(-1)[scells]
        f2 = (delta / (rho * c * c)).reshape(-1)[scells]
        if phi is None:
            self.s1_cos = to_flat(disc.facet_diag_host(
                self.src_block, f1, apod))
            self.s2_cos = to_flat(disc.facet_diag_host(
                self.src_block, f2, apod))
            self.s1_sin = self.s2_sin = None
        else:
            cw = np.cos(phi) if apod is None else apod * np.cos(phi)
            sw = np.sin(phi) if apod is None else apod * np.sin(phi)
            self.s1_cos = to_flat(disc.facet_diag_host(
                self.src_block, f1, cw))
            self.s1_sin = to_flat(disc.facet_diag_host(
                self.src_block, f1, sw))
            self.s2_cos = to_flat(disc.facet_diag_host(
                self.src_block, f2, cw))
            self.s2_sin = to_flat(disc.facet_diag_host(
                self.src_block, f2, sw))
        self._solver_cache = {}

    # ------------------------------------------------------------------
    @property
    def params(self):
        """All device arrays, threaded explicitly through jit (never
        closure-captured — large constants wreck compile times)."""
        p = {"m0": self.m0, "mvec2": self.mvec2, "s1_cos": self.s1_cos,
             "s2_cos": self.s2_cos, "stiff": self._stiff_op}
        if self.c3_e is not None:
            p["c3_e"], p["c4_e"] = self.c3_e, self.c4_e
        if self.c3_cells is not None:
            p["c3_c"], p["c4_c"] = self.c3_cells, self.c4_cells
        if self.c3_x is not None:
            p["c3_x"], p["c4_x"] = self.c3_x, self.c4_x
        if self.s1_sin is not None:
            p["s1_sin"], p["s2_sin"] = self.s1_sin, self.s2_sin
        if self.fvec_abs is not None:
            p["fvec"] = self.fvec_abs
        return p

    def _rhs(self, params, t, u, v):
        from fustpu.ops import vector as vec

        # unsteady LHS: m = m0 + mass(u; -2 beta / rho^2 c^4) — diagonal
        m = params["m0"] + u * params["mvec2"]
        b = self._apply_stiffness(params, u, v)
        b = b - vec.square(v) * params["mvec2"]   # + nl * v^2 mass term
        (g_c, g_s), (dg_c, dg_s) = sources.westervelt_source_coeffs(
            t, self.source, self.c_src)
        dt_ = self.dtype
        b = b + g_c.astype(dt_) * params["s1_cos"]
        b = b + dg_c.astype(dt_) * params["s2_cos"]
        if "s1_sin" in params:
            b = b + g_s.astype(dt_) * params["s1_sin"]
            b = b + dg_s.astype(dt_) * params["s2_sin"]
        if "fvec" in params:
            b = b + v * params["fvec"]
        return vec.pointwise_divide(b, m)     # the diagonal solve

    def _apply_stiffness(self, params, u_flat, v_flat):
        nd = self.mesh.ndofs
        if self.uniform:
            # both stiffness terms in ONE apply (linearity, scalar coeffs)
            x = self.c3_scalar * u_flat + self.c4_scalar * v_flat
        if self.impl == "extruded":
            from fustpu.ops import operators as ops

            if self.uniform:
                return ops.stiffness_apply_extruded(x, params["stiff"], nd)
            # one factorized pass for both terms (coefficients commute
            # with the in-cell contractions in the expanded layout)
            return ops.stiffness_apply_extruded_pair(
                u_flat, v_flat, params["stiff"], nd,
                params["c3_x"], params["c4_x"])
        if self.impl == "indexed":
            from fustpu.ops import operators as ops

            G, dofmap, D = params["stiff"]
            if self.uniform:
                return ops.stiffness_apply_indexed(x, G, None, dofmap, D, nd)
            # heterogeneous: one pass sharing a single scatter
            return ops.stiffness_apply_indexed_pair(
                u_flat, params["c3_c"], v_flat, params["c4_c"],
                G, dofmap, D, nd)
        g = self.mesh.grid_shape
        if self.uniform:
            b = mm.stiffness_apply_mm(params["stiff"], x.reshape(g))
        else:
            # one contraction pass for both terms (coefficients commute
            # with the in-cell contractions in the expanded layout)
            b = mm.stiffness_apply_mm_pair(
                params["stiff"], u_flat.reshape(g), v_flat.reshape(g),
                params["c3_e"], params["c4_e"])
        return b.reshape(-1)
