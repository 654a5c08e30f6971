"""Matrix-free spectral operators: mass, sum-factorised stiffness, facet mass.

Array-level re-design of /root/reference/cuda/operators.py:
- the CUDA mass kernel (one thread per (entity, dof) + atomic add,
  operators.py:18-70) becomes a batched elementwise multiply + separable
  overlap-add (structured path) or an XLA scatter-add (indexed path);
- the CUDA stiffness kernel (one block per cell, shared-memory contractions,
  operators.py:73-192) becomes six batched tensor contractions over the
  whole cell batch at once, with the geometric transform fused elementwise
  in between.

Both a structured fast path (node-grid layout, zero index arrays) and a
generic indexed path (explicit dofmap) are provided; they agree to roundoff
and the indexed path doubles as a cross-check in tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fustpu.ops.gather_scatter import (
    fold2d,
    fold3d,
    gather_dofs,
    scatter_add_dofs,
    windows2d,
    windows3d,
)

# Every contraction runs at HIGHEST: full float32 (float64 under x64).  On
# Hopper that keeps f32 dots off TF32, whose 10-bit mantissa would put
# ~1e-3 relative error into the apply.
_PRECISION = jax.lax.Precision.HIGHEST


def _bc(coeff: jax.Array) -> jax.Array:
    """(ncx, ncy, ncz) cell coefficients -> broadcastable to the expanded
    (ncx, n, ncy, n, ncz, n) layout."""
    return coeff[:, None, :, None, :, None]


# ---------------------------------------------------------------------------
# Structured path: x lives on the (gx, gy, gz) node grid; detJ/G live in the
# expanded (ncx, n, ncy, n, ncz, n[, 6]) layout (precompute.to_structured_layout).
# ---------------------------------------------------------------------------

def mass_apply(x: jax.Array, detJ: jax.Array, coeff: jax.Array,
               P: int) -> jax.Array:
    """y_grid = A_mass(x_grid): gather -> x * detJ * coeff -> overlap-add.

    Same math as reference cuda/operators.py:55-70 (diagonal per-cell mass
    thanks to GLL collocation), batched over all cells.
    """
    u = windows3d(x, P)
    return fold3d(u * detJ * _bc(coeff), P)


def stiffness_apply(x: jax.Array, G: jax.Array, coeff: jax.Array,
                    D: jax.Array, P: int) -> jax.Array:
    """y_grid = A_stiff(x_grid), sum-factorised.

    Forward contractions with D[q, i], geometric transform with the
    symmetric 6-component G, reverse contractions with D[q, i] transposed —
    the batched analogue of reference cuda/operators.py:139-190.
    """
    u = windows3d(x, P)                                  # (a,i,b,j,c,k)
    wx = jnp.einsum("qi,aibjck->aqbjck", D, u, precision=_PRECISION)
    wy = jnp.einsum("qj,aibjck->aibqck", D, u, precision=_PRECISION)
    wz = jnp.einsum("qk,aibjck->aibjcq", D, u, precision=_PRECISION)
    c = _bc(coeff)
    f0 = c * (G[..., 0] * wx + G[..., 1] * wy + G[..., 2] * wz)
    f1 = c * (G[..., 1] * wx + G[..., 3] * wy + G[..., 4] * wz)
    f2 = c * (G[..., 2] * wx + G[..., 4] * wy + G[..., 5] * wz)
    y = jnp.einsum("qi,aqbjck->aibjck", D, f0, precision=_PRECISION)
    y = y + jnp.einsum("qj,aibqck->aibjck", D, f1, precision=_PRECISION)
    y = y + jnp.einsum("qk,aibjcq->aibjck", D, f2, precision=_PRECISION)
    return fold3d(y, P)


def plane_facet_mass_apply(x_plane: jax.Array, detJ_f: jax.Array,
                           coeff: jax.Array, P: int) -> jax.Array:
    """Facet mass over a full boundary plane of a structured box.

    x_plane: (gs, gt) restriction of the node grid to the plane;
    detJ_f:  (ncs, n, nct, n) expanded facet factors; coeff: (ncs, nct).
    Returns the (gs, gt) plane contribution (add it into y at the plane).
    """
    u = windows2d(x_plane, P)
    return fold2d(u * detJ_f * coeff[:, None, :, None], P)


# ---------------------------------------------------------------------------
# Indexed (generic) path: explicit dofmaps, flat DOF vectors.  Used for
# arbitrary facet patches (source apertures) and as the test cross-check.
# ---------------------------------------------------------------------------

def mass_apply_indexed(x_flat: jax.Array, detJ: jax.Array, coeff: jax.Array,
                       dofmap: jax.Array, ndofs: int) -> jax.Array:
    """detJ: (entities, nd); coeff: (entities,); dofmap: (entities, nd).
    Works for cell mass (nd = n^3) and facet mass (nd = n^2) alike, exactly
    like the single reference mass kernel used for both."""
    vals = gather_dofs(x_flat, dofmap) * detJ * coeff[:, None]
    return scatter_add_dofs(vals, dofmap, ndofs)


# ---------------------------------------------------------------------------
# Extruded path: prismatic-topology meshes (fustpu.mesh.extruded).  The
# dofmap factorizes as dof = row2d*gz + zidx, so the gather/scatter are
# vectorized ROW operations with the structured z axis contiguous; the
# per-element indexed path below covers every other unstructured mesh.
# ---------------------------------------------------------------------------

from typing import NamedTuple


class ExtrudedStiffness(NamedTuple):
    """Device arrays for the factorized stiffness apply."""

    rows: jax.Array    # (ns * n^2,) int32 flattened 2D row gather indices
    G6: jax.Array      # (6, ns, n, n, ez) metric, z-expanded per stack
    Wz: jax.Array      # (ez, gz) 0/1 z window
    Dz: jax.Array      # (ez, ez) block-diagonal 1D derivative along z
    D: jax.Array       # (n, n) 1D derivative for the footprint axes


def build_extruded_stiffness(mesh, G_cells, D_1d, dtype) -> ExtrudedStiffness:
    """mesh: ExtrudedHexMesh; G_cells: (cells, n^3, 6) float64 host."""
    import numpy as np

    from fustpu.ops import spectral_mm as mm

    n = mesh.degree + 1
    ns, nz = mesh.nstacks, mesh.nz
    Gs = np.asarray(G_cells)[mesh.stack_cells]        # (ns, nz, n^3, 6)
    Gs = Gs.reshape(ns, nz, n, n, n, 6)
    G6 = np.ascontiguousarray(Gs.transpose(5, 0, 2, 3, 1, 4)
                              ).reshape(6, ns, n, n, nz * n)
    return ExtrudedStiffness(
        rows=jnp.asarray(mesh.rows2d.reshape(-1)),
        G6=jnp.asarray(G6, dtype),
        Wz=jnp.asarray(mm.window_matrix(nz, mesh.degree), dtype),
        Dz=jnp.asarray(mm.deriv_block_matrix(nz, D_1d), dtype),
        D=jnp.asarray(D_1d, dtype),
    )


def expand_coeff_extruded(mesh, coeff, dtype) -> jax.Array:
    """(cells,) per-cell coefficient -> (ns, 1, 1, ez) broadcastable over
    the extruded quadrature layout."""
    import numpy as np

    n = mesh.degree + 1
    c = np.asarray(coeff, np.float64).reshape(-1)[mesh.stack_cells]
    return jnp.asarray(np.repeat(c, n, axis=1)[:, None, None, :], dtype)


def _einsum(sub, A, x):
    return jnp.einsum(sub, A, x, precision=_PRECISION)


def stiffness_apply_extruded(x_flat: jax.Array, op: ExtrudedStiffness,
                             ndofs: int,
                             coeff_e: jax.Array | None = None) -> jax.Array:
    """y_flat = A_stiff(x_flat) on a factorized (n2d, gz) DOF layout.
    `coeff_e`: optional (ns, 1, 1, ez) per-cell coefficient
    (expand_coeff_extruded)."""
    gz = op.Wz.shape[1]
    _, ns, n, _, ez = op.G6.shape
    x2 = x_flat.reshape(-1, gz)
    g = x2[op.rows]                                   # (ns*n^2, gz) rows
    u = _einsum("ez,qz->qe", op.Wz, g).reshape(ns, n, n, ez)
    wx = _einsum("ai,qije->qaje", op.D, u)
    wy = _einsum("bj,qije->qibe", op.D, u)
    wz = _einsum("fe,qije->qijf", op.Dz, u)
    G = op.G6
    f0 = G[0] * wx + G[1] * wy + G[2] * wz
    f1 = G[1] * wx + G[3] * wy + G[4] * wz
    f2 = G[2] * wx + G[4] * wy + G[5] * wz
    if coeff_e is not None:
        f0, f1, f2 = f0 * coeff_e, f1 * coeff_e, f2 * coeff_e
    r = _einsum("ai,qaje->qije", op.D, f0)
    r = r + _einsum("bj,qibe->qije", op.D, f1)
    r = r + _einsum("fe,qijf->qije", op.Dz, f2)
    vals = _einsum("ez,qije->qijz", op.Wz, r).reshape(ns * n * n, gz)
    y2 = jnp.zeros((ndofs // gz, gz), x_flat.dtype)
    y2 = y2.at[op.rows].add(vals, mode="promise_in_bounds")
    return y2.reshape(-1)


def stiffness_apply_extruded_pair(x1: jax.Array, x2: jax.Array,
                                  op: ExtrudedStiffness, ndofs: int,
                                  c1_e: jax.Array, c2_e: jax.Array
                                  ) -> jax.Array:
    """y = A_c1(x1) + A_c2(x2) in one factorized pass: per-cell
    coefficients commute with the within-cell contractions once the
    fields are in the gathered/expanded layout, so the two fields
    combine right after the z-window (the heterogeneous Westervelt
    stage; see stiffness_apply_mm_pair)."""
    gz = op.Wz.shape[1]
    _, ns, n, _, ez = op.G6.shape
    g1 = x1.reshape(-1, gz)[op.rows]
    g2 = x2.reshape(-1, gz)[op.rows]
    u = (_einsum("ez,qz->qe", op.Wz, g1).reshape(ns, n, n, ez)
         * c1_e
         + _einsum("ez,qz->qe", op.Wz, g2).reshape(ns, n, n, ez)
         * c2_e)
    wx = _einsum("ai,qije->qaje", op.D, u)
    wy = _einsum("bj,qije->qibe", op.D, u)
    wz = _einsum("fe,qije->qijf", op.Dz, u)
    G = op.G6
    f0 = G[0] * wx + G[1] * wy + G[2] * wz
    f1 = G[1] * wx + G[3] * wy + G[4] * wz
    f2 = G[2] * wx + G[4] * wy + G[5] * wz
    r = _einsum("ai,qaje->qije", op.D, f0)
    r = r + _einsum("bj,qibe->qije", op.D, f1)
    r = r + _einsum("fe,qijf->qije", op.Dz, f2)
    vals = _einsum("ez,qije->qijz", op.Wz, r).reshape(ns * n * n, gz)
    y2 = jnp.zeros((ndofs // gz, gz), x1.dtype)
    y2 = y2.at[op.rows].add(vals, mode="promise_in_bounds")
    return y2.reshape(-1)


def stiffness_apply_indexed(x_flat: jax.Array, G: jax.Array,
                            coeff: jax.Array, dofmap: jax.Array,
                            D: jax.Array, ndofs: int) -> jax.Array:
    """G: (6, cells, n^3) component-major metric; dofmap: (cells, n^3);
    `coeff`: per-cell coefficients, or None for unit coefficients (skips
    the per-cell multiply — the uniform-media fold passes the folded
    FIELD and no coefficient vector)."""
    n = D.shape[0]
    cells = dofmap.shape[0]
    u = gather_dofs(x_flat, dofmap).reshape(cells, n, n, n)
    y = _indexed_contract(u, G, coeff, D)
    return scatter_add_dofs(y.reshape(cells, -1), dofmap, ndofs)


def _indexed_contract(u, G, coeff, D):
    """Per-cell stiffness contraction of gathered fields u (cells,n,n,n);
    G in component-major (6, cells, n^3) layout.
    `coeff=None` skips the per-cell coefficient multiply (callers that
    fold the coefficient into `u` up front — valid because a per-cell
    constant commutes with the in-cell contractions).

    DENSE-OPERATOR form: the three (n^3, n^3) derivative operators
    Dq3 = I (x) D (x) I put CELLS on the M axis of one (cells, n^3) @
    (n^3, n^3) matmul per direction, at n^2 times the FLOPs of sum
    factorisation."""
    cells, n = u.shape[0], D.shape[0]
    eye = jnp.eye(n, dtype=u.dtype)
    D3 = (jnp.kron(jnp.kron(D, eye), eye),
          jnp.kron(jnp.kron(eye, D), eye),
          jnp.kron(jnp.kron(eye, eye), D))
    u2 = u.reshape(cells, n ** 3)
    wx = _einsum("pq,cq->cp", D3[0], u2)
    wy = _einsum("pq,cq->cp", D3[1], u2)
    wz = _einsum("pq,cq->cp", D3[2], u2)
    c = 1.0 if coeff is None else coeff[:, None]
    f0 = c * (G[0] * wx + G[1] * wy + G[2] * wz)
    f1 = c * (G[1] * wx + G[3] * wy + G[4] * wz)
    f2 = c * (G[2] * wx + G[4] * wy + G[5] * wz)
    y = _einsum("pq,cp->cq", D3[0], f0)
    y = y + _einsum("pq,cp->cq", D3[1], f1)
    y = y + _einsum("pq,cp->cq", D3[2], f2)
    return y.reshape(cells, n, n, n)


def stiffness_apply_indexed_pair(x1: jax.Array, c1: jax.Array,
                                 x2: jax.Array, c2: jax.Array,
                                 G: jax.Array, dofmap: jax.Array,
                                 D: jax.Array, ndofs: int) -> jax.Array:
    """stiffness(x1; c1) + stiffness(x2; c2) in one pass sharing a
    SINGLE scatter-add AND a single contraction chain: the indexed-path
    counterpart of the structured pair apply for heterogeneous
    Westervelt (the reference launches the two stiffness kernels back to
    back and pays two atomic-add passes,
    cuda/demo_nonlinear_bowl.py:618-640).  Because the per-cell
    coefficients are constant within a cell they commute with the
    in-cell contractions, so the two gathered fields fold to
    c1*u1 + c2*u2 BEFORE one derivative/transform pass — half the
    contraction FLOPs of two applies.  G in component-major
    (6, cells, n^3) layout (see stiffness_apply_indexed)."""
    n = D.shape[0]
    cells = dofmap.shape[0]
    u1 = gather_dofs(x1, dofmap).reshape(cells, n, n, n)
    u2 = gather_dofs(x2, dofmap).reshape(cells, n, n, n)
    u = (c1[:, None, None, None] * u1 + c2[:, None, None, None] * u2)
    y = _indexed_contract(u, G, None, D)
    return scatter_add_dofs(y.reshape(cells, -1), dofmap, ndofs)
