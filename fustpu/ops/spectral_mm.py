"""Structured-grid stiffness operator (the 'mm' path: box and mapped
meshes) and the host-side matrices and layouts it shares with other paths.

The apply is sum-factorised over the whole cell batch at once: the
separable window gather (fustpu.ops.gather_scatter.windows3d) puts the
field in the element-batched (ncx, n, ncy, n, ncz, n) layout, three
contractions with the 1D GLL derivative D[q, i] give the reference
gradients, the symmetric 6-component metric G mixes them elementwise,
three transposed contractions and the separable overlap-add (fold3d) sum
the cell contributions — the batched analogue of the reference's
one-block-per-cell CUDA kernel (/root/reference/cuda/operators.py:73-192).
G is stored as (6, ex, ey, ez) in the expanded-grid layout (cell (a,b,c)
node (i,j,k) at (a n + i, b n + j, c n + k)), which reshapes for free to
the element-batched layout.

Sum factorisation rather than a dense window matrix and a dense
block-diagonal derivative matrix per axis: those FLOPs grow with the cell
count per axis, and on an H100 (700 W) at f32 that form was 1.2x slower at
P=4 32^3 and 2.7x slower at the flagship's P=6 118x72x72 cells.

The mass operator needs none of this: with GLL collocation the *assembled*
mass operator is globally diagonal, so `mass_diagonal` precomputes the
vector once per coefficient field and an apply is one elementwise multiply
(the reference re-scatters detJ on every mass launch instead,
cuda/operators.py:18-70).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fustpu.ops.gather_scatter import fold3d, windows3d

# HIGHEST keeps f32 contractions in full f32 (no TF32 on Hopper).
_PRECISION = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Host-side matrix construction (numpy, f64)
# ---------------------------------------------------------------------------

def window_matrix(ncells: int, P: int) -> np.ndarray:
    """(ncells*(P+1), ncells*P+1) selection matrix W[(b,j), y] = [y==b*P+j]
    (the extruded path's z-axis gather; its transpose is the z fold)."""
    n = P + 1
    e, g = ncells * n, ncells * P + 1
    W = np.zeros((e, g))
    rows = np.arange(e)
    cols = (rows // n) * P + (rows % n)
    W[rows, cols] = 1.0
    return W


def deriv_block_matrix(ncells: int, D: np.ndarray) -> np.ndarray:
    """(e, e) block-diagonal with `ncells` copies of the (n, n) nodal
    derivative matrix D[q, i]."""
    n = D.shape[0]
    e = ncells * n
    out = np.zeros((e, e))
    for b in range(ncells):
        out[b * n:(b + 1) * n, b * n:(b + 1) * n] = D
    return out


def to_expanded_layout(arr_cells: np.ndarray, nc, n: int) -> np.ndarray:
    """(cells, n^3[, k]) -> (ex, ey, ez[, k]) expanded-grid layout with cell
    (a,b,c) node (i,j,k) at (a*n+i, b*n+j, c*n+k)."""
    trailing = arr_cells.shape[2:]
    a = arr_cells.reshape(*nc, n, n, n, *trailing)
    a = a.transpose(0, 3, 1, 4, 2, 5, *range(6, a.ndim))
    return np.ascontiguousarray(
        a.reshape(nc[0] * n, nc[1] * n, nc[2] * n, *trailing))


def expand_cell_field(coeff: np.ndarray, n: int) -> np.ndarray:
    """(ncx, ncy, ncz) per-cell values -> (ex, ey, ez) by n-fold repeat."""
    return np.repeat(np.repeat(np.repeat(coeff, n, 0), n, 1), n, 2)


# ---------------------------------------------------------------------------
# Operator container and application (jit-traceable)
# ---------------------------------------------------------------------------

class MMStiffness(NamedTuple):
    """Device-side stiffness operator for one (sub-)grid."""

    D: jax.Array    # (n, n) 1D GLL derivative D[q, i]
    G: jax.Array    # (6, ex, ey, ez) — quadrature-scaled metric, with the
                    # material coefficient optionally folded in


def build_stiffness(nc, P: int, D_1d: np.ndarray, G_cells: np.ndarray,
                    dtype, coeff: np.ndarray | None = None) -> MMStiffness:
    """G_cells: (cells, n^3, 6) float64 (precompute.cell_geometry_factors);
    coeff: optional (ncx, ncy, ncz) per-cell coefficient folded into G."""
    n = P + 1
    Ge = to_expanded_layout(G_cells, nc, n)          # (ex, ey, ez, 6)
    Ge = np.moveaxis(Ge, -1, 0)                      # (6, ex, ey, ez)
    if coeff is not None:
        Ge = Ge * expand_cell_field(np.asarray(coeff), n)[None]
    return MMStiffness(D=jnp.asarray(D_1d, dtype), G=jnp.asarray(Ge, dtype))


def _batched(a: jax.Array, n: int) -> jax.Array:
    """(..., ex, ey, ez) expanded layout -> (..., a, n, b, n, c, n)."""
    *lead, ex, ey, ez = a.shape
    return a.reshape(*lead, ex // n, n, ey // n, n, ez // n, n)


def _middle(op: MMStiffness, u: jax.Array,
            coeff: jax.Array | None = None) -> jax.Array:
    """Within-cell part of the apply on the element batch u."""
    D = op.D
    n = D.shape[0]
    G = _batched(op.G, n)
    wx = jnp.einsum("qi,aibjck->aqbjck", D, u, precision=_PRECISION)
    wy = jnp.einsum("qj,aibjck->aibqck", D, u, precision=_PRECISION)
    wz = jnp.einsum("qk,aibjck->aibjcq", D, u, precision=_PRECISION)
    f0 = G[0] * wx + G[1] * wy + G[2] * wz
    f1 = G[1] * wx + G[3] * wy + G[4] * wz
    f2 = G[2] * wx + G[4] * wy + G[5] * wz
    if coeff is not None:
        f0, f1, f2 = f0 * coeff, f1 * coeff, f2 * coeff
    y = jnp.einsum("qi,aqbjck->aibjck", D, f0, precision=_PRECISION)
    y = y + jnp.einsum("qj,aibqck->aibjck", D, f1, precision=_PRECISION)
    y = y + jnp.einsum("qk,aibjcq->aibjck", D, f2, precision=_PRECISION)
    return y


def stiffness_apply_mm(op: MMStiffness, x: jax.Array,
                       coeff_e: jax.Array | None = None) -> jax.Array:
    """y_grid = A_stiff(x_grid).  `coeff_e`: optional (ex, ey, ez) expanded
    per-cell coefficient (omit if folded into G at build time)."""
    n = op.D.shape[0]
    P = n - 1
    c = None if coeff_e is None else _batched(coeff_e, n)
    return fold3d(_middle(op, windows3d(x, P), c), P)


def stiffness_apply_mm_pair(op: MMStiffness, x1: jax.Array, x2: jax.Array,
                            c1_e: jax.Array, c2_e: jax.Array) -> jax.Array:
    """y = A_c1(x1) + A_c2(x2) in ONE contraction pass.

    Per-cell coefficients are constant within each cell, so they commute
    with the within-cell derivative contractions once the fields are in
    the element-batched layout: combine u = c1*E(x1) + c2*E(x2) there and
    run a single unit-coefficient middle+fold.  Halves the heavy work of
    the heterogeneous Westervelt stage, which needs
    A_{-1/rho}(u) + A_{-delta/(rho c^2)}(v) (the reference launches two
    stiffness kernels, cuda/demo_nonlinear_bowl.py:618-625)."""
    n = op.D.shape[0]
    P = n - 1
    u = (windows3d(x1, P) * _batched(c1_e, n)
         + windows3d(x2, P) * _batched(c2_e, n))
    return fold3d(_middle(op, u), P)


def mass_diagonal(nc, P: int, detJ_cells: np.ndarray,
                  coeff: np.ndarray | None = None) -> np.ndarray:
    """The assembled (global) mass diagonal, float64 host: fold of
    detJ * coeff over cells.  Apply = x * diag.

    Strided in-place accumulation: global node (a*P+i, b*P+j, c*P+k) is
    the step-P slice out[i::P, j::P, k::P], so the fold is n^3 strided
    adds of (ncx, ncy, ncz) blocks — no expanded-layout transpose, which
    is the slow part of host set-up at 10^8 DOF."""
    n = P + 1
    ncx, ncy, ncz = nc
    dJ = detJ_cells.reshape(ncx, ncy, ncz, n, n, n)
    if coeff is not None:
        dJ = dJ * np.asarray(coeff)[..., None, None, None]
    out = np.zeros((ncx * P + 1, ncy * P + 1, ncz * P + 1))
    for i in range(n):
        oi = out[i::P][:ncx] if i < P else out[P::P]
        for j in range(n):
            oj = oi[:, j::P][:, :ncy] if j < P else oi[:, P::P]
            for k in range(n):
                ok = (oj[:, :, k::P][:, :, :ncz] if k < P
                      else oj[:, :, P::P])
                ok += dJ[:, :, :, i, j, k]
    return out
