"""Global-DOF <-> element-batch gather/scatter.

The reference handles the scatter-add (direct stiffness summation) with
``cuda.atomic.add`` per dof (/root/reference/cuda/operators.py:70,190).  On a
structured box with tensor-product numbering the scatter is *separable*:
global node index along each axis is cx*P + i, so cells overlap only at the
single shared plane per axis.  The whole 3D scatter-add therefore factors
into three 1D "overlap-adds", each of which is just reshape + pad + add —
fully vectorized, deterministic, and fusable by XLA.  The gather is the
matching "windowing" (two slices + a concat per axis).

The indexed path (``gather_dofs`` / ``scatter_add_dofs``) remains for
arbitrary facet patches and as a cross-check in tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# 1D building blocks along the leading axis
# ---------------------------------------------------------------------------

def _win_front(x: jax.Array, P: int) -> jax.Array:
    """(g, ...) -> (nc, n, ...) overlapping windows, g = nc*P + 1."""
    g = x.shape[0]
    nc = (g - 1) // P
    rest = x.shape[1:]
    a = x[: g - 1].reshape(nc, P, *rest)
    b = x[1:].reshape(nc, P, *rest)[:, P - 1 : P]  # node (c+1)*P
    return jnp.concatenate([a, b], axis=1)


def _fold_front(A: jax.Array, P: int) -> jax.Array:
    """(nc, n, ...) -> (g, ...) overlap-add (adjoint of _win_front)."""
    nc = A.shape[0]
    rest = A.shape[2:]
    zeros_pad = [(0, 0)] * (A.ndim - 1)
    main = A[:, :P].reshape(nc * P, *rest)
    main = jnp.pad(main, [(0, 1)] + zeros_pad[1:])
    ends = A[:, P]                                   # (nc, ...)
    block = jnp.pad(ends[:, None], [(0, 0), (P - 1, 0)] + zeros_pad[1:])
    shifted = jnp.pad(block.reshape(nc * P, *rest), [(1, 0)] + zeros_pad[1:])
    return main + shifted


# ---------------------------------------------------------------------------
# 3D structured gather / scatter
# ---------------------------------------------------------------------------

def windows3d(x: jax.Array, P: int) -> jax.Array:
    """(gx, gy, gz) node grid -> (ncx, n, ncy, n, ncz, n) element batch."""
    x = _win_front(x, P)                  # (ncx, n, gy, gz)
    x = jnp.moveaxis(x, 2, 0)             # (gy, ncx, n, gz)
    x = _win_front(x, P)                  # (ncy, n, ncx, n, gz)
    x = jnp.moveaxis(x, 4, 0)             # (gz, ncy, n, ncx, n)
    x = _win_front(x, P)                  # (ncz, n, ncy, n, ncx, n)
    return x.transpose(4, 5, 2, 3, 0, 1)  # (ncx, n, ncy, n, ncz, n)


def fold3d(A: jax.Array, P: int) -> jax.Array:
    """(ncx, n, ncy, n, ncz, n) element batch -> (gx, gy, gz) scatter-add."""
    A = A.transpose(4, 5, 2, 3, 0, 1)     # (ncz, n, ncy, n, ncx, n)
    A = _fold_front(A, P)                 # (gz, ncy, n, ncx, n)
    A = jnp.moveaxis(A, 0, 4)             # (ncy, n, ncx, n, gz)
    A = _fold_front(A, P)                 # (gy, ncx, n, gz)
    A = jnp.moveaxis(A, 0, 2)             # (ncx, n, gy, gz)
    return _fold_front(A, P)              # (gx, gy, gz)


def windows2d(x: jax.Array, P: int) -> jax.Array:
    """(gs, gt) plane -> (ncs, n, nct, n) facet batch (for boundary planes)."""
    x = _win_front(x, P)                  # (ncs, n, gt)
    x = jnp.moveaxis(x, 2, 0)
    x = _win_front(x, P)                  # (nct, n, ncs, n)
    return x.transpose(2, 3, 0, 1)


def fold2d(A: jax.Array, P: int) -> jax.Array:
    A = A.transpose(2, 3, 0, 1)
    A = _fold_front(A, P)
    A = jnp.moveaxis(A, 0, 2)
    return _fold_front(A, P)


# ---------------------------------------------------------------------------
# Indexed (generic) gather / scatter-add
# ---------------------------------------------------------------------------

def gather_dofs(x_flat: jax.Array, dofmap: jax.Array) -> jax.Array:
    """x[dofmap]: (ndofs,) -> (entities, local_dofs)."""
    return x_flat[dofmap]


def scatter_add_dofs(vals: jax.Array, dofmap: jax.Array,
                     ndofs: int) -> jax.Array:
    """Scatter-add of (entities, local_dofs) into (ndofs,).  XLA's GPU
    scatter-add accumulates with atomics, so the order of the sums (and
    the last bits of the result) can change from run to run."""
    return jnp.zeros((ndofs,), vals.dtype).at[dofmap.ravel()].add(
        vals.ravel(), mode="promise_in_bounds")
