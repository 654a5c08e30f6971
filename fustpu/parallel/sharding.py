"""Multi-chip domain decomposition over a JAX device mesh.

The reference distributes via MPI: DOLFINx partitions the mesh, each rank
owns a contiguous DOF range + ghosts, and hand-written pack/Isend/Irecv/
unpack kernels implement scatter_forward (owner->ghost copy) and
scatter_reverse (ghost->owner add) (/root/reference/cuda/scatterer.py,
cuda/utils.py:8-78).

Design: the box is partitioned into a (Sx, Sy, Sz) grid of
sub-boxes mapped onto a `jax.sharding.Mesh` with axes ('x','y','z').  Each
device holds its sub-box's node block *including* the single shared plane
with each neighbour (nodes on a cut plane are stored on both sides).  After
local assembly, a "halo sum" makes shared planes globally summed AND
consistent on both owners in one shot: along each partitioned axis the
boundary planes are exchanged with `lax.ppermute` and added.
Because every device then holds identical values on its shared planes, the
reference's separate scatter_forward after field updates is unnecessary —
axpy/copy/divide preserve consistency.  One exchange per assembly instead
of the reference's 3 forward + 2 reverse scatters per RK stage.

Data layout: distributed arrays carry leading device axes, e.g. a node
field is (Sx, Sy, Sz, lgx, lgy, lgz) with PartitionSpec('x','y','z') on the
leading axes; inside `shard_map` each device sees (1, 1, 1, lgx, lgy, lgz).
"""

from __future__ import annotations

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("x", "y", "z")


@dataclasses.dataclass
class DeviceGrid:
    """A (Sx, Sy, Sz) grid of devices over the box partition."""

    shape: tuple[int, int, int]
    mesh: Mesh

    @classmethod
    def create(cls, shape: tuple[int, int, int], devices=None) -> "DeviceGrid":
        n = int(np.prod(shape))
        devices = list(jax.devices() if devices is None else devices)[:n]
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        return cls(shape=tuple(shape),
                   mesh=Mesh(np.asarray(devices).reshape(shape), AXES))

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))

    def spec(self, *trailing_none: int) -> P:
        return P(*AXES, *([None] * trailing_none[0] if trailing_none else []))

    def put(self, stacked: np.ndarray, dtype=None) -> jax.Array:
        """Place a host array with leading (Sx, Sy, Sz) axes onto the grid.
        Multi-process safe: each process materialises only its addressable
        shards (every process holds the full host array — setup data is
        replicated host-side, like the reference's per-rank setup)."""
        sharding = NamedSharding(self.mesh, P(*AXES))
        arr = np.asarray(stacked, dtype and jnp.dtype(dtype))
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])

    def replicate(self, arr, dtype=None) -> jax.Array:
        """Fully-replicated global array (multi-process safe)."""
        sharding = NamedSharding(self.mesh, P())
        arr = np.asarray(arr, dtype and jnp.dtype(dtype))
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])


# ---------------------------------------------------------------------------
# Host-side split / merge of node fields and cell fields
# ---------------------------------------------------------------------------

def _check_divisible(nc: tuple[int, int, int], S: tuple[int, int, int]):
    for c, s in zip(nc, S):
        if c % s:
            raise ValueError(f"cells {nc} not divisible by device grid {S}")


def split_node_field(x: np.ndarray, nc, S, degree: int) -> np.ndarray:
    """(gx, gy, gz[, ...]) -> (Sx, Sy, Sz, lgx, lgy, lgz[, ...]) overlapping
    blocks; lg = (nc/S)*P + 1 (one shared plane per cut)."""
    _check_divisible(nc, S)
    Pd = degree
    lc = [c // s for c, s in zip(nc, S)]
    lg = [c * Pd + 1 for c in lc]
    out = np.empty((*S, *lg, *x.shape[3:]), dtype=x.dtype)
    for i in range(S[0]):
        for j in range(S[1]):
            for k in range(S[2]):
                out[i, j, k] = x[
                    i * lc[0] * Pd: i * lc[0] * Pd + lg[0],
                    j * lc[1] * Pd: j * lc[1] * Pd + lg[1],
                    k * lc[2] * Pd: k * lc[2] * Pd + lg[2]]
    return out


def merge_node_field(stacked: np.ndarray, nc, S, degree: int) -> np.ndarray:
    """Inverse of split_node_field (overlapping planes agree by
    construction; last-writer wins)."""
    Pd = degree
    lc = [c // s for c, s in zip(nc, S)]
    lg = [c * Pd + 1 for c in lc]
    g = [c * Pd + 1 for c in nc]
    out = np.empty((*g, *stacked.shape[6:]), dtype=stacked.dtype)
    for i in range(S[0]):
        for j in range(S[1]):
            for k in range(S[2]):
                out[i * lc[0] * Pd: i * lc[0] * Pd + lg[0],
                    j * lc[1] * Pd: j * lc[1] * Pd + lg[1],
                    k * lc[2] * Pd: k * lc[2] * Pd + lg[2]] = stacked[i, j, k]
    return out


def split_cell_field(arr: np.ndarray, nc, S) -> np.ndarray:
    """Structured-layout cell array (ncx, n, ncy, n, ncz, n, ...) or plain
    cell field (ncx, ncy, ncz) -> leading (Sx, Sy, Sz) blocks."""
    _check_divisible(nc, S)
    lc = [c // s for c, s in zip(nc, S)]
    if arr.ndim >= 6 and arr.shape[0] == nc[0] and arr.shape[2] == nc[1]:
        a = arr.reshape(S[0], lc[0], arr.shape[1], S[1], lc[1], arr.shape[3],
                        S[2], lc[2], *arr.shape[5:])
        return np.ascontiguousarray(a.transpose(
            0, 3, 6, 1, 2, 4, 5, 7, *range(8, a.ndim)))
    # plain (ncx, ncy, ncz[, ...]) cell field
    a = arr.reshape(S[0], lc[0], S[1], lc[1], S[2], lc[2], *arr.shape[3:])
    return np.ascontiguousarray(a.transpose(0, 2, 4, 1, 3, 5,
                                            *range(6, a.ndim)))


# ---------------------------------------------------------------------------
# In-shard halo sum (runs inside shard_map)
# ---------------------------------------------------------------------------

def halo_sum(y: jax.Array, grid_shape: tuple[int, int, int]) -> jax.Array:
    """Sum shared planes across neighbouring devices along every partitioned
    axis.  `y` is the device-local (lgx, lgy, lgz) block; afterwards the
    shared planes hold the full sum on BOTH devices (fusing the reference's
    scatter_reverse(add) + scatter_forward round trip,
    cuda/demo_nonlinear_bowl.py:604-615,640)."""
    for ax, name in enumerate(AXES):
        S = grid_shape[ax]
        if S == 1:
            continue
        idx = jax.lax.axis_index(name)
        lo = jax.lax.index_in_dim(y, 0, axis=ax, keepdims=False)
        hi = jax.lax.index_in_dim(y, y.shape[ax] - 1, axis=ax, keepdims=False)
        # send my low plane to the left neighbour (it adds into its high
        # plane); send my high plane to the right neighbour.
        from_right = jax.lax.ppermute(lo, name,
                                      [(i, i - 1) for i in range(1, S)])
        from_left = jax.lax.ppermute(hi, name,
                                     [(i, i + 1) for i in range(S - 1)])
        y = _add_plane(y, from_left, ax, 0, idx > 0)
        y = _add_plane(y, from_right, ax, y.shape[ax] - 1, idx < S - 1)
    return y


def _add_plane(y, plane, axis, pos, active):
    cur = jax.lax.index_in_dim(y, pos, axis=axis, keepdims=False)
    new = cur + jnp.where(active, 1.0, 0.0).astype(y.dtype) * plane
    return jax.lax.dynamic_update_index_in_dim(
        y, new, pos, axis)


# ---------------------------------------------------------------------------
# Distributed reductions (runs inside shard_map)
# ---------------------------------------------------------------------------

def ownership_weights(local_shape, grid_shape, dtype=jnp.float32):
    """Per-node multiplicity weights for the device-local block: nodes on a
    cut plane are stored on BOTH neighbours, so global reductions must
    weight them by 1/multiplicity (1/2 per partitioned axis they sit on —
    1/4 on shared edges, 1/8 on shared corners).  Traced: uses
    axis_index, so boundary devices keep weight 1 on the outer planes."""
    w = jnp.ones(local_shape, dtype)
    for ax, name in enumerate(AXES):
        S = grid_shape[ax]
        if S == 1:
            continue
        idx = jax.lax.axis_index(name)
        lo = jnp.where(idx > 0, 0.5, 1.0).astype(dtype)
        hi = jnp.where(idx < S - 1, 0.5, 1.0).astype(dtype)
        ones = jnp.ones((local_shape[ax],), dtype)
        prof = ones.at[0].set(lo).at[local_shape[ax] - 1].set(hi)
        shape = [1, 1, 1]
        shape[ax] = local_shape[ax]
        w = w * prof.reshape(shape)
    return w


def global_dot(x, y, grid_shape):
    """Distributed dot product of device-local node blocks (inside
    shard_map): multiplicity-weighted local contraction + psum.  The
    analogue of dolfinx la.inner_product over an IndexMap with ghosts."""
    w = ownership_weights(x.shape, grid_shape, x.dtype)
    return jax.lax.psum(jnp.sum(x * y * w), AXES)


def global_norm(x, grid_shape):
    return jnp.sqrt(global_dot(x, x, grid_shape))
