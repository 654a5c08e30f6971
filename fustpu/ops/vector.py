"""Vector (BLAS-1) operations — API parity with the reference's kernels
(axpy/copy/fill/pointwise_divide/square, /root/reference/cuda/operators.py
:195-275 and numba-cpu/operators.py:230-301).

These are trivially jnp expressions that XLA fuses into neighbouring ops; they exist as named functions so reference users find the same
vocabulary (and so model code reads like the reference's update steps).
All are pure (return new arrays) — the functional analogue of the
reference's in-place kernels.
"""

from __future__ import annotations

import jax.numpy as jnp


def axpy(alpha, x, y):
    """y + alpha * x (reference cuda/operators.py:195-211)."""
    return y + alpha * x


def copy(a):
    """Functional copy (reference :214-227); a no-op under jit."""
    return jnp.asarray(a)


def fill(alpha, like):
    """Constant vector shaped like `like` (reference :230-243)."""
    return jnp.full_like(like, alpha)


def pointwise_divide(a, b):
    """a / b (the diagonal mass solve, reference :246-258)."""
    return a / b


def square(a):
    """a * a (Westervelt v^2 term, reference :261-275)."""
    return a * a


def dot(x, y):
    """Global dot product (single device)."""
    return jnp.vdot(x, y)


def norm(x):
    """Global l2 norm (single device)."""
    return jnp.sqrt(jnp.vdot(x, x).real)
