"""Test configuration: run the suite on CPU with 8 virtual devices so the
multi-device sharding path is exercised without accelerator hardware (the
analogue of the reference's `mpirun -n k` distributed tests on a laptop),
and enable float64 so operator checks can use the reference's tight f64
tolerance (1e-12, /root/reference/numba-cpu/test_operators.py:30-33).

Tests that need a GPU are marked `gpu` and take the `gpu` fixture, which
skips them with a reason when the first JAX device is not a GPU; the
decision is made inside the fixture, never while a module is imported.
They run on the card with `JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/` (the rest of the suite assumes the CPU platform).
"""

import os

import pytest

platform = os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# the persistent-cache loader logs a benign machine-feature-string
# mismatch per hit; real failures still surface as Python exceptions
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402

from fustpu.utils.compile_cache import compile_cache_dir, \
    enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", platform)
jax.config.update("jax_enable_x64", True)

# Persistent XLA compile cache: the suite is compile-dominated, and cached
# re-runs skip every big compile.  The cache keys on HLO + compile options
# + jax version, so staleness cannot produce wrong numbers, only a
# recompile.  An existing JAX_COMPILATION_CACHE_DIR wins; the demo-CLI
# subprocess tests inherit the same directory through the environment.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", compile_cache_dir())
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
enable_compile_cache()


@pytest.fixture
def gpu():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first JAX device: {dev.platform})")
    return dev
