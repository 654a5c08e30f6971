"""JAX persistent compilation cache location.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and it wins;
otherwise the cache lives at the fixed path `<repo>/.jax_cache`, so every
entry point of this checkout (tests, demos, bench.py, chip_smoke.py) shares
one cache.  The path is part of the cache's key: a directory that moves
never hits.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The environment's cache directory if set, else `<repo>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    and cache every program that took `min_compile_secs` to compile.
    Returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
