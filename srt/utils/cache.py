"""Persistent XLA compilation cache.

The regen ``while_loop`` and the kernels take seconds to minutes to trace
and compile; caching compiled executables on disk lets the next process
skip that. Call :func:`enable` before the first jit (bench.py,
chip_smoke.py, tools/ and the CLI all do); it is the only place in the
repository that sets the cache directory. ``SRT_NO_COMPILE_CACHE=1``
opts out.
"""
from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path: the directory is part of the cache's key)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def enable() -> str | None:
    """Turn the persistent cache on; returns its directory (None when
    opted out)."""
    if os.environ.get("SRT_NO_COMPILE_CACHE"):
        return None
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
