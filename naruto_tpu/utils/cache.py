"""Persistent XLA compilation cache.

The sort-heavy mapping graphs take a while to compile; the persistent cache
lets every process after the first reuse the executables. Where the cache
lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it itself and
this module sets no other directory), else the fixed `.jax_cache/` at the
checkout root (a fixed path, because the path is part of the cache key).
Safe to call multiple times.
"""
from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # 0.0: persist even sub-second executables — engine construction
    # dispatches dozens of tiny one-off programs, and with the default 1 s
    # threshold none of them would persist
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # source locations embedded in the HLO make the cache key shift with
    # every unrelated code edit; strip them so entries survive edits
    jax.config.update("jax_include_full_tracebacks_in_locations", False)
    jax.config.update("jax_traceback_in_locations_limit", 0)
    return path
