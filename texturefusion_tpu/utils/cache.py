"""Persistent XLA compilation cache.

The pipeline compiles dozens of programs (one per static shape bucket);
the persistent cache lets every later process load them instead of
compiling again. Call once before building pipelines.
"""

from __future__ import annotations

import os

# fixed path inside the checkout: the path is part of the cache key, so
# a directory that moved would never hit
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR when set, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str:
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, however quick to compile: the small eager
    # programs (scatters, broadcasts) that first appear mid-run would
    # otherwise compile inside the frame loop
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
