"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLI, bench.py, profile_step.py,
__graft_entry__.py and the tests) calls `configure()` before its first
compile:

- if JAX_COMPILATION_CACHE_DIR is set, that directory and no other;
- otherwise `<checkout>/.jax_cache`, a fixed path (the cache is keyed
  by it, so a path that moved between runs would never hit), listed in
  .gitignore.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache")


def configure() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()` and
    cache every program that took a second or more to compile."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES" not in os.environ:
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
