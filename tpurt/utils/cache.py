"""Persistent compilation cache, set up the same way by every entry point.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing else is
set. Otherwise the cache lives at the fixed path `<checkout>/.jax_cache`
(listed in .gitignore): a fixed path, because the path is part of the
cache's key. Call this before the first compile.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Returns the cache directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
