"""Persistent XLA compile cache, placed from outside or at a fixed path.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache lives at `<checkout>/.jax_cache` — a fixed
path, because the directory is part of what a later process must find again.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
