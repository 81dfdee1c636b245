"""JAX's persistent compilation cache, kept in one place.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
changes it. Otherwise the cache goes to `<repo>/.jaxcache` (listed in
.gitignore): a fixed path, because the path is part of the cache key.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jaxcache")


def enable() -> str:
    """Arm the persistent compile cache; returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return jax.config.jax_compilation_cache_dir
