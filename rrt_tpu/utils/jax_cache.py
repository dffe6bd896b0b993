"""JAX's persistent compilation cache, in one place.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache lives in the
checkout, at `<checkout>/.jax_cache` (listed in .gitignore), a fixed path
so that a later process finds what an earlier one compiled.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache (and the dispatch calibration kept
    beside it) uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
