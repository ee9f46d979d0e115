"""One place that decides where JAX keeps its persistent compile cache.

Every entry point (scripts, benchmarks, examples) calls
`enable_compile_cache()` before its first compile:

  * if `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it by itself and this
    helper sets no other directory;
  * otherwise the cache lives at `<checkout>/.jax_cache`, a fixed path
    whatever the working directory (the path is part of the cache key, so
    a moving directory would never hit).
"""
from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get(ENV) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax
    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
