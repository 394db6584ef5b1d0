"""Persistent XLA compile cache (shared by cli.py, bench.py and chip_smoke).

The classify program takes seconds to minutes to compile, so every process
that drives the device shares one on-disk cache. The path is part of the
cache's key, so it is fixed: ``$JAX_COMPILATION_CACHE_DIR`` when that is set,
otherwise ``<repo>/.jax_cache`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The cache directory this process uses (see module docstring)."""
    env = os.environ.get(ENV)
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "..",
                                         ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX at the persistent compile cache; returns its directory.

    With the environment variable set, JAX reads it itself and nothing is
    set here; otherwise the fixed in-repo path is configured."""
    path = cache_dir()
    import jax
    if not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
