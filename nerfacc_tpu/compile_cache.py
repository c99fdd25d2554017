"""Where JAX keeps its persistent compilation cache.

Every entry point (the trainers, ``bench.py``, ``chip_smoke.py``, the
scripts and the tests) calls :func:`setup_compile_cache` before its first
compile. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and no other directory is set; otherwise the cache is ``.jax_cache`` at
the root of the checkout. The path is fixed because it is part of the
cache's key: a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the cache uses, whether or not it is set up yet."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def setup_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn the persistent cache on and return its directory.

    Programs that compile faster than ``min_compile_time_secs`` are not
    cached, unless ``JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS`` says
    otherwise.
    """
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        DEFAULT_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    if not os.environ.get("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs",
            min_compile_time_secs,
        )
    return compile_cache_dir()
