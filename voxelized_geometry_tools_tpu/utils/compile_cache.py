"""One place that decides where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os
from pathlib import Path

import jax

# ``.jax_cache`` at the root of the checkout (listed in .gitignore).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here. Otherwise the cache goes to a fixed directory in
    the checkout, so that repeated runs from one checkout find it again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
