"""Persistent XLA compilation cache for the entry-point scripts.

The cache directory is part of what the cache keys on, so it must not move
between runs: ``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it
itself); otherwise the cache lives at a fixed directory inside the checkout,
:data:`DEFAULT_DIR`, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["DEFAULT_DIR", "enable_compile_cache"]

#: in-checkout cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
