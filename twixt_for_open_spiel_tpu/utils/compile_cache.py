"""Where JAX keeps its persistent compilation cache.

A cache entry is found again only at the same path, so the cache lives at
one fixed place: the directory ``JAX_COMPILATION_CACHE_DIR`` names when it
is set (JAX reads that variable itself), and otherwise ``.jax_cache/`` at
the root of the checkout, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Call before the first compilation.  With ``JAX_COMPILATION_CACHE_DIR``
    set this sets nothing: JAX already took the directory from it.
    """
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    path = str(DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
