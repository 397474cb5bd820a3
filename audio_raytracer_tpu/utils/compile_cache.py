"""Where JAX keeps its persistent compilation cache.

Compiling the 1M-ray programs takes a large share of a cold run. JAX
reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is unset the cache
goes to one fixed directory of the checkout (the path is part of the
cache key, so a directory that moves never hits).
"""

from __future__ import annotations

import os
import pathlib

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory. Sets nothing
    when ``JAX_COMPILATION_CACHE_DIR`` is set."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
