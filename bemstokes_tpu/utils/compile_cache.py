"""Persistent XLA compilation cache placement, shared by every entry point
(the CLI, bench.py, chip_smoke.py, scripts)."""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path, since the directory is part of the
# cache key (a moving directory never hits); .gitignore lists it
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no directory; otherwise the cache goes to DEFAULT_CACHE_DIR."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
