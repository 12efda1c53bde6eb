"""JAX's persistent compilation cache, set up the same way by every launcher
(the CLI, bench.py, chip_smoke.py).

``JAX_COMPILATION_CACHE_DIR``, when set, is the only cache: JAX reads it
itself and nothing else is configured.  Otherwise the cache lives at the
fixed ``<repo>/.jax_cache`` — a fixed path, because the path is part of the
cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX at the compilation cache; returns the directory in use.
    Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
