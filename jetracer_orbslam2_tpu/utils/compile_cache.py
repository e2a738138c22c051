"""Persistent XLA compile cache: one fixed directory per checkout.

A cold run of the SLAM programs at 640x480 spends most of its set-up time
compiling.  JAX keeps compiled executables in a persistent cache keyed by
the program and the cache path, so the path must not move between runs.

Rule: when `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at `<checkout>/.jax_cache`
(listed in `.gitignore`).  Call `configure_compile_cache()` before the first
compilation: JAX opens the cache once per process.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=os.environ) -> tuple[str, bool]:
    """(directory, came_from_env) for the given environment."""
    env = environ.get(ENV_VAR)
    if env:
        return env, True
    return str(CHECKOUT_CACHE), False


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at the rule's directory and
    return it."""
    import jax

    path, from_env = cache_dir()
    if not from_env:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
