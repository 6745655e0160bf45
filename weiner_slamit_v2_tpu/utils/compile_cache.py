"""Persistent XLA compilation cache for the scripts that drive the system.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is (JAX reads it
itself). Otherwise the cache lives at ``<checkout>/.jax_cache``: a fixed
path, so that repeated runs from one checkout hit it. The test suite keeps
no persistent cache and does not call this.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
