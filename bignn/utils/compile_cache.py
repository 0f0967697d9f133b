"""Where JAX keeps its persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache goes to ``<checkout>/.cache/jax``:
a fixed path, so a later process on the same checkout finds what an earlier
one compiled.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".cache", "jax")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
