"""JAX's persistent compilation cache, set up in one place.

Scripts call ``setup()`` before their first compile.  The cache lives where
``JAX_COMPILATION_CACHE_DIR`` says when that variable is set, and in
``<repo>/.jax_cache`` otherwise (listed in .gitignore).  A fixed path
matters: the path is part of the cache key, so a cache that moves never
hits.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory ``setup()`` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def setup() -> str:
    """Point JAX's compilation cache at ``cache_dir()``; returns it."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
