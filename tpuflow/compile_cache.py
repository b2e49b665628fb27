"""Where JAX keeps its persistent compilation cache.

Every entry point calls :func:`setup_compile_cache` first. It imports
nothing from JAX, so scripts can call it before JAX is imported.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# A fixed path inside the checkout: the cache key includes the path, so
# a directory that moved would never hit.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def setup_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` if it is set, and set nothing
    else; otherwise point JAX at ``<checkout>/.jax_cache``. Returns the
    directory in use."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    path = str(DEFAULT_CACHE_DIR)
    os.environ[CACHE_ENV] = path
    if "jax" in sys.modules:
        # JAX read its environment when it was imported.
        sys.modules["jax"].config.update("jax_compilation_cache_dir", path)
    return path
