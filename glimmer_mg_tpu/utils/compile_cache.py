"""Where JAX keeps its persistent compile cache.

A compiled program is found again only at the path it was stored under,
so the cache lives at one fixed place: the directory named by
``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads the variable
itself), otherwise ``<checkout>/.cache/jax``, which git ignores.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".cache" / "jax"


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed directory.

    Call before the first compilation. Sets nothing when
    ``JAX_COMPILATION_CACHE_DIR`` is set. Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
