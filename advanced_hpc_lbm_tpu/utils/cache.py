"""Persistent XLA compilation cache setup.

Compiling a whole-run executable takes seconds; caching compiled
executables on disk makes every CLI/bench rerun of a known deck shape
start hot.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads
it and nothing here overrides it; otherwise the cache lives at one fixed
directory of the checkout, ``.jax_cache/`` (the path is part of the
cache's key, so it must not move between runs).  Opt-out with
LBM_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(env=None) -> str:
    """The directory the compile cache uses under ``env``."""
    env = os.environ if env is None else env
    return env.get("JAX_COMPILATION_CACHE_DIR") or str(CACHE_DIR)


def enable() -> str | None:
    """Turn the persistent cache on; returns its directory (None when
    opted out)."""
    if os.environ.get("LBM_NO_COMPILE_CACHE"):
        return None
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        CACHE_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return cache_dir()
