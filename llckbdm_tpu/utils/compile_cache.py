"""The persistent XLA compilation cache, shared by bench.py, chip_smoke.py
and the test suite.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at ``<repo>/.jax_cache``: a
fixed path, because the path is part of the cache key.
"""
from __future__ import annotations

import os
import pathlib

REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def use_compile_cache(min_compile_secs: float = 1.0) -> None:
    """Point JAX's persistent compilation cache at its directory.

    Call before the first compilation.  Programs that compile in less than
    ``min_compile_secs`` are not written to the cache.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
