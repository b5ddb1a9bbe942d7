"""Persistent XLA compilation cache.

Compiling the full-granule program takes far longer than running it, so
``bench.py``, ``chip_smoke.py`` and the CLI keep JAX's persistent
compilation cache on. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and this module sets no directory; otherwise the cache
lives at the fixed ``<checkout>/.jaxcache`` (the path is part of the
cache key, so it never derives from a temp name, a pid or the time).

Set ``HYPERRES_COMPILE_CACHE=0`` to disable.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

#: the cache directory used when JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jaxcache"


def enable_compilation_cache() -> Optional[Path]:
    """Turn JAX's persistent compilation cache on.

    Must run before the first compilation (any time before is fine —
    unlike platform selection it does not require pre-backend-init).
    Returns the cache dir, or None when disabled via
    ``HYPERRES_COMPILE_CACHE=0``."""
    if os.environ.get("HYPERRES_COMPILE_CACHE", "1") == "0":
        return None
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        d = Path(env_dir)
    else:
        d = DEFAULT_CACHE_DIR
        d.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(d))
    # cache EVERY program, whatever its size or compile time: with the
    # 1.0 s default, the pipeline's small helper programs (quantizers,
    # scalar reductions) recompile on every process start
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return d
