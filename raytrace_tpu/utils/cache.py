"""Persistent XLA compilation cache.

Wavefront programs and the fused kernel take seconds to compile per
shape; the persistent cache makes every shape a one-time cost per
machine.  Called by the CLI, the bench harness, ``__graft_entry__.py``
and ``chip_smoke.py``.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(cache_dir: str | None = None) -> str:
    """Enable JAX's persistent compilation cache (idempotent).

    Priority: $JAX_COMPILATION_CACHE_DIR > explicit arg > repo-local
    ``.jax_cache``.  Returns the directory used.
    """
    import jax

    d = (os.environ.get("JAX_COMPILATION_CACHE_DIR") or cache_dir
         or _DEFAULT_DIR)
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d
