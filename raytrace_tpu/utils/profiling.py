"""Profiler trace annotations for the render phases (SURVEY.md §5.1).

The reference has no instrumentation at all (its only console output is
parser warnings, serialize.rs:452-456); the framework marks
each pipeline phase with ``jax.named_scope`` so compiled-program
profiles (``--profile`` / ``jax.profiler.trace``) attribute device time
to ray-gen / intersect / shade / background / grad-psum instead of one
opaque fusion blob.  ``named_scope`` is trace-time metadata only — it
adds zero runtime work and composes with jit, shard_map, grad, and
Pallas kernel tracing alike.
"""

from __future__ import annotations

import functools

import jax


def annotate(name: str):
    """Decorator: run the function under ``jax.named_scope(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco
