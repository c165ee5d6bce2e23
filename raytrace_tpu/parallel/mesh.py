"""Device mesh construction.

One logical axis family for this workload (SURVEY.md §5.7-5.8):

* ``"d"`` — the ray/pixel data axis, sharded over every device.  The
  cards of one host are joined all to all, so the mesh follows the
  algorithm alone; multi-process row bands use a 2-level
  ``("host", "dev")`` mesh (process x local device).
* ``"p"`` — optional primitive axis for ring-sharded intersection of
  huge scenes (parallel/ring.py).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bring-up (SURVEY.md §5.8): ``jax.distributed
    .initialize`` with standard env-based auto-detection.

    Idempotent: repeated calls are ignored.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        pass  # already initialized (or single-process backend)


def maybe_init_distributed() -> bool:
    """Initialize multi-process JAX iff the environment asks for it —
    called by the CLI and bench BEFORE any device query.

    The trigger is an explicit cluster spec: ``RAYTRACE_TPU_COORDINATOR``
    (``host:port``) with ``RAYTRACE_TPU_NUM_PROCESSES`` and
    ``RAYTRACE_TPU_PROCESS_ID`` — the 2-process CPU-cluster test drives
    this path.  Returns True when an initialization was attempted.
    """
    import os

    coord = os.environ.get("RAYTRACE_TPU_COORDINATOR")
    if coord:
        init_distributed(
            coordinator=coord,
            num_processes=int(os.environ["RAYTRACE_TPU_NUM_PROCESSES"]),
            process_id=int(os.environ["RAYTRACE_TPU_PROCESS_ID"]))
        return True
    return False


def make_mesh(devices=None, axis_name: str = "d") -> Mesh:
    """Flat 1-D mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(n_host: int | None = None, devices=None) -> Mesh:
    """Two-level ("host", "dev") mesh: outer axis across processes,
    inner axis across each process's local devices (process-major, the
    layout of the multi-process row bands, parallel/multihost.py).

    ``n_host`` defaults to the process count (1 when single-process).
    """
    devices = jax.devices() if devices is None else devices
    if n_host is None:
        n_host = max(jax.process_count(), 1)
    n = len(devices)
    assert n % n_host == 0, (n, n_host)
    arr = np.asarray(devices).reshape(n_host, n // n_host)
    return Mesh(arr, ("host", "dev"))
