"""Multi-process (multi-host) rendering: the real ≥2-host execution
path (SURVEY.md §5.8).

The reference streams rows to disk as they finish (main.rs:56-58); the
multi-host analog is **per-host row bands**: the image's pixel rows are
split into one contiguous band per process, each band sharded over that
process's local devices on a global ``("host", "dev")`` mesh.  Forward
rendering needs zero cross-host collectives (embarrassingly parallel;
the counter-based RNG keys by *global* pixel identity so the result is
bit-identical to a single-process render), and each host fetches ONLY
its own addressable shards and writes ONLY its own rows into the shared
BMP — host 0 never materializes the full image.

Under multiprocess JAX, plain ``jnp.asarray`` builds process-local
arrays that cannot enter a global computation; every global input here
is built with ``jax.make_array_from_process_local_data`` (pixel ids:
per-band shards; scene leaves: fully replicated).

Bring-up is ``mesh.maybe_init_distributed()`` — called by the CLI and
bench before any jax device query when the env is configured.
Validated by tests/test_multihost.py: a real 2-process CPU cluster
(``jax.distributed.initialize`` local) renders bands that stitch
bit-identically to the single-process render.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from raytrace_tpu.parallel.mesh import make_mesh_2d
from raytrace_tpu.scene.schema import Scene, SceneData


def replicate_to_mesh(data: SceneData, mesh) -> SceneData:
    """SceneData leaves as fully-replicated GLOBAL arrays on the mesh —
    every process supplies its (identical) local copy."""
    sharding = NamedSharding(mesh, P())

    def rep(x):
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(x))

    return jax.tree.map(rep, data)


def render_rows_multihost(scene: Scene, *, seed: int = 0,
                          spp: int | None = None, mesh=None,
                          max_lanes: int = 1 << 22,
                          progress=None) -> tuple[int, int, np.ndarray]:
    """Render THIS process's row band of the full image.

    Returns ``(row_lo, row_hi, band)`` where ``band`` is the
    ``(row_hi - row_lo, W, 3)`` f64 linear-radiance rows (row 0 of the
    image = bottom, BMP order).  All processes must call this
    collectively (it launches a global computation over the full mesh).

    Partitioning is by WHOLE image rows: the
    row axis is padded up to a device-count multiple and each device
    renders a contiguous band of ``rows_pad / n_dev`` rows, so every
    ``(W, H, process x device)`` combination renders — the reference
    accepts any ``Options {width, height}`` (main.rs:39-59,
    scene.rs:191-198).  Pad rows re-render the image's top row (their
    RNG identity equals the real row's, so real rows stay bit-identical
    to the single-process render) and are discarded at the trim below.
    """
    from raytrace_tpu.render.integrator import (_render_chunks,
                                                _retry_launch,
                                                _s_p_launch,
                                                _wavefront_widest)

    data, spec = scene.data, scene.spec
    mesh = mesh if mesh is not None else make_mesh_2d()
    n_proc = max(jax.process_count(), 1)
    pid = jax.process_index()
    w, h = spec.width, spec.height
    aa = spp if spp is not None else max(spec.antialias, 1)

    axes = mesh.axis_names
    n_dev = int(np.prod(list(mesh.shape.values())))
    n_local = n_dev // n_proc

    # row axis padded to the device count, one contiguous row band per
    # device => per-process band = its devices' bands (device order
    # within the mesh is process-major, the make_mesh_2d layout)
    rows_per_dev = -(-h // n_dev)
    rows_pad = rows_per_dev * n_dev
    n_tot = rows_pad * w
    lo_row = pid * n_local * rows_per_dev
    hi_row = (pid + 1) * n_local * rows_per_dev
    lo_px, hi_px = lo_row * w, hi_row * w

    lane = np.arange(lo_px, hi_px, dtype=np.uint32)
    # pad rows (row >= h) re-render the top row; trimmed before return
    py_l = np.minimum(lane // w, h - 1).astype(np.uint32)
    px_l = (lane % w).astype(np.uint32)

    sharding = NamedSharding(mesh, P(axes))

    def globalize(arr):
        return jax.make_array_from_process_local_data(
            sharding, arr, global_shape=(n_tot,))

    px_g = globalize(px_l)
    py_g = globalize(py_l)
    data_g = replicate_to_mesh(data, mesh)

    # per-device lane budget -> (samples, pixels) per launch; the
    # in-jit chunk loop accumulates on device (integrator._render_chunks)
    # and itself tiles its shard into p_local-pixel launches, so the
    # per-device pixel tile must respect the budget too
    s_launch, p_budget = _s_p_launch(spec, aa, max_lanes,
                                     _wavefront_widest(spec))
    p_local = max(min(n_tot // n_dev, p_budget), 1)

    @partial(jax.jit, static_argnames=("s_launch", "n_chunks"))
    def launch(data, px, py, s0, s_launch, n_chunks):
        def local(data, px, py, s0):
            return _render_chunks(data, spec, px, py, s0, s_launch,
                                  n_chunks, seed, p_local)
        return shard_map(local, mesh=mesh,
                         in_specs=(P(), P(axes), P(axes), P()),
                         out_specs=P(axes))(data, px, py, s0)

    band = np.zeros((hi_px - lo_px, 3), np.float64)
    s0 = 0
    while s0 < aa:
        rem = aa - s0
        sl = s_launch if rem >= s_launch else rem
        g = max(rem // sl, 1) if sl == s_launch else 1
        g = min(g, 32)
        out = _retry_launch(launch, data_g, px_g, py_g, jnp.uint32(s0),
                            sl, g)
        n_s = g * sl
        # fetch ONLY this process's shards (host 0 never sees the rest)
        for shard in out.addressable_shards:
            (sl_rows, _) = shard.index
            a = sl_rows.start or 0
            band[a - lo_px: a - lo_px + shard.data.shape[0]] += (
                np.asarray(shard.data, np.float64) * (n_s / aa))
        s0 += n_s
        if progress is not None:
            progress(s0 / aa)

    # trim the pad rows off this process's band (a process entirely in
    # pad territory returns an empty 0-row band)
    row_lo = min(lo_row, h)
    row_hi = min(hi_row, h)
    band = band[: (row_hi - row_lo) * w]
    return row_lo, row_hi, band.reshape(-1, w, 3)


def write_bmp_band(path: str, width: int, height: int, row_lo: int,
                   band_srgb: np.ndarray) -> None:
    """Write this host's rows into the shared BMP at their byte offset
    (the multi-host analog of main.rs:56-58 row streaming).  Process 0
    must have created the file with the header first (or any process
    may, via ``ensure_bmp_file``)."""
    from raytrace_tpu.io import bmp

    stride = bmp.row_stride(width)
    rows = bmp.encode_rows(band_srgb)
    with open(path, "r+b") as f:
        f.seek(122 + row_lo * stride)
        f.write(rows.tobytes())


def ensure_bmp_file(path: str, width: int, height: int) -> None:
    """Create (or truncate) the BMP with its header and a zeroed pixel
    array, sized for the full image."""
    from raytrace_tpu.io import bmp

    stride = bmp.row_stride(width)
    with open(path, "wb") as f:
        f.write(bmp.header(width, height))
        f.truncate(122 + stride * height)


def render_to_bmp_multihost(scene: Scene, path: str, *, seed: int = 0,
                            spp: int | None = None,
                            max_lanes: int = 1 << 22,
                            progress=None) -> None:
    """Full multi-host pipeline: collective render, per-host sRGB encode
    + row-band write.  Requires ``path`` on a filesystem shared by all
    hosts (single-host multi-process: trivially true)."""
    from raytrace_tpu import color as colorlib

    spec = scene.spec
    row_lo, row_hi, band = render_rows_multihost(
        scene, seed=seed, spp=spp, max_lanes=max_lanes, progress=progress)
    if jax.process_index() == 0:
        ensure_bmp_file(path, spec.width, spec.height)
    # all hosts wait for the file to exist before seeking into it
    _barrier("bmp_header")
    srgb = np.asarray(colorlib.to_srgb(
        jnp.asarray(np.clip(band, 0.0, None), jnp.float32)))
    write_bmp_band(path, spec.width, spec.height, row_lo, srgb)
    _barrier("bmp_rows")


def _barrier(tag: str) -> None:
    """Cross-process sync via the distributed KV store (no device
    collective — works on any backend).

    A failed sync is a HARD error: the barrier protects the shared-BMP
    write protocol (header must exist before any host seeks into the
    file; all rows must land before anyone reads the result), and
    proceeding on a best-effort sleep would race the header write and
    corrupt the very file the barrier exists to protect.  Callers that cannot sync must not write.
    """
    if jax.process_count() <= 1:
        return
    try:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)
    except Exception as e:
        raise RuntimeError(
            f"multi-host barrier '{tag}' failed; aborting the shared-BMP "
            f"write rather than racing it (every process must reach this "
            f"barrier for the write protocol to be safe)") from e
