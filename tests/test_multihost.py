"""Real multi-process execution: a 2-process CPU cluster
(``jax.distributed.initialize`` local) renders per-host row bands that
stitch BIT-IDENTICALLY to the single-process render (SURVEY.md §5.8).

Each worker subprocess (tests/multihost_worker.py) takes the CLI's own
env bring-up path (RAYTRACE_TPU_COORDINATOR ->
parallel.mesh.maybe_init_distributed), builds global arrays with
``jax.make_array_from_process_local_data``, fetches only its
addressable shards, and writes only its own BMP rows.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import GOLDEN_SCENE, REPO_ROOT


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cluster_bit_identity(tmp_path):
    worker = REPO_ROOT / "tests" / "multihost_worker.py"
    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS",
                        "RAYTRACE_TPU_COORDINATOR",
                        "RAYTRACE_TPU_NUM_PROCESSES",
                        "RAYTRACE_TPU_PROCESS_ID")}
    env["JAX_COMPILATION_CACHE_DIR"] = str(
        REPO_ROOT / ".jax_cache_cpu")
    # plain `python script.py` puts the script dir, not the cwd, on
    # sys.path
    env["PYTHONPATH"] = str(REPO_ROOT)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, "2", str(pid),
             str(tmp_path)],
            cwd=str(REPO_ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"

    from raytrace_tpu.render.integrator import render_image
    from raytrace_tpu.scene.builder import load_scene_file
    from raytrace_tpu import color as colorlib
    from raytrace_tpu.io.bmp import read_bmp

    base = load_scene_file(str(GOLDEN_SCENE),
                           dtype=jnp.float32)
    # (9, 7): odd geometry with pad rows over the 2-process x
    # 2-device mesh (whole-row sharding renders
    # any W, H; odd strictly generalizes aligned)
    for w, h in ((9, 7),):
        # stitch the bands
        bands = {}
        for pid in range(2):
            z = np.load(tmp_path / f"band_{pid}_{w}x{h}.npz")
            bands[int(z["row_lo"])] = (int(z["row_hi"]), z["band"])
        rows = []
        lo = 0
        while lo < h:
            hi, band = bands[lo]
            rows.append(band)
            lo = hi
        stitched = np.concatenate(rows, axis=0)
        assert stitched.shape == (h, w, 3)

        # single-process reference render (this process, CPU mesh)
        sc = dataclasses.replace(
            base, spec=dataclasses.replace(base.spec, width=w, height=h))
        want = render_image(sc, seed=3, spp=2)

        np.testing.assert_array_equal(stitched, want)

        # and the jointly-written BMP equals the single-process encode
        got_bmp = read_bmp(str(tmp_path / f"multi_{w}x{h}.bmp"))
        want_srgb = np.asarray(colorlib.to_srgb(
            jnp.asarray(np.clip(want, 0.0, None), jnp.float32)))
        np.testing.assert_array_equal(got_bmp, want_srgb)


def test_row_aligned_bands_odd_geometry_single_process():
    """Whole-row sharding renders ANY (W, H) over the 8-device mesh —
    no alignment assert is reachable.  The
    single-process band must equal the plain render bit-for-bit."""
    import jax

    from raytrace_tpu.parallel.multihost import render_rows_multihost
    from raytrace_tpu.render.integrator import render_image
    from raytrace_tpu.scene.builder import load_scene_file

    base = load_scene_file(str(GOLDEN_SCENE),
                           dtype=jnp.float32)
    assert jax.device_count() == 8
    # one geometry: each (W, H) is a separate XLA compile, and the
    # 2-process cluster test already covers 9x7
    for w, h in ((5, 3),):
        sc = dataclasses.replace(
            base, spec=dataclasses.replace(base.spec, width=w, height=h))
        row_lo, row_hi, band = render_rows_multihost(sc, seed=5, spp=2)
        assert (row_lo, row_hi) == (0, h)
        want = render_image(sc, seed=5, spp=2)
        np.testing.assert_array_equal(band, want)


def test_barrier_failure_is_hard_error(monkeypatch):
    """A failed cross-process sync must ABORT the shared-BMP write, not
    sleep-and-race it."""
    import jax
    import pytest as _pytest
    from jax.experimental import multihost_utils

    from raytrace_tpu.parallel import multihost

    monkeypatch.setattr(jax, "process_count", lambda: 2)

    def boom(tag):
        raise TimeoutError("coordinator unreachable")

    monkeypatch.setattr(multihost_utils, "sync_global_devices", boom)
    with _pytest.raises(RuntimeError, match="barrier 'bmp_header' failed"):
        multihost._barrier("bmp_header")
