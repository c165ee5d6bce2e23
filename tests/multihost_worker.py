"""Worker process for the 2-process CPU-cluster test.

Usage: python multihost_worker.py <coordinator> <n_proc> <pid> <outdir>

Configures a CPU backend with 2 virtual local devices, joins the
cluster via the RAYTRACE_TPU_COORDINATOR env protocol (the same path
the CLI takes), renders this process's row band of the golden scene,
and saves it for the parent test to stitch + compare.
"""

import os
import sys


def main():
    coord, n_proc, pid, outdir = sys.argv[1:5]

    # CPU backend with 2 virtual devices per process — set BEFORE jax
    # is first imported/initialized (conftest does the same dance).
    # The XLA optimization level must MATCH the parent suite's (both at
    # the default here): different levels make different FMA/fusion
    # choices and break the bit-identity assertion against the
    # in-process reference render (observed with opt 0 vs default).
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2").strip()
    # the CLI's env protocol (parallel.mesh.maybe_init_distributed)
    os.environ["RAYTRACE_TPU_COORDINATOR"] = coord
    os.environ["RAYTRACE_TPU_NUM_PROCESSES"] = n_proc
    os.environ["RAYTRACE_TPU_PROCESS_ID"] = pid

    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        # multi-process CPU collectives (not needed by the render path,
        # which is collective-free, but make them real if available)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass

    from raytrace_tpu.parallel.mesh import maybe_init_distributed

    assert maybe_init_distributed()
    assert jax.process_count() == int(n_proc), jax.process_count()

    import numpy as np
    import dataclasses
    import jax.numpy as jnp

    from raytrace_tpu.scene.builder import load_scene_file
    from raytrace_tpu.parallel.multihost import (render_rows_multihost,
                                                 render_to_bmp_multihost)

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "examples", "test_scene.txt")
    base = load_scene_file(golden, dtype=jnp.float32)
    # (9, 7): odd W and H with pad rows — whole-row sharding must
    # render ANY (W, H, process x device) combination (odd strictly
    # generalizes the aligned case, and the single-process odd-geometry
    # test covers more shapes cheaply)
    for w, h in ((9, 7),):
        sc = dataclasses.replace(
            base, spec=dataclasses.replace(base.spec, width=w, height=h))
        row_lo, row_hi, band = render_rows_multihost(sc, seed=3, spp=2)
        np.savez(os.path.join(outdir, f"band_{pid}_{w}x{h}.npz"),
                 row_lo=row_lo, row_hi=row_hi, band=band)

        # and the full BMP pipeline (header + per-host row writes)
        render_to_bmp_multihost(sc, os.path.join(outdir, f"multi_{w}x{h}.bmp"),
                                seed=3, spp=2)
        print(f"worker {pid}: {w}x{h} rows [{row_lo}, {row_hi}) ok",
              flush=True)


if __name__ == "__main__":
    main()
