"""Full-resolution golden byte-diff against the reference's committed
render ``out.bmp``.

Renders the reference's exact golden workload (800 x 800, 1024 spp,
examples/test_scene.txt) twice with different seeds, sRGB-encodes
both, and byte-diffs (a) ours vs the committed ``out.bmp`` and (b) ours
vs ours.  Acceptance = noise-limited: distribution (a) must match
distribution (b), because the reference's RNG is time-seeded
(main.rs:43) and the scene is lit purely by 1-sample/bounce Monte-Carlo
paths — any unbiased estimator pair at 1024 spp differs by exactly this
much.  Also checks signed regional means (8x8 grid) for systematic bias.

The pytest twin (tests/test_golden.py::test_golden_fullres_bytediff)
runs the same comparisons at reduced spp on the suite's pinned CPU
backend; this script is the full-scale run on a GPU.  ``out.bmp`` is
not in this repository: point ``RAYTRACE_TPU_REFERENCE_DIR`` at a
snapshot of the upstream repository.

Usage: python tools/golden_check.py [spp]   (time: not measured)
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_DIR = os.environ.get("RAYTRACE_TPU_REFERENCE_DIR", "/root/reference")


def main(spp=1024):
    import jax.numpy as jnp
    from raytrace_tpu import color as colorlib
    from raytrace_tpu.io.bmp import read_bmp
    from raytrace_tpu.render.integrator import render_image
    from raytrace_tpu.scene.builder import load_scene_file
    from raytrace_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ref = read_bmp(os.path.join(REFERENCE_DIR, "out.bmp")).astype(np.int32)
    sc = load_scene_file(os.path.join(REPO, "examples", "test_scene.txt"),
                         dtype=jnp.float32)

    def render_bytes(seed):
        img = np.clip(np.asarray(render_image(sc, seed=seed, spp=spp)),
                      0.0, None)
        return np.asarray(colorlib.to_srgb(jnp.asarray(
            img.astype(np.float32)))).astype(np.int32)

    a = render_bytes(0)
    b = render_bytes(7)
    d_ref = np.abs(a - ref)
    d_own = np.abs(a - b)

    def stats(d):
        return {"mean": round(float(d.mean()), 2),
                "p50": int(np.percentile(d, 50)),
                "p99": int(np.percentile(d, 99)),
                "max": int(d.max())}

    signed = (a - ref).astype(np.float64)
    regional = signed.reshape(8, 100, 8, 100, 3).mean((1, 3, 4))
    out = {
        "spp": spp,
        "ref_vs_ours_seed0": stats(d_ref),
        "ours_seed0_vs_seed7": stats(d_own),
        "noise_limited": bool(d_ref.mean() < d_own.mean() * 1.10),
        "regional_bias_max_bytes": round(float(np.abs(regional).max()), 3),
        "unbiased": bool(np.abs(regional).max() < 1.5),
    }
    print(json.dumps(out))
    return 0 if (out["noise_limited"] and out["unbiased"]) else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024))
