"""Statistical golden-image parity vs the reference's committed render.

The reference's RNG is time-seeded (main.rs:43), so bitwise parity with
``out.bmp`` is impossible by construction; the meaningful contract
(SURVEY.md §4) is *statistical*: our Monte-Carlo estimator must converge
to the same image.  We render the golden scene at reduced resolution and
compare block means against the downsampled golden image within the MC
error budget.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest

from raytrace_tpu import color as colorlib
from raytrace_tpu.io.bmp import read_bmp
from raytrace_tpu.render.integrator import render_image
from raytrace_tpu.scene import dsl
from raytrace_tpu.scene.builder import build_scene

from conftest import GOLDEN_SCENE, reference_path

GOLDEN = str(reference_path("out.bmp"))
REF_SCENE = GOLDEN_SCENE.read_text()


@pytest.mark.slow
def test_golden_statistical_parity():
    # golden: 800x800 sRGB -> linear -> 16x16 block means => (50,50)
    ref = read_bmp(GOLDEN)
    ref_lin = colorlib.SRGB_VALUES[ref]
    ref_ds = ref_lin.reshape(50, 16, 50, 16, 3).mean((1, 3))

    sc = build_scene(dsl.parse(REF_SCENE), dtype=jnp.float32)
    sc = dataclasses.replace(
        sc, spec=dataclasses.replace(sc.spec, width=50, height=50))
    ours = np.clip(np.asarray(render_image(sc, seed=11, spp=512)), 0, 1)
    ours2 = np.clip(np.asarray(render_image(sc, seed=77, spp=512)), 0, 1)

    # compare in tone-mapped space (the emitter is unbounded linear; the
    # golden artifact clips at sRGB 255 = linear 1.0)
    ref_c = np.clip(ref_ds, 0, 1)

    # noise-limited: the distance to the golden image must not exceed
    # the distance between two of our own renders with different seeds
    # (x1.15 slack) — i.e. all remaining error is Monte-Carlo variance
    noise_floor = np.abs(ours - ours2).mean()
    assert np.abs(ours - ref_c).mean() < noise_floor * 1.15, (
        np.abs(ours - ref_c).mean(), noise_floor)

    # unbiased: per-channel and global means converge to the golden's
    assert np.abs((ours - ref_c).mean((0, 1))).max() < 0.01
    assert abs(ours.mean() - ref_c.mean()) < 0.005

    # structural checks on exact features
    # bottom-left quadrant wall is red-dominant, bottom-right green-dominant
    left = ours[10:40, 2:8].mean((0, 1))
    right = ours[10:40, 42:48].mean((0, 1))
    assert left[0] > left[1] * 1.5, left
    assert right[1] > right[0] * 1.5, right
    # emitter cap: the clipped-bright plateau makes argmax noisy, so
    # compare the *centroid* of the top-2% brightest pixels instead
    def bright_centroid(im):
        g = im.mean(-1)
        thresh = np.percentile(g, 98)
        ys, xs = np.nonzero(g >= thresh)
        return ys.mean(), xs.mean()

    (ry, rx), (oy, ox) = bright_centroid(ref_c), bright_centroid(ours)
    assert abs(ry - oy) <= 2.5, (ry, oy)
    assert abs(rx - ox) <= 2.5, (rx, ox)


@pytest.mark.slow
def test_golden_fullres_bytediff():
    """The repo's flagship acceptance artifact, automated: render the
    FULL golden config (800 x 800, 1024 spp by default) and byte-diff
    the sRGB output against the reference's committed ``out.bmp``.

    The reference RNG is time-seeded (main.rs:43) so bitwise equality is
    impossible; the acceptance criterion is *noise-limited*: the byte
    distance to the golden image must match the distance between two of
    our own independent renders (different seeds) — i.e. every remaining
    byte of difference is Monte-Carlo variance, not bias.

    The test suite runs on the pinned CPU backend (conftest.py), where
    the full 1024 spp would take hours — the suite default is 48 spp
    (the noise-limited criterion is spp-invariant: both our renders AND
    the noise floor scale together).  ``RAYTRACE_TPU_GOLDEN_SPP``
    overrides; the full-1024-spp record is produced by
    ``tools/golden_check.py`` (same comparisons, on a GPU).
    """
    spp = int(os.environ.get("RAYTRACE_TPU_GOLDEN_SPP", "48"))
    ref = read_bmp(GOLDEN).astype(np.int32)          # (800, 800, 3) sRGB

    sc = build_scene(dsl.parse(REF_SCENE), dtype=jnp.float32)
    assert (sc.spec.width, sc.spec.height) == (800, 800)

    def render_bytes(seed):
        img = np.clip(np.asarray(render_image(sc, seed=seed, spp=spp)),
                      0.0, None)
        srgb = np.asarray(colorlib.to_srgb(jnp.asarray(
            img.astype(np.float32))))
        return srgb.astype(np.int32)

    ours_a = render_bytes(seed=0)
    ours_b = render_bytes(seed=7)

    d_ref = np.abs(ours_a - ref)
    d_own = np.abs(ours_a - ours_b)

    # noise-limited: indistinguishable from our own seed-to-seed noise
    assert d_ref.mean() < d_own.mean() * 1.10, (d_ref.mean(), d_own.mean())
    assert np.percentile(d_ref, 99) <= np.percentile(d_own, 99) * 1.25

    # absolute caps (PERF.md's measured values +25% headroom at 1024spp)
    if spp >= 256:
        scale = (1024 / spp) ** 0.5   # MC noise ~ 1/sqrt(spp)
        assert d_ref.mean() < 13.5 * scale, d_ref.mean()

    # unbiased: signed regional means vanish on an 8x8 grid.  The cap
    # scales with per-pixel MC noise (~ 1/sqrt(spp)): the fixed 1.5 at
    # 1024 spp left <1-sigma headroom at low spp (regional sigma at 48
    # spp is ~0.45 over 100*100*3 samples -> max over 64 regions ~1.3)
    signed = (ours_a - ref).astype(np.float64)
    regional = signed.reshape(8, 100, 8, 100, 3).mean((1, 3, 4))
    cap = 1.5 * max(1.0, (1024 / spp) ** 0.5 * 0.75)
    assert np.abs(regional).max() < cap, (np.abs(regional).max(), cap)
