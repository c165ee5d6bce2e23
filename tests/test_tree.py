"""DFS tree-walk radiance (integrator.radiance_tree_v): the
shape-agnostic fan-out form a fused fan-out kernel would trace.  Fan-out
scenes render through the XLA wavefront (radiance_v).

Correctness contract: the tree walk visits the same virtual-compacted
child set with the same RNG stream identities as the wavefront
``radiance_v`` (tested against the scalar oracle elsewhere); only the
floating-point accumulation order differs, so f64 agreement must be at
roundoff level.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from raytrace_tpu.render import megakernel
from raytrace_tpu.render.integrator import (primary_rays, radiance_tree_v,
                                            radiance_v, sample_pixels,
                                            tree_nodes)
from raytrace_tpu.scene.builder import load_scene_file

from conftest import repo_path

SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))
CORNELL = str(repo_path("examples", "cornell_indirect.txt"))


def _lanes(spec, n, seed=3):
    r = np.random.RandomState(seed)
    pix = jnp.asarray(r.randint(0, spec.width, n), jnp.uint32)
    piy = jnp.asarray(r.randint(0, spec.height, n), jnp.uint32)
    aa = jnp.asarray(r.randint(0, 4, n), jnp.uint32)
    cam = jnp.asarray(r.randint(0, spec.cam_samples, n), jnp.uint32)
    return pix, piy, aa, cam


def _depth(sc, d):
    return dataclasses.replace(
        sc, spec=dataclasses.replace(sc.spec, max_depth=d))


@pytest.mark.slow
@pytest.mark.parametrize("scene_file", [SHOWCASE, CORNELL])
def test_tree_matches_wavefront_f64(scene_file):
    """DFS tree == lane-compacted wavefront at f64 roundoff, across all
    four materials, three light models, DoF camera, fan-out B=4/m=2
    (materials_showcase) and the linear golden-style chain (cornell).
    Fast tier: depth 2 (15-node trace); the full-depth trace is the
    @slow variant below."""
    sc = _depth(load_scene_file(scene_file, dtype=jnp.float64), 2)
    pix, piy, aa, cam = _lanes(sc.spec, 512)
    ro, rd, k1, k2 = primary_rays(sc.data, sc.spec, pix, piy, aa, cam, 5)
    want = radiance_v(sc.data, sc.spec, ro, rd, k1, k2)
    got = radiance_tree_v(sc.data, sc.spec, ro, rd, k1, k2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.slow
@pytest.mark.parametrize("scene_file", [SHOWCASE, CORNELL])
def test_tree_matches_wavefront_f64_full_depth(scene_file):
    """Full-depth (max_depth=4, 63-node) variant — minutes of cold XLA
    compile, so slow-tier only."""
    sc = load_scene_file(scene_file, dtype=jnp.float64)
    pix, piy, aa, cam = _lanes(sc.spec, 512)
    ro, rd, k1, k2 = primary_rays(sc.data, sc.spec, pix, piy, aa, cam, 5)
    want = radiance_v(sc.data, sc.spec, ro, rd, k1, k2)
    got = radiance_tree_v(sc.data, sc.spec, ro, rd, k1, k2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-12, atol=1e-14)


def test_tree_nodes_counts():
    sc = load_scene_file(SHOWCASE)
    assert sc.spec.children_per_ray == 4
    assert sc.spec.max_live_children == 2
    assert tree_nodes(sc.spec) == 63          # sum_{d=0}^{5} 2^d
    lin = load_scene_file(CORNELL)
    assert tree_nodes(lin.spec) == 6          # m=1: one node per level


def test_megakernel_fanout_usable(monkeypatch):
    """Fan-out scenes are outside the fused kernel's regime: even on a
    GPU backend they render through the XLA wavefront — sample_pixels
    never launches the kernel for them."""
    import jax

    sc = load_scene_file(SHOWCASE, dtype=jnp.float32)
    assert sc.spec.children_per_ray > 1
    assert not megakernel.fits(sc.spec, jnp.float32)
    monkeypatch.setattr(megakernel.jax, "default_backend", lambda: "gpu")
    assert not megakernel.usable(sc.data, sc.spec)
    calls = []
    monkeypatch.setattr(megakernel, "radiance_lanes",
                        lambda *a, **k: calls.append(a))
    px = jnp.arange(4, dtype=jnp.uint32)
    sids = jnp.arange(1, dtype=jnp.uint32)
    jax.make_jaxpr(lambda d: sample_pixels(d, sc.spec, px, px, sids, 3))(
        sc.data)
    assert calls == []
