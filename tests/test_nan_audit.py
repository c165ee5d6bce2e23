"""NaN audit under ``jax_debug_nans`` (SURVEY.md §5.2).

The reference has a latent NaN path — the indirect-specular half-vector
normalizes ``dir - ray.direction`` with the *shadowed* ray, which is 0
when they coincide (raytrace.rs:108,115) — and no sanitizers to catch
it.  This build keeps that path out by construction
(models/materials.py guards every normalize/rsqrt/div with where-traps);
this test turns on JAX's NaN debugger, which re-runs every primitive
un-jitted and raises on any NaN output, and drives the forward render
AND the full scene-parameter gradient over scenes covering all four
materials, all three lights, fan-out, DoF, and skybox.

``jax_debug_nans`` re-executes op-by-op, so this runs on deliberately
tiny lane counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace_tpu.render.integrator import sample_pixels
from raytrace_tpu.scene.builder import load_scene_file

from conftest import GOLDEN_SCENE, repo_path

SCENES = [
    str(GOLDEN_SCENE),      # indirect-only golden
    # all-materials showcase: the slowest eager debug_nans run — slow
    # tier (golden + cornell keep every NaN-prone path reachable fast)
    pytest.param(str(repo_path("examples", "materials_showcase.txt")),
                 marks=pytest.mark.slow),
    # cornell overlaps the golden scene's NaN surface — slow tier
    pytest.param(str(repo_path("examples", "cornell_indirect.txt")),
                 marks=pytest.mark.slow),
]


@pytest.fixture
def debug_nans():
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("scene_file", SCENES)
def test_forward_and_grad_nan_free(debug_nans, scene_file):
    sc = load_scene_file(scene_file, dtype=jnp.float32)
    # depth 2 keeps the eager op-by-op debug_nans run fast while still
    # covering every NaN-prone path (TIR sqrt, Schlick pow, hemisphere
    # normalize, zero-rd dead lanes — all reachable at depth <= 2; both
    # historical gradient NaNs fired at depth 0).  The showcase's
    # fan-out tree grows 2^depth nodes and debug_nans re-executes every
    # primitive eagerly, so the all-materials scene audits at depth 1 —
    # still covering every per-material op plus dead/zero-rd child
    # lanes (spawned at depth 0, shaded at depth 1) at 1/4 the ops.
    depth = 1 if "showcase" in scene_file else 2
    spec = dataclasses.replace(sc.spec, width=8, height=8,
                               max_depth=depth)
    px = jnp.arange(8, dtype=jnp.uint32)
    py = jnp.arange(8, dtype=jnp.uint32) % spec.height
    sids = jnp.arange(2, dtype=jnp.uint32)

    # forward: jax_debug_nans re-runs each primitive eagerly and raises
    # FloatingPointError on the first NaN anywhere in the pipeline
    out = sample_pixels(sc.data, spec, px, py, sids, 3)
    assert np.isfinite(np.asarray(out)).all()

    # backward: every SceneData leaf's gradient must be NaN-free too
    def loss(data):
        return jnp.sum(sample_pixels(data, spec, px, py, sids, 3) ** 2)

    grads = jax.grad(loss)(sc.data)
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()
