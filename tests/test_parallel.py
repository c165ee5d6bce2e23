"""Sharding correctness on the 8-virtual-device CPU mesh (SURVEY.md §4):
tile-sharded render must equal the single-device render bit-for-bit, and
psum'd sharded gradients must equal unsharded gradients.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from raytrace_tpu.scene import dsl
from raytrace_tpu.scene.builder import build_scene
from raytrace_tpu.render.integrator import render_image, sample_pixels
from raytrace_tpu.parallel.mesh import make_mesh, make_mesh_2d
from raytrace_tpu.parallel.tile import render_image_sharded
from raytrace_tpu.optim import loss_and_grad, make_sharded_step

from conftest import GOLDEN_SCENE

REF_SCENE = GOLDEN_SCENE.read_text()


def _scene(w=16, h=16, dtype=jnp.float64):
    sc = build_scene(dsl.parse(REF_SCENE), dtype=dtype)
    return dataclasses.replace(
        sc, spec=dataclasses.replace(sc.spec, width=w, height=h))


@pytest.mark.slow
def test_sharded_render_bit_identical():
    sc = _scene()
    a = render_image(sc, seed=5, spp=4)
    b = render_image_sharded(sc, seed=5, spp=4)
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_sharded_render_2d_mesh():
    # [slow tier — fast twin: test_sharded_render_nondivisible_pixels
    # covers the sharded launch on the flat mesh]
    sc = _scene()
    mesh = make_mesh_2d(n_host=2)
    assert dict(mesh.shape) == {"host": 2, "dev": 4}
    a = render_image(sc, seed=9, spp=2)
    b = render_image_sharded(sc, seed=9, spp=2, mesh=mesh)
    np.testing.assert_array_equal(a, b)


def test_sharded_render_nondivisible_pixels():
    # 5x5 = 25 pixels over 8 devices: padding path
    sc = _scene(5, 5)
    a = render_image(sc, seed=2, spp=2)
    b = render_image_sharded(sc, seed=2, spp=2)
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_sharded_grads_match_psum():
    # max_depth=1 keeps grad-sync semantics while cutting the unrolled
    # program (and its shard_map-AD compile, the suite's worst cost) 3x
    sc = _scene(8, 4)
    sc = dataclasses.replace(
        sc, spec=dataclasses.replace(sc.spec, max_depth=1))
    w, h = sc.spec.width, sc.spec.height
    pix = np.arange(w * h, dtype=np.uint32)
    px = jnp.asarray(pix % w)
    py = jnp.asarray(pix // w)
    sids = jnp.arange(2, dtype=jnp.uint32)
    target = jnp.zeros((w * h, 3), jnp.float64)

    loss0, g0 = loss_and_grad(sc.data, sc.spec, px, py, sids,
                              jnp.uint32(3), target)

    mesh = make_mesh()
    step = make_sharded_step(sc.spec, mesh, seed=3)
    loss1, g1 = step(sc.data, px, py, sids, target)

    np.testing.assert_allclose(float(loss0), float(loss1), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-10)


def test_mesh_shapes():
    m = make_mesh()
    assert m.devices.shape == (8,)
    m2 = make_mesh_2d(n_host=4)
    assert dict(m2.shape) == {"host": 4, "dev": 2}


def test_sharded_render_large_scene_scan_path():
    """Tile-sharded render of a > LARGE_SCENE_THRESHOLD scene — the
    lax.scan closest-hit running inside shard_map.  Regression: the
    scan-carry inits were replicated constants, which mismatch the
    mesh-varying carry type under shard_map (vma)."""
    from raytrace_tpu.scene.procedural import make_sphere_field

    sc = make_sphere_field(80, width=16, height=16, dtype=jnp.float32)
    # depth 1 keeps the vma-regression coverage (the scan carry appears
    # at every level identically) at 1/2 the traced program
    sc = dataclasses.replace(
        sc, spec=dataclasses.replace(sc.spec, max_depth=1))
    assert sc.spec.n_objects > 64
    a = render_image(sc, seed=2, spp=2)
    b = render_image_sharded(sc, seed=2, spp=2)
    np.testing.assert_array_equal(a, b)
