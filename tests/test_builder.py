"""Scene builder tests (camera constructors camera.rs:51-73, SoA layout)."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytrace_tpu.scene import dsl
from raytrace_tpu.scene.builder import build_scene, camera_look_at, camera_matrix
from raytrace_tpu.scene.schema import (
    MAT_INDIRECT_PHONG, SHAPE_PLANE, SHAPE_SPHERE)

from conftest import GOLDEN_SCENE

REF_SCENE = GOLDEN_SCENE.read_text()


def test_reference_scene_layout():
    sc = build_scene(dsl.parse(REF_SCENE), dtype=jnp.float64)
    assert sc.spec.shape_type == (SHAPE_PLANE,) * 5 + (SHAPE_SPHERE,) * 2
    assert sc.spec.mat_type == (MAT_INDIRECT_PHONG,) * 7
    assert sc.spec.n_lights == 0
    assert sc.spec.antialias == 1024
    # indirect-only scene: no reflect/refract slots compiled
    assert not sc.spec.has_reflect
    assert not sc.spec.has_refract
    assert sc.spec.n_indirect == 1
    np.testing.assert_allclose(np.asarray(sc.data.prim_p[5]), [0, 1.5, 0])
    np.testing.assert_allclose(np.asarray(sc.data.mat_ambient[6]), [5, 5, 5])


def test_camera_new_matrix():
    pos, m = camera_matrix((0, 3, 17), (0, 0, -1), (0, 1, 0), 3.6)
    np.testing.assert_allclose(pos, [0, 3, 17])
    # dir = M @ (x, y, 1): straight ahead = look * im_dist
    np.testing.assert_allclose(m @ [0, 0, 1], [0, 0, -3.6], atol=1e-12)
    # +x in image space = u = unit(cross(look, up)) = (1,0,0)
    np.testing.assert_allclose(m[:, 0], [1, 0, 0], atol=1e-12)
    np.testing.assert_allclose(m[:, 1], [0, 1, 0], atol=1e-12)


def test_camera_look_at():
    # look_at(focus, look, up, pov, h): position = focus - look_unit * h*cot
    pov = np.pi / 2
    pos, m = camera_look_at((0, 0, -5), (0, 0, -1), (0, 1, 0), pov, 2.0)
    cot = 1.0 / np.tan(pov / 2)  # = 1
    np.testing.assert_allclose(pos, [0, 0, -5 + 2 * cot], atol=1e-12)
    np.testing.assert_allclose(m @ [0, 0, 1], [0, 0, -cot], atol=1e-12)


def test_reflect_refract_flags():
    src = """{ objects: [
      { bounds: Sphere { center: (0,0,0) radius: 1 }
        material: TransparentMaterial { specular: rgb(1,1,1) exponent: 1
                                        ior: 1.5 } }
    ]
    lights: [ ]
    camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 1)
    background: SolidColorBackground { color: rgb(0,0,0) }
    options: { width: 1 height: 1 antialias: 1 }
    }"""
    sc = build_scene(dsl.parse(src))
    assert sc.spec.has_reflect
    assert sc.spec.has_refract
    assert sc.spec.n_indirect == 0
    assert sc.spec.children_per_ray == 2


def test_dof_camera_im_dist_cache():
    src = """{ objects: [ ]
    lights: [ ]
    camera: DepthOfFieldCamera new(
        new((0,0,5), (0,0,-1), (0,1,0), 2.5),
        5.0, 0.1, 4)
    background: SolidColorBackground { color: rgb(0,0,0) }
    options: { width: 1 height: 1 antialias: 1 }
    }"""
    sc = build_scene(dsl.parse(src), dtype=jnp.float64)
    # |M @ (0,0,1)| = im_dist (camera.rs:98)
    assert float(sc.data.cam_im_dist) == pytest.approx(2.5)
    assert sc.spec.cam_samples == 4


def test_default_dtype_f32():
    sc = build_scene(dsl.parse(REF_SCENE))
    assert sc.data.prim_p.dtype == jnp.float32
