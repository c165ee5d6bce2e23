"""Wavefront integrator vs scalar recursive oracle (double-entry test).

Every scene below is rendered twice in f64: once by the wavefront level
loop (the production path) and once by the per-ray recursive oracle in
``ref_scalar.py`` written directly from raytrace.rs.  Both consume the
same counter-based RNG streams, so agreement is exact up to float
reassociation — this pins the recursion→wavefront restructuring and all
four material semantics without Monte-Carlo statistics.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from raytrace_tpu.scene import dsl
from raytrace_tpu.scene.builder import build_scene
from raytrace_tpu.scene.schema import BG_SKYBOX
from raytrace_tpu.render.integrator import render_image

import ref_scalar

from conftest import GOLDEN_SCENE, repo_path

REF_SCENE = GOLDEN_SCENE.read_text()


def _small(scene_src: str, w=6, h=6):
    sc = build_scene(dsl.parse(scene_src), dtype=jnp.float64)
    sc = dataclasses.replace(
        sc, spec=dataclasses.replace(sc.spec, width=w, height=h))
    return sc


def _compare(sc, spp=2, seed=7, atol=1e-9):
    img = render_image(sc, seed=seed, spp=spp)
    aa_ids = list(range(spp))
    for py in range(sc.spec.height):
        for px in range(sc.spec.width):
            want = ref_scalar.render_pixel(sc.data, sc.spec, px, py,
                                           aa_ids, seed)
            got = img[py, px]
            np.testing.assert_allclose(
                got, want, atol=atol, rtol=1e-7,
                err_msg=f"pixel ({px},{py})")


def test_golden_scene_indirect():
    sc = _small(REF_SCENE)
    _compare(sc)


PHONG_LIGHTS = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.7, 0.6, 0.5)
        specular: rgb(0.1, 0.1, 0.1) exponent: 16 ambient: rgb(0.02,0.02,0.02) } }
    { bounds: Sphere { center: (0, 0, -4) radius: 1 }
      material: PhongMaterial { diffuse: rgb(0.8, 0.2, 0.2)
        specular: rgb(0.4, 0.4, 0.4) exponent: 32 ambient: rgb(0,0,0) } }
    { bounds: Sphere { center: (1.5, 0.5, -5) radius: 0.7 }
      material: PhongMaterial { diffuse: rgb(0.2, 0.8, 0.3)
        specular: rgb(0,0,0) exponent: 1 ambient: rgb(0,0,0) } }
  ]
  lights: [
    { model: PointLight { location: (2, 4, -2) } color: rgb(1.5, 1.4, 1.2) }
    { model: DirectionalLight { direction: (-1, -2, -1) } color: rgb(0.3,0.3,0.4) }
    { model: AreaLight { origin: (-2, 4, -3) side1: (1, 0, 0)
        side2: (0, 0, 1) } color: rgb(0.8, 0.8, 0.8) }
  ]
  camera: SimplePerspectiveCamera new((0, 0.5, 1), (0, -0.1, -1), (0, 1, 0), 1.8)
  background: SolidColorBackground { color: rgb(0.1, 0.15, 0.2) }
  options: { width: 6 height: 6 antialias: 1 }
}"""


def test_phong_three_light_models():
    _compare(_small(PHONG_LIGHTS))


FRESNEL = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.5,0.5,0.5) specular: rgb(0,0,0)
        exponent: 1 ambient: rgb(0.05,0.05,0.05) } }
    { bounds: Sphere { center: (0, 0, -4) radius: 1 }
      material: FresnelMaterial { diffuse: rgb(0.1, 0.1, 0.4)
        specular: rgb(0.9, 0.9, 0.9) exponent: 64 ambient: rgb(0,0,0)
        ior: 1.5 } }
  ]
  lights: [
    { model: PointLight { location: (3, 3, -1) } color: rgb(1, 1, 1) }
  ]
  camera: SimplePerspectiveCamera new((0, 0.3, 0), (0, 0, -1), (0, 1, 0), 2)
  background: SolidColorBackground { color: rgb(0.2, 0.25, 0.3) }
  options: { width: 6 height: 6 antialias: 1 }
}"""


def test_fresnel_reflection():
    _compare(_small(FRESNEL))


TRANSPARENT = """{
  objects: [
    { bounds: Plane { point: (0, -1.2, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.6,0.4,0.3) specular: rgb(0,0,0)
        exponent: 1 ambient: rgb(0.05,0.03,0.02) } }
    { bounds: Sphere { center: (0, 0, -3.5) radius: 1 }
      material: TransparentMaterial { specular: rgb(0.9, 0.9, 0.9)
        exponent: 64 ior: 1.5 } }
  ]
  lights: [
    { model: PointLight { location: (-2, 3, -1) } color: rgb(1.2, 1.2, 1.2) }
  ]
  camera: SimplePerspectiveCamera new((0, 0, 0), (0, 0, -1), (0, 1, 0), 2)
  background: SolidColorBackground { color: rgb(0.3, 0.35, 0.45) }
  options: { width: 6 height: 6 antialias: 1 }
}"""


def test_transparent_refraction():
    _compare(_small(TRANSPARENT))


def test_depth_of_field_camera():
    src = TRANSPARENT.replace(
        "SimplePerspectiveCamera new((0, 0, 0), (0, 0, -1), (0, 1, 0), 2)",
        "DepthOfFieldCamera new(new((0, 0, 0), (0, 0, -1), (0, 1, 0), 2),"
        " 3.5, 0.2, 3)")
    sc = _small(src)
    assert sc.spec.cam_samples == 3
    _compare(sc)


@pytest.mark.slow
def test_compaction_bit_identical(monkeypatch):
    """Wavefront compaction (B slots -> m live lanes per parent) must
    not change a single bit: RNG keys are derived pre-compaction and
    the child gates are material-exclusive."""
    from raytrace_tpu.render.integrator import sample_pixels
    from raytrace_tpu.scene import dsl as _dsl
    from raytrace_tpu.scene.builder import build_scene as _build

    src = repo_path("examples", "materials_showcase.txt").read_text()
    sc = _build(_dsl.parse(src), dtype=jnp.float64)
    sc = dataclasses.replace(
        sc, spec=dataclasses.replace(sc.spec, max_depth=2))
    assert sc.spec.children_per_ray > sc.spec.max_live_children > 0
    w, h = sc.spec.width, sc.spec.height
    pix = np.arange(0, w * h, 971, dtype=np.uint32)
    px, py = jnp.asarray(pix % w), jnp.asarray(pix // w)
    sids = jnp.arange(1, dtype=jnp.uint32)

    a = np.asarray(sample_pixels(sc.data, sc.spec, px, py, sids, 11))
    monkeypatch.setenv("RAYTRACE_TPU_NO_COMPACTION", "1")
    b = np.asarray(sample_pixels(sc.data, sc.spec, px, py, sids, 11))
    np.testing.assert_array_equal(a, b)


def test_skybox_background():
    # synthetic 3x5 / 4x4 faces injected directly into the scene pytree
    sc = _small(FRESNEL)
    rng_np = np.random.RandomState(0)
    sizes = ((3, 5), (4, 4), (2, 2), (4, 3), (3, 3), (5, 5))
    hmax = max(s[0] for s in sizes)
    wmax = max(s[1] for s in sizes)
    cube = np.zeros((6, hmax, wmax, 3))
    for i, (h, w) in enumerate(sizes):
        cube[i, :h, :w] = rng_np.rand(h, w, 3)
    sc = dataclasses.replace(
        sc,
        data=dataclasses.replace(sc.data, bg_cube=jnp.asarray(cube)),
        spec=dataclasses.replace(sc.spec, bg_type=BG_SKYBOX,
                                 face_sizes=sizes))
    _compare(sc)


def test_mixed_materials_one_scene():
    src = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: IndirectPhongMaterial { diffuse: rgb(0.7,0.7,0.7)
        specular: rgb(0,0,0) exponent: 1 ambient: rgb(0,0,0) samples: 2 } }
    { bounds: Sphere { center: (-1, 0, -4) radius: 0.8 }
      material: FresnelMaterial { diffuse: rgb(0.2,0.2,0.5)
        specular: rgb(0.8,0.8,0.8) exponent: 32 ambient: rgb(0,0,0) ior: 1.4 } }
    { bounds: Sphere { center: (1, 0, -4) radius: 0.8 }
      material: TransparentMaterial { specular: rgb(0.9,0.9,0.9)
        exponent: 32 ior: 1.5 } }
    { bounds: Sphere { center: (0, 1.5, -5) radius: 0.6 }
      material: PhongMaterial { diffuse: rgb(0.9,0.6,0.1)
        specular: rgb(0.3,0.3,0.3) exponent: 8 ambient: rgb(0.4,0.3,0.1) } }
  ]
  lights: [
    { model: PointLight { location: (0, 4, -2) } color: rgb(1, 1, 1) }
  ]
  camera: SimplePerspectiveCamera new((0, 0.5, 0), (0, 0, -1), (0, 1, 0), 1.5)
  background: SolidColorBackground { color: rgb(0.15, 0.18, 0.22) }
  options: { width: 6 height: 6 antialias: 1 }
}"""
    sc = _small(src)
    assert sc.spec.has_reflect and sc.spec.has_refract
    assert sc.spec.n_indirect == 2
    assert sc.spec.children_per_ray == 4
    _compare(sc)


def test_f32_close_to_f64_oracle():
    # production dtype sanity: f32 render within loose tolerance of oracle
    sc64 = _small(PHONG_LIGHTS)
    sc32 = build_scene(dsl.parse(PHONG_LIGHTS), dtype=jnp.float32)
    sc32 = dataclasses.replace(
        sc32, spec=dataclasses.replace(sc32.spec, width=6, height=6))
    img32 = render_image(sc32, seed=3, spp=2)
    for py in range(6):
        for px in range(6):
            want = ref_scalar.render_pixel(sc64.data, sc64.spec, px, py,
                                           [0, 1], 3)
            np.testing.assert_allclose(img32[py, px], want, atol=2e-3,
                                       rtol=2e-3, err_msg=f"({px},{py})")


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A kill mid-write must leave the previous resume file valid: the
    writer goes through a temp file + os.replace."""
    from raytrace_tpu.render import integrator

    ck = str(tmp_path / "state.npz")
    img = np.arange(12, dtype=np.float64).reshape(4, 3)
    integrator._save_checkpoint(ck, image=img, s_done=7)
    before = np.load(ck)
    np.testing.assert_array_equal(before["image"], img)
    assert int(before["s_done"]) == 7

    real_savez = np.savez

    def dying_savez(path, **arrays):
        # simulate a kill partway through serialization: some bytes of
        # the temp file land on disk, then the process "dies"
        with open(path if isinstance(path, str) else path, "wb") as f:
            f.write(b"\x00partial")
        raise KeyboardInterrupt  # stand-in for SIGKILL

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        integrator._save_checkpoint(ck, image=img * 2, s_done=9)
    monkeypatch.setattr(np, "savez", real_savez)

    after = np.load(ck)  # still loadable, still the OLD state
    np.testing.assert_array_equal(after["image"], img)
    assert int(after["s_done"]) == 7


def test_retry_launch_transient_then_success():
    """Tile-level retry (SURVEY.md §5.3): a launch that dies with a
    transient runtime error is re-issued; the retried result is used.
    Programming errors are NOT retried."""
    import jax

    from raytrace_tpu.render.integrator import _retry_launch

    calls = {"n": 0}
    err_cls = getattr(jax.errors, "JaxRuntimeError", RuntimeError)

    def flaky(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise err_cls("transient device failure")
        return x + 1

    assert int(_retry_launch(flaky, jnp.int32(41))) == 42
    assert calls["n"] == 2

    def broken(x):
        raise ValueError("programming error")

    with pytest.raises(ValueError):
        _retry_launch(broken, jnp.int32(0))

    def always_down(x):
        raise err_cls("still down")

    with pytest.raises(err_cls):
        _retry_launch(always_down, jnp.int32(0), retries=1)
