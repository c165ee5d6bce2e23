"""Fused render kernel: parity with the jnp path in interpret mode, the
launch wrapper (block padding, packed parameters), the kernel choice per
backend and regime, the gradient rule, and the kernel's lowering to
Triton for the GPU."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytrace_tpu.render import megakernel
from raytrace_tpu.render.integrator import (primary_rays, radiance_linear_v,
                                            sample_pixels)
from raytrace_tpu.scene import dsl
from raytrace_tpu.scene.builder import build_scene, load_scene_file
from raytrace_tpu.scene.schema import BG_SKYBOX

from conftest import GOLDEN_SCENE, repo_path

GOLDEN = str(GOLDEN_SCENE)


def _lanes(n, w, h, aa=4):
    rng = np.random.RandomState(7)
    pix = jnp.asarray(rng.randint(0, w, n), jnp.uint32)
    piy = jnp.asarray(rng.randint(0, h, n), jnp.uint32)
    aas = jnp.asarray(rng.randint(0, aa, n), jnp.uint32)
    cam = jnp.zeros(n, jnp.uint32)
    return pix, piy, aas, cam


def _assert_lanes_match(got, want, frac=0.97, mean_rtol=None):
    # The two paths trace the same ops but compile separately, so FMA
    # contraction may differ; rays that graze a silhouette (disc ~ 0)
    # can flip hit/miss.  Parity is therefore statistical: almost every
    # lane matches exactly, and aggregates agree tightly.
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        close = np.isclose(g, w, rtol=1e-5, atol=1e-6)
        assert close.mean() > frac, f"only {close.mean():.3f} lanes match"
        if mean_rtol is not None:
            np.testing.assert_allclose(g.mean(), w.mean(), rtol=mean_rtol)


def _parity(sc, n, seed, aa=4):
    spec = sc.spec
    pix, piy, aas, cam = _lanes(n, spec.width, spec.height, aa)
    got = megakernel.radiance_lanes(sc.data, spec, pix, piy, aas, cam, seed,
                                    interpret=True)
    ro, rd, k1, k2 = primary_rays(sc.data, spec, pix, piy, aas, cam, seed)
    want = radiance_linear_v(sc.data, spec, ro, rd, k1, k2)
    return got, want, (ro, rd)


MIRROR_SCENE = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.6,0.5,0.4)
        specular: rgb(0.3,0.3,0.3) exponent: 8
        ambient: rgb(0.05,0.05,0.05) } }
    { bounds: Sphere { center: (0, 0, -4) radius: 1 }
      material: PhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0.4,0.4,0.4) exponent: 16 ambient: rgb(0,0,0) } }
  ]
  lights: [
    { model: PointLight { location: (2, 3, -1) } color: rgb(1.2,1.1,1.0) }
    { model: DirectionalLight { direction: (0, -1, -0.2) }
      color: rgb(0.3, 0.3, 0.35) }
  ]
  camera: DepthOfFieldCamera new(
    new((0,0,0), (0,0,-1), (0,1,0), 2),
    4.0, 0.05, 2)
  background: SolidColorBackground { color: rgb(0.1, 0.12, 0.15) }
  options: { width: 32 height: 32 antialias: 2 }
}"""


def _mirror(src=MIRROR_SCENE):
    return build_scene(dsl.parse(src), dtype=jnp.float32)


def _with_skybox(sc, seed, sizes=((3, 5), (4, 4), (2, 2), (4, 3), (3, 3),
                                  (5, 5))):
    rng = np.random.RandomState(seed)
    hmax = max(s[0] for s in sizes)
    wmax = max(s[1] for s in sizes)
    cube = np.zeros((6, hmax, wmax, 3), np.float32)
    for i, (h, w) in enumerate(sizes):
        cube[i, :h, :w] = rng.rand(h, w, 3)
    return dataclasses.replace(
        sc,
        data=dataclasses.replace(sc.data, bg_cube=jnp.asarray(cube)),
        spec=dataclasses.replace(sc.spec, bg_type=BG_SKYBOX,
                                 face_sizes=sizes))


def _on_gpu(monkeypatch):
    """Make the capability check see a GPU backend (routing tests only:
    nothing is compiled for the card)."""
    monkeypatch.setattr(megakernel.jax, "default_backend", lambda: "gpu")


def test_kernel_choice_per_backend_and_regime(monkeypatch):
    """fits() is the regime check; usable() adds the backend: linear
    f32 scenes of <= 64 objects take the kernel on a GPU only; f64,
    fan-out and large scenes never do; nor does any scene inside an
    object-sharded ring render."""
    from raytrace_tpu.ops import intersect
    from raytrace_tpu.scene.procedural import make_sphere_field

    sc = load_scene_file(GOLDEN, dtype=jnp.float32)
    f64 = load_scene_file(GOLDEN, dtype=jnp.float64)
    fan = load_scene_file(str(repo_path("examples", "materials_showcase.txt")),
                          dtype=jnp.float32)
    big = make_sphere_field(100, mix_materials=False, dtype=jnp.float32)
    assert sc.spec.children_per_ray == 1 and fan.spec.children_per_ray > 1
    assert big.spec.children_per_ray == 1 and big.spec.n_objects > 64

    assert megakernel.fits(sc.spec, jnp.float32)
    assert not megakernel.fits(f64.spec, jnp.float64)
    assert not megakernel.fits(fan.spec, jnp.float32)
    assert not megakernel.fits(big.spec, jnp.float32)

    assert not megakernel.usable(sc.data, sc.spec)     # CPU: jnp path
    _on_gpu(monkeypatch)
    assert megakernel.usable(sc.data, sc.spec)
    for other in (f64, fan, big):
        assert not megakernel.usable(other.data, other.spec)
    prev = intersect.set_ring_ctx(object())
    try:
        assert not megakernel.usable(sc.data, sc.spec)
    finally:
        intersect.set_ring_ctx(prev)


def _kernel_launches(monkeypatch):
    """Record kernel launches (the spy answers through the jnp path, so
    nothing is compiled for the card)."""
    from raytrace_tpu.ops.vec import V3

    calls = []

    def spy(data, spec, pix, piy, aa, cam, seed, *, interpret=False):
        calls.append(seed)
        return V3(*megakernel._jnp_reference(data, spec, pix, piy, aa, cam,
                                             seed))

    monkeypatch.setattr(megakernel, "radiance_lanes", spy)
    return calls


def test_sample_pixels_routing(monkeypatch):
    """On a GPU, sample_pixels launches the kernel for a linear scene
    with a static seed; a traced seed (per-step optimizer reseeding)
    takes the jnp path; on the CPU nothing launches the kernel."""
    sc = load_scene_file(GOLDEN, dtype=jnp.float32)
    spec = sc.spec
    px = jnp.arange(8, dtype=jnp.uint32)
    sids = jnp.arange(2, dtype=jnp.uint32)
    calls = _kernel_launches(monkeypatch)

    jax.make_jaxpr(lambda d: sample_pixels(d, spec, px, px, sids, 3))(sc.data)
    assert calls == []
    _on_gpu(monkeypatch)
    jax.make_jaxpr(lambda d: sample_pixels(d, spec, px, px, sids, 3))(sc.data)
    assert calls == [3]
    jax.make_jaxpr(lambda d, s: sample_pixels(d, spec, px, px, sids, s))(
        sc.data, jnp.uint32(3))
    assert calls == [3]


def test_golden_scene_parity():
    """Kernel (interpret mode) == jnp path on the reference's golden
    scene."""
    sc = load_scene_file(GOLDEN, dtype=jnp.float32)
    got, want, _ = _parity(sc, 1000, seed=3)
    _assert_lanes_match(got, want, mean_rtol=0.05)
    # scene is lit only through the MC indirect path; output nonzero
    assert float(jnp.max(got.x)) > 0.0


def test_mirror_phong_dof_lights_parity():
    """Reflect slot + point/directional lights + DoF lens sampling all
    run inside the kernel; parity vs the jnp path."""
    sc = _mirror()
    assert sc.spec.has_reflect and sc.spec.children_per_ray == 1
    assert megakernel.fits(sc.spec, jnp.float32)
    got, want, _ = _parity(sc, 500, seed=5, aa=2)
    _assert_lanes_match(got, want)


def test_grad_through_kernel():
    """custom_vjp: grad through the fused kernel == grad of the jnp
    path (the backward *is* the jnp path's VJP, re-traced)."""
    sc = load_scene_file(GOLDEN, dtype=jnp.float32)
    spec = sc.spec
    pix, piy, aas, cam = _lanes(128, spec.width, spec.height)

    def loss_kernel(data):
        v = megakernel.radiance_lanes(data, spec, pix, piy, aas, cam, 1,
                                      interpret=True)
        return jnp.sum(v.x + v.y + v.z)

    def loss_jnp(data):
        ro, rd, k1, k2 = primary_rays(data, spec, pix, piy, aas, cam, 1)
        v = radiance_linear_v(data, spec, ro, rd, k1, k2)
        return jnp.sum(v.x + v.y + v.z)

    g_kernel = jax.grad(loss_kernel)(sc.data)
    g_jnp = jax.grad(loss_jnp)(sc.data)
    leaves_k, _ = jax.tree.flatten(g_kernel)
    leaves_j, _ = jax.tree.flatten(g_jnp)
    assert any(float(jnp.max(jnp.abs(l))) > 0 for l in leaves_k)
    for k, j in zip(leaves_k, leaves_j):
        np.testing.assert_allclose(np.asarray(k), np.asarray(j),
                                   rtol=1e-5, atol=1e-6)


def test_gradient_rule_ignores_integer_inputs():
    """The VJP gives float0 cotangents to the integer lane ids and
    re-traces the jnp path: jax.vjp of the kernel's forward with any
    cotangent equals the jnp VJP exactly."""
    sc = _mirror()
    spec = sc.spec
    pix, piy, aas, cam = _lanes(64, spec.width, spec.height, aa=2)
    g = tuple(jnp.asarray(np.random.RandomState(i).rand(64), jnp.float32)
              for i in range(3))
    _, vjp_k = jax.vjp(lambda d: megakernel._radiance_lanes_vjp(
        d, spec, pix, piy, aas, cam, 2, True), sc.data)
    _, vjp_j = jax.vjp(lambda d: megakernel._jnp_reference(
        d, spec, pix, piy, aas, cam, 2), sc.data)
    for a, b in zip(jax.tree.leaves(vjp_k(g)), jax.tree.leaves(vjp_j(g))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, _, _, _, d_pix, *_ = megakernel._vjp_bwd(
        spec, 2, True, (sc.data, pix, piy, aas, cam), g)
    assert d_pix.dtype == jax.dtypes.float0 and d_pix.shape == (64,)


@pytest.mark.parametrize("n,block", [(77, 256), (300, 128)])
def test_block_padding(monkeypatch, n, block):
    """Lane counts that are not a multiple of the block are padded up
    to whole blocks and trimmed back: one partial block, and several
    blocks with a ragged tail."""
    monkeypatch.setattr(megakernel, "BLOCK_LANES", block)
    sc = load_scene_file(GOLDEN, dtype=jnp.float32)
    got, want, _ = _parity(sc, n, seed=0)
    assert got.x.shape == got.y.shape == got.z.shape == (n,)
    _assert_lanes_match(got, want, frac=0.95)
    text = str(jax.make_jaxpr(
        lambda d: megakernel._radiance_lanes_fwd_kernel(
            d, sc.spec, *_lanes(n, 8, 8), 0, True))(sc.data))
    total = -(-n // block) * block
    assert f"f32[{total}]" in text and f"u32[{total}]" in text


def test_packed_params_power_of_two():
    """The scene scalars pack into one 1-D array padded to a power of
    two, and the in-kernel unpacking reads every leaf back in order."""
    for sc in (load_scene_file(GOLDEN, dtype=jnp.float32), _mirror()):
        params = megakernel._pack_params(sc.data)
        k = sum(int(np.size(getattr(sc.data, n)))
                for n in megakernel._LAYOUT)
        assert params.ndim == 1 and params.dtype == jnp.float32
        assert params.shape[0] >= k
        assert params.shape[0] & (params.shape[0] - 1) == 0
        assert params.shape[0] < 2 * max(k, 1)
        np.testing.assert_array_equal(np.asarray(params[k:]), 0.0)
        tab = megakernel._unpack_params(
            np.asarray(params), megakernel._leaf_shapes(sc.data),
            jnp.float32)
        for name in megakernel._LAYOUT:
            leaf = np.asarray(getattr(sc.data, name))
            got = getattr(tab, name)
            if leaf.ndim == 0:
                assert got == leaf
            elif leaf.ndim == 1:
                assert [got[i] for i in range(leaf.shape[0])] == list(leaf)
            else:
                for i in range(leaf.shape[0]):
                    for j in range(leaf.shape[1]):
                        assert got[i, j] == leaf[i, j]
    assert [megakernel._pow2(k) for k in (1, 2, 3, 170, 256, 257)] == [
        1, 2, 4, 256, 256, 512]


def test_skybox_deferred_parity():
    """Skybox scenes run fused: the kernel streams ONE merged miss
    record and the post-pass adds tp * skybox(rd); parity vs the inline
    jnp path."""
    from raytrace_tpu.ops.intersect import closest_hit

    sc = _with_skybox(_mirror(), seed=3)
    assert sc.spec.children_per_ray == 1
    assert megakernel.fits(sc.spec, jnp.float32)
    got, want, (ro, rd) = _parity(sc, 500, seed=9, aa=2)
    _assert_lanes_match(got, want)
    # background actually contributes (miss lanes nonzero)
    miss = ~np.asarray(closest_hit(sc.data, sc.spec, ro, rd).hit)
    assert miss.any()
    assert np.asarray(got.x)[miss].max() > 0


def test_skybox_no_fanout_parity():
    """Pure-diffuse scene (children_per_ray == 0) + skybox: the linear
    chain breaks after level 0 and the merged miss record still carries
    every background term."""
    src = MIRROR_SCENE.replace("specular: rgb(0.3,0.3,0.3)",
                               "specular: rgb(0,0,0)").replace(
                               "specular: rgb(0.4,0.4,0.4)",
                               "specular: rgb(0,0,0)")
    sc = _with_skybox(_mirror(src), seed=5, sizes=((4, 4),) * 6)
    assert sc.spec.children_per_ray == 0
    got, want, _ = _parity(sc, 500, seed=9, aa=2)
    _assert_lanes_match(got, want)
    assert float(np.max(np.asarray(got.x))) > 0.0


@pytest.mark.parametrize("variant", ["golden", "mirror_lights_dof",
                                     "skybox"])
def test_kernel_lowers_to_triton_for_cuda(variant):
    """Every regime the kernel claims lowers through Pallas' Triton
    route for the CUDA platform (cross-platform lowering on the CPU:
    an unsupported primitive fails here, before any card is asked)."""
    sc = {"golden": lambda: load_scene_file(GOLDEN, dtype=jnp.float32),
          "mirror_lights_dof": _mirror,
          "skybox": lambda: _with_skybox(_mirror(), seed=1)}[variant]()
    pix, piy, aas, cam = _lanes(1024, sc.spec.width, sc.spec.height)
    fn = jax.jit(lambda d: megakernel.radiance_lanes(
        d, sc.spec, pix, piy, aas, cam, 3).x)
    text = fn.trace(sc.data).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text or "triton" in text


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp_on_gpu(gpu):
    """On a card: the compiled Triton kernel matches the jnp path on
    the golden scene at a 2^16-lane launch."""
    sc = load_scene_file(GOLDEN, dtype=jnp.float32)
    assert megakernel.usable(sc.data, sc.spec)
    spec = sc.spec
    pix, piy, aas, cam = _lanes(1 << 16, spec.width, spec.height)
    got = jax.jit(lambda d: megakernel.radiance_lanes(
        d, spec, pix, piy, aas, cam, 3))(sc.data)
    ro, rd, k1, k2 = primary_rays(sc.data, spec, pix, piy, aas, cam, 3)
    want = radiance_linear_v(sc.data, spec, ro, rd, k1, k2)
    _assert_lanes_match(got, want, frac=0.999, mean_rtol=1e-3)
