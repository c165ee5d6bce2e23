"""Fused render kernel: the whole per-lane pipeline as ONE Pallas kernel
compiled through Triton for the GPU.

The jnp wavefront path (render/integrator.py) is correct and fully
general, but XLA may materialize fusion boundaries to device memory —
``(N,)`` f32 intermediates per level round.  For scenes whose wavefront
never fans out (``spec.children_per_ray <= 1``, which includes the
reference's golden scene — one indirect MC slot, raytrace.rs:99-117 —
and pure mirror-Phong scenes) with at most ``LARGE_SCENE_THRESHOLD``
objects, this kernel runs the *entire* per-lane pipeline — RNG key
derivation, AA jitter, NDC transform (main.rs:39-53), camera projection
(camera.rs:77-122), all ``max_depth + 2`` closest-hit + shade rounds
(raytrace.rs:261-276) — on 1-D lane blocks held in registers.  Device
memory traffic is 16 B/lane of integer identity in + 12 B/lane of
radiance out.

Design notes:

* **Zero duplicated math.**  The kernel body calls the very same
  functions as the jnp path (``integrator.primary_rays``,
  ``integrator.radiance_linear_v`` → ``ops.intersect.closest_hit``,
  ``models.materials.shade``, ...).  Those are all elementwise and
  shape-agnostic, so they trace equally well on lane blocks inside
  ``pallas_call``.  Correctness of the kernel *is* correctness of the
  reference semantics already unit-tested on the jnp path.

* **Scene scalars are one small input.**  The scene is a few hundred
  floats (7-object golden scene: ~170), packed into one 1-D array
  padded to a power of two.  Inside the kernel a tiny shim
  (:class:`_Tab`) re-presents them with the ``data.prim_p[i, 0]``
  indexing the shared code uses; each access is one scalar load,
  uniform across the block and cache-resident.

* **Scope.**  :func:`fits` is the regime check (linear, small, f32);
  :func:`usable` adds the capability check (a GPU backend, no
  object-sharded ring context).  Fan-out and large scenes run the XLA
  wavefront.  Skybox backgrounds defer the texture lookup: the kernel
  streams ONE merged miss record per lane and a jnp post-pass adds
  ``tp * skybox(rd)``.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp

from raytrace_tpu.ops.intersect import LARGE_SCENE_THRESHOLD
from raytrace_tpu.ops.vec import V3
from raytrace_tpu.scene.schema import BG_SOLID, SceneData, SceneSpec

# lanes per block and Triton launch parameters, chosen by the on-card
# sweep recorded in PERF.md (golden scene, 2^21 lanes)
BLOCK_LANES = 256
NUM_WARPS = 8
NUM_STAGES = 1

# SceneData leaves packed into the scalar parameter array, in order.
# bg_cube is excluded (solid backgrounds never touch it; skybox lookups
# run in the deferred post-pass).
_LAYOUT = (
    "prim_p", "prim_q",
    "mat_diffuse", "mat_specular", "mat_exponent",
    "mat_ambient", "mat_ior", "mat_samples",
    "light_p", "light_e1", "light_e2", "light_color",
    "cam_position", "cam_matrix",
    "cam_focus", "cam_aperture", "cam_im_dist",
    "bg_color",
)


def fits(spec: SceneSpec, dtype) -> bool:
    """Whether the scene's regime is one the kernel covers: a linear
    chain (``children_per_ray <= 1``), at most ``LARGE_SCENE_THRESHOLD``
    live objects, f32."""
    n_live = sum(1 for t in spec.shape_type if t >= 0)
    return (spec.children_per_ray <= 1
            and n_live <= LARGE_SCENE_THRESHOLD
            and jnp.dtype(dtype) == jnp.float32)


def usable(data: SceneData, spec: SceneSpec) -> bool:
    """Whether this (data, spec) renders through the compiled kernel:
    the regime fits and the default backend is a GPU.  Inside an
    object-sharded ring render closest-hit needs ``ppermute`` over the
    mesh axis, which cannot run inside a kernel."""
    from raytrace_tpu.ops import intersect

    return (intersect._RING_CTX is None
            and jax.default_backend() == "gpu"
            and fits(spec, data.prim_p.dtype))


class _Tab:
    """Scalar-table shim: presents a nested list of traced scalars with
    the array indexing the shared render code uses (``t[i]``,
    ``t[i, j]``) plus a ``dtype`` attribute."""

    def __init__(self, vals, dtype):
        self._v = vals
        self.dtype = dtype

    def __getitem__(self, idx):
        v = self._v
        if isinstance(idx, tuple):
            for k in idx:
                v = v[k]
            return v
        v = v[idx]
        return _Tab(v, self.dtype) if isinstance(v, list) else v


def _leaf_shapes(data: SceneData):
    return tuple((name, tuple(np.shape(getattr(data, name))))
                 for name in _LAYOUT)


def _pack_params(data: SceneData) -> jnp.ndarray:
    """Flatten the scalar scene leaves into one 1-D f32 array whose
    length is a power of two (Triton block shapes must be)."""
    flat = jnp.concatenate([jnp.ravel(getattr(data, name)).astype(jnp.float32)
                            for name in _LAYOUT])
    k = flat.shape[0]
    return jnp.pad(flat, (0, _pow2(k) - k))


def _pow2(k: int) -> int:
    """Smallest power of two >= k (and >= 1)."""
    return 1 << max(k - 1, 0).bit_length()


def _unpack_params(params_ref, shapes, dtype):
    """Rebuild a SceneData-shaped namespace of scalar shims from the
    packed parameter array.  Every element is one scalar load."""
    fields = {}
    k = 0
    for name, shape in shapes:
        if len(shape) == 0:
            fields[name] = params_ref[k]
            k += 1
        elif len(shape) == 1:
            fields[name] = _Tab([params_ref[k + i] for i in range(shape[0])],
                                dtype)
            k += shape[0]
        else:
            fields[name] = _Tab(
                [[params_ref[k + i * shape[1] + j] for j in range(shape[1])]
                 for i in range(shape[0])], dtype)
            k += shape[0] * shape[1]
    fields["bg_cube"] = None  # unreachable: skybox lookups are deferred
    return SimpleNamespace(**fields)


def _kernel(params_ref, pix_ref, piy_ref, aa_ref, cam_ref, *outs,
            spec: SceneSpec, seed: int, shapes):
    from raytrace_tpu.render.integrator import (primary_rays,
                                                radiance_linear_v)

    data = _unpack_params(params_ref, shapes, jnp.float32)
    ro, rd, k1, k2 = primary_rays(data, spec, pix_ref[...], piy_ref[...],
                                  aa_ref[...], cam_ref[...], seed)
    if spec.bg_type == BG_SOLID:
        rad = radiance_linear_v(data, spec, ro, rd, k1, k2)
    else:
        # skybox: the per-lane bilinear texture gather stays out of the
        # kernel — ONE merged miss record streams out (a live linear
        # lane misses at most once) and the post-pass in
        # _radiance_lanes_fwd_kernel adds tp * skybox(rd)
        recs: list = []
        rad = radiance_linear_v(data, spec, ro, rd, k1, k2,
                                miss_records=recs)
        ((miss, mrd, mtp),) = recs
        o = outs[3:]
        o[0][...] = jnp.where(miss, 1.0, 0.0).astype(jnp.float32)
        o[1][...], o[2][...], o[3][...] = mrd.x, mrd.y, mrd.z
        o[4][...], o[5][...], o[6][...] = mtp.x, mtp.y, mtp.z
    outs[0][...] = rad.x
    outs[1][...] = rad.y
    outs[2][...] = rad.z


def radiance_lanes(data: SceneData, spec: SceneSpec, pix, piy, aa, cam,
                   seed: int, *, interpret: bool = False) -> V3:
    """Per-lane radiance through the fused kernel, with a custom VJP so
    ``jax.grad`` works through it: the forward pass runs the kernel; the
    backward pass re-traces the *jnp* path (the same elementwise math —
    see module docstring) and differentiates that.  Scene-parameter
    gradients therefore match the jnp path's gradients exactly.

    pix/piy/aa/cam: (N,) integer identity arrays (any int dtype).
    Returns a V3 of (N,) f32 linear radiance.  ``interpret`` runs the
    kernel through the Pallas interpreter (tests on the CPU).
    """
    out = _radiance_lanes_vjp(data, spec, pix, piy, aa, cam, seed,
                              interpret)
    return V3(*out)


@partial(jax.custom_vjp, nondiff_argnums=(1, 6, 7))
def _radiance_lanes_vjp(data, spec, pix, piy, aa, cam, seed, interpret):
    v = _radiance_lanes_fwd_kernel(data, spec, pix, piy, aa, cam, seed,
                                   interpret)
    return (v.x, v.y, v.z)


def _jnp_reference(data, spec, pix, piy, aa, cam, seed):
    from raytrace_tpu.render.integrator import (primary_rays,
                                                radiance_linear_v)
    ro, rd, k1, k2 = primary_rays(data, spec, pix, piy, aa, cam, seed)
    v = radiance_linear_v(data, spec, ro, rd, k1, k2)
    return (v.x, v.y, v.z)


def _vjp_fwd(data, spec, pix, piy, aa, cam, seed, interpret):
    v = _radiance_lanes_fwd_kernel(data, spec, pix, piy, aa, cam, seed,
                                   interpret)
    return (v.x, v.y, v.z), (data, pix, piy, aa, cam)


def _vjp_bwd(spec, seed, interpret, res, g):
    data, pix, piy, aa, cam = res
    _, vjp = jax.vjp(
        lambda d: _jnp_reference(d, spec, pix, piy, aa, cam, seed), data)
    (d_data,) = vjp(g)
    # integer-valued primals take float0 cotangents
    zero = lambda x: np.zeros(x.shape, jax.dtypes.float0)  # noqa: E731
    return (d_data, zero(pix), zero(piy), zero(aa), zero(cam))


_radiance_lanes_vjp.defvjp(_vjp_fwd, _vjp_bwd)


def _radiance_lanes_fwd_kernel(data: SceneData, spec: SceneSpec, pix, piy,
                               aa, cam, seed: int, interpret: bool) -> V3:
    """The raw fused-kernel launch (no AD plumbing)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltr

    assert fits(spec, data.prim_p.dtype), "scene outside the kernel regime"
    n = pix.shape[0]
    total = -(-n // BLOCK_LANES) * BLOCK_LANES

    def block(a):
        return jnp.pad(a.astype(jnp.uint32), (0, total - n))

    params = _pack_params(data)
    lane_spec = pl.BlockSpec((BLOCK_LANES,), lambda i: (i,))
    # inside shard_map the output varies over the same mesh axes as the
    # lane-id inputs; vma must be declared on the out avals
    vma = getattr(jax.typeof(pix), "vma", frozenset())
    out_shape = jax.ShapeDtypeStruct((total,), jnp.float32, vma=vma)
    n_out = 3 if spec.bg_type == BG_SOLID else 10

    fn = pl.pallas_call(
        partial(_kernel, spec=spec, seed=seed, shapes=_leaf_shapes(data)),
        grid=(total // BLOCK_LANES,),
        in_specs=[pl.BlockSpec(params.shape, lambda i: (0,)),
                  lane_spec, lane_spec, lane_spec, lane_spec],
        out_specs=(lane_spec,) * n_out,
        out_shape=(out_shape,) * n_out,
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=NUM_STAGES),
        interpret=interpret,
        name="render_linear",
    )
    ox, oy, oz, *rec = fn(params, block(pix), block(piy), block(aa),
                          block(cam))
    rad = V3(ox[:n], oy[:n], oz[:n])
    if rec:
        # deferred background: fused jnp post-pass over the miss record
        # (the only stage with a texture gather)
        from raytrace_tpu.models.backgrounds import background_color_v
        miss, rdx, rdy, rdz, tpx, tpy, tpz = (a[:n] for a in rec)
        bg = background_color_v(data, spec, V3(rdx, rdy, rdz))
        m = miss > 0.5
        rad = V3(rad.x + jnp.where(m, tpx * bg.x, 0.0),
                 rad.y + jnp.where(m, tpy * bg.y, 0.0),
                 rad.z + jnp.where(m, tpz * bg.z, 0.0))
    return rad
