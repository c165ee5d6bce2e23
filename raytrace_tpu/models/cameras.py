"""Camera models: batched primary-ray generation.

Data-parallel equivalent of the reference's ``Camera`` trait
(camera.rs:19-27) and its two impls: ``SimplePerspectiveCamera::project``
(camera.rs:77-79) and ``DepthOfFieldCamera::project`` (camera.rs:110-122).
The per-pixel virtual call becomes batched component-form arithmetic over
an (N,) lane axis (ops/vec.py layout note); the camera *type* is a static
switch from SceneSpec so only one code path is ever compiled.
"""

from __future__ import annotations

import jax.numpy as jnp

from raytrace_tpu.ops import rng, vec
from raytrace_tpu.ops.vec import V3
from raytrace_tpu.scene.schema import CAM_DEPTH_OF_FIELD, SceneData, SceneSpec


def _mat_apply(m, x, y, z) -> V3:
    """dir = M @ (x, y, z) with scalar matrix entries against (N,) lanes."""
    return V3(m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
              m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
              m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)


def project(data: SceneData, spec: SceneSpec, pos_x, pos_y, k1, k2):
    """Project normalized image coordinates to rays.

    ``pos_x``/``pos_y``: (N,) NDC coordinates ((-1,-1)..(1,1) = largest
    centered square in the image, camera.rs:22-24).  ``k1``/``k2``:
    per-lane RNG streams (used only by the depth-of-field lens sampler).
    Returns ``(origin: V3, direction: V3)``.
    """
    dtype = pos_x.dtype
    m = data.cam_matrix
    one = jnp.ones_like(pos_x)
    d = _mat_apply(m, pos_x, pos_y, one)              # M @ (x, y, 1)
    cam_pos = V3(jnp.zeros_like(pos_x) + data.cam_position[0],
                 jnp.zeros_like(pos_x) + data.cam_position[1],
                 jnp.zeros_like(pos_x) + data.cam_position[2])

    if spec.cam_type != CAM_DEPTH_OF_FIELD:
        return cam_pos, vec.normalize(d)

    # DepthOfFieldCamera::project (camera.rs:110-121): d stays
    # un-normalized; lens point sampled uniformly on a disc via
    # theta ~ U[0,2pi), r = sqrt(u) * aperture.
    ip = cam_pos + d                                  # image plane point
    fp = cam_pos + d.scale(data.cam_focus / data.cam_im_dist)
    theta = rng.draw(k1, k2, rng.PURPOSE_LENS_THETA, dtype) * (2.0 * jnp.pi)
    u = rng.draw(k1, k2, rng.PURPOSE_LENS_R, dtype)
    r = jnp.sqrt(u) * data.cam_aperture
    lens = _mat_apply(m, jnp.cos(theta) * r, jnp.sin(theta) * r,
                      jnp.zeros_like(r))
    origin = ip + lens
    return origin, vec.normalize(fp - origin)
