"""Background models: solid color and six-face skybox.

Data-parallel equivalent of the reference's ``Background`` trait
(scene.rs:159-188) and its impls (raytrace.rs:228-256): the per-ray
dominant-axis macro chain (raytrace.rs:234-245) becomes a branch-free
masked select over all three axes, and the per-texel ``Texture::sample``
bilinear (texture.rs:46-58) becomes a batched gather on the device-resident
``(6, H, W, 3)`` face array.

Semantics preserved exactly:

* dominant axis chosen by strict ``>`` comparisons, checked in x, y, z
  order; ties (e.g. |dx| == |dy| maximal) fall through to BLACK
  (raytrace.rs:251-254);
* face UVs: x-face ``(-dz/dx, -dy/|dx|)``, y-face ``(dx/|dy|, dz/dy)``,
  z-face ``(dx/dz, -dy/|dz|)``, each mapped ``*0.5 + 0.5``
  (raytrace.rs:251-253);
* bilinear sample with clamp to [0,1] then scale by ``(size-1)``, texel
  clamp at the high edge (texture.rs:46-58).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from raytrace_tpu.ops.vec import V3
from raytrace_tpu.scene.schema import BG_SKYBOX, SceneData, SceneSpec
from raytrace_tpu.utils.profiling import annotate

# face order in SceneData.bg_cube (builder.py): px nx py ny pz nz
FACE_PX, FACE_NX, FACE_PY, FACE_NY, FACE_PZ, FACE_NZ = range(6)


@annotate("background")
def background_color_v(data: SceneData, spec: SceneSpec, rd: V3) -> V3:
    """Background radiance for miss rays, component layout."""
    if spec.bg_type != BG_SKYBOX:
        zero = jnp.zeros_like(rd.x)
        return V3(zero + data.bg_color[0], zero + data.bg_color[1],
                  zero + data.bg_color[2])
    out = _skybox(data, spec, jnp.stack([rd.x, rd.y, rd.z], -1))
    return V3(out[..., 0], out[..., 1], out[..., 2])


def background_color(data: SceneData, spec: SceneSpec, rd) -> jnp.ndarray:
    """Background radiance for miss rays ``rd`` (N,3) -> (N,3)."""
    if spec.bg_type != BG_SKYBOX:
        return jnp.broadcast_to(data.bg_color, rd.shape)
    return _skybox(data, spec, rd)


def _skybox(data: SceneData, spec: SceneSpec, rd) -> jnp.ndarray:
    dtype = rd.dtype
    dx, dy, dz = rd[..., 0], rd[..., 1], rd[..., 2]
    ax, ay, az = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)

    # dominant-axis tests in the reference's x, y, z order (strict >)
    x_dom = (ax > az) & (ax > ay)
    y_dom = (ay > ax) & (ay > az)
    z_dom = (az > ax) & (az > ay)

    safe = lambda d: jnp.where(d == 0, 1.0, d)  # noqa: E731 — div guard;
    # guarded lanes are never selected (a zero component cannot be dominant)

    face = jnp.where(
        x_dom, jnp.where(dx > 0, FACE_PX, FACE_NX),
        jnp.where(y_dom, jnp.where(dy > 0, FACE_PY, FACE_NY),
                  jnp.where(dz > 0, FACE_PZ, FACE_NZ)))
    u = jnp.where(x_dom, -dz / safe(dx),
                  jnp.where(y_dom, dx / safe(ay), dx / safe(dz)))
    v = jnp.where(x_dom, -dy / safe(ax),
                  jnp.where(y_dom, dz / safe(dy), -dy / safe(az)))
    u = u * 0.5 + 0.5
    v = v * 0.5 + 0.5

    # per-face static sizes (faces are padded into one array)
    sizes = np.asarray(spec.face_sizes)                     # (6, 2) h, w
    fh = jnp.asarray(sizes[:, 0], dtype)[face]
    fw = jnp.asarray(sizes[:, 1], dtype)[face]

    # Texture::sample (texture.rs:46-58): clamp, scale by size-1, bilinear
    x = jnp.clip(u, 0.0, 1.0) * (fw - 1.0)
    y = jnp.clip(v, 0.0, 1.0) * (fh - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    xx = (x - x0)[..., None]
    yy = (y - y0)[..., None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, fw.astype(jnp.int32) - 1)
    y1i = jnp.minimum(y0i + 1, fh.astype(jnp.int32) - 1)

    cube = data.bg_cube
    c00 = cube[face, y0i, x0i]
    c01 = cube[face, y1i, x0i]
    c10 = cube[face, y0i, x1i]
    c11 = cube[face, y1i, x1i]
    cx0 = c00 * (1.0 - yy) + c01 * yy
    cx1 = c10 * (1.0 - yy) + c11 * yy
    out = cx0 * (1.0 - xx) + cx1 * xx

    none_dom = ~(x_dom | y_dom | z_dom)
    return jnp.where(none_dom[..., None], jnp.zeros_like(out), out)
