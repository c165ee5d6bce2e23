"""Material shading: batched, branch-free re-design of the four
``Material::color`` impls (raytrace.rs:30-226).

The reference shades one hit at a time through a trait object and
recurses into ``ray_color`` for reflection / refraction / Monte-Carlo
indirect bounces.  Here one call shades a whole wavefront level: material
polymorphism is per-lane masked selects over parameters already chosen by
the closest-hit loop (ops/intersect.py HitRec), and recursion becomes
*child slot emission* — each lane produces up to
B = has_reflect + has_refract + n_indirect child rays with per-child
throughput weights, consumed by the iterative wavefront loop in
:mod:`raytrace_tpu.render.integrator`.  All arrays are
component-separated ``(N,)`` lanes (ops/vec.py layout note).

Semantics preserved exactly (per material, with citations):

* normal flipped toward the viewer (raytrace.rs:38,77,130,176);
* significance gates ``diffuse.significance()*sig > 1/512`` etc.
  (raytrace.rs:35-36,74-75,137-138,193);
* Lambertian ``diffuse*Lc*max(0,l.n)/pi`` and Blinn-ish specular
  ``spec*Lc*max(0, n.normalize(l-d))^exp`` (raytrace.rs:52,55);
* shadow rays offset 1e-5 along the light direction, blocked iff the
  closest hit satisfies ``t^2 < r^2`` (range-free lights: any hit)
  (raytrace.rs:43-50);
* Schlick fresnel ``clamp1(r0 + (1-r0)(1-cos)^5)`` with the *Fresnel*
  material using ``1-|n.d|`` (raytrace.rs:132-136) and the *Transparent*
  material using the refracted-ray cosine on exit (raytrace.rs:187-192);
* Snell refraction with ``n = ior`` when exiting / ``1/ior`` entering,
  total internal reflection when ``sin^2 >= 1`` (raytrace.rs:177-186);
* mirror reflection ``d - 2(d.n)n`` with un-normalized child direction
  (raytrace.rs:60-61); refracted child direction normalized
  (raytrace.rs:219);
* MC hemisphere sampling with the reference's exact (quirky)
  distribution: ``r1 ~ U[-1,1)``, ``phi ~ U[0,2pi)``,
  ``dir = ((1-r1^2)cos(phi), r1, (1-r1^2)sin(phi))`` — un-normalized,
  non-cosine-weighted — flipped into the normal hemisphere, weighted
  ``diffuse * (n.dir) / (samples * 0.5)``, child significance passed
  **unattenuated** (raytrace.rs:99-117);
* every secondary ray origin offset ``1e-5`` along its direction.

Documented divergence: the reference's indirect *specular* term uses the
shadowing inner ``ray`` binding, so ``dir - ray.direction == 0`` and
``normalize(0) = NaN`` whenever an IndirectPhongMaterial has nonzero
specular (raytrace.rs:108,115 — latent NaN, SURVEY.md §2 #10).  Here that
term contributes 0 instead of NaN, and spec-only indirect children are
culled (their reference contribution is all-NaN).  A second measure-zero
guard: ``normalize(ldir - d)`` returns 0 instead of NaN when
``ldir == d`` exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from raytrace_tpu.models.lights import light_dir_and_sq_range
from raytrace_tpu.ops import rng
from raytrace_tpu.ops import vec
from raytrace_tpu.ops.intersect import HitRec, occluded_v
from raytrace_tpu.ops.vec import V3, dot
from raytrace_tpu.scene.schema import (MAT_FRESNEL, MAT_TRANSPARENT,
                                       SceneData, SceneSpec)
from raytrace_tpu.utils.profiling import annotate

_OFFSET = 1e-5  # secondary-ray origin offset (raytrace.rs:43,62,108,211,220)


def _clamp0(x):
    return jnp.maximum(x, 0.0)


def _clamp1(x):
    return jnp.minimum(x, 1.0)


class Child(NamedTuple):
    """One child-slot emission: a masked batch of secondary rays."""

    ro: V3
    rd: V3                 # direction (reference normalization semantics)
    sig: jnp.ndarray       # (N,) significance for the child
    weight: V3             # contribution weight (throughput factor)
    live: jnp.ndarray      # (N,) bool: slot active for this lane
    slot: int              # static slot index (RNG stream derivation)


@annotate("shade")
def shade(data: SceneData, spec: SceneSpec, ro: V3, rd: V3, hit: HitRec,
          sig, live, k1, k2, depth):
    """Shade one wavefront level.

    Returns ``(emit: V3, children: list[Child])`` where ``emit`` is the
    *local* radiance of each lane (ambient + direct lighting; background
    for miss lanes is handled by the integrator) and ``children`` are the
    secondary-ray slots (empty at the final level).

    ``depth`` is the static recursion depth of the level (the unrolled
    level loop / static DFS); past ``spec.max_depth`` the level is
    shaded ambient-only and spawns nothing (raytrace.rs:33).
    """
    dtype = ro.x.dtype
    diffuse, specular, ambient = hit.diffuse, hit.specular, hit.ambient
    exponent, ior, msamples = hit.exponent, hit.ior, hit.msamples
    is_fresnel, is_transp, is_indirect = (hit.is_fresnel, hit.is_transp,
                                          hit.is_indirect)

    pt = hit.pt    # surface-snapped hit point (ops/intersect.py)
    nd = dot(hit.normal, rd)              # raw-normal cosine (unflipped)
    flip = nd > 0
    n_f = vec.where(flip, -hit.normal, hit.normal)

    # ---- fresnel / refraction block (raytrace.rs:128-136, 174-192) ----
    # Statically skipped when the scene has no Fresnel/Transparent
    # materials (spec.mat_type is compile-time): ~40 elementwise ops per
    # shade round that contribute exactly fres_mult == 1 otherwise —
    # e.g. the golden scene (Phong + IndirectPhong only) saves them in
    # every one of its 6 level rounds.  ``fres_mult = None`` encodes the
    # static 1.0 (helpers below elide the multiply entirely).
    has_ft = any(t in (MAT_FRESNEL, MAT_TRANSPARENT) for t in spec.mat_type)
    if has_ft:
        r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        # Transparent: Snell + TIR
        ior_safe = jnp.where(ior != 0, ior, 1.0)  # ior=0 -> no refraction
        n_ratio = jnp.where(nd > 0, ior, 1.0 / ior_safe)
        sin2 = n_ratio * n_ratio * (1.0 - nd * nd)
        refract_ok = (sin2 < 1.0) & (ior != 0)
        # double-where: sqrt'(0) = inf, so TIR lanes must see a safe
        # inner argument (1.0), not just a masked output — otherwise the
        # backward pass forms inf * 0 = NaN (tests/test_nan_audit.py)
        cos_t = jnp.where(
            refract_ok,
            jnp.sqrt(_clamp0(jnp.where(refract_ok, 1.0 - sin2, 1.0))), 0.0)
        # mask n_ratio on TIR lanes so ``refr`` stays finite there — its
        # value is never selected, but an inf/NaN would poison cotangents
        # through the masked branches (the where-NaN gradient trap)
        n_r = jnp.where(refract_ok, n_ratio, 0.0)
        refr = rd.scale(n_r) - n_f.scale(n_r * jnp.abs(nd) + cos_t)
        omcos_transp = jnp.where(
            nd > 0,
            jnp.where(refract_ok, 1.0 - dot(n_f, refr), 0.0),
            1.0 - jnp.abs(nd))
        omcos = jnp.where(is_fresnel, 1.0 - jnp.abs(nd), omcos_transp)
        omcos2 = omcos * omcos
        schlick = _clamp1(r0 + (1.0 - r0) * omcos2 * omcos2 * omcos)
        fresnel = jnp.where(is_transp & ~refract_ok, 1.0, schlick)
        fres_mult = jnp.where(is_fresnel | is_transp, fresnel,
                              jnp.ones_like(fresnel))
    else:
        fresnel = refract_ok = refr = None  # refract slot needs has_ft
        fres_mult = None                    # statically 1.0

    def _fm(x):
        """``x * fres_mult`` with the static-1.0 multiply elided."""
        return x if fres_mult is None else x * fres_mult

    # ---- significance gates ----
    diff_sig = diffuse.x + diffuse.y + diffuse.z
    spec_sig = specular.x + specular.y + specular.z
    ms = spec.min_significance
    diffuse_gate = diff_sig * sig > ms
    if has_ft:
        diffuse_gate = diffuse_gate & ~is_transp
    spec_gate = _fm(spec_sig) * sig > ms

    emit = ambient  # Transparent's ambient is all-zero by construction

    if depth > spec.max_depth:
        # ambient only, no direct light, no recursion (raytrace.rs:33)
        return emit, []

    # ---- direct lighting (static loop over lights) ----
    shaded = live & hit.hit
    inv_pi = np.asarray(1.0 / np.pi, dtype)
    for li, lt in enumerate(spec.light_type):
        ldir, sqr, has_range = light_dir_and_sq_range(
            data, lt, li, pt, k1, k2, dtype)
        blocked = occluded_v(data, spec, pt + ldir.scale(_OFFSET),
                             ldir, sqr, has_range)
        vis = shaded & ~blocked
        lr, lg, lb = (data.light_color[li, 0], data.light_color[li, 1],
                      data.light_color[li, 2])
        lam = _clamp0(dot(ldir, n_f)) * inv_pi
        dmask = vis & diffuse_gate
        wd = jnp.where(dmask, lam, 0.0)
        emit = V3(emit.x + diffuse.x * lr * wd,
                  emit.y + diffuse.y * lg * wd,
                  emit.z + diffuse.z * lb * wd)
        half = vec.safe_normalize(ldir - rd)
        ph = _clamp0(dot(n_f, half)) ** exponent
        smask = vis & spec_gate
        ws = jnp.where(smask, _fm(ph), 0.0)
        emit = V3(emit.x + specular.x * lr * ws,
                  emit.y + specular.y * lg * ws,
                  emit.z + specular.z * lb * ws)

    # ---- child slots ----
    children: list[Child] = []
    slot = 0
    can_spawn = live & hit.hit
    if spec.has_reflect:
        rdir = rd - n_f.scale(2.0 * dot(rd, n_f))
        gate = can_spawn & spec_gate & ~is_indirect
        children.append(Child(
            ro=pt + rdir.scale(_OFFSET), rd=rdir,
            sig=(sig * spec_sig if fres_mult is None
                 else sig * spec_sig * fres_mult),
            weight=(specular if fres_mult is None
                    else specular.scale(fres_mult)),
            live=gate, slot=slot))
        slot += 1
    if spec.has_refract:
        assert has_ft  # has_refract => a Transparent material is present
        gate = can_spawn & is_transp & (fresnel < 1.0) & refract_ok
        omf = _clamp1(1.0 - fresnel)
        rdir = vec.safe_normalize(refr)
        children.append(Child(
            ro=pt + rdir.scale(_OFFSET), rd=rdir,
            sig=omf * sig,
            weight=V3(omf, omf, omf),
            live=gate, slot=slot))
        slot += 1
    for k in range(spec.n_indirect):
        r1 = rng.draw(k1, k2, rng.PURPOSE_INDIRECT_R1 + 2 * k,
                      dtype) * 2.0 - 1.0
        phi = rng.draw(k1, k2, rng.PURPOSE_INDIRECT_R2 + 2 * k,
                       dtype) * (2.0 * jnp.pi)
        s = 1.0 - r1 * r1
        d = V3(s * jnp.cos(phi), r1, s * jnp.sin(phi))
        d = vec.where(dot(d, n_f) >= 0, d, -d)
        fac = msamples * 0.5
        w = dot(n_f, d) / jnp.where(fac > 0, fac, 1.0)
        # raytrace.rs:99 spawns when diffuse OR specular is significant,
        # but a spec-only indirect child's reference contribution is
        # all-NaN (module docstring divergence) so those are culled —
        # leaving exactly the diffuse-significant ones
        gate = can_spawn & is_indirect & diffuse_gate & (k < msamples)
        children.append(Child(
            ro=pt + d.scale(_OFFSET), rd=d,
            sig=sig,                      # unattenuated (raytrace.rs:109)
            weight=diffuse.scale(w), live=gate, slot=slot))
        slot += 1
    return emit, children
