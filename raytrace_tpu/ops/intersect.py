"""Batched ray-scene intersection (closest hit + shadow queries).

Data-parallel re-design of the reference's geometry kernel (SURVEY.md §2
#2-5): ``Sphere::intersect`` (shapes.rs:43-89), ``Plane::intersect``
(shapes.rs:93-112) and the linear-scan ``Scene::intersect``
(scene.rs:244-250).  The reference tests one ray against one boxed shape
at a time through a vtable; here a structure-of-arrays batch of N rays is
tested against all objects at once as pure elementwise arithmetic.

Layout: everything is component-separated ``(N,)`` arrays (ops/vec.py) —
no ``(N, O)`` t-matrix is ever built: the object loop is statically
unrolled with a *running min* carried in ``(N,)`` registers, and the
winning object's **shading parameters are selected during the same
loop** (a chain of masked selects) — no argmin and no gather
materializes.

Semantics preserved exactly:

* sphere: strict ``discriminant > 0``; near root ``(-b - sqrt(D)) / 2a``
  if ``t > 0`` else far root; unit outward normal ``(p - c)/|p - c|``
  (shapes.rs:60-87);
* plane: ``t = n.(p0 - o) / n.d``, reject ``t <= 0``; the returned normal
  is the *stored* plane normal, un-normalized and un-flipped
  (shapes.rs:102-110);
* closest hit: first minimum in scene-file object order (``min_by_key``
  keeps the earliest minimum, scene.rs:248; the running ``<`` update does
  the same);
* shadow query: blocked iff the closest hit satisfies ``t^2 < range^2``
  (or any hit at all for range-free directional lights, raytrace.rs:43-50)
  — since ``min(t)^2 < r^2  <=>  any(t^2 < r^2)`` for positive t, the
  shadow query needs no min at all.

Documented divergences (guarded edge cases, SURVEY.md §2 #4):

* a ray exactly parallel to a plane gives ``t = ±inf`` (or NaN when also
  contained in the plane) in the reference; both are measure-zero float
  accidents, rejected here (``denominator == 0`` => miss) to keep
  gradients finite;

* hit points are **snapped onto the analytic surface** before shading
  (sphere: ``c + r * unit(pt - c)``; plane: ``pt`` minus its normal
  distance).  In f64 this is the identity to ~1e-16, i.e. reference
  semantics are preserved bit-for-noise; in f32 it is load-bearing: the
  raw ``ro + rd * t`` reconstruction carries ``O(|ro|) * eps_f32 ~ 2e-5``
  of error — *larger* than the reference's fixed 1e-5 secondary-ray
  offset (raytrace.rs:43,62,108) — so secondary rays could start inside
  spheres and spuriously self-intersect, visibly darkening sphere
  regions (measured: ~15/255 sRGB in the golden image's sphere area).

Differentiability: the winning object *selection* is discrete (no
gradient, = subgradient semantics at visibility silhouettes); ``t``,
normals and material parameters are selected values of differentiable
per-object expressions, so gradients flow into sphere centers/radii,
plane points/normals and the whole material table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from raytrace_tpu.ops import vec
from raytrace_tpu.ops.vec import V3, dot, pack, splat
from raytrace_tpu.scene.schema import (
    MAT_FRESNEL, MAT_INDIRECT_PHONG, MAT_TRANSPARENT, SHAPE_PLANE,
    SHAPE_SPHERE, SceneData, SceneSpec)
from raytrace_tpu.utils.profiling import annotate


class HitRec(NamedTuple):
    """Closest-hit record + pre-selected shading parameters, all (N,)."""

    t: jnp.ndarray         # hit distance; +inf on miss
    hit: jnp.ndarray       # bool
    obj: jnp.ndarray       # int32 winning object (scene-file order)
    normal: V3             # geometric normal (reference semantics)
    pt: V3                 # hit point, snapped onto the analytic surface
    # winning object's material row (selected during the min loop)
    diffuse: V3
    specular: V3
    ambient: V3
    exponent: jnp.ndarray
    ior: jnp.ndarray
    msamples: jnp.ndarray
    is_fresnel: jnp.ndarray   # bool
    is_transp: jnp.ndarray    # bool
    is_indirect: jnp.ndarray  # bool


def safe_inv2a(a):
    """``0.5 / a``, guarded for zero-direction lanes: dead / TIR child
    slots carry ``rd = 0`` (live = False, e.g. materials.py's masked
    refraction direction), and an inf here becomes ``inf * 0 = NaN``
    in backward-pass cotangents (caught by tests/test_nan_audit.py).
    ``disc`` keeps the real ``a``, so those lanes still compute
    ``has = False`` — no phantom hits, just finite masked t values."""
    return 0.5 / jnp.where(a > 0, a, 1.0)


def _object_t(data: SceneData, spec: SceneSpec, i: int, ro: V3, rd: V3,
              a, inv2a=None):
    """t and validity for object ``i`` (static), as (N,) arrays.

    ``inv2a = 0.5 / a`` is hoisted to the caller's per-level scope when
    provided — it is ray-only, so the division runs once per closest-hit
    round instead of once per sphere."""
    if spec.shape_type[i] == SHAPE_SPHERE:
        c = V3(data.prim_p[i, 0], data.prim_p[i, 1], data.prim_p[i, 2])
        r = data.prim_q[i, 0]
        oc = ro - c  # scalar components broadcast against (N,)
        b = 2.0 * dot(rd, oc)
        cc = dot(oc, oc) - r * r
        disc = b * b - 4.0 * a * cc
        has = disc > 0.0
        sq = jnp.sqrt(jnp.where(has, disc, 1.0))   # NaN-safe for grads
        if inv2a is None:
            inv2a = safe_inv2a(a)
        t1 = (-b - sq) * inv2a
        t2 = (-b + sq) * inv2a
        t = jnp.where(t1 > 0.0, t1, t2)
        return t, has & (t > 0.0)
    assert spec.shape_type[i] == SHAPE_PLANE
    n = V3(data.prim_q[i, 0], data.prim_q[i, 1], data.prim_q[i, 2])
    p_dot_n = (data.prim_p[i, 0] * data.prim_q[i, 0]
               + data.prim_p[i, 1] * data.prim_q[i, 1]
               + data.prim_p[i, 2] * data.prim_q[i, 2])
    denom = dot(rd, n)
    numer = p_dot_n - dot(ro, n)
    ok = denom != 0.0
    t = numer / jnp.where(ok, denom, 1.0)
    return t, ok & (t > 0.0)


def _snapped_point(pt: V3, rel: V3, inv, is_sph, radius, nrm: V3,
                   p0: V3) -> V3:
    """Project the reconstructed hit point onto the winning object's
    analytic surface (see module docstring: f32 robustness, f64 no-op).

    ``rel = pt - center``, ``inv = 1/|rel|`` (sphere lanes); ``nrm``/
    ``p0`` are the plane's stored normal and point (plane lanes).
    """
    # sphere: center + radius * unit(rel)
    k = radius * inv
    sph = V3(pt.x - rel.x + rel.x * k,
             pt.y - rel.y + rel.y * k,
             pt.z - rel.z + rel.z * k)
    # plane: pt - n * ((pt - p0).n / n.n)
    nn = dot(nrm, nrm)
    dist = (dot(pt, nrm) - dot(p0, nrm)) / jnp.where(nn > 0, nn, 1.0)
    pln = pt - nrm.scale(jnp.where(nn > 0, dist, 0.0))
    return vec.where(is_sph, sph, pln)


# above this object count the statically unrolled loop gives way to a
# lax.scan over object chunks (compile size stays O(1) in scene size)
LARGE_SCENE_THRESHOLD = 64
_SCAN_CHUNK = 16


def _typed_geometry(data: SceneData, spec: SceneSpec):
    """Static type partition: (sphere idx, plane idx) as np arrays."""
    st = np.asarray(spec.shape_type)
    return np.nonzero(st == SHAPE_SPHERE)[0], np.nonzero(st == SHAPE_PLANE)[0]


def vma_zeros(x):
    """Zeros with ``x``'s shape, dtype AND vma (inside shard_map a
    replicated ``jnp.zeros`` constant would mismatch varying carry
    types).  The naive ``x * 0`` turns non-finite lanes into NaN — and
    dead lanes legitimately carry ``rd = 0`` / arbitrary origins in the
    masked-child pattern — so non-finite inputs are sanitized first."""
    return jnp.where(jnp.isfinite(x), x, 0.0) * 0


def _scan_min(t_best, obj, hit, params, ids, body, n_like):
    """Scan ``body`` over chunks of the object axis, carrying the
    running (t_best, obj, hit).  params: (O, K) rows; ids: (O,) int32
    global object indices.  Chunks are padded with id = -1 (masked)."""
    o = params.shape[0]
    pad = (-o) % _SCAN_CHUNK
    if pad:
        params = jnp.concatenate(
            [params, jnp.zeros((pad, params.shape[1]), params.dtype)])
        ids = jnp.concatenate([ids, jnp.full(pad, -1, jnp.int32)])
    params = params.reshape(-1, _SCAN_CHUNK, params.shape[1])
    ids = ids.reshape(-1, _SCAN_CHUNK)

    def step(carry, xs):
        t_b, ob, h = carry
        rows, rid = xs
        for c in range(_SCAN_CHUNK):
            t_i, v_i = body(rows[c])
            v_i = v_i & (rid[c] >= 0)
            t_i = jnp.where(v_i, t_i, jnp.inf)
            # gid tie-break: sphere/plane partitions are scanned out of
            # scene-file order, so restore min_by_key's first-in-scene-
            # order semantics (scene.rs:248) on exact t ties
            better = (t_i < t_b) | ((t_i == t_b) & v_i & (rid[c] < ob))
            t_b = jnp.where(better, t_i, t_b)
            ob = jnp.where(better, rid[c], ob)
            h = h | v_i
        return (t_b, ob, h), None

    (t_best, obj, hit), _ = jax.lax.scan(
        step, (t_best, obj, hit), (params, ids))
    return t_best, obj, hit


def _scan_all_objects(data: SceneData, spec: SceneSpec, ro: V3, rd: V3, a):
    """Running-min over all objects via lax.scan (large scenes)."""
    n_like = ro.x
    sph, pln = _typed_geometry(data, spec)
    # carries derive from the rays so they inherit their vma (see
    # vma_zeros; caught driving the sharded >64-object render)
    zero = vma_zeros(n_like)
    t_best = zero + jnp.inf
    obj = zero.astype(jnp.int32) + np.int32(2 ** 31 - 1)
    hit = zero > 1

    if len(sph):
        rows = jnp.concatenate(
            [data.prim_p[sph], data.prim_q[sph, 0:1]], axis=1)  # (S, 4)
        ids = jnp.asarray(sph.astype(np.int32))

        def sphere_body(row):
            oc = ro - V3(row[0], row[1], row[2])
            b = 2.0 * dot(rd, oc)
            cc = dot(oc, oc) - row[3] * row[3]
            disc = b * b - 4.0 * a * cc
            has = disc > 0.0
            sq = jnp.sqrt(jnp.where(has, disc, 1.0))
            inv2a = safe_inv2a(a)
            t1 = (-b - sq) * inv2a
            t2 = (-b + sq) * inv2a
            t = jnp.where(t1 > 0.0, t1, t2)
            return t, has & (t > 0.0)

        t_best, obj, hit = _scan_min(t_best, obj, hit, rows, ids,
                                     sphere_body, n_like)

    if len(pln):
        rows = jnp.concatenate(
            [data.prim_p[pln], data.prim_q[pln]], axis=1)       # (P, 6)
        ids = jnp.asarray(pln.astype(np.int32))

        def plane_body(row):
            nrm = V3(row[3], row[4], row[5])
            p_dot_n = row[0] * row[3] + row[1] * row[4] + row[2] * row[5]
            denom = dot(rd, nrm)
            numer = p_dot_n - dot(ro, nrm)
            ok = denom != 0.0
            t = numer / jnp.where(ok, denom, 1.0)
            return t, ok & (t > 0.0)

        t_best, obj, hit = _scan_min(t_best, obj, hit, rows, ids,
                                     plane_body, n_like)
    return t_best, jnp.where(hit, obj, 0), hit


def packed_object_table(data: SceneData, spec: SceneSpec) -> jnp.ndarray:
    """The (O, 22) per-object parameter table the scanned regime (and
    the object-sharded ring render, parallel/ring.py) gathers winning
    rows from: geometry, material row, and static type flags."""
    dtype = data.prim_p.dtype
    mts = np.asarray(spec.mat_type, np.int32)
    sts = np.asarray(spec.shape_type, np.int32)
    flags = np.stack([mts == MAT_FRESNEL, mts == MAT_TRANSPARENT,
                      mts == MAT_INDIRECT_PHONG,
                      sts == SHAPE_SPHERE], 1).astype(np.float32)
    return jnp.concatenate([
        data.prim_p, data.prim_q,                       # 0:3, 3:6
        data.mat_diffuse, data.mat_specular,            # 6:9, 9:12
        data.mat_ambient,                               # 12:15
        data.mat_exponent[:, None], data.mat_ior[:, None],
        data.mat_samples[:, None],                      # 15, 16, 17
        jnp.asarray(flags, dtype),                      # 18:22
    ], axis=1)


def hitrec_from_rows(rows, t_best, obj, hit, ro: V3, rd: V3) -> HitRec:
    """Assemble a HitRec from gathered packed-table rows (N, 22)
    (packed_object_table layout): normal reconstruction, surface
    snapping, material fields."""
    col = lambda j: rows[:, j]  # noqa: E731
    t_safe = jnp.where(hit, t_best, 0.0)
    pt = ro + rd.scale(t_safe)
    rel = pt - V3(col(0), col(1), col(2))
    nrm2 = dot(rel, rel)
    inv = jax.lax.rsqrt(jnp.where(nrm2 > 0, nrm2, 1.0))
    is_sph = col(21) > 0.5
    normal = V3(jnp.where(is_sph, rel.x * inv, col(3)),
                jnp.where(is_sph, rel.y * inv, col(4)),
                jnp.where(is_sph, rel.z * inv, col(5)))
    pt = _snapped_point(pt, rel, inv, is_sph, col(3),
                        V3(col(3), col(4), col(5)),
                        V3(col(0), col(1), col(2)))

    return HitRec(
        t=t_best, hit=hit, obj=obj, normal=normal, pt=pt,
        diffuse=V3(col(6), col(7), col(8)),
        specular=V3(col(9), col(10), col(11)),
        ambient=V3(col(12), col(13), col(14)),
        exponent=col(15),
        ior=jnp.where(hit, col(16), 1.0),  # miss lanes: finite ior
        msamples=col(17),
        is_fresnel=col(18) > 0.5, is_transp=col(19) > 0.5,
        is_indirect=col(20) > 0.5)


def _closest_hit_scanned(data: SceneData, spec: SceneSpec, ro: V3,
                         rd: V3) -> HitRec:
    """Large-scene closest hit: scan + one packed-table row gather.

    The winning object's parameters come from a single ``take`` of a
    packed (O, 22) table — one gather per level instead of per-object
    selects, the right trade once O is large.
    """
    t_best, obj, hit = _scan_all_objects(data, spec, ro, rd, dot(rd, rd))
    rows = jnp.take(packed_object_table(data, spec), obj, axis=0)  # (N, 22)
    return hitrec_from_rows(rows, t_best, obj, hit, ro, rd)


# --- object-sharded (ring) dispatch ----------------------------------------
# Trace-time hook set by parallel.ring's object-sharded render: while a
# RingContext is active (inside a shard_map body), every closest-hit and
# shadow query is answered by circulating object shards around the mesh
# axis with ppermute instead of by the resident scene — the device never
# holds more than 1/k of the geometry + material tables (SURVEY.md §5.7).
_RING_CTX = None


def set_ring_ctx(ctx):
    """Install a ring context; returns the previous one (for restore)."""
    global _RING_CTX
    prev = _RING_CTX
    _RING_CTX = ctx
    return prev


@annotate("intersect")
def closest_hit(data: SceneData, spec: SceneSpec, ro: V3, rd: V3) -> HitRec:
    """Closest-hit query + material row selection (scene.rs:247-249)."""
    if _RING_CTX is not None:
        from raytrace_tpu.parallel import ring
        return ring.ring_closest_hit(_RING_CTX, ro, rd)
    dtype = ro.x.dtype
    n_like = ro.x
    a = dot(rd, rd)

    mts = np.asarray(spec.mat_type, np.int32)
    live_obj = [i for i in range(spec.n_objects) if spec.shape_type[i] >= 0]

    if len(live_obj) > LARGE_SCENE_THRESHOLD:
        return _closest_hit_scanned(data, spec, ro, rd)

    t_best = jnp.full_like(n_like, jnp.inf)
    hit = jnp.zeros(n_like.shape, bool)
    obj = jnp.zeros(n_like.shape, jnp.int32)
    sel = None  # dict of selected params

    has_sphere = any(spec.shape_type[i] == SHAPE_SPHERE for i in live_obj)
    inv2a = safe_inv2a(a) if has_sphere else None
    for i in live_obj:
        t_i, v_i = _object_t(data, spec, i, ro, rd, a, inv2a)
        t_i = jnp.where(v_i, t_i, jnp.inf)
        better = t_i < t_best
        t_best = jnp.where(better, t_i, t_best)
        hit = hit | v_i
        obj = jnp.where(better, i, obj)

        is_sph = spec.shape_type[i] == SHAPE_SPHERE
        row = dict(
            cx=data.prim_p[i, 0], cy=data.prim_p[i, 1], cz=data.prim_p[i, 2],
            qx=data.prim_q[i, 0], qy=data.prim_q[i, 1], qz=data.prim_q[i, 2],
            dr=data.mat_diffuse[i, 0], dg=data.mat_diffuse[i, 1],
            db=data.mat_diffuse[i, 2],
            sr=data.mat_specular[i, 0], sg=data.mat_specular[i, 1],
            sb=data.mat_specular[i, 2],
            ar=data.mat_ambient[i, 0], ag=data.mat_ambient[i, 1],
            ab=data.mat_ambient[i, 2],
            exp=data.mat_exponent[i], ior=data.mat_ior[i],
            ms=data.mat_samples[i],
            sph=np.asarray(1.0 if is_sph else 0.0, dtype),
            fre=np.asarray(1.0 if mts[i] == MAT_FRESNEL else 0.0, dtype),
            tra=np.asarray(1.0 if mts[i] == MAT_TRANSPARENT else 0.0, dtype),
            ind=np.asarray(1.0 if mts[i] == MAT_INDIRECT_PHONG else 0.0,
                           dtype),
        )
        if sel is None:
            # unconditionally adopt the first object's row: miss lanes
            # then carry object-0 parameters, exactly like the argmin
            # formulation (argmin of all-inf = 0) — and unlike a zero
            # fill, real parameter values (ior etc.) keep the masked-out
            # material arithmetic finite for clean gradients
            sel = {k: jnp.broadcast_to(v, n_like.shape) for k, v in
                   row.items()}
        else:
            sel = {k: jnp.where(better, row[k], sel[k]) for k in sel}

    if sel is None:  # empty scene
        z = jnp.zeros_like(n_like)
        zv = V3(z, z, z)
        return HitRec(t=jnp.full_like(n_like, jnp.inf),
                      hit=jnp.zeros(n_like.shape, bool), obj=obj,
                      normal=zv, pt=ro, diffuse=zv, specular=zv,
                      ambient=zv, exponent=z, ior=z, msamples=z,
                      is_fresnel=z > 1, is_transp=z > 1, is_indirect=z > 1)

    # normal: sphere => unit (pt - c); plane => stored q, raw
    t_safe = jnp.where(hit, t_best, 0.0)
    pt = ro + rd.scale(t_safe)
    rel = pt - V3(sel["cx"], sel["cy"], sel["cz"])
    nrm2 = dot(rel, rel)
    inv = jax.lax.rsqrt(jnp.where(nrm2 > 0, nrm2, 1.0))
    is_sph = sel["sph"] > 0.5
    normal = V3(
        jnp.where(is_sph, rel.x * inv, sel["qx"]),
        jnp.where(is_sph, rel.y * inv, sel["qy"]),
        jnp.where(is_sph, rel.z * inv, sel["qz"]))
    pt = _snapped_point(pt, rel, inv, is_sph, sel["qx"],
                        V3(sel["qx"], sel["qy"], sel["qz"]),
                        V3(sel["cx"], sel["cy"], sel["cz"]))

    return HitRec(
        t=t_best, hit=hit, obj=obj, normal=normal, pt=pt,
        diffuse=V3(sel["dr"], sel["dg"], sel["db"]),
        specular=V3(sel["sr"], sel["sg"], sel["sb"]),
        ambient=V3(sel["ar"], sel["ag"], sel["ab"]),
        exponent=sel["exp"], ior=sel["ior"], msamples=sel["ms"],
        is_fresnel=sel["fre"] > 0.5, is_transp=sel["tra"] > 0.5,
        is_indirect=sel["ind"] > 0.5)


def occluded_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3,
               sq_range, has_range: bool) -> jnp.ndarray:
    """Shadow query (raytrace.rs:43-50), component form: is any hit
    inside range?  Equivalent to the reference's closest-hit test but
    min-free (see module docstring)."""
    if _RING_CTX is not None:
        from raytrace_tpu.parallel import ring
        return ring.ring_occluded(_RING_CTX, ro, rd, sq_range, has_range)
    a = dot(rd, rd)
    n_live = sum(1 for t in spec.shape_type if t >= 0)
    if n_live > LARGE_SCENE_THRESHOLD:
        t_best, _, hit = _scan_all_objects(data, spec, ro, rd, a)
        if has_range:
            return hit & (t_best * t_best < sq_range)
        return hit
    blocked = jnp.zeros(ro.x.shape, bool)
    has_sphere = any(t == SHAPE_SPHERE for t in spec.shape_type)
    inv2a = safe_inv2a(a) if has_sphere else None
    for i in range(spec.n_objects):
        if spec.shape_type[i] < 0:
            continue
        t_i, v_i = _object_t(data, spec, i, ro, rd, a, inv2a)
        if has_range:
            v_i = v_i & (t_i * t_i < sq_range)
        blocked = blocked | v_i
    return blocked


# ---------------------------------------------------------------------------
# (N, 3) API wrappers (tests / external callers)


class Hit(NamedTuple):
    """Legacy (N,3)-layout hit record."""

    t: jnp.ndarray
    normal: jnp.ndarray   # (N, 3)
    obj: jnp.ndarray
    hit: jnp.ndarray


def intersect(data: SceneData, spec: SceneSpec, ro, rd) -> Hit:
    """Closest-hit query for an (N,3) ray batch (scene.rs:247-249)."""
    h = closest_hit(data, spec, splat(ro), splat(rd))
    return Hit(t=h.t, normal=pack(h.normal), obj=h.obj, hit=h.hit)


def occluded(data: SceneData, spec: SceneSpec, ro, rd,
             sq_range, has_range: bool) -> jnp.ndarray:
    """Shadow query for an (N,3) ray batch."""
    return occluded_v(data, spec, splat(ro), splat(rd), sq_range, has_range)
