"""Primitive-sharded ring intersection (the TP / ring-attention analog).

For scenes too large to keep resident per-device during intersection,
the object set is sharded over the mesh's data axis and *circulated*
around the device ring with ``lax.ppermute`` (SURVEY.md §5.7): at every
one of the k steps each device intersects its ray shard against the
object shard currently resident, folds the result into a running
``min(t)`` — an associative reduction, so the ring form is exact — and
forwards the shard to its neighbor.  After k steps every ray has seen
every object while only 1/k of the geometry was ever resident per
device.

The per-step shard intersection is a ``lax.scan`` over the shard's
unified primitive table (:func:`scan_table`), so the per-device program
size is O(1) in shard size.

There is no softmax-like coupling across the object axis (unlike
attention), so no blockwise/Ulysses variant is needed — the ring is the
whole story.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from raytrace_tpu.ops.intersect import _typed_geometry, vma_zeros
from raytrace_tpu.ops.vec import V3
from raytrace_tpu.scene.schema import Scene, SceneData, SceneSpec


def shard_geometry(data: SceneData, spec: SceneSpec, k: int):
    """Split the scene into k equal unified-table object shards.

    Returns ``(tables (k, C, 4), ids (k, C), n_sph_pad)`` where every
    shard holds ``n_sph_pad`` sphere rows (cx, cy, cz, r) followed by
    plane rows (n, p.n); zero-padding rows are masked by the kernel's
    r > 0 / n != 0 validity and carry id -1.  Index maps are static
    (from SceneSpec); values stay jnp so gradients flow back into
    ``data``.
    """
    sph, pln = _typed_geometry(data, spec)
    dt = data.prim_p.dtype

    def shard_rows(rows, ids):
        o = rows.shape[0]
        per = -(-max(o, 1) // k)
        pad = per * k - o
        rows = jnp.concatenate(
            [rows, jnp.zeros((pad, 4), dt)]) if o else jnp.zeros(
                (per * k, 4), dt)
        ids = np.concatenate([ids, np.full(pad, -1, np.int64)])
        return rows.reshape(k, per, 4), ids.reshape(k, per), per

    sph_rows = (jnp.concatenate(
        [data.prim_p[sph], data.prim_q[sph, 0:1]], axis=1)
        if len(sph) else jnp.zeros((0, 4), dt))
    pn = jnp.sum(data.prim_p[pln] * data.prim_q[pln], axis=1,
                 keepdims=True)
    pln_rows = (jnp.concatenate([data.prim_q[pln], pn], axis=1)
                if len(pln) else jnp.zeros((0, 4), dt))

    sph_rows, sph_ids, n_sph_pad = shard_rows(sph_rows, sph)
    pln_rows, pln_ids, _ = shard_rows(pln_rows, pln)

    tables = jnp.concatenate([sph_rows, pln_rows], axis=1)
    ids = jnp.asarray(
        np.concatenate([sph_ids, pln_ids], axis=1).astype(np.int32))
    return tables, ids, n_sph_pad


_ID_SENTINEL = np.int32(2 ** 31 - 1)  # obj value on miss lanes


def scan_table(table, ids, n_sph_pad: int, ro: V3, rd: V3):
    """(t, global obj id, hit) of rays vs one unified primitive table.

    table: (C, 4), spheres (cx, cy, cz, r) in rows [0, n_sph_pad),
    planes (nx, ny, nz, p.n) after (shapes.rs:60-87, 102-110; the plane
    test only needs ``n.(p0 - o) = p.n - o.n``, so the point is
    pre-reduced); ids: (C,) int32 global object id per row (pad rows:
    -1, masked by r > 0 / n != 0).  On an exact t tie the lowest global
    id wins (min_by_key first-in-scene-order, scene.rs:248), so within
    a shard and across the ring fold ties resolve identically.  Miss
    lanes carry id 2^31-1 — mask with ``hit`` before gathering.
    """
    a = rd.x * rd.x + rd.y * rd.y + rd.z * rd.z
    # derive the carry init from ro.x so it inherits ro's vma (inside
    # shard_map a replicated zeros init would mismatch the carry type);
    # vma_zeros also sanitizes non-finite dead-lane origins
    zero = vma_zeros(ro.x)
    init = (zero + jnp.inf, zero.astype(jnp.int32) + _ID_SENTINEL,
            zero > 1)

    def step(carry, xs):
        row, gid, rowid = xs
        is_sph = rowid < n_sph_pad
        # sphere branch
        ocx, ocy, ocz = ro.x - row[0], ro.y - row[1], ro.z - row[2]
        b = 2.0 * (rd.x * ocx + rd.y * ocy + rd.z * ocz)
        cc = ocx * ocx + ocy * ocy + ocz * ocz - row[3] * row[3]
        disc = b * b - 4.0 * a * cc
        has = disc > 0.0
        sq = jnp.sqrt(jnp.where(has, disc, 1.0))
        inv2a = 0.5 / jnp.where(a > 0, a, 1.0)  # zero-rd-safe (intersect.safe_inv2a)
        ts1 = (-b - sq) * inv2a
        ts2 = (-b + sq) * inv2a
        ts = jnp.where(ts1 > 0.0, ts1, ts2)
        vs = has & (ts > 0.0) & (row[3] > 0.0)  # r > 0: mask pad rows
        # plane branch
        denom = rd.x * row[0] + rd.y * row[1] + rd.z * row[2]
        numer = row[3] - (ro.x * row[0] + ro.y * row[1] + ro.z * row[2])
        ok = denom != 0.0
        tp = numer / jnp.where(ok, denom, 1.0)
        vp = ok & (tp > 0.0)

        t_i = jnp.where(is_sph, ts, tp)
        v_i = jnp.where(is_sph, vs, vp)
        t_best, obj, hit = carry
        t_i = jnp.where(v_i, t_i, jnp.inf)
        better = (t_i < t_best) | ((t_i == t_best) & v_i & (gid < obj))
        return (jnp.where(better, t_i, t_best),
                jnp.where(better, gid, obj), hit | v_i), None

    rowids = jnp.arange(table.shape[0], dtype=jnp.int32)
    (t, obj, hit), _ = jax.lax.scan(step, init, (table, ids, rowids))
    return t, obj, hit


def ring_closest_hit_local(table, ids, n_sph_pad: int, ro: V3, rd: V3,
                           axis: str):
    """Ring intersection body — call inside ``shard_map``.

    Each device holds its ray shard (ro/rd) and one object shard
    (table+ids); shards circulate ``axis_size`` times.  Returns
    (t (N,), obj (N,), hit (N,)) for the local ray shard, with the
    first-minimum-in-file-order tie-break across shards: on an exact t
    tie the lower global object id wins (scene.rs:248).
    """
    k = lax.axis_size(axis)
    perm = [(i, (i + 1) % k) for i in range(k)]
    t_best = jnp.full_like(ro.x, jnp.inf)
    obj = jnp.full(ro.x.shape, jnp.int32(2 ** 31 - 1))
    hit = jnp.zeros(ro.x.shape, bool)

    for step in range(k):
        t_s, gid, h_s = scan_table(table, ids, n_sph_pad, ro, rd)
        t_s = jnp.where(h_s, t_s, jnp.inf)
        better = (t_s < t_best) | ((t_s == t_best) & h_s & (gid < obj))
        t_best = jnp.where(better, t_s, t_best)
        obj = jnp.where(better, gid, obj)
        hit = hit | h_s
        if step + 1 < k:
            table = lax.ppermute(table, axis, perm)
            ids = lax.ppermute(ids, axis, perm)
    obj = jnp.where(hit, obj, 0)
    return t_best, obj, hit


class RingContext(NamedTuple):
    """Per-device state for object-sharded rendering, installed via
    ``ops.intersect.set_ring_ctx`` inside a shard_map body.  While
    active, every closest-hit / shadow query in the wavefront integrator
    runs as a ppermute ring over ``axis``."""

    axis: str
    table: jnp.ndarray     # (C, 4) local geometry shard (unified rows)
    ids: jnp.ndarray       # (C,) global object id per row (pad: -1)
    n_sph_pad: int         # static sphere-partition size of each shard
    mat_rows: jnp.ndarray  # (per, 22) local packed-object-table shard
                           #   (contiguous global rows [d*per, (d+1)*per))


def ring_gather_rows(mat_rows, obj, axis: str):
    """Gather winning packed-table rows for sharded tables: the (O, 22)
    object table is sharded in contiguous row ranges over ``axis``;
    shards circulate with ppermute and each ray picks its row when the
    owning shard is resident.  Exact (pure selects), O(N*22) per step.
    """
    k = lax.axis_size(axis)
    per = mat_rows.shape[0]
    me = lax.axis_index(axis)
    perm = [(i, (i + 1) % k) for i in range(k)]
    out = jnp.zeros((obj.shape[0], mat_rows.shape[1]), mat_rows.dtype)
    rows = mat_rows
    for step in range(k):
        src = (me - step) % k          # global shard resident this step
        local = obj - src * per
        m = (local >= 0) & (local < per)
        got = jnp.take(rows, jnp.clip(local, 0, per - 1), axis=0)
        out = jnp.where(m[:, None], got, out)
        if step + 1 < k:
            rows = lax.ppermute(rows, axis, perm)
    return out


def ring_closest_hit(ctx: RingContext, ro: V3, rd: V3):
    """Full ring closest-hit: intersection ring + material-row ring +
    HitRec assembly.  Produces bit-identical records to the dense
    scanned path (the (t, id)-lexicographic min is fold-order-free and
    the row math is shared via ``intersect.hitrec_from_rows``)."""
    from raytrace_tpu.ops.intersect import hitrec_from_rows

    t_best, obj, hit = ring_closest_hit_local(
        ctx.table, ctx.ids, ctx.n_sph_pad, ro, rd, ctx.axis)
    rows = ring_gather_rows(ctx.mat_rows, obj, ctx.axis)
    return hitrec_from_rows(rows, t_best, obj, hit, ro, rd)


def ring_occluded(ctx: RingContext, ro: V3, rd: V3, sq_range,
                  has_range: bool):
    """Shadow query through the ring (raytrace.rs:43-50 semantics)."""
    t_best, _, hit = ring_closest_hit_local(
        ctx.table, ctx.ids, ctx.n_sph_pad, ro, rd, ctx.axis)
    if has_range:
        return hit & (t_best * t_best < sq_range)
    return hit


def shard_object_table(table: jnp.ndarray, k: int):
    """Pad the (O, 22) packed object table to k contiguous row shards.
    Returns (k, per, 22); pad rows are never selected (obj < O)."""
    o = table.shape[0]
    per = -(-o // k)
    pad = per * k - o
    if pad:
        table = jnp.concatenate(
            [table, jnp.zeros((pad, table.shape[1]), table.dtype)])
    return table.reshape(k, per, table.shape[1])


def strip_object_data(data: SceneData) -> SceneData:
    """Replace the per-object leaves with 1-row dummies: in ring mode
    the shading code touches only light/camera/background leaves, and
    replicating (O, .) arrays into the shard_map body would defeat the
    point of sharding the scene."""
    z1 = jnp.zeros((1, 3), data.prim_p.dtype)
    z0 = jnp.zeros((1,), data.prim_p.dtype)
    return dataclasses.replace(
        data, prim_p=z1, prim_q=z1, mat_diffuse=z1, mat_specular=z1,
        mat_ambient=z1, mat_exponent=z0, mat_ior=z0, mat_samples=z0)


@partial(jax.jit, static_argnames=("spec", "seed", "s_launch", "n_chunks",
                                   "mesh", "p_local", "n_sph_pad"))
def _render_chunks_ring(data, spec, tables, ids, mats, px, py, s0,
                        s_launch, n_chunks, seed, mesh, p_local,
                        n_sph_pad):
    """Device-accumulated sharded render launches with BOTH the pixel
    axis and the object set sharded over the mesh (the huge-scene
    counterpart of parallel.tile._render_chunks_sharded)."""
    from raytrace_tpu.ops import intersect
    from raytrace_tpu.render.integrator import _render_chunks

    axes = mesh.axis_names
    assert len(axes) == 1, "ring rendering wants a flat 1-axis mesh"
    axis = axes[0]

    def local(data, tables, ids, mats, px, py, s0):
        ctx = RingContext(axis=axis, table=tables[0], ids=ids[0],
                          n_sph_pad=n_sph_pad, mat_rows=mats[0])
        prev = intersect.set_ring_ctx(ctx)
        try:
            return _render_chunks(data, spec, px, py, s0, s_launch,
                                  n_chunks, seed, p_local)
        finally:
            intersect.set_ring_ctx(prev)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(axes), P(axes), P(axes), P(axes), P(axes), P()),
        out_specs=P(axes))
    return fn(data, tables, ids, mats, px, py, s0)


def render_image_ring(scene: Scene, *, seed: int = 0,
                      spp: int | None = None, mesh=None,
                      max_lanes: int = 1 << 22, progress=None,
                      checkpoint: str | None = None) -> np.ndarray:
    """Full-image render with the OBJECT set ring-sharded over the mesh
    (and the pixel axis tile-sharded as usual): no device ever holds
    more than 1/k of the geometry + material tables.  Bit-identical to
    the dense render — the RNG is identity-keyed and the ring fold is
    the same (t, id)-lexicographic min as the scanned path.

    The public entry point for scenes too large to replicate
    (SURVEY.md §5.7; the scale analog of the reference's linear
    ``Scene::intersect``, scene.rs:247-249).
    """
    from raytrace_tpu.ops.intersect import packed_object_table
    from raytrace_tpu.parallel.mesh import make_mesh
    from raytrace_tpu.render.integrator import _image_loop

    data, spec = scene.data, scene.spec
    mesh = mesh if mesh is not None else make_mesh()
    if len(mesh.axis_names) > 1:
        raise ValueError("ring rendering wants a flat 1-axis mesh; "
                         "got " + str(mesh.axis_names))
    k = int(np.prod(list(mesh.shape.values())))

    # host-side shard construction: each device receives only its slice
    tables, ids, n_sph_pad = shard_geometry(data, spec, k)
    mats = shard_object_table(packed_object_table(data, spec), k)
    stripped = strip_object_data(data)
    ring_scene = dataclasses.replace(scene, data=stripped)

    def _pad(px, py):
        n = px.shape[0]
        pad = (-n) % k
        if pad:
            px = jnp.concatenate([px, jnp.zeros(pad, px.dtype)])
            py = jnp.concatenate([py, jnp.zeros(pad, py.dtype)])
        return px, py, n

    def launch_chunks(data, spec, px, py, s0, s_launch, n_chunks, seed,
                      p_launch):
        px, py, n = _pad(px, py)
        p_local = max(p_launch // k, 1)
        out = _render_chunks_ring(data, spec, tables, ids, mats, px, py,
                                  s0, s_launch, n_chunks, seed, mesh,
                                  p_local, n_sph_pad)
        return out[:n]

    def launch(data, spec, px, py, sids, seed):
        raise NotImplementedError  # chunked path is always used

    return _image_loop(ring_scene, launch, seed=seed, spp=spp,
                       max_lanes=max_lanes * k, progress=progress,
                       checkpoint=checkpoint, launch_chunks=launch_chunks)


def make_ring_intersector(spec: SceneSpec, mesh, axis: str = "d"):
    """Jitted end-to-end ring intersection over ``mesh``.

    Returns ``fn(data, ro (N,3), rd (N,3)) -> (t, obj, hit)`` with rays
    and objects both sharded over ``axis`` (N divisible by the mesh
    size).
    """
    k = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))

    def run(data, ro, rd):
        tables, ids, n_sph_pad = shard_geometry(data, spec, k)

        def body(table, ids, ro, rd):
            return ring_closest_hit_local(
                table[0], ids[0], n_sph_pad,
                V3(ro[:, 0], ro[:, 1], ro[:, 2]),
                V3(rd[:, 0], rd[:, 1], rd[:, 2]), axis)

        fn = shard_map(
            body, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis)))
        return fn(tables, ids, ro, rd)

    return jax.jit(run)
