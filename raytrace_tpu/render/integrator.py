"""Wavefront integrator: the data-parallel re-design of the recursive core
``ray_color`` / ``raytrace`` (raytrace.rs:261-276) and the driver pixel
loop (main.rs:45-59).

The reference recurses per ray with data-dependent branching.  XLA wants
one traced program with static shapes, so recursion becomes a statically
unrolled *level loop* (SURVEY.md §7): level ``d`` holds all rays at
recursion depth ``d`` — ``N * B^d`` lanes where ``B`` is the static
branching factor (reflect + refract + n_indirect slots derived from the
material set actually in the scene).  Each level does one batched
closest-hit query, one batched shade, accumulates ``throughput * emit``
into the per-primary-sample radiance, and emits the next level's rays.
Significance/depth pruning (raytrace.rs:17-18) becomes lane masking, and
the whole loop is differentiable: ``jax.grad`` of any function of the
returned radiance flows into every SceneData leaf.

Radiance decomposition note: the reference computes
``res = local + Σ_child weight_child * ray_color(child)`` bottom-up; by
linearity this equals the top-down sum over all tree nodes of
``(Π ancestors' weights) * local``, which is what the level loop
accumulates — no recursion stack needed.

Levels run ``0 ‥ max_depth+1`` inclusive: depths 0‥4 shade fully and
spawn, depth 5 is intersected then shaded ambient/background-only
(raytrace.rs:18,33 semantics ⇒ 6 intersection rounds per primary sample,
matching BASELINE.md).
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from raytrace_tpu.models.backgrounds import background_color_v
from raytrace_tpu.models.cameras import project
from raytrace_tpu.models.materials import shade
from raytrace_tpu.ops import rng, vec
from raytrace_tpu.ops.intersect import closest_hit
from raytrace_tpu.ops.vec import V3
from raytrace_tpu.scene.schema import Scene, SceneData, SceneSpec
from raytrace_tpu.utils.profiling import annotate


def _flatten_slots(parts):
    """[(N,), ...] per child slot -> (N*B,) interleaved per parent.

    Slot arrays are stacked on a new minor axis then flattened, so the
    B children of parent i occupy lanes [i*B, (i+1)*B) — keeping the
    per-primary grouping contiguous for the level-sum reshape.
    """
    if len(parts) == 1:
        return parts[0]
    return jnp.stack(parts, axis=1).reshape(-1)


def _compact_children(b: int, m: int, live, ro, rd, sig, tp, k1, k2):
    """Compact B child slots down to m live lanes per parent.

    The child gates are material-exclusive (SceneSpec.max_live_children)
    so each parent has at most m live children among its b slots; a
    branchless per-parent selection network (O(b*m) masked selects)
    moves them into the first m output slots.  RNG keys are derived
    *before* compaction, so every surviving lane keeps its exact stream
    identity — compacted and uncompacted renders are bit-identical
    while deep levels shrink from N*B^d to N*m^d lanes (a 4-slot
    transparent+indirect scene does (4/2)^5 = 32x less work at the
    deepest level).
    """
    n = live.shape[0] // b
    live2 = live.reshape(n, b)
    # exclusive running count of live slots = each live child's
    # destination slot within its parent
    prefix = jnp.cumsum(live2, axis=1) - live2.astype(jnp.int32)

    def comp(arr, default):
        a2 = arr.reshape(n, b)
        cols = []
        for j in range(m):
            col = jnp.full((n,), default, a2.dtype)
            for s in range(b):
                take = live2[:, s] & (prefix[:, s] == j)
                col = jnp.where(take, a2[:, s], col)
            cols.append(col)
        return jnp.stack(cols, axis=1).reshape(-1)

    def compv(v: V3) -> V3:
        return V3(comp(v.x, 0), comp(v.y, 0), comp(v.z, 0))

    return (comp(live, False), compv(ro), compv(rd), comp(sig, 0),
            compv(tp), comp(k1, 0), comp(k2, 0))


def radiance_linear_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3,
                      k1, k2, significance=None, miss_records=None) -> V3:
    """Radiance chain for scenes whose wavefront never fans out
    (``spec.children_per_ray <= 1`` — e.g. the golden scene's single
    indirect slot, or pure mirror-Phong scenes).

    Unlike :func:`radiance_v` this is *shape-agnostic*: every op is
    elementwise over whatever shape ``ro.x`` has, with no reshapes —
    which is what lets the fused render kernel
    (:mod:`raytrace_tpu.render.megakernel`) run the exact same code on
    lane blocks held in registers.

    ``miss_records``: when a list is passed, background shading is
    DEFERRED — miss lanes contribute 0 here and ONE merged
    ``(miss_mask, rd, tp)`` tuple is appended for the whole chain: a
    live linear-chain lane misses at most once (a missed lane spawns no
    children — materials.shade gates every slot on ``hit.hit`` — so it
    is dead at every later level), making the per-lane miss set a
    single record.  The fused kernel uses this for skybox scenes: the
    bilinear texture gather stays out of the kernel, which emits the
    merged miss event, and a fused jnp post-pass adds
    ``tp * skybox(rd)``.  Exact: a lane's contributions are
    hit-XOR-miss per level, so deferring the single miss term changes
    only the order of exact +0 additions.
    """
    dtype = ro.x.dtype
    sig = (jnp.ones_like(ro.x) if significance is None
           else jnp.broadcast_to(significance, ro.x.shape).astype(dtype))
    live = jnp.ones(ro.x.shape, bool)
    tp = vec.full_like(sig, 1.0)
    acc = vec.full_like(sig, 0.0)
    zero = vec.full_like(sig, 0.0)
    m_any = jnp.zeros(ro.x.shape, bool)
    m_rd = zero
    m_tp = zero

    for depth in range(spec.max_depth + 2):
        hit = closest_hit(data, spec, ro, rd)
        emit, children = shade(data, spec, ro, rd, hit, sig, live, k1, k2,
                               depth)
        assert len(children) <= 1, "use radiance_v for fan-out scenes"
        if miss_records is None:
            bg = background_color_v(data, spec, rd)
            local = vec.where(hit.hit, emit, bg)
        else:
            miss = live & ~hit.hit
            m_any = m_any | miss
            m_rd = vec.where(miss, rd, m_rd)
            m_tp = vec.where(miss, tp, m_tp)
            local = vec.where(hit.hit, emit, vec.full_like(sig, 0.0))
        contrib = vec.where(live, tp.mul(local), vec.full_like(sig, 0.0))
        acc = acc + contrib

        if not children:
            break
        c = children[0]
        ro, rd, sig, live = c.ro, c.rd, c.sig, c.live
        tp = tp.mul(c.weight)
        tp = vec.where(live, tp, vec.full_like(sig, 0.0))
        k1, k2 = rng.derive(k1, k2, c.slot)

    if miss_records is not None:
        miss_records.append((m_any, m_rd, m_tp))
    return acc


def _route_children(children, m: int, tp: V3, k1, k2):
    """b child slots -> m virtual children, routed per lane in registers.

    The elementwise analog of :func:`_compact_children` for the DFS tree
    walk (:func:`radiance_tree_v`).  There a lane's b child slots are
    separate register values (not segments of a widened lane axis), so
    routing the <=m live ones into the first m virtual slots is a pure
    per-lane selection network with no reshape.

    RNG keys are derived from the ORIGINAL slot index before routing, so
    every surviving child keeps the exact stream identity it has in the
    (un)compacted wavefront.  Returns m tuples
    ``(ro, rd, sig, tp, live, k1, k2)`` where ``tp`` is the parent
    throughput already multiplied by the child's weight.
    """
    b = len(children)
    keys = [rng.derive(k1, k2, c.slot) for c in children]
    tps = [tp.mul(c.weight) for c in children]

    # exclusive running count of live slots = destination virtual slot
    run = jnp.zeros(children[0].live.shape, jnp.int32)
    prefix = []
    for c in children:
        prefix.append(run)
        run = run + c.live.astype(jnp.int32)

    virt = []
    for j in range(m):
        take = [children[s].live & (prefix[s] == j) for s in range(b)]

        def sel(getter):
            out = jnp.zeros_like(getter(0))
            for s in range(1, b):
                out = jnp.where(take[s], getter(s), out)
            return jnp.where(take[0], getter(0), out)

        def selv(getter):
            return V3(sel(lambda s: getter(s).x),
                      sel(lambda s: getter(s).y),
                      sel(lambda s: getter(s).z))

        live = take[0]
        for s in range(1, b):
            live = live | take[s]
        virt.append((selv(lambda s: children[s].ro),
                     selv(lambda s: children[s].rd),
                     sel(lambda s: children[s].sig),
                     selv(lambda s: tps[s]),
                     live,
                     sel(lambda s: keys[s][0]),
                     sel(lambda s: keys[s][1])))
    return virt


def radiance_tree_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3,
                    k1, k2, significance=None) -> V3:
    """Radiance for fan-out scenes as a static DFS over the virtual
    child tree — the *shape-agnostic* counterpart of :func:`radiance_v`.

    :func:`radiance_v` widens the lane axis by the branching factor at
    each level and compacts it with reshapes, which a kernel operating
    on fixed lane blocks cannot do.  Here
    the recursion tree of ``ray_color`` (raytrace.rs:261-267) is walked
    depth-first instead: each node performs one closest-hit + shade on
    the SAME lane shape, routes its b child slots into
    ``m = spec.max_live_children`` virtual children per lane
    (:func:`_route_children` — the slot gates are material-exclusive,
    raytrace.rs:59-64/99-117/154-164/214-223, so at most m are live),
    and recurses into each.  Total work is ``sum_d m^d`` node visits —
    identical lane-work to the compacted wavefront, with zero lane-axis
    reshapes.

    Visits the same child set with the same RNG stream identities as
    :func:`radiance_v`; only the floating-point accumulation ORDER
    differs (DFS vs per-level block sums), so the two agree to roundoff
    rather than bit-for-bit.  It is the form a fused fan-out kernel
    would trace; the render path runs :func:`radiance_v`.
    """
    dtype = ro.x.dtype
    sig = (jnp.ones_like(ro.x) if significance is None
           else jnp.broadcast_to(significance, ro.x.shape).astype(dtype))
    live = jnp.ones(ro.x.shape, bool)
    tp = vec.full_like(sig, 1.0)

    def node(ro, rd, sig, live, tp, k1, k2, depth):
        hit = closest_hit(data, spec, ro, rd)
        emit, children = shade(data, spec, ro, rd, hit, sig, live, k1, k2,
                               depth)
        bg = background_color_v(data, spec, rd)
        local = vec.where(hit.hit, emit, bg)
        acc = vec.where(live, tp.mul(local), vec.full_like(sig, 0.0))
        if not children:
            return acc
        m = min(max(spec.max_live_children, 1), len(children))
        if m < len(children):
            virt = _route_children(children, m, tp, k1, k2)
        else:
            virt = [(c.ro, c.rd, c.sig, tp.mul(c.weight), c.live)
                    + rng.derive(k1, k2, c.slot) for c in children]
        for cro, crd, csig, ctp, clive, ck1, ck2 in virt:
            ctp = vec.where(clive, ctp, vec.full_like(csig, 0.0))
            acc = acc + node(cro, crd, csig, clive, ctp, ck1, ck2,
                             depth + 1)
        return acc

    return node(ro, rd, sig, live, tp, k1, k2, 0)


def tree_nodes(spec: SceneSpec) -> int:
    """Closest-hit rounds per lane in :func:`radiance_tree_v` (the DFS
    node count): ``sum_{d=0}^{max_depth+1} m^d``."""
    m = max(min(spec.max_live_children, spec.children_per_ray), 1)
    total, w = 0, 1
    for _ in range(spec.max_depth + 2):
        total += w
        w *= m
    return total


def radiance_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3, k1, k2,
               significance=None) -> V3:
    """Radiance for a batch of primary rays — ``ray_color`` for a
    wavefront (raytrace.rs:261-267), component layout.

    ro/rd: V3 of (N,) lanes; k1/k2: (N,) per-lane RNG streams;
    significance: initial per-ray significance (default 1.0, main.rs:54).
    Returns V3 of (N,) linear radiance components.
    """
    if spec.children_per_ray <= 1:
        return radiance_linear_v(data, spec, ro, rd, k1, k2, significance)
    n = ro.x.shape[0]
    dtype = ro.x.dtype
    sig = (jnp.ones(n, dtype) if significance is None
           else jnp.broadcast_to(significance, (n,)).astype(dtype))
    live = jnp.ones(n, bool)
    tp = vec.full_like(sig, 1.0)
    acc = vec.full_like(sig, 0.0)

    for depth in range(spec.max_depth + 2):
        hit = closest_hit(data, spec, ro, rd)
        emit, children = shade(data, spec, ro, rd, hit, sig, live, k1, k2,
                               depth)
        bg = background_color_v(data, spec, rd)
        local = vec.where(hit.hit, emit, bg)
        contrib = vec.where(live, tp.mul(local), vec.full_like(sig, 0.0))
        # sum this level's lanes back onto the primary-ray axis
        acc = V3(acc.x + contrib.x.reshape(n, -1).sum(axis=1),
                 acc.y + contrib.y.reshape(n, -1).sum(axis=1),
                 acc.z + contrib.z.reshape(n, -1).sum(axis=1))

        if not children:
            break
        # flatten child slots: (N_level, B, ...) -> (N_level * B, ...)
        ro = V3(*(_flatten_slots([c.ro[i] for c in children])
                  for i in range(3)))
        rd = V3(*(_flatten_slots([c.rd[i] for c in children])
                  for i in range(3)))
        sig = _flatten_slots([c.sig for c in children])
        live_n = _flatten_slots([c.live for c in children])
        tp_children = [tp.mul(c.weight) for c in children]
        tp = V3(*(_flatten_slots([t[i] for t in tp_children])
                  for i in range(3)))
        live = live_n
        tp = vec.where(live, tp, vec.full_like(sig, 0.0))
        ks = [rng.derive(k1, k2, c.slot) for c in children]
        k1 = _flatten_slots([k[0] for k in ks])
        k2 = _flatten_slots([k[1] for k in ks])

        b, m = len(children), spec.max_live_children
        if 0 < m < b and not os.environ.get("RAYTRACE_TPU_NO_COMPACTION"):
            live, ro, rd, sig, tp, k1, k2 = _compact_children(
                b, m, live, ro, rd, sig, tp, k1, k2)

    return acc


def radiance(data: SceneData, spec: SceneSpec, ro, rd, k1, k2,
             significance=None) -> jnp.ndarray:
    """(N,3)-layout wrapper around :func:`radiance_v`."""
    out = radiance_v(data, spec, vec.splat(ro), vec.splat(rd), k1, k2,
                     significance)
    return vec.pack(out)


@annotate("raygen")
def primary_rays(data: SceneData, spec: SceneSpec, pix, piy, aa, cam,
                 seed: int):
    """Jittered primary rays for per-lane (pixel-x, pixel-y, aa-sample,
    lens-sample) integer identity arrays — the NDC transform of
    main.rs:39-53 plus the camera projection, shape-agnostic (used on 1D
    lane vectors by :func:`sample_pixels` and on 2D register blocks by
    the Pallas megakernel).

    Returns ``(ro: V3, rd: V3, k1, k2)`` where k1/k2 are the per-lane
    RNG streams (the lens index already folded in).
    """
    dtype = data.prim_p.dtype

    pix = pix.astype(jnp.uint32)
    piy = piy.astype(jnp.uint32)
    aa = aa.astype(jnp.uint32)
    cam = cam.astype(jnp.uint32)

    # jitter streams keyed by (x, y, aa) only — shared across lens samples
    jk1, jk2 = rng.make_keys(seed, pix, piy, aa)
    u = rng.draw(jk1, jk2, rng.PURPOSE_AA_X, dtype)
    v = rng.draw(jk1, jk2, rng.PURPOSE_AA_Y, dtype)

    # NDC transform (main.rs:39-53): unit square inscribed in the image
    halfw = spec.width / 2.0
    halfh = spec.height / 2.0
    scale = max(1.0 / halfw, 1.0 / halfh)
    pos_x = ((rng.to_float(pix, dtype) + u) - halfw) * scale
    pos_y = ((rng.to_float(piy, dtype) + v) - halfh) * scale

    # full per-lane streams fold in the lens sample index
    k1, k2 = rng.make_keys(seed, pix, piy, aa, cam)
    ro, rd = project(data, spec, pos_x, pos_y, k1, k2)
    return ro, rd, k1, k2


def sample_pixels(data: SceneData, spec: SceneSpec, px, py, sample_ids,
                  seed: int) -> jnp.ndarray:
    """Render a set of samples for a batch of pixels — the data-parallel
    driver loop body (main.rs:45-55 × raytrace.rs:270-276).

    px/py: (P,) integer pixel coordinates (x from the left, y from the
    *bottom*, matching the BMP bottom-up row order the reference streams,
    main.rs:45-58); sample_ids: (S,) integer antialias sample indices in
    [0, antialias).  Returns the (P, 3) *mean* radiance over the S
    samples and the camera's lens samples.

    The AA jitter is drawn per (pixel, aa-sample) (main.rs:50-53); the
    camera's own ``samples()`` lens loop (raytrace.rs:272-275) adds an
    inner axis of ``spec.cam_samples`` lens draws per AA sample.
    """
    dtype = data.prim_p.dtype
    p, s = px.shape[0], sample_ids.shape[0]
    c = spec.cam_samples

    # lane axis = (pixel, aa_sample, cam_sample), flattened
    pix = jnp.repeat(px, s * c)
    piy = jnp.repeat(py, s * c)
    aa = jnp.tile(jnp.repeat(sample_ids, c), p)
    cam = jnp.tile(jnp.arange(c, dtype=jnp.uint32), p * s)

    from raytrace_tpu.render import megakernel
    # traced seeds (per-step optimizer reseeding) can't parameterize the
    # kernel's closure; they take the jnp path
    if isinstance(seed, (int, np.integer)) and megakernel.usable(data, spec):
        rad = megakernel.radiance_lanes(data, spec, pix, piy, aa, cam, seed)
    else:
        ro, rd, k1, k2 = primary_rays(data, spec, pix, piy, aa, cam, seed)
        rad = radiance_v(data, spec, ro, rd, k1, k2)
    out = V3(rad.x.reshape(p, s * c).mean(axis=1),
             rad.y.reshape(p, s * c).mean(axis=1),
             rad.z.reshape(p, s * c).mean(axis=1))
    return vec.pack(out)


@partial(jax.jit, static_argnames=("spec", "seed"))
def _render_tile(data, spec, px, py, sample_ids, seed):
    return sample_pixels(data, spec, px, py, sample_ids, seed)


@partial(jax.jit, static_argnames=("spec", "seed", "s_launch", "n_chunks",
                                   "p_launch"))
def _render_chunks(data, spec, px, py, s0, s_launch, n_chunks, seed,
                   p_launch):
    """``n_chunks`` sample chunks x all pixel tiles, accumulated ON
    DEVICE in one launch.

    A naive host loop would fetch every (pixel-tile, sample-chunk)
    launch's output and pay one device round trip and one dispatch per
    launch.  Here both loops are ``fori_loop``s inside one jit: the
    outer loop walks ``p_launch``-pixel tiles (the lane-budget knob),
    the inner loop walks sample chunks; only the final (P, 3) mean
    reaches the host.
    """
    dtype = data.prim_p.dtype
    n = px.shape[0]
    p_launch = min(p_launch, n)
    pad = (-n) % p_launch
    if pad:
        px = jnp.concatenate([px, jnp.zeros(pad, px.dtype)])
        py = jnp.concatenate([py, jnp.zeros(pad, py.dtype)])
    n_tiles = (n + pad) // p_launch

    # seed carries from px so they inherit px's vma (inside shard_map
    # the outputs vary over the mesh; a replicated zeros init would
    # make the fori_loop carry types mismatch)
    def vzeros(p):
        return (p * 0).astype(dtype)[:, None] + jnp.zeros((1, 3), dtype)

    def tile_body(tidx, acc):
        off = tidx * p_launch
        pxt = jax.lax.dynamic_slice(px, (off,), (p_launch,))
        pyt = jax.lax.dynamic_slice(py, (off,), (p_launch,))

        def chunk_body(i, tacc):
            sids = (s0 + i * s_launch
                    + jnp.arange(s_launch, dtype=jnp.uint32))
            return tacc + sample_pixels(data, spec, pxt, pyt, sids, seed)

        t = jax.lax.fori_loop(0, n_chunks, chunk_body, vzeros(pxt))
        return jax.lax.dynamic_update_slice(acc, t / n_chunks, (off, 0))

    out = jax.lax.fori_loop(0, n_tiles, tile_body, vzeros(px))
    return out[:n]


def _wavefront_widest(spec: SceneSpec) -> int:
    """Widest wavefront level in lanes-per-primary-sample: each level
    expands to B slots, then compaction (if enabled and useful) shrinks
    to m live lanes before the next level."""
    b = max(spec.children_per_ray, 1)
    m = max(spec.max_live_children, 1)
    if m >= b or os.environ.get("RAYTRACE_TPU_NO_COMPACTION"):
        return b ** (spec.max_depth + 1)
    return b * m ** spec.max_depth


def _s_p_launch(spec: SceneSpec, aa: int, max_lanes: int, widest: int = 1):
    """Pick (samples, pixels) per launch so the wavefront's widest level
    stays within the device lane budget — and *fills* that budget: small
    images take more samples per launch, so every launch is wide enough
    to keep the device busy."""
    lane_budget = max(max_lanes // (widest * spec.cam_samples), 1)
    n_pix = spec.width * spec.height
    if n_pix <= lane_budget:
        p_launch = n_pix
        s_launch = min(aa, max(lane_budget // n_pix, 1))
    else:
        p_launch = lane_budget
        s_launch = 1
    return s_launch, p_launch


# runtime failures worth re-issuing a pure launch for
_TRANSIENT_ERRORS = (getattr(jax.errors, "JaxRuntimeError", RuntimeError),)
# deterministic XLA statuses that a retry cannot fix: re-raise at once
# (an OOM retry even actively hurts — it thrashes the allocator)
_PERMANENT_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                      "INVALID_ARGUMENT", "INVALID ARGUMENT",
                      "OUT_OF_RANGE", "UNIMPLEMENTED", "FAILED_PRECONDITION",
                      "out of memory", "Out of memory")


def _is_transient(err: BaseException) -> bool:
    """Whether a JaxRuntimeError is plausibly transient (lost device,
    worker deadline, preemption) rather than a deterministic
    failure.  JaxRuntimeError carries the XLA status in its message;
    anything matching a permanent status class is NOT retried."""
    msg = str(err)
    return not any(m in msg for m in _PERMANENT_MARKERS)


def _retry_launch(fn, *args, retries: int = 2):
    """Run a device launch, retrying on transient runtime failures.

    Every render launch is a pure function of (scene, pixel/sample
    identity arrays) — idempotent by construction — so a launch killed
    by a transient device or runtime fault is safely re-issued
    (SURVEY.md §5.3: tile-level retry; the reference's closest analog
    is its valid-prefix row streaming, main.rs:56-58).  Only transient
    runtime errors are retried (``_is_transient``); programming errors
    and deterministic XLA failures (OOM, invalid argument) propagate
    immediately.  ``block_until_ready`` inside the guarded region
    surfaces async device failures here rather than at the later host
    fetch.
    """
    import sys
    import time as _time

    for attempt in range(retries + 1):
        try:
            return jax.block_until_ready(fn(*args))
        except _TRANSIENT_ERRORS as e:
            if attempt == retries or not _is_transient(e):
                raise
            print(f"[raytrace_tpu] launch failed (attempt {attempt + 1}/"
                  f"{retries + 1}); retrying", file=sys.stderr)
            _time.sleep(0.5 * (attempt + 1))


def _save_checkpoint(path: str, **arrays) -> None:
    """Atomic checkpoint write: temp file + ``os.replace`` so a kill
    mid-write never corrupts the resume state the feature exists to
    protect (SURVEY.md §5.3-5.4; the reference's analog is its
    valid-prefix row streaming, main.rs:56-58)."""
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz when the name has no extension
    if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def _image_loop(scene: Scene, launch, *, seed: int, spp: int | None,
                max_lanes: int, progress, checkpoint: str | None,
                launch_chunks=None, chunk_group: int = 32) -> np.ndarray:
    """Host tiling loop shared by single-device and sharded rendering.

    Outer loop over AA-sample chunks, inner loop over pixel tiles; the
    f64 host accumulator is checkpointed to ``checkpoint`` (npz) after
    every completed sample chunk, so a killed long render resumes at the
    last chunk boundary — the data-parallel analog of the reference's
    valid-prefix row streaming (main.rs:56-58; SURVEY.md §5.4).

    ``progress``: called with one float, the completed fraction in
    [0, 1] (samples fully accumulated plus the in-flight chunk's pixel
    share).
    """
    data, spec = scene.data, scene.spec
    w, h = spec.width, spec.height
    aa = spp if spp is not None else max(spec.antialias, 1)
    # the fused kernel covers only linear scenes, whose widest level is
    # one lane per sample, so the wavefront width sizes every launch
    s_launch, p_launch = _s_p_launch(spec, aa, max_lanes,
                                     _wavefront_widest(spec))

    image = np.zeros((h * w, 3), np.float64)
    s_done = 0
    if checkpoint is not None and os.path.exists(checkpoint):
        ck = np.load(checkpoint)
        ident = (ck["width"] == w and ck["height"] == h
                 and ck["aa"] == aa and ck["seed"] == seed)
        if ident:
            image = ck["image"]
            s_done = int(ck["s_done"])
        else:
            raise ValueError(
                f"checkpoint {checkpoint} was written for a different "
                f"render config; refusing to mix")

    pix = np.arange(h * w, dtype=np.uint32)
    px_all, py_all = pix % w, pix // w

    if launch_chunks is not None:
        # accumulate (pixel tile x sample chunk) launches on device,
        # fetching only once per group of chunks.  The group size is
        # bounded by a per-launch WORK budget in lane-levels — a single
        # XLA execution that runs for minutes can trip device worker
        # deadlines, so heavy fan-out scenes take smaller groups.
        work_per_chunk = (h * w * s_launch * spec.cam_samples
                          * _wavefront_widest(spec))
        budget = 1 << 28
        g_cap = max(min(chunk_group, budget // max(work_per_chunk, 1)), 1)
        px_d, py_d = jnp.asarray(px_all), jnp.asarray(py_all)
        s0 = s_done
        while s0 < aa:
            rem = aa - s0
            if rem >= s_launch:
                g, sl = min(g_cap, rem // s_launch), s_launch
            else:
                g, sl = 1, rem          # ragged tail chunk
            n_s = g * sl
            out = _retry_launch(launch_chunks, data, spec, px_d, py_d,
                                jnp.uint32(s0), sl, g, seed, p_launch)
            image += np.asarray(out, np.float64) * (n_s / aa)
            s0 += n_s
            if progress is not None:
                progress(s0 / aa)
            if checkpoint is not None:
                _save_checkpoint(checkpoint, image=image, s_done=s0,
                                 width=w, height=h, aa=aa, seed=seed)
        return image.reshape(h, w, 3)

    for s0 in range(s_done, aa, s_launch):
        sids = jnp.arange(s0, min(s0 + s_launch, aa), dtype=jnp.uint32)
        s_weight = len(sids) / aa
        for p0 in range(0, h * w, p_launch):
            sl = slice(p0, min(p0 + p_launch, h * w))
            out = _retry_launch(launch, data, spec, jnp.asarray(px_all[sl]),
                                jnp.asarray(py_all[sl]), sids, seed)
            image[sl] += np.asarray(out, np.float64) * s_weight
            if progress is not None:
                # fully-done samples + the in-flight chunk's pixel share
                progress((s0 + len(sids) * sl.stop / (h * w)) / aa)
        if checkpoint is not None:
            _save_checkpoint(checkpoint, image=image, s_done=s0 + len(sids),
                             width=w, height=h, aa=aa, seed=seed)
    return image.reshape(h, w, 3)


def render_image(scene: Scene, *, seed: int = 0, spp: int | None = None,
                 max_lanes: int = 1 << 22, progress=None,
                 checkpoint: str | None = None) -> np.ndarray:
    """Render the full image on one device: host tiling loop around the
    jitted per-tile sampler.  Returns an (H, W, 3) float array of linear
    radiance, row 0 = *bottom* row (BMP order).

    ``spp`` overrides the scene's antialias count.  ``max_lanes`` bounds
    device memory (see :func:`_s_p_launch`); ``checkpoint`` enables
    chunk-level resume.
    """
    def launch(data, spec, px, py, sids, seed):
        return _render_tile(data, spec, px, py, sids, seed)

    return _image_loop(scene, launch, seed=seed, spp=spp,
                       max_lanes=max_lanes, progress=progress,
                       checkpoint=checkpoint, launch_chunks=_render_chunks)
