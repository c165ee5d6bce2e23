"""Benchmark harness: rays/sec on the golden workload, on one GPU.

Metric: rays/sec at 1024^2, depth-4 bounces — one "ray" = one
scene-intersection round of a wavefront lane (the golden scene traces
max_depth+2 = 6 per primary sample, BASELINE.md).

Measurement methodology: the launch loop runs *inside* jit as a
``lax.fori_loop`` whose body input varies per iteration and whose
output feeds a scalar sum fetched at the end — so every launch really
executes on device, in order, with no host round-trips.  Throughput is
the **least-squares slope of median chain time over several chain
lengths** (k = 4, 16, 64), which cancels the fixed dispatch + transfer
+ fetch overhead.

Default mode prints ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "device", "card"}.  ``vs_baseline`` is measured against
the reference's own workload ground truth: the reference publishes no
numbers (BASELINE.md), so the anchor is REF_CPU_RAYS_PER_SEC, the rust
binary's estimated single-thread throughput (see BASELINE.md §"de
novo"); update it if re-measured.

``--large N`` benches an N-sphere procedural field (the scanned
closest-hit path) instead of the golden scene.

``--shard`` mode (BASELINE.md item 3, the scaling-efficiency harness):
weak-scaling comparison on the current mesh — every device runs the
same per-device launch as the single-device bench, pixels sharded via
``shard_map``; efficiency = single-device slope / sharded slope (1.0 =
perfect).  Prints one JSON line with per-device throughput and
efficiency.

The script refuses to run (non-zero exit) unless JAX's default device
is a GPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from functools import partial

import numpy as np

# the reference's golden scene, committed as a DSL file
GOLDEN_SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples", "test_scene.txt")

# Anchor: the reference Rust binary is single-thread scalar f64.  Rust
# is unavailable in this image, so the anchor was MEASURED with a
# faithful C++ stand-in (native/ref_anchor.cpp: same recursion, same
# golden-scene math per bounce, same xorshift128 RNG; g++ -O2
# -march=native, this machine's CPU): 8.51M scene-intersections/sec,
# radiance mean cross-checked against this renderer (0.433 vs 0.441).
REF_CPU_RAYS_PER_SEC = 8.5e6

KS, REPS = (4, 16, 64), 5


def _measure_slope(chain, px, py, ks=KS, reps=REPS):
    """LSQ slope (s/launch) + intercept of median chain time over k,
    plus the raw per-k times (for the audit tools' tables).

    Every timed call gets fresh inputs.  Medians of interleaved reps +
    a least-squares fit over chain lengths make the slope robust to
    per-call latency outliers and drift.
    """
    for k in ks:
        chain(px, py, k).block_until_ready()   # compile + warm
    times = {k: [] for k in ks}
    bias = 0
    for _ in range(reps):
        for k in ks:
            bias += 1
            t0 = time.perf_counter()
            float(chain(px + bias, py, k))
            times[k].append(time.perf_counter() - t0)
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    a = np.array([[k, 1.0] for k in ks])
    y = np.array([med(times[k]) for k in ks])
    (per_launch, overhead), *_ = np.linalg.lstsq(a, y, rcond=None)
    return float(per_launch), float(overhead), times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shard", action="store_true",
                    help="weak-scaling efficiency over the device mesh")
    ap.add_argument("--lanes", type=int, default=1 << 21,
                    help="lanes per device per launch (default 2^21)")
    ap.add_argument("--large", type=int, default=None, metavar="N",
                    help="bench an N-sphere procedural field instead of "
                         "the golden scene (scanned closest-hit path)")
    ap.add_argument("--mix", action="store_true",
                    help="with --large: mixed materials (Transparent/"
                         "Fresnel/IndirectPhong) => fan-out scene")
    args = ap.parse_args(argv)

    import jax
    from raytrace_tpu.parallel.mesh import maybe_init_distributed
    maybe_init_distributed()
    import jax.numpy as jnp
    from raytrace_tpu.scene.builder import load_scene_file
    from raytrace_tpu.render.integrator import sample_pixels
    from raytrace_tpu.utils.cache import enable_compile_cache
    from raytrace_tpu.utils.device import nvidia_smi_line, require_gpu

    where = {"device": require_gpu(), "card": nvidia_smi_line()}
    enable_compile_cache()

    sc = load_scene_file(GOLDEN_SCENE, dtype=jnp.float32)
    # BASELINE config: 1024^2, depth-4 (golden scene constants)
    spec = dataclasses.replace(sc.spec, width=1024, height=1024)
    data = sc.data
    levels = spec.max_depth + 2  # intersect rounds per primary sample

    n_s = 16
    n_pix = max(args.lanes // n_s, 1)
    pix = np.arange(n_pix, dtype=np.uint32)
    px = jnp.asarray(pix % spec.width)
    py = jnp.asarray(pix // spec.width)
    sids = jnp.arange(n_s, dtype=jnp.uint32)

    def chain_body(px, py, k):
        def body(i, acc):
            o = sample_pixels(data, spec, (px + i) % spec.width, py, sids, 0)
            return acc + jnp.sum(o)
        # carry init derives from px so it inherits px's vma (inside
        # shard_map a replicated 0.0 would mismatch the varying carry)
        return jax.lax.fori_loop(0, k, body, (px[0] * 0).astype(jnp.float32))

    if args.large:
        # ---- large-scene regime: the scanned closest-hit path ----
        from raytrace_tpu.scene.procedural import make_sphere_field

        sc_l = make_sphere_field(args.large, mix_materials=args.mix)
        data_l, spec_l = sc_l.data, sc_l.spec
        n_obj = sum(1 for t in spec_l.shape_type if t >= 0)
        levels_l = spec_l.max_depth + 2

        def chain_large(px, py, k):
            def body(i, acc):
                o = sample_pixels(data_l, spec_l, (px + i) % spec_l.width,
                                  py, sids, 0)
                return acc + jnp.sum(o)
            return jax.lax.fori_loop(
                0, k, body, (px[0] * 0).astype(jnp.float32))

        t_launch, _, _ = _measure_slope(
            jax.jit(chain_large, static_argnames=("k",)), px, py)
        primary = n_pix * n_s * spec_l.cam_samples
        # intersect rounds per primary sample: the level count for a
        # linear chain, the virtual-tree node count for fan-out (the
        # compacted wavefront visits the same node set)
        if spec_l.children_per_ray > 1:
            from raytrace_tpu.render.integrator import tree_nodes
            rounds = tree_nodes(spec_l)
        else:
            rounds = levels_l
        tag = "mix" if args.mix else "linear"
        rays_per_sec = primary * rounds / t_launch
        print(json.dumps({
            "metric": f"large_scene_{n_obj}obj_{tag}",
            "value": round(rays_per_sec),
            "unit": "rays/s",
            "vs_baseline": round(rays_per_sec / REF_CPU_RAYS_PER_SEC, 2),
            "launch_ms": round(t_launch * 1e3, 3),
            "obj_tests_per_sec": round(rays_per_sec * n_obj),
            **where,
        }))
        return 0

    chain = jax.jit(chain_body, static_argnames=("k",))
    per_launch, overhead, _ = _measure_slope(chain, px, py)
    primary = n_pix * n_s * spec.cam_samples
    rays_per_sec = primary * levels / per_launch

    if not args.shard:
        print(json.dumps({
            "metric": "rays_per_sec_per_chip_1024sq_depth4",
            "value": round(rays_per_sec),
            "unit": "rays/s",
            "vs_baseline": round(rays_per_sec / REF_CPU_RAYS_PER_SEC, 2),
            "per_launch_ms": round(per_launch * 1e3, 3),
            "fixed_overhead_ms": round(overhead * 1e3, 1),
            **where,
        }))
        return 0

    # ---- weak scaling over the mesh -----------------------------------
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from raytrace_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    n_dev = int(np.prod(list(mesh.shape.values())))
    axes = mesh.axis_names

    pix_g = np.arange(n_pix * n_dev, dtype=np.uint32)
    pxg = jnp.asarray(pix_g % spec.width)
    pyg = jnp.asarray((pix_g // spec.width) % spec.height)

    @partial(jax.jit, static_argnames=("k",))
    def chain_sharded(px, py, k):
        def local(px, py):
            s = chain_body(px, py, k)
            for ax in axes:
                s = jax.lax.psum(s, ax)
            return s
        return shard_map(local, mesh=mesh,
                         in_specs=(P(axes), P(axes)),
                         out_specs=P())(px, py)

    slope_sh, overhead_sh, _ = _measure_slope(chain_sharded, pxg, pyg)
    eff = per_launch / slope_sh
    total_rays = primary * levels * n_dev / slope_sh
    print(json.dumps({
        "metric": f"scaling_efficiency_weak_{n_dev}dev",
        "value": round(eff, 4),
        "unit": "fraction",
        "vs_baseline": round(eff, 4),
        "n_devices": n_dev,
        "rays_per_sec_per_device": round(total_rays / n_dev),
        "rays_per_sec_total": round(total_rays),
        "single_device_launch_ms": round(per_launch * 1e3, 3),
        "sharded_launch_ms": round(slope_sh * 1e3, 3),
        **where,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
