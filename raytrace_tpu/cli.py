"""Command-line driver — the data-parallel ``main.rs``.

The reference hardcodes ``test_scene.txt`` -> ``out.bmp`` with no flags
(main.rs:16,34).  This driver keeps those defaults for drop-in
compatibility but exposes the knobs a production renderer needs: paths,
sample counts, precision, device-mesh sharding, profiling, checkpointed
resumable renders.

Pipeline (mirrors main.rs:13-60): read scene -> parse -> build device
pytree -> render (tiled / sharded wavefront) -> sRGB encode -> BMP.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytrace_tpu",
        description="Differentiable wavefront raytracer")
    p.add_argument("scene", nargs="?", default="test_scene.txt",
                   help="scene DSL file (default: test_scene.txt, main.rs:16)")
    p.add_argument("-o", "--output", default="out.bmp",
                   help="output BMP path (default: out.bmp, main.rs:34)")
    p.add_argument("--spp", type=int, default=None,
                   help="override the scene's antialias sample count")
    p.add_argument("--width", type=int, default=None,
                   help="override render width")
    p.add_argument("--height", type=int, default=None,
                   help="override render height")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--f64", action="store_true",
                   help="render in float64 (XLA path; the fused kernel is f32)")
    p.add_argument("--max-lanes", type=int, default=1 << 22,
                   help="device lane budget per launch (memory knob)")
    p.add_argument("--shard", action="store_true",
                   help="shard pixels over all visible devices (pjit)")
    p.add_argument("--shard-objects", action="store_true",
                   help="ring-shard the scene's objects over all devices "
                        "(for scenes too large to replicate); implies "
                        "pixel sharding")
    p.add_argument("--checkpoint", default=None,
                   help="npz path for resumable rendering state")
    p.add_argument("--profile", default=None,
                   help="write a jax profiler trace to this directory")
    p.add_argument("--log-json", default=None,
                   help="append structured log events to this JSONL file")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from raytrace_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    # multi-process bring-up BEFORE the first device query (SURVEY.md
    # §5.8) — no-op unless the env configures a cluster
    from raytrace_tpu.parallel.mesh import maybe_init_distributed
    maybe_init_distributed()
    multiproc = getattr(jax, "process_count", lambda: 1)() > 1

    import jax.numpy as jnp
    import dataclasses

    from raytrace_tpu import color as colorlib
    from raytrace_tpu.io.bmp import write_bmp
    from raytrace_tpu.scene.builder import load_scene_file
    from raytrace_tpu.scene.dsl import SceneSyntaxError
    from raytrace_tpu.utils.logging import RenderLog

    log = RenderLog(json_path=args.log_json, quiet=args.quiet)

    try:
        with log.phase("load_scene", path=args.scene):
            scene = load_scene_file(
                args.scene,
                dtype=jnp.float64 if args.f64 else jnp.float32)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)  # main.rs:18 shape
        return 1
    except SceneSyntaxError as e:
        print(f"error: {e}", file=sys.stderr)  # main.rs:28 shape
        return 1

    spec = scene.spec
    overrides = {}
    if args.width is not None:
        overrides["width"] = args.width
    if args.height is not None:
        overrides["height"] = args.height
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
        scene = dataclasses.replace(scene, spec=spec)

    spp = args.spp if args.spp is not None else max(spec.antialias, 1)
    log.event("scene", objects=spec.n_objects, lights=spec.n_lights,
              size=f"{spec.width}x{spec.height}", spp=spp,
              branching=spec.children_per_ray,
              devices=jax.device_count(), backend=jax.default_backend())

    n_primary = spec.width * spec.height * spp * spec.cam_samples

    def progress(frac):
        if not args.quiet:
            print(f"\r[raytrace_tpu] render {100 * frac:5.1f}%",
                  end="", file=sys.stderr, flush=True)

    if args.profile:
        jax.profiler.start_trace(args.profile)

    t0 = time.perf_counter()
    if multiproc:
        # multi-host: collective render, per-host row-band writes into
        # the shared BMP (parallel/multihost.py) — host 0 never holds
        # the full image; the encode/write phase is folded in
        from raytrace_tpu.parallel.multihost import render_to_bmp_multihost
        render_to_bmp_multihost(scene, args.output, seed=args.seed,
                                spp=spp, max_lanes=args.max_lanes,
                                progress=progress)
        dt = time.perf_counter() - t0
        if not args.quiet:
            print("", file=sys.stderr)
        log.event("render_done", seconds=round(dt, 3),
                  primary_samples=n_primary,
                  samples_per_sec=round(n_primary / dt),
                  rays_per_sec=round(
                      n_primary * (spec.max_depth + 2) / dt),
                  processes=jax.process_count())
        if args.profile:
            jax.profiler.stop_trace()
        return 0
    if args.shard_objects:
        from raytrace_tpu.parallel.ring import render_image_ring
        img = render_image_ring(scene, seed=args.seed, spp=spp,
                                max_lanes=args.max_lanes,
                                progress=progress,
                                checkpoint=args.checkpoint)
    elif args.shard:
        from raytrace_tpu.parallel.tile import render_image_sharded
        img = render_image_sharded(scene, seed=args.seed, spp=spp,
                                   max_lanes=args.max_lanes,
                                   progress=progress,
                                   checkpoint=args.checkpoint)
    else:
        from raytrace_tpu.render.integrator import render_image
        img = render_image(scene, seed=args.seed, spp=spp,
                           max_lanes=args.max_lanes, progress=progress,
                           checkpoint=args.checkpoint)
    dt = time.perf_counter() - t0
    if not args.quiet:
        print("", file=sys.stderr)

    if args.profile:
        jax.profiler.stop_trace()

    # BASELINE metric family: primary samples/sec (each traces
    # max_depth+2 wavefront levels, BASELINE.md)
    log.event("render_done", seconds=round(dt, 3),
              primary_samples=n_primary,
              samples_per_sec=round(n_primary / dt),
              rays_per_sec=round(n_primary * (spec.max_depth + 2) / dt))

    with log.phase("encode_write", path=args.output):
        from raytrace_tpu.io.native import write_bmp_native

        clipped = np.clip(img, 0.0, None).astype(np.float32)
        if not write_bmp_native(args.output, clipped):
            # no native toolchain: pure-Python fallback
            srgb = np.asarray(colorlib.to_srgb(jnp.asarray(clipped)))
            write_bmp(args.output, srgb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
