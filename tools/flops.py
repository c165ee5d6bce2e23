"""Exact elementwise-op count of the render pipeline, per lane.

Walks the jaxpr of the full per-lane chain (RNG -> jitter -> camera ->
``max_depth + 2`` x (closest-hit + shade) -> background) and counts
every elementwise op weighted by output element count.  This is the
*same* traced program the fused render kernel runs on its lane blocks
(render/megakernel.py docstring: one source of truth), so the count is
the kernel's per-lane arithmetic exactly, not an estimate.  It does not
depend on the hardware.

Achieved op/s = ops_per_lane x lanes/s (lanes/s from a timed launch on
the card); the relevant ceiling is the device's f32 SIMT rate — a
raytracer's hot ops are 3-vectors, not matmuls, so tensor cores are
idle by design.

Op weights: every elementwise arith/compare/select/convert = 1 op per
output element (transcendentals and rsqrt/div take several issue
slots, so counting them as 1 makes a utilization derived from this a
LOWER bound).  Integer ops count too (the RNG is integer arithmetic).
Reductions count their input size; shape-only ops
(reshape/broadcast/slice/convert-free) are 0.
"""

import os
import sys
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_SCENE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "test_scene.txt")

# elementwise primitives: 1 op / output element
_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "abs", "sign", "floor", "ceil",
    "round", "max", "min", "rem", "pow", "integer_pow", "exp", "log",
    "log1p", "expm1", "sqrt", "rsqrt", "sin", "cos", "tan", "tanh",
    "logistic", "eq", "ne", "lt", "le", "gt", "ge", "and", "or", "xor",
    "not", "select_n", "shift_left", "shift_right_logical",
    "shift_right_arithmetic", "clamp", "nextafter", "is_finite",
    "square",
}
# ops counted by *input* size (fold the whole operand through the VPU)
_REDUCTIONS = {"reduce_sum", "reduce_max", "reduce_min", "reduce_and",
               "reduce_or", "reduce_prod", "argmax", "argmin"}
_ZERO = {
    "reshape", "broadcast_in_dim", "squeeze", "transpose", "slice",
    "dynamic_slice", "dynamic_update_slice", "concatenate", "gather",
    "scatter", "convert_element_type", "bitcast_convert_type", "iota",
    "copy", "stop_gradient", "rev", "pad", "select_and_scatter_add",
}


def _size(aval):
    return int(np.prod(aval.shape)) if aval.shape else 1


def count_jaxpr(jaxpr, mult=1, ops=None):
    ops = Counter() if ops is None else ops
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        sub = None
        inner_mult = mult
        if name == "scan":
            # must precede the generic "jaxpr" param check: a scan body
            # executes ``length`` times
            sub = eqn.params["jaxpr"]
            inner_mult = mult * eqn.params["length"]
        elif "jaxpr" in eqn.params:
            sub = eqn.params["jaxpr"]
        elif "call_jaxpr" in eqn.params:
            sub = eqn.params["call_jaxpr"]
        elif name == "while":
            raise ValueError("while_loop trip count unknown; not used "
                             "in the render chain")
        elif name == "cond":
            # count the widest branch
            best, bestn = None, -1
            for br in eqn.params["branches"]:
                c = count_jaxpr(br.jaxpr if hasattr(br, "jaxpr") else br,
                                mult)
                n = sum(c.values())
                if n > bestn:
                    best, bestn = c, n
            ops.update(best)
            continue
        if sub is not None:
            count_jaxpr(sub.jaxpr if hasattr(sub, "jaxpr") else sub,
                        inner_mult, ops)
            continue
        if name in _ELEMENTWISE:
            ops[name] += mult * max(_size(v.aval) for v in eqn.outvars)
        elif name in _REDUCTIONS:
            ops[name] += mult * sum(_size(v.aval) for v in eqn.invars)
        elif name in _ZERO or name.startswith("random_"):
            pass
        elif name == "fori_loop":
            raise ValueError("unexpected fori")
        else:
            ops["?" + name] += mult * max(
                (_size(v.aval) for v in eqn.outvars), default=1)
    return ops


def lane_ops(scene_path=None, n=256, dtype=None, verbose=True):
    """Ops/lane of the full per-lane radiance chain for a scene."""
    import jax
    import jax.numpy as jnp
    from raytrace_tpu.scene.builder import load_scene_file
    from raytrace_tpu.render.megakernel import _jnp_reference

    scene_path = scene_path or GOLDEN_SCENE
    sc = load_scene_file(scene_path, dtype=dtype or jnp.float32)
    ids = jnp.zeros(n, jnp.uint32)

    jaxpr = jax.make_jaxpr(
        lambda d: _jnp_reference(d, sc.spec, ids, ids, ids, ids, 0))(sc.data)
    ops = count_jaxpr(jaxpr.jaxpr)
    total = sum(ops.values())
    unknown = {k: v for k, v in ops.items() if k.startswith("?")}
    if verbose:
        for k, v in sorted(ops.items(), key=lambda kv: -kv[1]):
            print(f"{k:28s} {v / n:10.1f} /lane")
        print(f"{'TOTAL':28s} {total / n:10.1f} ops/lane "
              f"({sc.spec.max_depth + 2} levels)")
        if unknown:
            print("unclassified:", unknown)
    return total / n


if __name__ == "__main__":
    lane_ops(sys.argv[1] if len(sys.argv) > 1 else None)
