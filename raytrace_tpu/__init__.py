"""raytrace_tpu — a differentiable wavefront raytracing framework.

A from-scratch JAX / XLA / Pallas re-design of the capabilities of the
reference CPU raytracer ``j-dong/rust-raytrace`` (see SURVEY.md).  The
reference's recursive, scalar, trait-object architecture is replaced by a
wavefront renderer: structure-of-arrays ray batches walked through a
fixed-depth unrolled bounce loop inside one ``jit``/``shard_map`` region,
with polymorphism (materials / shapes / lights / backgrounds / cameras)
expressed as integer type ids + masked selects over padded parameter
tables.  The whole forward pass is differentiable with ``jax.grad``.

Layer map (mirrors SURVEY.md §1, re-designed data-parallel-first):

    cli.py                 L6 driver            (main.rs)
    scene/dsl.py           L5 scene DSL parser  (serialize.rs)
    io/bmp.py              L5 image I/O         (bmp.rs)
    render/integrator.py   L4 wavefront engine  (raytrace.rs)
    scene/schema.py        L3 scene pytree      (scene.rs)
    models/*               L3 semantics         (camera.rs, scene.rs traits)
    render/megakernel.py   L4 fused render kernel (Pallas, Triton route)
    ops/*                  L2 geometry/shading kernels (shapes.rs, color.rs)
    color.py, ops/rng.py   L1 substrate         (types.rs, color tables)
    parallel/*             net-new: mesh/tile sharding, ring intersection
"""

__version__ = "0.1.0"

from raytrace_tpu.scene.schema import SceneData, SceneSpec, Scene
from raytrace_tpu.scene.dsl import deserialize, SceneSyntaxError
