"""Model semantics: cameras, lights, backgrounds, materials.

Data-parallel re-designs of the reference's trait hierarchies
(``src/camera.rs``, ``src/scene.rs`` light/background traits, the four
``Material::color`` impls in ``src/raytrace.rs``): each trait becomes a
batched pure function over structure-of-arrays ray data, with trait
polymorphism expressed as static type switches (compile-time, from
SceneSpec) or masked selects (runtime, per object)."""
