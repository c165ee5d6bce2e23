"""Scene representation: a padded structure-of-arrays pytree.

Data-parallel re-design of the reference's scene model (``src/scene.rs``,
SURVEY.md §2 #8, #13-15).  The reference stores a ``Vec<Object>`` of boxed
trait objects — pointer-chasing polymorphism that cannot be vectorized.
Here the scene is two pieces:

* :class:`SceneData` — a registered pytree of padded device arrays
  (geometry, material table, light table, camera matrices, background).
  Every leaf is a differentiable parameter: ``jax.grad`` of any render
  loss flows into sphere centers, plane normals, material colors, light
  colors, camera position, ...

* :class:`SceneSpec` — the static (hashable) half: array sizes, type
  switches that select code paths, and render options.  Passing it as a
  static argument to ``jit`` lets XLA specialize: a scene with no
  transparent materials never compiles a refraction slot, a solid-color
  background never compiles the skybox gather, etc.

Object ordering: objects keep their scene-file order on a single padded
object axis of length ``n_objects``.  Per-object shape data is stored
type-unioned (``prim_p``/``prim_q``), so closest-hit is one masked argmin
over the object axis with the reference's first-minimum tie-break
(scene.rs:247-249) preserved exactly.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# Shape type ids (shapes.rs: Sphere, Plane)
SHAPE_SPHERE = 0
SHAPE_PLANE = 1

# Material type ids (scene.rs:32-89)
MAT_PHONG = 0
MAT_INDIRECT_PHONG = 1
MAT_FRESNEL = 2
MAT_TRANSPARENT = 3

# Light model ids (scene.rs:117-155)
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_AREA = 2

# Camera type ids (camera.rs)
CAM_SIMPLE_PERSPECTIVE = 0
CAM_DEPTH_OF_FIELD = 1

# Background type ids (scene.rs:159-188)
BG_SOLID = 0
BG_SKYBOX = 1

# Render-engine constants (raytrace.rs:17-18)
MIN_SIGNIFICANCE = 1.0 / 256.0 / 2.0
MAX_DEPTH = 4


def _dc(cls):
    """Register a dataclass as a pytree with all fields as data."""
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@partial(_dc)
@dataclasses.dataclass
class SceneData:
    """Dynamic (traced, differentiable) scene parameters.

    Axis O = padded object count, L = padded light count.  Padding lanes
    are masked out via ``shape_type < 0`` / ``light_type < 0`` sentinels
    in SceneSpec masks.
    """

    # --- geometry, type-unioned per object (shapes.rs:43-112) ---
    # sphere: prim_p = center, prim_q[0] = radius
    # plane:  prim_p = point,  prim_q = normal (stored raw, NOT normalized,
    #         exactly like shapes.rs:108 returns it)
    prim_p: jnp.ndarray        # (O, 3)
    prim_q: jnp.ndarray        # (O, 3)

    # --- material table (scene.rs:32-89), one row per object ---
    mat_diffuse: jnp.ndarray   # (O, 3)
    mat_specular: jnp.ndarray  # (O, 3)
    mat_exponent: jnp.ndarray  # (O,)
    mat_ambient: jnp.ndarray   # (O, 3)
    mat_ior: jnp.ndarray       # (O,)
    mat_samples: jnp.ndarray   # (O,) float — MC sample count as a weight
                               #   (raytrace.rs:110 `samples as f64 * 0.5`)

    # --- lights (scene.rs:109-155) ---
    # point: light_p = location
    # directional: light_e1 = direction
    # area: light_p = origin, light_e1/light_e2 = parallelogram sides
    light_p: jnp.ndarray       # (L, 3)
    light_e1: jnp.ndarray      # (L, 3)
    light_e2: jnp.ndarray      # (L, 3)
    light_color: jnp.ndarray   # (L, 3)

    # --- camera (camera.rs:31-123) ---
    cam_position: jnp.ndarray  # (3,)
    cam_matrix: jnp.ndarray    # (3, 3): dir = M @ (x, y, 1)
    cam_focus: jnp.ndarray     # () DoF focal distance
    cam_aperture: jnp.ndarray  # () DoF aperture radius
    cam_im_dist: jnp.ndarray   # () |M @ (0,0,1)| cached like camera.rs:98

    # --- background ---
    bg_color: jnp.ndarray      # (3,) solid color (scene.rs:165-168)
    bg_cube: jnp.ndarray       # (6, H, W, 3) linear skybox faces, or (6,1,1,3)
                               #   zeros when spec.bg_type == BG_SOLID

    @property
    def dtype(self):
        return self.prim_p.dtype


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static scene structure: sizes, type tags, compile-time switches."""

    # per-object static tags (tuples => hashable)
    shape_type: tuple[int, ...]   # SHAPE_* per object, -1 for padding
    mat_type: tuple[int, ...]     # MAT_* per object, -1 for padding
    light_type: tuple[int, ...]   # LIGHT_* per light, -1 for padding

    cam_type: int = CAM_SIMPLE_PERSPECTIVE
    cam_samples: int = 1          # camera.rs:26 default 1; DoF: samples
    bg_type: int = BG_SOLID

    # render options (scene.rs:191-198)
    width: int = 800
    height: int = 800
    antialias: int = 1

    # engine constants (raytrace.rs:17-18) — overridable per render
    max_depth: int = MAX_DEPTH
    min_significance: float = MIN_SIGNIFICANCE

    # wavefront branching slots, derived by the builder from the material
    # set actually present (SURVEY.md §7: recursion -> static expansion)
    has_reflect: bool = True      # any phong/fresnel/transparent material
    has_refract: bool = False     # any transparent material
    n_indirect: int = 0           # max MC samples over indirect materials

    # static (h, w) of each loaded skybox face (texture.rs:20-24);
    # faces are padded into one (6, Hmax, Wmax, 3) array in SceneData
    face_sizes: tuple[tuple[int, int], ...] = ((1, 1),) * 6

    @property
    def n_objects(self) -> int:
        return len(self.shape_type)

    @property
    def n_lights(self) -> int:
        return len(self.light_type)

    @property
    def children_per_ray(self) -> int:
        """Static wavefront branching factor B (SURVEY.md §7b)."""
        return int(self.has_reflect) + int(self.has_refract) + self.n_indirect

    @property
    def max_live_children(self) -> int:
        """Static bound on *live* children per lane — the child gates in
        models/materials.py are material-exclusive: indirect slots fire
        only on IndirectPhong hits (which never spawn reflect/refract
        slots, gate ``~is_indirect``), while reflect+refract fire only
        on the other materials.  The wavefront can therefore be
        compacted from B slots to this many lanes per parent with zero
        loss (integrator._compact_children)."""
        return max(int(self.has_reflect) + int(self.has_refract),
                   self.n_indirect)

    def object_mask(self) -> np.ndarray:
        return np.array([t >= 0 for t in self.shape_type])

    def light_mask(self) -> np.ndarray:
        return np.array([t >= 0 for t in self.light_type])


@dataclasses.dataclass
class Scene:
    """A complete scene: traced data + static spec (host-side handle)."""

    data: SceneData
    spec: SceneSpec

    # non-traced extras kept host-side
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
