"""Parser tests (serialize.rs semantics; SURVEY.md §4 unit-test plan)."""

import math

import pytest

from raytrace_tpu.scene import dsl


from conftest import GOLDEN_SCENE

REF_SCENE = GOLDEN_SCENE.read_text()


def test_parses_reference_scene_verbatim():
    ast = dsl.parse(REF_SCENE)
    assert len(ast.objects) == 7
    assert len(ast.lights) == 0
    # first five are planes, then two spheres (test_scene.txt order)
    kinds = [type(o.bounds).__name__ for o in ast.objects]
    assert kinds == ["PlaneAst"] * 5 + ["SphereAst"] * 2
    assert ast.objects[5].bounds.center == (0, 1.5, 0)
    assert ast.objects[5].bounds.radius == 1.5
    assert ast.objects[6].material.ambient == (5.0, 5.0, 5.0)
    assert all(o.material.kind == "IndirectPhong" for o in ast.objects)
    assert all(o.material.samples == 1 for o in ast.objects)
    cam = ast.camera
    assert cam.kind == "SimplePerspective" and cam.mode == "new"
    assert cam.position == (0, 3, 17)
    assert cam.im_dist == 3.6
    assert ast.background.kind == "SolidColor"
    assert ast.background.color == (0.051, 0.051, 0.051)
    assert (ast.options.width, ast.options.height, ast.options.antialias) == (
        800, 800, 1024)


def test_comments_all_three_styles():
    src = """{
    objects: [ ] # hash comment
    lights: [ ]  // line comment
    camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 1)
    /* block
       comment */
    background: SolidColorBackground { color: rgb(0, 0, 0) }
    options: { width: 1 height: 1 antialias: 1 }
    }"""
    ast = dsl.parse(src)
    assert ast.options.width == 1


MINIMAL_TAIL = """
    lights: [ ]
    camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 1)
    background: SolidColorBackground { color: rgb(0, 0, 0) }
    options: { width: 1 height: 1 antialias: 1 }
}"""


def _scene_with_objects(objs: str) -> str:
    return "{ objects: [" + objs + "]" + MINIMAL_TAIL


def test_all_materials_and_shapes():
    src = _scene_with_objects("""
      { bounds: Sphere { center: (1, 2, 3) radius: 4 }
        material: PhongMaterial { diffuse: rgb(1,0,0) specular: rgb(0,1,0)
                                  exponent: 8 ambient: rgb(0,0,1) } }
      { bounds: Plane { point: (0,0,0) normal: (0,1,0) }
        material: FresnelMaterial { diffuse: rgb(1,1,1) specular: rgb(1,1,1)
                                    exponent: 2 ambient: rgb(0,0,0) ior: 1.5 } }
      { bounds: Sphere { center: (0,0,0) radius: 1 }
        material: TransparentMaterial { specular: rgb(1,1,1) exponent: 4
                                        ior: 1.33 } }
    """)
    ast = dsl.parse(src)
    kinds = [o.material.kind for o in ast.objects]
    assert kinds == ["Phong", "Fresnel", "Transparent"]
    assert ast.objects[1].material.ior == 1.5


def test_lights_all_three_models():
    src = """{ objects: [ ]
    lights: [
      { model: PointLight { location: (1, 2, 3) } color: rgb(1, 1, 1) }
      { model: DirectionalLight { direction: (0, -1, 0) } color: rgb(2, 2, 2) }
      { model: AreaLight { origin: (0,5,0) side1: (1,0,0) side2: (0,0,1) }
        color: rgb(3,3,3) }
    ]
    camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 1)
    background: SolidColorBackground { color: rgb(0,0,0) }
    options: { width: 1 height: 1 antialias: 1 }
    }"""
    ast = dsl.parse(src)
    assert [l.kind for l in ast.lights] == ["Point", "Directional", "Area"]
    assert ast.lights[0].location == (1, 2, 3)
    assert ast.lights[2].side2 == (0, 0, 1)


def test_look_at_camera_and_angles():
    src = """{ objects: [ ]
    lights: [ ]
    camera: SimplePerspectiveCamera look_at((0,0,0), (0,0,-1), (0,1,0),
                                            90 deg, 2)
    background: SolidColorBackground { color: rgb(0,0,0) }
    options: { width: 1 height: 1 antialias: 1 }
    }"""
    ast = dsl.parse(src)
    assert ast.camera.mode == "look_at"
    assert ast.camera.pov == pytest.approx(math.pi / 2)

    src_rad = src.replace("90 deg", "1.5 rad")
    assert dsl.parse(src_rad).camera.pov == pytest.approx(1.5)


def test_depth_of_field_camera():
    src = """{ objects: [ ]
    lights: [ ]
    camera: DepthOfFieldCamera new(
        new((0,0,5), (0,0,-1), (0,1,0), 2),
        5.0, 0.1, 16)
    background: SolidColorBackground { color: rgb(0,0,0) }
    options: { width: 1 height: 1 antialias: 1 }
    }"""
    ast = dsl.parse(src)
    cam = ast.camera
    assert cam.kind == "DepthOfField"
    assert cam.dof_focus == 5.0
    assert cam.aperture == 0.1
    assert cam.samples == 16


def test_string_escapes():
    src = r'''{ objects: [ ]
    lights: [ ]
    camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 1)
    background: SkyboxBackground {
      px: load("a\n\x41\u{42}b") nx: load("n") py: load("p") ny: load("q")
      pz: load("r") nz: load("s")
    }
    options: { width: 1 height: 1 antialias: 1 }
    }'''
    ast = dsl.parse(src)
    assert ast.background.faces[0] == "a\nABb"


def test_error_undefined_field():
    src = _scene_with_objects("""
      { bounds: Sphere { center: (0,0,0) radius: 1 wrong: 2 }
        material: PhongMaterial { diffuse: rgb(0,0,0) specular: rgb(0,0,0)
                                  exponent: 1 ambient: rgb(0,0,0) } }""")
    with pytest.raises(dsl.SceneSyntaxError, match="undefined field: wrong"):
        dsl.parse(src)


def test_error_missing_field():
    src = _scene_with_objects("""
      { bounds: Sphere { center: (0,0,0) }
        material: PhongMaterial { diffuse: rgb(0,0,0) specular: rgb(0,0,0)
                                  exponent: 1 ambient: rgb(0,0,0) } }""")
    with pytest.raises(dsl.SceneSyntaxError, match="missing one or more fields"):
        dsl.parse(src)


def test_error_no_such_class():
    src = _scene_with_objects("""
      { bounds: Cube { } material: PhongMaterial { diffuse: rgb(0,0,0)
        specular: rgb(0,0,0) exponent: 1 ambient: rgb(0,0,0) } }""")
    with pytest.raises(dsl.SceneSyntaxError, match="no such class: Cube"):
        dsl.parse(src)


def test_error_has_row_col():
    with pytest.raises(dsl.SceneSyntaxError) as ei:
        dsl.parse("{ objects: [ ] lights: @ }")
    assert ei.value.row == 1
    assert ei.value.col > 0


def test_unsigned_coercion(capsys):
    src = """{ objects: [ ]
    lights: [ ]
    camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 1)
    background: SolidColorBackground { color: rgb(0,0,0) }
    options: { width: 1 height: 1 antialias: -3 }
    }"""
    ast = dsl.parse(src)
    assert ast.options.antialias == 0  # negative u32 clamps with warning
    assert "negative" in capsys.readouterr().out
