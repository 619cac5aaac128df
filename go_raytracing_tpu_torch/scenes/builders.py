"""The reference scenes rebuilt on the SceneBuilder API.

Every constructor takes ``device`` (``None`` means "cuda") and returns
``(Scene, Camera)``.  The random sphere field in ``random_scene`` uses a
seeded NumPy generator, so its layout is deterministic.  Scenes that need
a feature the port does not have yet (marble noise, image textures, HDRI
environments) raise ``NotImplementedError`` naming the ROADMAP.md item
they wait for.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

from ..camera import Camera
from ..geometry.scene import Affine, SceneBuilder
from ..io import obj as obj_mod


def _camera():
    return Camera()


def random_scene(device=None, seed: int = 7,
                 grid: Tuple[int, int, int, int] = (-10, 10, -10, 10),
                 ground_color=(0.5, 0.5, 0.5), lambert_prob=0.3, metal_prob=0.3,
                 dielectric_prob=0.3, large_spheres_y=1.0):
    """The knobs mirror the JAX package's ``random_scene``.  Lambertian
    spheres are always moving (center2 = center + (0, U(0,0.5), 0))."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    ground = b.lambertian(b.checker(0.32, ground_color, (0.9, 0.9, 0.9)))
    b.plane((0, 0, -1), (0, 1, 0), ground)

    for a in range(grid[0], grid[1]):
        for c in range(grid[2], grid[3]):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < lambert_prob:
                albedo = rng.random(3) * rng.random(3)
                mat = b.lambertian(tuple(albedo))
                center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
                b.moving_sphere(center, center2, 0.2, mat)
            elif choose < lambert_prob + metal_prob:
                albedo = 0.5 + rng.random(3) * 0.5
                mat = b.metal(tuple(albedo), rng.random() * 0.5)
                b.sphere(center, 0.2, mat)
            elif choose < lambert_prob + metal_prob + dielectric_prob:
                b.sphere(center, 0.2, b.dielectric(1.5))

    y = large_spheres_y
    b.sphere((0, y, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, y, 0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4, y, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))

    cam = (
        _camera()
        .set_resolution(1200, 16.0 / 9.0)
        .set_quality(500, 50)
        .set_position((13, 2, 3), (0, 0, 0), (0, 1, 0))
        .set_lens(20, 0.6, 10.0)
        .enable_sky_gradient(True)
    )
    return b.build(device=device), cam


def checkered_spheres_scene(device=None):
    b = SceneBuilder()
    checker = b.lambertian(b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0, -10, 0), 10, checker)
    b.sphere((0, 10, 0), 10, checker)
    cam = (
        _camera()
        .set_resolution(600, 16.0 / 9.0)
        .set_quality(100, 50)
        .set_position((13, 2, 3), (0, 0, 0), (0, 1, 0))
        .set_lens(20, 0, 10)
        .enable_sky_gradient(True)
    )
    return b.build(device=device), cam


def simple_scene(device=None):
    b = SceneBuilder()
    ground = b.lambertian((0.8, 0.8, 0.0))
    center = b.lambertian((0.1, 0.2, 0.5))
    left = b.dielectric(1.5)
    bubble = b.dielectric(1.0 / 1.5)
    right = b.metal((0.8, 0.6, 0.2), 0.0)
    b.plane((0, -0.5, -1), (0, 1, 0), ground)
    b.sphere((0, 0, -1), 0.5, center)
    b.sphere((-1, 0, -1), 0.5, left)
    b.sphere((-1, 0, -1), 0.4, bubble)
    b.sphere((1, 0, -1), 0.5, right)
    cam = (
        _camera()
        .set_resolution(400, 16.0 / 9.0)
        .set_quality(100, 50)
        .set_position((0, 0, 2), (0, 0, -1), (0, 1, 0))
        .set_lens(90, 0, 10)
        .enable_sky_gradient(True)
    )
    return b.build(device=device), cam


def earth_scene(device=None, **kwargs):
    raise NotImplementedError(
        "scene not ported yet: it needs image textures (ROADMAP.md A16)")


def perlin_spheres_scene(device=None, **kwargs):
    raise NotImplementedError(
        "scene not ported yet: it needs marble noise textures (ROADMAP.md A13)")


def quads_scene(device=None):
    b = SceneBuilder()
    b.quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), b.lambertian((1.0, 0.2, 0.2)))
    b.quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), b.lambertian((0.2, 1.0, 0.2)))
    b.quad((3, -2, 1), (0, 0, 4), (0, 4, 0), b.lambertian((0.2, 0.2, 1.0)))
    b.quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), b.lambertian((1.0, 0.5, 0.0)))
    b.quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), b.lambertian((0.2, 0.8, 0.8)))
    cam = (
        _camera()
        .set_resolution(400, 1.0)
        .set_quality(100, 50)
        .set_position((0, 0, 9), (0, 0, 0), (0, 1, 0))
        .set_lens(80, 0, 10)
        .enable_sky_gradient(True)
    )
    return b.build(device=device), cam


def primitives_scene(device=None):
    b = SceneBuilder()
    red = b.lambertian((0.8, 0.1, 0.1))
    green = b.lambertian((0.1, 0.8, 0.1))
    blue = b.lambertian((0.1, 0.1, 0.8))
    metal = b.metal((1.0, 1.0, 1.0), 0)
    light = b.diffuse_light((2, 2, 2))
    checker = b.lambertian(b.checker(1.0, (0.0, 0.0, 0.0), (0.9, 0.9, 0.9)))

    b.plane((0, -1, 0), (0, 1, 0), checker)
    b.circle((-5, 0, 0), (0, 1, 0), 0.9, red)
    b.pyramid((-2.5, -1, 0), 1.4, 1.8, green)
    b.sphere((0, 0.6, 0), 0.8, b.dielectric(1.5))
    b.box((2.0, -1, -0.5), (3.0, 0.0, 0.5), blue)
    area = b.quad((-2, 5, -2), (4, 0, 0), (0, 0, 4), light)
    b.add_light(area)
    b.sphere((5, 0.6, 0), 0.8, metal)
    cam = (
        _camera()
        .set_resolution(800, 16.0 / 9.0)
        .set_quality(300, 25)
        .set_position((0, 2, 10), (0, 0, 0), (0, 1, 0))
        .set_lens(45, 0, 10)
        .set_background((0, 0, 0))
        .enable_sky_gradient(True)
    )
    return b.build(device=device), cam


def hdri_test_scene(device=None, **kwargs):
    raise NotImplementedError(
        "scene not ported yet: it needs HDRI environments (ROADMAP.md A15)")


def _cornell_walls(b: SceneBuilder, white, red, green):
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)


def cornell_box_scene(device=None):
    b = SceneBuilder()
    white = b.lambertian((0.73, 0.73, 0.73))
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((3, 3, 3))

    area = b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    b.add_light(area)
    _cornell_walls(b, white, red, green)

    b.box((0, 0, 0), (165, 330, 165), white,
          Affine.trs(rotation_deg=(0, 15, 0), position=(265, 0, 295)))
    b.box((0, 0, 0), (165, 165, 165), white,
          Affine.trs(rotation_deg=(0, -18, 0), position=(130, 0, 65)))

    # Thin global fog filling the box interior
    b.volume_box((0, 0, 0), (555, 555, 555), 0.001, (1, 1, 1))

    cam = (
        _camera()
        .set_resolution(600, 1.0)
        .set_quality(500, 5)
        .set_position((278, 278, -800), (278, 278, 0), (0, 1, 0))
        .set_lens(40, 0, 10)
        .set_background((0, 0, 0))
    )
    return b.build(device=device), cam


def glossy_metal_test(device=None):
    b = SceneBuilder()
    b.plane((0, 0, 0), (0, 1, 0), b.lambertian((0.5, 0.5, 0.5)))
    b.sphere((-2.5, 1, 0), 1.0, b.metal((0.8, 0.6, 0.2), 0.0))
    b.sphere((0, 1, 0), 1.0, b.metal((0.8, 0.6, 0.2), 0.2))
    b.sphere((2.5, 1, 0), 1.0, b.metal((0.8, 0.6, 0.2), 0.5))
    area = b.quad((-2, 5, -2), (4, 0, 0), (0, 0, 4), b.diffuse_light((4, 4, 4)))
    b.add_light(area)
    cam = (
        _camera()
        .set_resolution(640, 16.0 / 9.0)
        .set_quality(100, 10)
        .set_position((0, 2, 10), (0, 1, 0), (0, 1, 0))
        .set_lens(40, 0, 10)
        .set_background((0, 0, 0))
    )
    return b.build(device=device), cam


def cornell_box_glossy(device=None):
    b = SceneBuilder()
    white = b.lambertian((0.73, 0.73, 0.73))
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    _cornell_walls(b, white, red, green)
    area = b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105), b.diffuse_light((15, 15, 15)))
    b.add_light(area)
    b.sphere((150, 100, 400), 100, b.metal((1.0, 0.84, 0.0), 0.05))
    b.sphere((278, 100, 400), 100, b.metal((1.0, 0.84, 0.0), 0.15))
    b.sphere((410, 100, 400), 100, b.metal((0.95, 0.95, 0.98), 0.25))
    b.sphere((278, 130, 180), 130, b.dielectric(1.5))
    cam = (
        _camera()
        .set_resolution(600, 1.0)
        .set_quality(200, 5)
        .set_position((278, 278, -800), (278, 200, 200), (0, 1, 0))
        .set_lens(40, 0, 10)
        .set_background((0, 0, 0))
    )
    return b.build(device=device), cam


# Instancing of a shared mesh: (position, rotation about y in degrees)
LUCY_POSITIONS = [
    ((150, 0, 150), 45), ((400, 0, 150), 315), ((150, 0, 400), 135),
    ((400, 0, 400), 225), ((278, 0, 278), 0), ((100, 0, 278), 90),
    ((450, 0, 278), 270), ((278, 0, 100), 180), ((278, 0, 450), 0),
    ((200, 0, 350), 60),
]

# The reference's statue, where a checkout holds it (a git-lfs stub does not
# count); the procedural stand-ins of io/obj.py take its place otherwise.
LUCY_OBJ = Path(__file__).resolve().parents[2] / "assets" / "models" / "lucy_low.obj"


def cornell_box_lucy(device=None, n_instances: int = 10, mesh_detail=(48, 40),
                     roughness=None, mesh_kind: str = "lathe"):
    """Instances of one shared mesh in the Cornell box (the JAX package's
    builder and arguments).

    The statue is a procedural stand-in with Lucy's bounding box
    (``io/obj.py``): ``mesh_detail = (segments, rings)`` sets its triangle
    count (``(256, 220)`` gives 112,128), ``roughness > 0`` folds the lathe
    like a scanned statue, and ``mesh_kind="statue"`` takes the multi-lobed
    ``statue_standin`` with ``mesh_detail[0]`` as its detail.
    """
    b = SceneBuilder()
    white = b.lambertian((0.73, 0.73, 0.73))
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    area = b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105), b.diffuse_light((15, 15, 15)))
    b.add_light(area)
    _cornell_walls(b, white, red, green)

    lucy_mat = b.lambertian((0.9, 0.9, 0.9))
    if LUCY_OBJ.is_file() and not obj_mod.is_lfs_stub(str(LUCY_OBJ)):
        verts, tris = obj_mod.load_obj(str(LUCY_OBJ))
    elif mesh_kind == "statue":
        # None -> the kind's default (0.0 is a valid smooth statue)
        verts, tris = obj_mod.statue_standin(
            mesh_detail[0], roughness=0.3 if roughness is None else roughness)
    else:
        verts, tris = obj_mod.lucy_standin(
            *mesh_detail, roughness=0.0 if roughness is None else roughness)
    proto = b.mesh(verts, tris)
    for pos, rot in LUCY_POSITIONS[:n_instances]:
        xf = Affine.trs(scale=(0.15, 0.15, 0.15), rotation_deg=(0, rot, 0), position=pos)
        b.mesh_instance(proto, lucy_mat, xf)

    cam = (
        _camera()
        .set_resolution(600, 1.0)
        .set_quality(50, 5)
        .set_position((278, 278, -800), (278, 278, 0), (0, 1, 0))
        .set_lens(40, 0, 10)
        .set_background((0, 0, 0))
    )
    return b.build(device=device), cam


def cornell_smoke(device=None):
    b = SceneBuilder()
    white = b.lambertian((0.73, 0.73, 0.73))
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    area = b.quad((113, 554, 127), (330, 0, 0), (0, 0, 305), b.diffuse_light((3, 3, 3)))
    b.add_light(area)
    _cornell_walls(b, white, red, green)
    b.volume_box((0, 0, 0), (165, 330, 165), 0.01, (0, 0, 0),
                 Affine.trs(rotation_deg=(0, 15, 0), position=(265, 0, 295)))
    b.volume_box((0, 0, 0), (165, 165, 165), 0.01, (1, 1, 1),
                 Affine.trs(rotation_deg=(0, -18, 0), position=(130, 0, 65)))
    cam = (
        _camera()
        .set_resolution(600, 1.0)
        .set_quality(150, 5)
        .set_position((278, 278, -800), (278, 278, 0), (0, 1, 0))
        .set_lens(40, 0, 10)
        .set_background((0, 0, 0))
    )
    return b.build(device=device), cam


# Scene registry, aliases included
REGISTRY: Dict[str, Callable] = {}
for _names, _fn in [
    (("random", "randomscene"), random_scene),
    (("checkered", "checker", "checkered-spheres"), checkered_spheres_scene),
    (("simple", "simple-scene"), simple_scene),
    (("perlin", "perlin-spheres"), perlin_spheres_scene),
    (("earth", "earth-scene"), earth_scene),
    (("quads", "quads-scene"), quads_scene),
    (("cornell", "cornell-box"), cornell_box_scene),
    (("cornell-glossy",), cornell_box_glossy),
    (("cornell-lucy",), cornell_box_lucy),
    (("cornell-smoke", "cornell-fog"), cornell_smoke),
    (("glossy-metal", "glossy-metal-test"), glossy_metal_test),
    (("primitives", "primitives-scene"), primitives_scene),
    (("hdri", "hdri-test", "hdr"), hdri_test_scene),
]:
    for _n in _names:
        REGISTRY[_n] = _fn


def load_scene(name: str, device=None, **kwargs):
    """Scene lookup by name or alias.  ``device=None`` means "cuda";
    ``kwargs`` pass through to the builder."""
    fn = REGISTRY.get(name.lower())
    if fn is None:
        raise KeyError(f"unknown scene: {name} (have {sorted(set(REGISTRY))})")
    return fn(device=device, **kwargs)
