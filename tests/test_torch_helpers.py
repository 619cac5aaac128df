"""Shared helpers for the tests of the PyTorch/CUDA port
(``tests/test_torch_*.py``): hand the JAX package's scene and camera to
the port as plain numpy, build the test scenes in either package, and bring
the JAX package's gradient stash and gradients dict to numpy.
"""

import dataclasses

import numpy as np


def scene_tree(jscene):
    """JAX ``Scene`` -> nested dict of numpy arrays and flags, the form
    ``go_raytracing_tpu_torch.convert.scene_from_numpy`` takes."""
    def pack(p):
        return {k: (None if v is None else np.asarray(v))
                for k, v in p._asdict().items()}

    tree = {}
    for f in dataclasses.fields(jscene):
        v = getattr(jscene, f.name)
        if f.name in ("spheres", "planar", "volumes", "materials", "textures"):
            tree[f.name] = pack(v)
        elif f.name.startswith("light_"):
            tree[f.name] = np.asarray(v)
        else:
            tree[f.name] = v
    return tree


def build_mixed(pkg, **build_kwargs):
    """The mixed scene of tests/test_pallas.py's megakernel test: checker
    plane, metal, dielectric and moving spheres, quad, quad light, box
    volume.  ``pkg`` is either package (both expose SceneBuilder)."""
    b = pkg.SceneBuilder()
    checker_floor = b.lambertian(b.checker(0.7, (0.2, 0.2, 0.2), (0.9, 0.9, 0.9)))
    b.plane((0, 0, 0), (0, 1, 0), checker_floor)
    b.sphere((0, 1, -1), 0.8, b.metal((0.9, 0.8, 0.5), 0.2))
    b.sphere((-1.8, 0.8, 0), 0.7, b.dielectric(1.5))
    b.moving_sphere((1.8, 0.5, 0.5), (2.2, 0.9, 0.5), 0.4,
                    b.lambertian((0.2, 0.5, 0.8)))
    b.quad((1.0, 0.2, 0.8), (1.2, 0, 0), (0, 1.2, 0), b.lambertian((0.7, 0.2, 0.2)))
    light = b.diffuse_light((6, 6, 6))
    q = b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), light)
    b.add_light(q)
    b.volume_box((-3, 0, -3), (3, 3, 3), 0.02, (0.8, 0.8, 0.8))
    return b.build(**build_kwargs)


MIXED_CAM = dict(
    image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
    look_from=(0, 2, 5), look_at=(0, 0.8, 0), background=(0.1, 0.1, 0.2),
    vfov=45.0, use_sky_gradient=False,
)


def build_mini_cornell(pkg, **build_kwargs):
    """The gradient test scene of tests/test_grad_kernel.py (checker floor,
    red wall, white ceiling and box, a fog volume filling the room, a quad
    light), with the light made bright enough (400, 380, 360) that the
    firefly clamp bites on the box's top and not on the floor.  Every
    gradient source of the product-chain tier at once."""
    b = pkg.SceneBuilder()
    white = b.lambertian((0.73, 0.72, 0.71))
    red = b.lambertian((0.65, 0.05, 0.05))
    checker = b.lambertian(b.checker(2.0, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
    light = b.diffuse_light((400.0, 380.0, 360.0))
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), checker)        # floor
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), red)          # right
    b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)  # ceiling
    q = b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    b.add_light(q)
    b.box((150, 0, 150), (350, 200, 350), white)
    b.volume_box((0.1, 0.1, 0.1), (554.9, 554.9, 554.9), 0.0008,
                 (0.9, 0.95, 1.0))
    return b.build(**build_kwargs)


MINI_CORNELL_CAM = dict(
    image_width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
    look_from=(278, 278, -800), look_at=(278, 278, 0), vfov=40.0,
    background=(0.02, 0.01, 0.03),
)


def build_sky_diffuse(pkg, **build_kwargs):
    """Checker floor, two lambertian spheres and a quad light under the
    sky gradient (the product-tier scene of tests/test_grad_render.py plus
    a sphere): misses at every depth carry the sky colour."""
    b = pkg.SceneBuilder()
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10),
           b.lambertian(b.checker(0.8, (0.7, 0.3, 0.2), (0.2, 0.3, 0.7))))
    b.sphere((0, 1, 0), 1.0, b.lambertian((0.2, 0.6, 0.3)))
    b.sphere((-2, 0.7, 1), 0.7, b.lambertian((0.6, 0.5, 0.4)))
    q = b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((5, 5, 5)))
    b.add_light(q)
    return b.build(**build_kwargs)


SKY_CAM = dict(
    image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3,
    look_from=(0, 2, 6), look_at=(0, 1, 0), vfov=40.0, use_sky_gradient=True,
)


def build_sphere_field(pkg, **build_kwargs):
    """64 lambertian spheres on a floor under a quad light: enough spheres
    for the tiled ray layout (tests/test_grad_render.py's tiled scene)."""
    b = pkg.SceneBuilder()
    b.quad((-40, 0, -40), (80, 0, 0), (0, 0, 80), b.lambertian((0.6, 0.55, 0.5)))
    blue = b.lambertian((0.2, 0.3, 0.7))
    for i in range(8):
        for j in range(8):
            b.sphere((i * 3 - 10, 0.5, j * 3 - 10), 0.5, blue)
    q = b.quad((-2, 12, -2), (4, 0, 0), (0, 0, 4), b.diffuse_light((7, 7, 7)))
    b.add_light(q)
    return b.build(**build_kwargs)


SPHERE_FIELD_CAM = dict(
    image_width=12, aspect_ratio=1.0, samples_per_pixel=2, max_depth=3,
    look_from=(0, 8, 20), look_at=(0, 0, 0), vfov=45.0,
    background=(0.05, 0.06, 0.08),
)


def grads_to_numpy(grads):
    """Gradients dict of either package -> dict of numpy arrays."""
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in grads.items()}


def jax_stash_to_numpy(carry, n_rays):
    """Carry of the JAX package's ``grad_fwd_stash`` (miss colour rows and
    the two stash arrays, each padded to [.., rows, 128] blocks) -> (miss
    colour [3, R], stash_f [D, 12, R], stash_i [D, 3, R]) in numpy."""
    mc, sf, si = carry
    mc = np.stack([np.asarray(a).reshape(-1)[:n_rays] for a in mc])
    sf, si = np.asarray(sf), np.asarray(si)
    return (mc, sf.reshape(sf.shape[0], sf.shape[1], -1)[:, :, :n_rays],
            si.reshape(si.shape[0], si.shape[1], -1)[:, :, :n_rays])
