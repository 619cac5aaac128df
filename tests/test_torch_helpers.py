"""Shared helpers for the tests of the PyTorch/CUDA port
(``tests/test_torch_*.py``): hand the JAX package's scene and camera to
the port as plain numpy, and build the mixed test scene in either package.
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
