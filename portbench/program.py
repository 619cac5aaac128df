"""The system under test: the port's scene builder, ``render_image`` and
``render_grad``, driven from a configuration file.  Nothing here computes a
result: it builds the scene through the port's public API, in the order
the configuration's steps give, and calls the port's entry points."""

from __future__ import annotations

import numpy as np

import go_raytracing_tpu_torch as grt
from go_raytracing_tpu_torch.geometry.scene import Affine


def build(config: dict, sky, device):
    """(scene, camera) of the configuration, on ``device``."""
    b = grt.SceneBuilder()
    names = {}

    def colour_or_texture(step):
        return names[step["texture"]] if "texture" in step else tuple(step["color"])

    for step in config["scene"]:
        op = step["op"]
        if op == "checker":
            names[step["name"]] = b.checker(step["scale"], tuple(step["even"]), tuple(step["odd"]))
        elif op == "lambertian":
            names[step["name"]] = b.lambertian(colour_or_texture(step))
        elif op == "metal":
            names[step["name"]] = b.metal(colour_or_texture(step), step["fuzz"])
        elif op == "dielectric":
            names[step["name"]] = b.dielectric(step["ior"])
        elif op == "diffuse_light":
            names[step["name"]] = b.diffuse_light(colour_or_texture(step))
        elif op == "quad":
            q = b.quad(step["q"], step["u"], step["v"], names[step["material"]])
            if step.get("light"):
                b.add_light(q)
        elif op == "box":
            b.box(step["a"], step["b"], names[step["material"]],
                  Affine.trs(rotation_deg=tuple(step["rotation_deg"]),
                             position=tuple(step["position"])))
        elif op == "plane":
            b.plane(step["point"], step["normal"], names[step["material"]])
        elif op == "sphere":
            b.sphere(step["center"], step["radius"], names[step["material"]])
        elif op == "volume_box":
            b.volume_box(step["a"], step["b"], step["density"], tuple(step["color"]))
        else:
            raise ValueError(f"no builder step {op!r}")
    if sky is not None:
        b.set_environment(np.asarray(sky, np.float32), config["environment"].get("rotation_deg", 0.0))
    c = config["camera"]
    cam = (grt.Camera()
           .set_resolution(config["width"], config["aspect"][0] / config["aspect"][1])
           .set_quality(config["spp"], config["max_depth"])
           .set_position(tuple(c["look_from"]), tuple(c["look_at"]), tuple(c["vup"]))
           .set_lens(c["vfov"], c["defocus_angle"], c["focus_dist"])
           .set_background(tuple(c["background"]))
           .enable_sky_gradient(c["sky_gradient"])
           .set_phantom_hdri(c["phantom_hdri"]))
    return b.build(device=device), cam


def frame(scene, cam, seed):
    """One frame: ``render_image``, the picture copied to the host."""
    return grt.render_image(scene, cam, seed=seed, device=scene.device).cpu()


def grad_step(scene, cam, target, seed):
    """One gradient step: ``render_grad``'s loss and gradients, synchronised
    (``render_grad`` ends on a device synchronisation)."""
    return grt.render_grad(scene, cam, target, seed=seed, device=scene.device)


def target(scene, cam, seed, scale):
    """A fitting job's target: the scene's framebuffer at ``seed`` / spp,
    times ``scale``."""
    fb = grt.render(scene, cam, seed=seed, device=scene.device)
    return fb / cam.samples_per_pixel * scale


def camera_rays(cam):
    return cam.image_width * cam.image_height * cam.samples_per_pixel
