"""Camera: configuration, builder, presets, and megabatch ray generation.

An immutable, hashable dataclass holds the configuration; the viewport
geometry is derived host-side in float64 numpy and cast to float32 at the
end, so the per-ray arithmetic starts from the same constants whatever
the device.

``generate_rays`` is vectorized over the ray megabatch: jittered pixel
offsets, per-ray times in [0,1), defocus-disk origins for depth of field,
and the "slow path" that rebuilds the camera basis at each ray's time for
camera motion blur.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from .core import rng as rngmod
from .core.vec3 import V3

Vec = Tuple[float, float, float]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


@dataclass(frozen=True)
class Camera:
    """Static camera configuration + derived viewport geometry."""

    aspect_ratio: float = 1.0
    image_width: int = 800
    samples_per_pixel: int = 10
    max_depth: int = 50
    vfov: float = 90.0
    look_from: Vec = (0.0, 0.0, 0.0)
    look_at: Vec = (0.0, 0.0, -1.0)
    vup: Vec = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 1.0
    look_from2: Vec = (0.0, 0.0, 0.0)
    look_at2: Vec = (0.0, 0.0, 0.0)
    camera_motion: bool = False
    free_camera: bool = False
    forward: Vec = (0.0, 0.0, -1.0)
    background: Vec = (0.0, 0.0, 0.0)
    use_sky_gradient: bool = False
    phantom_hdri: bool = False

    # ------------------------------------------------------------------
    # Builder methods — return updated copies
    # ------------------------------------------------------------------
    def set_resolution(self, width: int, aspect_ratio: float) -> "Camera":
        return replace(self, image_width=width, aspect_ratio=aspect_ratio)

    def set_quality(self, samples: int, max_depth: int) -> "Camera":
        return replace(self, samples_per_pixel=samples, max_depth=max_depth)

    def set_position(self, look_from, look_at, vup) -> "Camera":
        return replace(
            self, look_from=tuple(look_from), look_at=tuple(look_at), vup=tuple(vup)
        )

    def set_lens(self, vfov, defocus_angle, focus_dist) -> "Camera":
        return replace(
            self, vfov=vfov, defocus_angle=defocus_angle, focus_dist=focus_dist
        )

    def set_motion(self, look_from2, look_at2) -> "Camera":
        return replace(
            self,
            look_from2=tuple(look_from2),
            look_at2=tuple(look_at2),
            camera_motion=True,
        )

    def enable_free_camera(self, position, forward, vup) -> "Camera":
        fwd = np.asarray(forward, np.float64)
        fwd = fwd / np.linalg.norm(fwd)
        up = np.asarray(vup, np.float64)
        up = up / np.linalg.norm(up)
        return replace(
            self,
            look_from=tuple(position),
            forward=tuple(fwd),
            vup=tuple(up),
            free_camera=True,
        )

    def set_background(self, color) -> "Camera":
        return replace(self, background=tuple(color))

    def enable_sky_gradient(self, enable: bool = True) -> "Camera":
        return replace(self, use_sky_gradient=enable)

    def set_phantom_hdri(self, phantom: bool = True) -> "Camera":
        return replace(self, phantom_hdri=phantom)

    # ------------------------------------------------------------------
    # Derived geometry
    # ------------------------------------------------------------------
    @property
    def image_height(self) -> int:
        return max(int(self.image_width / self.aspect_ratio), 1)

    def _basis(self):
        if self.free_camera:
            w = -np.asarray(self.forward, np.float64)
        else:
            w = np.asarray(self.look_from, np.float64) - np.asarray(
                self.look_at, np.float64
            )
            w = w / np.linalg.norm(w)
        u = np.cross(np.asarray(self.vup, np.float64), w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        return u, v, w

    def _viewport(self):
        theta = math.radians(self.vfov)
        h = math.tan(theta / 2.0)
        viewport_height = 2.0 * h * self.focus_dist
        viewport_width = viewport_height * (self.image_width / self.image_height)
        return viewport_width, viewport_height

    def _defocus_radius(self) -> float:
        return self.focus_dist * math.tan(math.radians(self.defocus_angle / 2.0))


# Presets
def quick_preview() -> Camera:
    return Camera(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=10, max_depth=10,
        vfov=20.0, defocus_angle=0.0, focus_dist=10.0,
        look_from=(13, 2, 3), look_at=(0, 0, 0), vup=(0, 1, 0),
        background=(0.5, 0.7, 1.0), use_sky_gradient=True,
    )


def standard_quality() -> Camera:
    return Camera(
        aspect_ratio=16.0 / 9.0, image_width=600, samples_per_pixel=100, max_depth=50,
        vfov=20.0, defocus_angle=0.6, focus_dist=10.0,
        look_from=(13, 2, 3), look_at=(0, 0, 0), vup=(0, 1, 0),
        background=(0.5, 0.7, 1.0),
    )


def high_quality() -> Camera:
    return Camera(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=500, max_depth=50,
        vfov=20.0, defocus_angle=0.6, focus_dist=10.0,
        look_from=(13, 2, 3), look_at=(0, 0, 0), vup=(0, 1, 0),
        background=(0.5, 0.7, 1.0),
    )


# -----------------------------------------------------------------------------
# Ray generation
# -----------------------------------------------------------------------------

def generate_rays(cam: Camera, px, py, stream, seed):
    """Camera rays for pixel coords px/py [R] (integer tensors) and RNG
    streams [R].  Runs on the device of ``px``.

    Returns (origin V3, direction V3 (unnormalized), time [R]) — component
    SoA (core/vec3.py).
    """
    f32 = torch.float32
    dev = px.device
    jx, jy, _ = rngmod.uniform3(seed, stream, 0, rngmod.JITTER_X)
    offset_x = jx - 0.5
    offset_y = jy - 0.5
    ray_time = rngmod.uniform(seed, stream, 0, rngmod.RAY_TIME)

    iw, ih = cam.image_width, cam.image_height
    vp_w, vp_h = cam._viewport()
    fx = px.to(f32) + offset_x
    fy = py.to(f32) + offset_y

    def const(v64):
        """float64 host vector -> V3 of float32 scalars on the device."""
        return V3.from_tuple(tuple(np.asarray(v64).astype(np.float32)),
                             device=dev)

    if not cam.camera_motion and not cam.free_camera:
        # Fast path: constant basis, folded host-side in float64
        u, v, w = cam._basis()
        center = np.asarray(cam.look_from, np.float64)
        viewport_u = u * vp_w
        viewport_v = -v * vp_h
        du = viewport_u / iw
        dv = viewport_v / ih
        upper_left = center - w * cam.focus_dist - viewport_u / 2 - viewport_v / 2
        pixel00 = upper_left + 0.5 * (du + dv)

        sample = const(pixel00) + const(du) * fx + const(dv) * fy

        origin = V3.full(fx.shape, tuple(center.astype(np.float32)), device=dev)
        if cam.defocus_angle > 0:
            r1, r2 = rngmod.uniform2(seed, stream, 0, rngmod.DEFOCUS_R)
            dx, dy = rngmod.in_unit_disk_from_uniforms(r1, r2)
            radius = cam._defocus_radius()
            origin = origin + const(u * radius) * dx + const(v * radius) * dy
        return origin, sample - origin, ray_time

    # Slow path: per-ray basis at ray time
    t = ray_time
    ones = torch.ones_like(fx)
    c0 = V3.from_tuple(cam.look_from, device=dev)
    center0 = V3(c0.x * ones, c0.y * ones, c0.z * ones)
    if cam.camera_motion:
        vel = V3.from_tuple(_sub(cam.look_from2, cam.look_from), device=dev)
        current_center = center0 + V3(vel.x * t, vel.y * t, vel.z * t)
    else:
        current_center = center0

    if cam.free_camera:
        u_np, v_np, w_np = cam._basis()
        w = V3.from_tuple(tuple(w_np), like=current_center)
        u = V3.from_tuple(tuple(u_np), like=current_center)
        v = V3.from_tuple(tuple(v_np), like=current_center)
    else:
        lookat0 = V3.from_tuple(cam.look_at, like=current_center)
        if cam.camera_motion:
            lvel = V3.from_tuple(_sub(cam.look_at2, cam.look_at), device=dev)
            current_lookat = lookat0 + V3(lvel.x * t, lvel.y * t, lvel.z * t)
        else:
            current_lookat = lookat0
        w = (current_center - current_lookat).unit()
        vup = V3.from_tuple(cam.vup, like=current_center)
        u = vup.cross(w).unit()
        v = w.cross(u)

    # python floats are rounded to float32 when they meet a float32 tensor
    viewport_u = u * float(np.float32(vp_w))
    viewport_v = -v * float(np.float32(vp_h))
    du = viewport_u * (1.0 / iw)
    dv = viewport_v * (1.0 / ih)
    upper_left = (
        current_center - w * float(np.float32(cam.focus_dist))
        - viewport_u * 0.5 - viewport_v * 0.5
    )
    pixel00 = upper_left + (du + dv) * 0.5
    sample = pixel00 + du * fx + dv * fy

    origin = current_center
    if cam.defocus_angle > 0:
        r1, r2 = rngmod.uniform2(seed, stream, 0, rngmod.DEFOCUS_R)
        dx, dy = rngmod.in_unit_disk_from_uniforms(r1, r2)
        radius = float(np.float32(cam._defocus_radius()))
        origin = origin + (u * dx + v * dy) * radius
    return origin, sample - origin, ray_time
