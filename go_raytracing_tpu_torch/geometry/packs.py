"""Structure-of-arrays primitive tables.

Each primitive kind is a dense SoA pack; the wavefront kernel sweeps a
whole pack per ray instead of dispatching through an object graph.

Primitive map:
  - Sphere / moving sphere                  -> SpherePack
  - Quad, Triangle, Circle, Plane           -> PlanarPack (unified
    plane-hit + kind-specific interior test)
  - Box / Pyramid                           -> builder sugar emitting
    quads/triangles into PlanarPack
  - Translate/Rotate/Scale wrappers         -> affine transforms baked into
    vertices at build time (exact for planar primitives)
  - Constant-density media                  -> VolumePack (OBB media)

This module holds the table types, their constants and ``sample_volumes``
(free-flight sampling of the media, plain tensor code).  Surface
intersection lives in ``ops/cuda_intersect`` (the closest-hit kernels and
their plain versions).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.vec3 import V3

# Planar primitive kinds
KIND_QUAD = 0
KIND_TRI = 1
KIND_CIRCLE = 2
KIND_PLANE = 3

BIG = np.float32(3.0e38)


@dataclass(frozen=True)
class SpherePack:
    """Static and moving spheres. ``center`` is the t=0 position and
    ``velocity`` the per-unit-time displacement."""

    center: torch.Tensor    # [N, 3] f32
    velocity: torch.Tensor  # [N, 3] f32
    radius: torch.Tensor    # [N]    f32
    mat: torch.Tensor       # [N]    i32


@dataclass(frozen=True)
class PlanarPack:
    """Quads, triangles, circles and infinite planes in one table.

    Field use per kind:
      quad:     q=Q, u, v = edge vectors; w = n/|n|^2
      triangle: q=v0, u=edge1, v=edge2; interior via barycentrics
      circle:   q=center, radius
      plane:    q=point
    """

    q: torch.Tensor       # [N, 3]
    u: torch.Tensor       # [N, 3]
    v: torch.Tensor       # [N, 3]
    normal: torch.Tensor  # [N, 3] unit
    w: torch.Tensor       # [N, 3]
    d: torch.Tensor       # [N] plane constant dot(normal, q)
    radius: torch.Tensor  # [N] circle radius (0 otherwise)
    kind: torch.Tensor    # [N] i32
    mat: torch.Tensor     # [N] i32


VOL_BOX = 0
VOL_SPHERE = 1
VOL_PLANES = 2


@dataclass(frozen=True)
class VolumePack:
    """Constant-density media.  Rays are mapped to local space by a 3x4
    affine ``world_to_local``; the boundary there is the
    [box_min, box_max] slab box (VOL_BOX), the unit sphere (VOL_SPHERE)
    or an intersection of half-spaces (VOL_PLANES)."""

    world_to_local: torch.Tensor   # [N, 3, 4]
    box_min: torch.Tensor          # [N, 3]
    box_max: torch.Tensor          # [N, 3]
    neg_inv_density: torch.Tensor  # [N] = -1/rho
    mat: torch.Tensor              # [N] i32 (isotropic phase material)
    kind: torch.Tensor             # [N] i32 VOL_BOX | VOL_SPHERE | VOL_PLANES
    planes: Optional[torch.Tensor] = None  # [N, K, 4] half-spaces or None


def volume_interval(pack: VolumePack, o: V3, d: V3):
    """Where each ray's line enters and leaves each medium: (t0, t1), both
    [R, N], in units of the ray parameter; t1 <= t0 where it misses.
    Differentiable in o and d."""
    n = pack.neg_inv_density.shape[0]
    r_ = o.x.shape[0]
    dev = o.x.device
    big = float(BIG)
    m = pack.world_to_local  # [N, 3, 4]

    def to_local(v: V3, translate):
        out = []
        for i in range(3):
            c = (
                m[None, :, i, 0] * v.x[:, None]
                + m[None, :, i, 1] * v.y[:, None]
                + m[None, :, i, 2] * v.z[:, None]
            )
            if translate:
                c = c + m[None, :, i, 3]
            out.append(c)  # [R, N]
        return out

    o_l = to_local(o, True)
    d_l = to_local(d, False)

    def safe_denominator(x):
        return torch.where(torch.abs(x) < 1e-12,
                           torch.where(x < 0, -1e-12, 1e-12), x)

    t0 = torch.full((r_, n), -np.inf, dtype=torch.float32, device=dev)
    t1 = torch.full((r_, n), np.inf, dtype=torch.float32, device=dev)
    for i in range(3):
        inv = 1.0 / safe_denominator(d_l[i])
        ta = (pack.box_min[None, :, i] - o_l[i]) * inv
        tb = (pack.box_max[None, :, i] - o_l[i]) * inv
        t0 = torch.maximum(t0, torch.minimum(ta, tb))
        t1 = torch.minimum(t1, torch.maximum(ta, tb))

    # Unit-sphere boundaries (VOL_SPHERE) in local space.
    a_q = d_l[0] ** 2 + d_l[1] ** 2 + d_l[2] ** 2
    hb = o_l[0] * d_l[0] + o_l[1] * d_l[1] + o_l[2] * d_l[2]
    c_q = o_l[0] ** 2 + o_l[1] ** 2 + o_l[2] ** 2 - 1.0
    disc = hb * hb - a_q * c_q
    sph_ok = disc > 0.0
    # sqrt's derivative is infinite at 0: masked (disc <= 0) lanes must
    # see a safe operand or the backward pass emits 0 * inf = NaN.
    sq = torch.sqrt(torch.where(sph_ok, disc, 1.0))
    # Floor 1e-12: reciprocal's backward squares this, and (1e-20)^2
    # underflows f32 to an inf partial on degenerate lanes.
    inv_a = 1.0 / torch.clamp_min(a_q, 1e-12)
    is_sph = pack.kind[None, :] == VOL_SPHERE
    t0 = torch.where(is_sph, torch.where(sph_ok, (-hb - sq) * inv_a, big), t0)
    t1 = torch.where(is_sph, torch.where(sph_ok, (-hb + sq) * inv_a, -big), t1)

    # Convex-polyhedron boundaries (VOL_PLANES): [entry, exit] =
    # [max lower, min upper] over the local half-spaces n.x <= d.
    if pack.planes is not None:
        kmax = pack.planes.shape[1]
        p0 = torch.full((r_, n), -np.inf, dtype=torch.float32, device=dev)
        p1 = torch.full((r_, n), np.inf, dtype=torch.float32, device=dev)
        empty = torch.zeros((r_, n), dtype=torch.bool, device=dev)
        for k in range(kmax):
            nx = pack.planes[None, :, k, 0]
            ny = pack.planes[None, :, k, 1]
            nz = pack.planes[None, :, k, 2]
            dd = pack.planes[None, :, k, 3]
            den = nx * d_l[0] + ny * d_l[1] + nz * d_l[2]
            num = dd - (nx * o_l[0] + ny * o_l[1] + nz * o_l[2])
            tq = num / safe_denominator(den)
            p0 = torch.maximum(p0, torch.where(den < -1e-12, tq, -np.inf))
            p1 = torch.minimum(p1, torch.where(den > 1e-12, tq, np.inf))
            empty = empty | ((torch.abs(den) <= 1e-12) & (num < 0.0))
        is_pl = pack.kind[None, :] == VOL_PLANES
        t0 = torch.where(is_pl, torch.where(empty, big, p0), t0)
        t1 = torch.where(is_pl, torch.where(empty, -big, p1), t1)
    return t0, t1


def sample_volumes(pack: VolumePack, o: V3, d: V3, t_min, t_surface, u_flight):
    """Free-flight sampling of every medium along each ray, component SoA.

    ``u_flight``: [R, N] uniforms, one per (ray, volume); ``t_surface``:
    [R] distance of the surface hit that bounds the flight (BIG for none).
    Returns (t_vol [R], idx [R] i32, hit [R] bool): the nearest accepted
    scatter distance and its volume.  Differentiable in o and d; every
    clamp floor keeps the backward pass finite on the lanes it masks."""
    n = pack.neg_inv_density.shape[0]
    r_ = o.x.shape[0]
    dev = o.x.device
    big = float(BIG)
    if n == 0:
        return (torch.full((r_,), big, device=dev),
                torch.zeros((r_,), dtype=torch.int32, device=dev),
                torch.zeros((r_,), dtype=torch.bool, device=dev))
    t0, t1 = volume_interval(pack, o, d)
    crosses = t1 > t0

    t0c = torch.clamp_min(t0, t_min)   # a ray that starts inside enters at t_min
    t1c = torch.minimum(t1, t_surface[:, None])
    inside = crosses & (t0c < t1c)

    ray_len = d.length()[:, None]
    dist_inside = (t1c - t0c) * ray_len
    # 1e-38 is a float32 denormal: the floor keeps log finite at u == 0
    log_u = torch.log(torch.clamp_min(u_flight, 1e-38))
    hit_dist = pack.neg_inv_density[None, :] * log_u
    accept = inside & (hit_dist <= dist_inside)
    t_scatter = t0c + hit_dist / ray_len
    t_pair = torch.where(accept, t_scatter, big)

    # first volume among equals, as a sweep in table order would take it
    t_best, idx = t_pair[:, 0], torch.zeros((r_,), dtype=torch.int32, device=dev)
    for vi in range(1, n):
        closer = t_pair[:, vi] < t_best
        t_best = torch.where(closer, t_pair[:, vi], t_best)
        idx = torch.where(closer, vi, idx)
    return t_best, idx, t_best < big
