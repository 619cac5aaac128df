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

This module holds the table types and constants only; the tensor-side
``intersect_*`` oracles come with the gather integrator (ROADMAP.md A8a).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

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
    or an intersection of half-spaces (VOL_PLANES).  Only VOL_BOX media
    are built so far (ROADMAP.md A14)."""

    world_to_local: torch.Tensor   # [N, 3, 4]
    box_min: torch.Tensor          # [N, 3]
    box_max: torch.Tensor          # [N, 3]
    neg_inv_density: torch.Tensor  # [N] = -1/rho
    mat: torch.Tensor              # [N] i32 (isotropic phase material)
    kind: torch.Tensor             # [N] i32 VOL_BOX | VOL_SPHERE | VOL_PLANES
    planes: Optional[torch.Tensor] = None  # [N, K, 4] half-spaces or None
