"""Texture tables: solid / checker (noise and image ids reserved).

A dense SoA pack evaluated branchlessly per ray.  Checker is the 3D
lattice parity of floor(p/scale + 1e-4).  Marble noise (ROADMAP.md A13)
and image textures (ROADMAP.md A16) keep their kind ids and table columns
so the tables stay comparable with the JAX package's, but cannot be built
yet.  ``evaluate`` comes with the gradient slice (ROADMAP.md A5).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_IMAGE = 3


@dataclass(frozen=True)
class TexturePack:
    kind: torch.Tensor         # [T] i32
    color: torch.Tensor        # [T, 3] solid color
    even_color: torch.Tensor   # [T, 3] checker even
    odd_color: torch.Tensor    # [T, 3] checker odd
    inv_scale: torch.Tensor    # [T] checker 1/scale
    noise_scale: torch.Tensor  # [T]
    image_id: torch.Tensor     # [T] i32 index into atlas
    atlas: torch.Tensor        # [I, Hmax, Wmax, 3] f32 (dummy [1,1,1,3])
    atlas_wh: torch.Tensor     # [I, 2] i32 (width, height) of each image
