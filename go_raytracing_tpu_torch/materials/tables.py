"""Material tables.

A dense parameter table replaces per-object material dispatch; the
wavefront kernel evaluates the scatter branchlessly per ray.

Kinds:
  - LAMBERTIAN: scatter = normal + random_unit (not normalized), near-zero
    fallback to the normal; pdf = cos/pi; the only kind that uses NEE.
  - METAL: reflect + fuzz * random_unit; absorbed when the fuzzed direction
    dips below the surface; never uses NEE.
  - DIELECTRIC: Snell + total internal reflection + Schlick-probabilistic
    reflection; attenuation = 1; IOR inverted on back faces.
  - DIFFUSE_LIGHT: emissive only, never scatters.
  - ISOTROPIC: uniform-sphere scatter (volume phase function).

This module holds the table type and kind ids only; the tensor-side
``scatter`` / ``brdf_pdf`` / ``emitted`` come with the gradient slice
(ROADMAP.md A5).  The forward render evaluates materials inside
``ops/cuda_wavefront``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4


@dataclass(frozen=True)
class MaterialPack:
    kind: torch.Tensor  # [M] i32
    tex: torch.Tensor   # [M] i32 albedo/emission texture id
    fuzz: torch.Tensor  # [M] f32 (metal)
    ior: torch.Tensor   # [M] f32 (dielectric)
