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

The tensor-side functions below serve the standard integrator
(``integrator/wavefront``); the megakernels of ``ops/cuda_wavefront``
evaluate materials themselves.  ``scatter`` / ``brdf_pdf`` look a ray's
material up by id (differentiable in fuzz, IOR and the texture colours);
``scatter_from_attrs`` / ``brdf_pdf_from_attrs`` take the constants the
attribute kernels of ``ops/cuda_intersect`` hand out per ray.  Each pair
shares one body: the table variants only fetch their rows first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core import rng as rngmod
from ..core.vec3 import V3
from . import textures as tex

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


class ScatterResult(NamedTuple):
    direction: V3     # new ray direction (not normalized)
    attenuation: V3
    emitted: V3
    scattered: torch.Tensor    # [R] bool: False for lights / absorbed metal
    can_use_nee: torch.Tensor  # [R] bool: lambertian only


def can_use_nee_table(pack: MaterialPack):
    return pack.kind == MAT_LAMBERTIAN


def emitted(pack: MaterialPack, tpack: tex.TexturePack, mat_id, u, v, p: V3,
            **tex_flags) -> V3:
    """Emission per ray: nonzero only for DIFFUSE_LIGHT (its texture)."""
    mat_id = mat_id.long()
    is_light = tex.take_rows(pack.kind, mat_id) == MAT_DIFFUSE_LIGHT
    val = tex.evaluate(tpack, tex.take_rows(pack.tex, mat_id), u, v, p, **tex_flags)
    return V3.select(is_light, val, V3.zeros(is_light.shape, device=is_light.device))


def scatter_from_attrs(mat_kind, fuzz, ior, albedo: V3,
                       ray_d: V3, normal: V3, front_face,
                       seed, stream, bounce) -> ScatterResult:
    """Branchless scatter for the whole wavefront from per-ray material
    constants: kind, fuzz, IOR and the albedo already evaluated."""
    su1, su2, _ = rngmod.uniform3(seed, stream, bounce, rngmod.SCATTER_U)
    z = 1.0 - 2.0 * su1
    phi = (2.0 * math.pi) * su2
    rr = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    rand_unit = V3(rr * torch.cos(phi), rr * torch.sin(phi), z)
    u_fresnel = rngmod.uniform(seed, stream, bounce, rngmod.FRESNEL)

    # --- Lambertian ---------------------------------------------------------
    lam_dir = normal + rand_unit
    lam_dir = V3.select(lam_dir.near_zero(), normal, lam_dir)

    # --- Metal --------------------------------------------------------------
    reflected = ray_d.reflect(normal).unit() + rand_unit * fuzz
    metal_ok = reflected.dot(normal) > 0.0

    # --- Dielectric ---------------------------------------------------------
    ri = torch.where(front_face, 1.0 / ior, ior)
    unit_d = ray_d.unit()
    cos_theta = torch.clamp_max((-unit_d).dot(normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ri * sin_theta > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_m_cos = torch.clamp_min(1.0 - cos_theta, 0.0)
    omc2 = one_m_cos * one_m_cos
    schlick = r0 + (1.0 - r0) * (omc2 * omc2 * one_m_cos)
    do_reflect = cannot_refract | (schlick > u_fresnel)
    diel_dir = V3.select(
        do_reflect, unit_d.reflect(normal), unit_d.refract(normal, ri))

    # --- Select by kind -----------------------------------------------------
    direction = V3.select(
        mat_kind == MAT_LAMBERTIAN,
        lam_dir,
        V3.select(
            mat_kind == MAT_METAL,
            reflected,
            V3.select(mat_kind == MAT_DIELECTRIC, diel_dir, rand_unit),  # isotropic
        ),
    )
    dev = mat_kind.device
    attenuation = V3.select(
        mat_kind == MAT_DIELECTRIC,
        V3.full(mat_kind.shape, (1.0, 1.0, 1.0), device=dev), albedo)
    is_light = mat_kind == MAT_DIFFUSE_LIGHT
    scattered = ~is_light & ((mat_kind != MAT_METAL) | metal_ok)
    emitted_col = V3.select(is_light, albedo, V3.zeros(mat_kind.shape, device=dev))
    return ScatterResult(
        direction=direction,
        attenuation=attenuation,
        emitted=emitted_col,
        scattered=scattered,
        can_use_nee=mat_kind == MAT_LAMBERTIAN,
    )


def scatter(pack: MaterialPack, tpack: tex.TexturePack, mat_id,
            ray_d: V3, normal: V3, front_face, u, v, p: V3,
            seed, stream, bounce, **tex_flags) -> ScatterResult:
    """``scatter_from_attrs`` with the material looked up by id and its
    texture evaluated at the hit."""
    mat_id = mat_id.long()
    take = tex.take_rows
    albedo = tex.evaluate(tpack, take(pack.tex, mat_id), u, v, p, **tex_flags)
    return scatter_from_attrs(take(pack.kind, mat_id), take(pack.fuzz, mat_id),
                              take(pack.ior, mat_id), albedo, ray_d, normal,
                              front_face, seed, stream, bounce)


def brdf_pdf_from_attrs(mat_kind, fuzz, wi: V3, wo: V3, normal: V3):
    """PDF(wi, wo, n) for the MIS weight, from per-ray material constants.

    wi: unit vector toward the viewer (-ray_dir), wo: light direction.
    Lambertian: max(cos,0)/pi.  Metal: Phong lobe with exponent (1-fuzz)*50,
    0 when fuzz == 0.  Dielectric/light: 0 (delta).  Isotropic: 1/4pi.
    """
    cos_theta = normal.dot(wo)
    lam_pdf = torch.clamp_min(cos_theta, 0.0) / math.pi

    refl = (-wi).reflect(normal)
    cos_alpha = refl.dot(wo)
    exponent = (1.0 - fuzz) * 50.0
    phong = (exponent + 1.0) / (2.0 * math.pi) * torch.pow(
        torch.clamp_min(cos_alpha, 1e-20), exponent)
    metal_pdf = torch.where((fuzz == 0.0) | (cos_alpha < 0.0), 0.0, phong)

    iso_pdf = torch.full_like(lam_pdf, 1.0 / (4.0 * math.pi))

    return torch.where(
        mat_kind == MAT_LAMBERTIAN,
        lam_pdf,
        torch.where(
            mat_kind == MAT_METAL,
            metal_pdf,
            torch.where(mat_kind == MAT_ISOTROPIC, iso_pdf, 0.0),
        ),
    )


def brdf_pdf(pack: MaterialPack, mat_id, wi: V3, wo: V3, normal: V3):
    """``brdf_pdf_from_attrs`` with the material looked up by id."""
    mat_id = mat_id.long()
    return brdf_pdf_from_attrs(tex.take_rows(pack.kind, mat_id),
                               tex.take_rows(pack.fuzz, mat_id), wi, wo, normal)
