"""Vector math core: constants and ``[..., 3]`` helpers (PyTorch).

Every "vector" here is a tensor whose last axis has size 3, batched over
arbitrary leading axes.  The hot path uses the component-SoA ``V3`` type
(core/vec3.py) instead; these helpers serve API boundaries and tests.
"""

from __future__ import annotations

import torch

EPS_PARALLEL = 1e-8    # ray-parallel-to-plane epsilon
EPS_HIT = 1e-3         # self-intersection epsilon
NEAR_ZERO = 1e-8       # degenerate-scatter epsilon


def dot(a, b):
    """Batched dot product over the trailing size-3 axis."""
    return torch.sum(a * b, dim=-1)


def vdot(a, b):
    """Like :func:`dot` but keeps the trailing axis (shape ``[..., 1]``)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v):
    return torch.sum(v * v, dim=-1)


def length(v):
    return torch.sqrt(length_squared(v))


def rsqrt_safe(x):
    """1/sqrt(x) that never divides by zero (callers mask the x==0 lanes)."""
    pos = x > 0
    return torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def unit(v):
    """Normalize; a zero vector is returned unchanged."""
    l2 = torch.sum(v * v, dim=-1, keepdim=True)
    return torch.where(l2 > 0, v * rsqrt_safe(l2), v)


def near_zero(v):
    """True where all three components are < 1e-8 in magnitude."""
    return torch.all(torch.abs(v) < NEAR_ZERO, dim=-1)


def reflect(v, n):
    """Mirror reflection of ``v`` about normal ``n``."""
    return v - 2.0 * vdot(v, n) * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of a unit vector ``uv``; ``etai_over_etat`` is a
    float or broadcasts over the batch (shape ``[...]`` or ``[..., 1]``)."""
    if isinstance(etai_over_etat, torch.Tensor) and etai_over_etat.dim() \
            and etai_over_etat.shape[-1:] != (1,):
        etai_over_etat = etai_over_etat[..., None]
    cos_theta = torch.clamp_max(vdot(-uv, n), 1.0)
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    r_out_parallel = -torch.sqrt(
        torch.clamp_min(
            torch.abs(1.0 - torch.sum(r_out_perp * r_out_perp, dim=-1,
                                      keepdim=True)),
            1e-20,
        )
    ) * n
    return r_out_perp + r_out_parallel


def ray_at(origin, direction, t):
    """Point along a ray: ``origin + t * direction``."""
    return origin + t[..., None] * direction
