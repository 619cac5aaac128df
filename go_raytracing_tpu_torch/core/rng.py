"""Counter-based RNG for the wavefront path tracer (PyTorch).

Every random draw is a pure function of which draw it is::

    (seed, stream, bounce, purpose)

``stream`` is the global ray counter, ``bounce`` the wavefront iteration
and ``purpose`` enumerates the draw site.  The hash is PCG3D (Jarzynski &
Olano, "Hash Functions for GPU Rendering", JCGT 2020).  There is no
``torch.Generator`` anywhere in the package: renders are deterministic,
chunking and resumption do not change the samples, and the CUDA kernel
(``csrc/wavefront.cu``) recomputes the very same bits per ray.

PyTorch has little unsigned 32-bit arithmetic on CUDA, so the hash runs in
int64 and masks to 32 bits after every step.  A 32x32-bit product can
exceed 2**63; int64 multiplication wraps modulo 2**64, which leaves the
low 32 bits exact.  The float step ``(bits >> 8) * 2**-24`` is exact in
float32, so the uniforms equal the JAX package's bit for bit.
"""

from __future__ import annotations

import math

import torch

# Draw-purpose enumeration.  Each wavefront bounce consumes a disjoint set
# of purposes; adding new ones at the end keeps old renders reproducible.
JITTER_X = 0
JITTER_Y = 1
RAY_TIME = 2
DEFOCUS_R = 3
DEFOCUS_PHI = 4
SCATTER_U = 5
SCATTER_V = 6
FRESNEL = 7
LIGHT_PICK = 8
LIGHT_U = 9
LIGHT_V = 10
VOLUME_FLIGHT = 11
HDRI_ROW = 12
HDRI_COL = 13

_MASK = 0xFFFFFFFF
_M = 1664525
_A = 1013904223


def _u32(x):
    return x & _MASK


def _pcg3d(x, y, z):
    """PCG3D hash: three uint32 (held in int64) in, three out."""
    x = _u32(x * _M + _A)
    y = _u32(y * _M + _A)
    z = _u32(z * _M + _A)
    x = _u32(x + y * z)
    y = _u32(y + z * x)
    z = _u32(z + x * y)
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = _u32(x + y * z)
    y = _u32(y + z * x)
    z = _u32(z + x * y)
    return x, y, z


def _to_unit_float(bits):
    """uint32 (in int64) -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def _as_u32(v, device):
    """Python int or integer tensor -> int64 tensor holding v mod 2**32."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64) & _MASK
    return torch.tensor(int(v) & _MASK, dtype=torch.int64, device=device)


def uniform3(seed, stream, bounce, purpose):
    """Three independent U[0,1) floats for (seed, stream, bounce, purpose).

    ``stream`` is an integer tensor (the ray counter; int32 values are
    read as their unsigned 32-bit pattern); ``seed``, ``bounce`` and
    ``purpose`` are python ints or integer tensors.  Returns three float32
    tensors shaped like ``stream``, on its device.
    """
    device = stream.device
    s = stream.to(torch.int64) & _MASK
    seed_u = _as_u32(seed, device)
    a = s ^ _u32(seed_u * 0x9E3779B9)
    b = _u32(_as_u32(bounce, device) * 0x85EBCA6B) ^ seed_u
    c = _u32(_as_u32(purpose, device) * 0xC2B2AE35 + 0x27D4EB2F)
    a, b, c = torch.broadcast_tensors(a, b, c)
    x, y, z = _pcg3d(a, b, c)
    return _to_unit_float(x), _to_unit_float(y), _to_unit_float(z)


def uniform(seed, stream, bounce, purpose):
    """One U[0,1) float32 per stream element."""
    return uniform3(seed, stream, bounce, purpose)[0]


def uniform2(seed, stream, bounce, purpose):
    """Two U[0,1) float32s per stream element."""
    x, y, _ = uniform3(seed, stream, bounce, purpose)
    return x, y


# -----------------------------------------------------------------------------
# Distribution samplers (closed-form inverse CDFs)
# -----------------------------------------------------------------------------

def unit_vector_from_uniforms(u1, u2):
    """Uniform direction on the unit sphere: z ~ U[-1,1], phi ~ U[0,2pi)."""
    z = 1.0 - 2.0 * u1
    phi = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_disk_from_uniforms(u1, u2):
    """Uniform point in the unit disk: r = sqrt(u), theta ~ U[0,2pi)."""
    r = torch.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def random_unit_vector(seed, stream, bounce, purpose=SCATTER_U):
    u1, u2, _ = uniform3(seed, stream, bounce, purpose)
    return unit_vector_from_uniforms(u1, u2)
