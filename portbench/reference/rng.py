"""Counter-based random draws: PCG3D on (seed, stream, bounce, purpose).

A frozen copy of the program's keyed hash, written again in plain PyTorch:
every draw of the path tracer is a pure function of which draw it is, so
the reference regenerates any ray's draws for itself.  The hash runs in
int64, masked to 32 bits after each step; ``(bits >> 8) * 2**-24`` is exact
in float32.
"""

from __future__ import annotations

import torch

JITTER_X = 0
RAY_TIME = 2
SCATTER_U = 5
FRESNEL = 7
LIGHT_PICK = 8
LIGHT_U = 9
HDRI_ROW = 12
HDRI_COL = 13

_MASK = 0xFFFFFFFF
_M = 1664525
_A = 1013904223


def _u32(x):
    return x & _MASK


def _pcg3d(x, y, z):
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


def _unit_float(bits):
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def _as_u32(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64) & _MASK
    return torch.tensor(int(v) & _MASK, dtype=torch.int64, device=device)


def uniform3(seed, stream, bounce, purpose):
    """Three U[0, 1) float32 tensors shaped like ``stream``."""
    device = stream.device
    s = stream.to(torch.int64) & _MASK
    seed_u = _as_u32(seed, device)
    a = s ^ _u32(seed_u * 0x9E3779B9)
    b = _u32(_as_u32(bounce, device) * 0x85EBCA6B) ^ seed_u
    c = _u32(_as_u32(purpose, device) * 0xC2B2AE35 + 0x27D4EB2F)
    a, b, c = torch.broadcast_tensors(a, b, c)
    x, y, z = _pcg3d(a, b, c)
    return _unit_float(x), _unit_float(y), _unit_float(z)


def uniform(seed, stream, bounce, purpose):
    return uniform3(seed, stream, bounce, purpose)[0]
