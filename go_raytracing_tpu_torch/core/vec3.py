"""Component-SoA 3-vectors (PyTorch).

``V3`` holds three independent ``[R]`` tensors instead of one ``[R, 3]``
tensor.  The CUDA kernel reads and writes component arrays: neighbouring
threads then touch neighbouring addresses, which is what a coalesced load
needs.  ``V3`` is a NamedTuple, so it unpacks and compares like a tuple.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEAR_ZERO = 1e-8


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # --- construction -----------------------------------------------------
    @staticmethod
    def from_rows(a):
        """[..., 3] tensor -> V3 of [...] components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def from_tuple(t, like=None, dtype=torch.float32, device=None):
        """Python 3-tuple -> V3 of scalars (or broadcast to ``like.x``)."""
        if like is not None:
            device = like.x.device
        x = torch.tensor(float(t[0]), dtype=dtype, device=device)
        y = torch.tensor(float(t[1]), dtype=dtype, device=device)
        z = torch.tensor(float(t[2]), dtype=dtype, device=device)
        if like is not None:
            shape = like.x.shape
            x, y, z = x.expand(shape), y.expand(shape), z.expand(shape)
        return V3(x, y, z)

    @staticmethod
    def zeros(shape, dtype=torch.float32, device=None):
        return V3(*(torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(3)))

    @staticmethod
    def full(shape, v, dtype=torch.float32, device=None):
        return V3(*(torch.full(shape, float(v[i]), dtype=dtype, device=device)
                    for i in range(3)))

    def rows(self):
        """V3 -> [..., 3] tensor (API boundary only; costs a relayout)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    # --- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # --- geometry -----------------------------------------------------------
    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o) -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length2(self):
        return self.dot(self)

    def length(self):
        return torch.sqrt(self.length2())

    def unit(self) -> "V3":
        """Normalize; zero vectors unchanged."""
        l2 = self.length2()
        pos = l2 > 0
        inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, l2, 1.0)), 1.0)
        return self * inv

    def near_zero(self):
        return (
            (torch.abs(self.x) < NEAR_ZERO)
            & (torch.abs(self.y) < NEAR_ZERO)
            & (torch.abs(self.z) < NEAR_ZERO)
        )

    def reflect(self, n: "V3") -> "V3":
        """Mirror about normal n."""
        return self - n * (2.0 * self.dot(n))

    def refract(self, n: "V3", etai_over_etat) -> "V3":
        """Snell refraction of a unit vector."""
        cos_theta = torch.clamp_max((-self).dot(n), 1.0)
        perp = (self + n * cos_theta) * etai_over_etat
        par_len = -torch.sqrt(
            torch.clamp_min(torch.abs(1.0 - perp.length2()), 1e-20))
        return perp + n * par_len

    def at(self, d: "V3", t) -> "V3":
        """Ray evaluation: self + t * d."""
        return self + d * t

    # --- selection / indexing ----------------------------------------------
    @staticmethod
    def select(mask, a: "V3", b: "V3") -> "V3":
        return V3(
            torch.where(mask, a.x, b.x),
            torch.where(mask, a.y, b.y),
            torch.where(mask, a.z, b.z),
        )

    def take(self, idx) -> "V3":
        return V3(self.x[idx], self.y[idx], self.z[idx])

    def to(self, *args, **kwargs) -> "V3":
        return V3(self.x.to(*args, **kwargs), self.y.to(*args, **kwargs),
                  self.z.to(*args, **kwargs))

    def sum(self):
        return self.x + self.y + self.z

    def min_comp(self):
        return torch.minimum(self.x, torch.minimum(self.y, self.z))

    def max_comp(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def clip(self, lo, hi) -> "V3":
        return V3(self.x.clamp(lo, hi), self.y.clamp(lo, hi),
                  self.z.clamp(lo, hi))

    def minimum(self, v) -> "V3":
        return V3(self.x.clamp_max(v), self.y.clamp_max(v),
                  self.z.clamp_max(v))
