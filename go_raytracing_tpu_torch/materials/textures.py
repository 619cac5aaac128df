"""Texture tables: solid / checker (noise and image ids reserved).

A dense SoA pack evaluated branchlessly per ray.  Checker is the 3D
lattice parity of floor(p/scale + 1e-4).  Marble noise (ROADMAP.md A13)
and image textures (ROADMAP.md A16) keep their kind ids and table columns
so the tables stay comparable with the JAX package's, but cannot be built
yet; ``evaluate`` raises for a scene that claims to hold one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.vec3 import V3
from ..ops import cuda_rows

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


class _TakeRows(torch.autograd.Function):
    """``index_select`` whose backward pass is ``ops/cuda_rows.row_sums``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return cuda_rows.row_sums(g, idx, ctx.n_rows), None


def take_rows(table, idx):
    """``table[idx]`` for a table a gradient may flow into.  The backward
    pass adds each row's cotangents in a fixed order
    (``ops/cuda_rows.row_sums``), so a gradient has the same bits on every
    run.  Neither of PyTorch's own gathers does both: the backward pass of
    ``index_select`` adds the rows with atomics (the order of the sums, and
    so a gradient's last bits, change from run to run), and that of
    advanced indexing walks every run of equal indices in one thread, which
    for a few-row table indexed by millions of rays takes seconds (14 s for
    a 1.6 M-ray Cornell render on an H100; PERF.md)."""
    if table.requires_grad and torch.is_grad_enabled():
        return _TakeRows.apply(table, idx)
    return torch.index_select(table, 0, idx)


def evaluate(pack: TexturePack, tex_id, u, v, p: V3, *, has_noise=False,
             has_image=False) -> V3:
    """Texture value for each ray: tex_id [R] integer, u/v [R], p: V3 -> V3.

    Differentiable in the colour tables (the rows are picked by indexing)
    and, nowhere, in ``p``: a checker's parity is piecewise constant.
    ``has_noise`` / ``has_image`` are the scene's static flags; both kinds
    are still to be ported."""
    if has_noise:
        raise NotImplementedError(
            "marble noise textures are not ported yet (ROADMAP.md A13)")
    if has_image:
        raise NotImplementedError(
            "image textures are not ported yet (ROADMAP.md A16)")
    tex_id = tex_id.long()
    kind = take_rows(pack.kind, tex_id)
    inv_scale = take_rows(pack.inv_scale, tex_id)
    out = V3.from_rows(take_rows(pack.color, tex_id))
    lx = torch.floor(inv_scale * p.x + 1e-4).to(torch.int32)
    ly = torch.floor(inv_scale * p.y + 1e-4).to(torch.int32)
    lz = torch.floor(inv_scale * p.z + 1e-4).to(torch.int32)
    is_even = (lx + ly + lz) % 2 == 0
    checker = V3.select(is_even, V3.from_rows(take_rows(pack.even_color, tex_id)),
                        V3.from_rows(take_rows(pack.odd_color, tex_id)))
    return V3.select(kind == TEX_CHECKER, checker, out)
