"""Texture tables: solid / checker / Perlin marble / image.

A dense SoA pack evaluated branchlessly per ray.

  - Checker: the 3D lattice parity of floor(p/scale + 1e-4).
  - Marble: 0.5 * (1 + sin(scale * z + 10 * turb(p * scale, 7))), the
    reference's Perlin with plain trilinear interpolation of the corner
    gradients' dot products (no Hermite smoothing) and gradients that are
    normalized cube samples, both quirks kept as the JAX package keeps them.
    As there, a lattice point's gradient comes from the PCG3D hash of its
    coordinates (``core/rng._pcg3d``, uint32 arithmetic held in int64), not
    from the reference's permutation tables.  ``marble`` is the one torch
    function of it: ``evaluate`` (the standard integrator) and the plain
    version of the megakernel (``ops/cuda_wavefront._bounce_loop``) both
    call it, and the kernel's device code (``csrc/wavefront_common.cuh``)
    repeats its operations in the same order.
  - Image: the nearest texel of the image at (u, v), both clamped to [0, 1]
    and v flipped (rt/image_texture.go:26-41), from the scene's atlas of
    images padded to the largest (``image_texels``).  The megakernels take
    no image texture: a scene with one runs on the standard integrator, or,
    where ``integrator/wavefront.image_prefactor_ok`` holds, through the
    megakernel on the scene with its images made white, times the texel of
    each camera ray's first hit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import rng as rngmod
from ..core import segsum
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


def _floor_i32(x):
    """floor(x) as int32, saturating at the int32 range as the card's and
    XLA's conversions do (NaN gives 0); PyTorch's own conversion on the CPU
    gives INT_MIN for every value out of range."""
    f = torch.floor(x)
    i = torch.clamp(f, -2147483648.0, 2147483520.0).to(torch.int32)
    i = torch.where(f >= 2147483648.0, torch.full_like(i, 2147483647), i)
    return torch.where(torch.isnan(f), torch.zeros_like(i), i)


def _lattice_grad(i, j, k):
    """Gradient at integer lattice point (i, j, k), int32 tensors of one
    shape: the PCG3D hash of the three coordinates read as a cube sample in
    [-1, 1)^3, normalized.  Returns three float32 tensors."""
    mask = 0xFFFFFFFF
    x, y, z = rngmod._pcg3d(i.to(torch.int64) & mask, j.to(torch.int64) & mask,
                            k.to(torch.int64) & mask)

    def cube(v):
        return 2.0 * rngmod._to_unit_float(v) - 1.0

    gx, gy, gz = cube(x), cube(y), cube(z)
    inv = 1.0 / torch.sqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-12))
    return gx * inv, gy * inv, gz * inv


def perlin_noise_soa(p: V3, with_grad: bool = False):
    """Gradient noise, roughly in [-1, 1], at points p (a V3 of [R]
    tensors): plain trilinear interpolation of the 8 corners' gradient
    dot products.  ``with_grad`` also returns its analytic gradient in p, a
    V3: the product rule over the 8 corner weights, sum of (d weight) *
    (g . offset) + weight * g, with the lattice cell held fixed (one-sided
    at a cell's faces), as the JAX kernel's ``noise1(with_grad=True)``."""
    fx, fy, fz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    u, v, w = p.x - fx, p.y - fy, p.z - fz
    i, j, k = _floor_i32(p.x), _floor_i32(p.y), _floor_i32(p.z)
    accum = torch.zeros_like(p.x)
    dx, dy, dz = accum, accum, accum
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                gx, gy, gz = _lattice_grad(i + di, j + dj, k + dk)
                dot = gx * (u - di) + gy * (v - dj) + gz * (w - dk)
                wu = u if di else 1.0 - u
                wv = v if dj else 1.0 - v
                ww = w if dk else 1.0 - w
                accum = accum + wu * wv * ww * dot
                if with_grad:
                    su, sv, sw = float(2 * di - 1), float(2 * dj - 1), float(2 * dk - 1)
                    dx = dx + (su * wv * ww * dot + wu * wv * ww * gx)
                    dy = dy + (wu * sv * ww * dot + wu * wv * ww * gy)
                    dz = dz + (wu * wv * sw * dot + wu * wv * ww * gz)
    return (accum, V3(dx, dy, dz)) if with_grad else accum


def perlin_turb_soa(p: V3, depth: int = 7):
    """|fBm| turbulence: ``depth`` octaves of ``perlin_noise_soa``, each at
    twice the frequency and half the weight of the one before."""
    accum = torch.zeros_like(p.x)
    weight = 1.0
    pt = p
    for _ in range(depth):
        accum = accum + weight * perlin_noise_soa(pt)
        weight *= 0.5
        pt = pt * 2.0
    return torch.abs(accum)


def perlin_noise(p):
    """``perlin_noise_soa`` for points p [..., 3]."""
    return perlin_noise_soa(V3(p[..., 0], p[..., 1], p[..., 2]))


def perlin_turb(p, depth: int = 7):
    """``perlin_turb_soa`` for points p [..., 3]."""
    return perlin_turb_soa(V3(p[..., 0], p[..., 1], p[..., 2]), depth)


def marble(p: V3, scale):
    """The marble texture's value at p (scale: [R] or a number):
    0.5 * (1 + sin(scale * z + 10 * turb(p * scale, 7)))."""
    s = scale * p.z + 10.0 * perlin_turb_soa(p * scale, 7)
    return 0.5 * (1.0 + torch.sin(s))


def marble_grad(p: V3, scale):
    """The marble's value at p and its gradient in p: (value [R], V3).

    turb = sum_o w_o noise(p s 2^o) over 7 octaves (w_o = 2^-o), so
    d turb/dp = sum_o w_o s 2^o grad noise, and with arg = s z + 10 |turb|

        d marble/dp = 0.5 cos(arg) (10 sign(turb) d turb/dp + s z_hat),

    sign(0) = 0, as the JAX kernel's reverse sweep takes it.  The octave
    loop repeats that kernel's operations and order; the pathwise and fused
    reverse sweeps (``ops/cuda_wavefront``) and ``csrc/wavefront_common.cuh``
    (``marble_grad``) compute the same."""
    mt = p * scale
    tacc = torch.zeros_like(p.x)
    da = [tacc, tacc, tacc]
    twt = 1.0
    osc = scale * 1.0
    for _ in range(7):
        nval, nd = perlin_noise_soa(mt, with_grad=True)
        tacc = tacc + twt * nval
        da = [da[c] + twt * osc * nd[c] for c in range(3)]
        twt *= 0.5
        osc = osc * 2.0
        mt = mt * 2.0
    arg = scale * p.z + 10.0 * torch.abs(tacc)
    sgn = torch.sign(tacc)
    half_cos = 0.5 * torch.cos(arg)
    ten_sgn = 10.0 * sgn
    return (0.5 * (1.0 + torch.sin(arg)),
            V3(half_cos * (ten_sgn * da[0]), half_cos * (ten_sgn * da[1]),
               half_cos * (ten_sgn * da[2] + scale)))


def image_texels(pack: TexturePack, img, u, v):
    """Flat atlas row of the nearest texel at (u, v) of image ``img`` (all
    [R]): u and v clamped to [0, 1], v flipped (rt/image_texture.go:33),
    the column and row truncated to int32 and clamped to the image's own
    width and height, as the JAX package's ``evaluate`` computes them.  The
    row indexes ``pack.atlas`` flattened to [I * Hmax * Wmax, 3]."""
    wh = torch.index_select(pack.atlas_wh, 0, img.long())
    w, h = wh[:, 0], wh[:, 1]
    uc = torch.clamp(u, 0.0, 1.0)
    vc = 1.0 - torch.clamp(v, 0.0, 1.0)
    xi = torch.minimum(torch.clamp_min((uc * w.to(u.dtype)).to(torch.int32), 0), w - 1)
    yi = torch.minimum(torch.clamp_min((vc * h.to(u.dtype)).to(torch.int32), 0), h - 1)
    _, hh, ww, _ = pack.atlas.shape
    return (img.to(torch.int64) * hh + yi) * ww + xi


def evaluate(pack: TexturePack, tex_id, u, v, p: V3, *, has_noise=False,
             has_image=False) -> V3:
    """Texture value for each ray: tex_id [R] integer, u/v [R], p: V3 -> V3.

    Differentiable in the colour tables and the atlas (the rows are picked
    by indexing) and in ``p`` through the marble (a checker's parity and an
    image's texel choice are piecewise constant).  ``has_noise`` /
    ``has_image`` are the scene's static flags: a scene without noise
    textures skips the marble, one without images the atlas.  The atlas is
    read through ``core/segsum.take_rows_sorted``: it has half a million
    rows at 1024x512, whose per-texel sums the backward pass takes in a
    fixed order."""
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
    out = V3.select(kind == TEX_CHECKER, checker, out)
    if has_noise:
        m = marble(p, take_rows(pack.noise_scale, tex_id))
        out = V3.select(kind == TEX_NOISE, V3(m, m, m), out)
    if has_image:
        texel = image_texels(pack, take_rows(pack.image_id, tex_id), u, v)
        t = segsum.take_rows_sorted(pack.atlas.reshape(-1, 3), texel)
        out = V3.select(kind == TEX_IMAGE, V3(t[:, 0], t[:, 1], t[:, 2]), out)
    return out
