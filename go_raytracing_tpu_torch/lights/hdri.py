"""HDRI environment maps with luminance importance sampling.

Counterpart of the JAX package's ``lights/hdri.py`` (itself the reference's
rt/hdri.go).  The distribution is built host-side in NumPy, with the same
code as there, so the tables are bit for bit the JAX package's; sampling
picks a texel from a Walker alias table over the flattened pixel grid (two
lookups a sample), and the pdf table holds the density the alias table
encodes, so MIS weights stay exact.

Conventions (the reference's):
  - equirect mapping: phi = atan2(z, x), theta = asin(y), u = 0.5 + phi/2pi
    (+ rotation, wrapped), v = 0.5 - theta/pi;
  - per-pixel weight = Rec.709 luminance * sin(theta), sin(theta) being the
    cosine of the elevation;
  - solid-angle pdf = pdf[px] * W * H / (2 pi^2 sin(theta)), floored at 1e-10;
  - ``sample_direction`` returns the *nearest* texel as emission, while
    ``sample`` (the miss shader) is bilinear with horizontal wrap and
    vertical clamp.

The alias tables and the pdf are constants: ``apply_params`` swaps
``data`` only, and gradients reach the texels through the miss shader and
the emission of the importance samples.  Both gathers that can carry a
gradient go through ``core/segsum.take_rows_sorted``, whose backward pass
sums the cotangents per texel in a fixed order (``miss_texel_grad`` is the
same sum written out for the gradient kernels' tiers).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.segsum import cols_segment_sum_factored, take_rows_sorted
from ..core.vec3 import V3

TWO_PI = 2.0 * np.pi


class Environment(NamedTuple):
    data: torch.Tensor             # [H, W, 3] linear radiance
    rotation: torch.Tensor         # scalar radians (float32)
    pdf: torch.Tensor              # [H, W] pixel pdf the alias table encodes
    marginal_cdf: torch.Tensor     # [H + 1]
    conditional_cdf: torch.Tensor  # [H, W + 1]
    total_power: torch.Tensor      # scalar
    alias_idx: torch.Tensor        # [H * W] i32 alias cell (Walker table)
    alias_cut: torch.Tensor        # [H * W] f32 keep-own-cell threshold


def _build_alias(weight: np.ndarray):
    """Walker alias table for the flattened pixel distribution, built
    vectorized: the larges' excess mass (cumsum E) is matched to the
    smalls' deficit mass (cumsum D) with one searchsorted.  A small whose
    deficit interval straddles two larges gets a single donor anyway (the
    alias format allows one), so the encoded distribution q differs from
    the target by at most two boundary deficits per large; q is returned
    and used as the pdf table, which keeps the estimator unbiased.

    Returns (alias_idx [N] i32, alias_cut [N] f32, q [H, W] f64 summing
    to 1).  The same code as the JAX package's, so the same bits."""
    h, w = weight.shape
    n = h * w
    p = weight.reshape(-1).astype(np.float64)
    total = p.sum()
    if total <= 0 or n == 0:
        return (
            np.arange(max(n, 1), dtype=np.int32)[:n],
            np.ones(n, np.float32),
            np.zeros((h, w), np.float64),
        )
    scaled = p * (n / total)  # mean 1
    cut = np.minimum(scaled, 1.0)
    alias = np.arange(n, dtype=np.int64)
    small = scaled < 1.0
    idx_s = np.nonzero(small)[0]
    idx_l = np.nonzero(~small)[0]
    if len(idx_s) and len(idx_l):
        deficit = 1.0 - scaled[idx_s]
        excess = scaled[idx_l] - 1.0
        donor = np.searchsorted(np.cumsum(excess), np.cumsum(deficit) - 1e-12)
        alias[idx_s] = idx_l[np.minimum(donor, len(idx_l) - 1)]
    # exact encoded distribution: own retained mass + donated-in mass
    q = cut.copy()
    np.add.at(q, alias[idx_s], 1.0 - scaled[idx_s])
    q /= n
    return alias.astype(np.int32), cut.astype(np.float32), q.reshape(h, w)


def build_environment(data, rotation_degrees: float = 0.0,
                      device=None) -> Environment:
    """Build the importance-sampling distribution of an [H, W, 3] radiance
    array on ``device`` (the array's own for a tensor, else the CPU)."""
    if isinstance(data, torch.Tensor):
        device = data.device if device is None else device
        data = data.detach().cpu().numpy()
    data = np.asarray(data, np.float32)
    h, w = data.shape[:2]
    v = (np.arange(h, dtype=np.float64) + 0.5) / h
    theta = (0.5 - v) * np.pi
    sin_theta = np.cos(theta)  # elevation convention

    lum = 0.2126 * data[..., 0] + 0.7152 * data[..., 1] + 0.0722 * data[..., 2]
    weight = np.maximum(lum.astype(np.float64) * sin_theta[:, None], 0.0)

    row_sums = weight.sum(axis=1)
    total_power = weight.sum()

    cond = np.zeros((h, w + 1), np.float64)
    np.cumsum(weight, axis=1, out=cond[:, 1:])
    safe_rows = np.where(row_sums > 0, row_sums, 1.0)
    cond /= safe_rows[:, None]

    marg = np.zeros(h + 1, np.float64)
    np.cumsum(row_sums, out=marg[1:])
    alias_idx, alias_cut, q = _build_alias(weight)
    if total_power > 0:
        marg /= total_power
        pdf = q  # the sampling density the alias table encodes
    else:
        pdf = weight

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return Environment(
        data=t(data, np.float32),
        rotation=t(np.float32(np.deg2rad(rotation_degrees)), np.float32),
        pdf=t(pdf, np.float32),
        marginal_cdf=t(marg, np.float32),
        conditional_cdf=t(cond, np.float32),
        total_power=t(np.float32(total_power), np.float32),
        alias_idx=t(alias_idx, np.int32),
        alias_cut=t(alias_cut, np.float32),
    )


def environment_from_numpy(fields: dict, device) -> Environment:
    """Dict of the ``Environment`` field names -> ``Environment`` on
    ``device``, the tables taken as given."""
    int_fields = ("alias_idx",)
    return Environment(**{
        k: torch.from_numpy(np.array(fields[k], np.int32 if k in int_fields
                                     else np.float32)).to(device)
        for k in Environment._fields})


def quad_table(data):
    """[H, W, 3] -> [H*W, 12] table of 2x2 bilinear footprints
    (c00 c10 c01 c11) with horizontal wrap and vertical clamp baked in.
    Slices and concatenations only, so a gradient reaches the texels
    through it."""
    h, w = data.shape[:2]
    dx = torch.roll(data, -1, dims=1)                      # x+1, wrap
    dy = torch.cat([data[1:], data[-1:]], dim=0)           # y+1, clamp
    dxy = torch.roll(dy, -1, dims=1)
    return torch.cat([data, dx, dy, dxy], dim=2).reshape(h * w, 12)


def quad_table_transpose(qcot, h: int, w: int):
    """The transpose of :func:`quad_table`: a [H*W, 12] cotangent of the
    table -> the [H, W, 3] cotangent of the texels."""
    q = qcot.reshape(h, w, 4, 3)
    g = q[:, :, 0] + torch.roll(q[:, :, 1], 1, dims=1)
    gy = q[:, :, 2] + torch.roll(q[:, :, 3], 1, dims=1)   # cotangent of dy
    g = g.clone()
    g[1:] = g[1:] + gy[:-1]
    g[-1] = g[-1] + gy[-1]
    return g


def _unit_rows(d):
    """[R, 3] -> unit rows (zero rows unchanged), V3.unit's arithmetic."""
    return torch.stack(list(V3.from_rows(d).unit()), dim=-1)


def direction_to_uv(env: Environment, d):
    """[R, 3] directions -> (u, v) in [0, 1)."""
    du = _unit_rows(d)
    phi = torch.atan2(du[..., 2], du[..., 0])
    theta = torch.asin(torch.clamp(du[..., 1], -1.0, 1.0))
    u = 0.5 + phi / TWO_PI + env.rotation / TWO_PI
    u = u - torch.floor(u)
    v = 0.5 - theta / np.pi
    return u, v


def uv_to_direction(env: Environment, u, v):
    """(u, v) -> [R, 3] unit direction."""
    u = u - env.rotation / TWO_PI
    u = u - torch.floor(u)
    phi = (u - 0.5) * TWO_PI
    theta = (0.5 - v) * np.pi
    ct = torch.cos(theta)
    return torch.stack([ct * torch.cos(phi), torch.sin(theta), ct * torch.sin(phi)],
                       dim=-1)


def sample(env: Environment, d):
    """Miss-shader radiance for [R, 3] directions: bilinear with horizontal
    wrap and vertical clamp."""
    h, w = env.data.shape[:2]
    u, v = direction_to_uv(env, d)
    px = u * w - 0.5
    py = v * h - 0.5
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    fx = (px - x0.to(px.dtype))[..., None]
    fy = (py - y0.to(py.dtype))[..., None]
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    c00 = env.data[y0c, x0w]
    c10 = env.data[y0c, x1w]
    c01 = env.data[y1c, x0w]
    c11 = env.data[y1c, x1w]
    c0 = c00 * (1.0 - fx) + c10 * fx
    c1 = c01 * (1.0 - fx) + c11 * fx
    return c0 * (1.0 - fy) + c1 * fy


def _solid_angle_pdf(env: Environment, y, x, v):
    h, w = env.data.shape[:2]
    theta = (0.5 - v) * np.pi
    sin_theta = torch.clamp_min(torch.cos(theta), 1e-10)
    p = env.pdf[y, x] * (w * h) / (2.0 * np.pi * np.pi * sin_theta)
    return torch.clamp_min(p, 1e-10)


def pdf(env: Environment, d):
    """Solid-angle pdf of sampling the [R, 3] directions d."""
    h, w = env.data.shape[:2]
    u, v = direction_to_uv(env, d)
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return _solid_angle_pdf(env, y, x, v)


def _alias_pick(env: Environment, xi1, xi2):
    """Pick a pixel from the alias table: (row, column) int64."""
    h, w = env.data.shape[:2]
    n = h * w
    cell = torch.clamp_max((xi1 * n).to(torch.int32), n - 1).long()
    keep = xi2 < env.alias_cut[cell]
    chosen = torch.where(keep, cell, env.alias_idx[cell].long())
    return chosen // w, chosen % w


def sample_direction(env: Environment, xi1, xi2):
    """Importance-sample directions.  xi1, xi2: [R] uniforms.  Returns
    (direction [R, 3], emission [R, 3] (nearest texel), pdf [R])."""
    h, w = env.data.shape[:2]
    y, x = _alias_pick(env, xi1, xi2)
    u = (x.to(torch.float32) + 0.5) / w
    v = (y.to(torch.float32) + 0.5) / h
    d = uv_to_direction(env, u, v)
    emission = env.data[y, x]
    return d, emission, _solid_angle_pdf(env, y, x, v)


# -----------------------------------------------------------------------------
# Component-SoA forms (the render path's)
# -----------------------------------------------------------------------------

def _direction_to_uv_soa(env: Environment, d: V3):
    du = d.unit()
    phi = torch.atan2(du.z, du.x)
    theta = torch.asin(torch.clamp(du.y, -1.0, 1.0))
    u = 0.5 + phi / TWO_PI + env.rotation / TWO_PI
    u = u - torch.floor(u)
    v = 0.5 - theta / np.pi
    return u, v


def miss_footprint(env: Environment, d: V3):
    """(fx, fy, base texel id) of the bilinear miss fetch for V3 directions:
    the index math that ``sample_soa``, ``miss_texel_grad`` and the gradient
    tiers' miss carry share (the top edge's fy collapse included)."""
    h, w = env.data.shape[:2]
    u, v = _direction_to_uv_soa(env, d)
    px = u * w - 0.5
    py = v * h - 0.5
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    fx = px - x0.to(px.dtype)
    fy = py - y0.to(py.dtype)
    x0w = torch.remainder(x0, w)
    y0c = torch.clamp(y0, 0, h - 1)
    # Top edge: y0 = -1 clamps both bilinear rows to row 0, but the quad at
    # base row 0 holds rows (0, 1): collapse the blend to row 0.
    fy = torch.where(y0 < 0, 0.0, fy)
    return fx, fy, y0c * w + x0w


def blend_quad(qcols, fx, fy) -> V3:
    """Bilinear blend of the 12 footprint columns (c00 c10 c01 c11 x rgb)
    -> V3.  qcols: a sequence of 12 [R] tensors."""
    c00 = V3(qcols[0], qcols[1], qcols[2])
    c10 = V3(qcols[3], qcols[4], qcols[5])
    c01 = V3(qcols[6], qcols[7], qcols[8])
    c11 = V3(qcols[9], qcols[10], qcols[11])
    c0 = c00 * (1.0 - fx) + c10 * fx
    c1 = c01 * (1.0 - fx) + c11 * fx
    return c0 * (1.0 - fy) + c1 * fy


def quad_rows(env: Environment, base):
    """The 12 footprint columns of the texels ``base`` [R], as a [12, R]
    tensor (one gather of the quad table)."""
    return take_rows_sorted(quad_table(env.data), base).t()


def sample_soa(env: Environment, d: V3) -> V3:
    """Miss-shader radiance for V3 directions (bilinear, horizontal wrap,
    vertical clamp): one [R, 12] gather of the footprint table.  A gradient
    reaches the texels (in a fixed order) and the direction."""
    fx, fy, base = miss_footprint(env, d)
    q = quad_rows(env, base)
    return blend_quad([q[j] for j in range(12)], fx, fy)


def miss_texel_grad(env: Environment, d: V3, lam: V3):
    """d<lam, sample_soa(env, d)>/d(env.data), [H, W, 3], written out: the
    footprint cotangents are summed per base texel (``core/segsum``: the
    rays whose cotangent is zero skipped, 5 columns gathered into key
    order, expanded to 12 there), then pushed
    through the transpose of ``quad_table``.

    d: V3 directions (any value where lam is 0); lam: V3 cotangent of the
    per-ray miss radiance (0 on rays that did not miss)."""
    h, w = env.data.shape[:2]
    fx, fy, base = miss_footprint(env, d)

    def expand(fx_, fy_, lx_, ly_, lz_):
        w00 = (1.0 - fx_) * (1.0 - fy_)
        w10 = fx_ * (1.0 - fy_)
        w01 = (1.0 - fx_) * fy_
        w11 = fx_ * fy_
        return [wgt * ch for wgt in (w00, w10, w01, w11)
                for ch in (lx_, ly_, lz_)]

    qcot = cols_segment_sum_factored(
        base, (fx, fy, lam.x, lam.y, lam.z), expand, h * w,
        zero_cols=(lam.x, lam.y, lam.z))
    return quad_table_transpose(qcot, h, w)


def pdf_soa(env: Environment, d: V3):
    h, w = env.data.shape[:2]
    u, v = _direction_to_uv_soa(env, d)
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return _solid_angle_pdf(env, y, x, v)


def sample_direction_soa(env: Environment, xi1, xi2):
    """Importance sampling: (V3 direction, V3 emission (nearest texel, a
    gradient reaches it), pdf [R])."""
    h, w = env.data.shape[:2]
    y, x = _alias_pick(env, xi1, xi2)
    u = (x.to(torch.float32) + 0.5) / w
    v = (y.to(torch.float32) + 0.5) / h
    uu = u - env.rotation / TWO_PI
    uu = uu - torch.floor(uu)
    phi = (uu - 0.5) * TWO_PI
    theta = (0.5 - v) * np.pi
    ct = torch.cos(theta)
    d = V3(ct * torch.cos(phi), torch.sin(theta), ct * torch.sin(phi))
    em = take_rows_sorted(env.data.reshape(h * w, 3), y * w + x)
    emission = V3(em[:, 0], em[:, 1], em[:, 2])
    sin_theta = torch.clamp_min(ct, 1e-10)
    p = env.pdf[y, x] * (w * h) / (2.0 * np.pi * np.pi * sin_theta)
    return d, emission, torch.clamp_min(p, 1e-10)


def texel_ids(env: Environment, xi1, xi2):
    """Flat texel id (row * W + column) that ``sample_direction_soa`` picks
    for the uniforms (xi1, xi2)."""
    y, x = _alias_pick(env, xi1, xi2)
    return y * env.data.shape[1] + x
