"""The two jobs the benchmark times, done by the plain reference: a frame
(``render_image``'s picture) and a gradient step (``render_grad``'s loss and
gradients of the pixel MSE against a target).

Camera rays are taken in blocks of whole samples; a frame adds its samples
into the framebuffer one at a time, in sample order, as the program's
renderer does.  A gradient step makes its framebuffer, loss and cotangent
from a first pass over the blocks and sums every block's gradients in
float64 in a second; under an environment the second pass is the pathwise
tier's: the pathwise stash, the miss terms, and the reverse sweep, which
with quad lights beside the environment (the fused tier) also returns each
environment sample's texel cotangent.

``hold=control`` is the control: the same jobs with what each ray carries
from bounce to bounce held in bfloat16.
"""

from __future__ import annotations

import torch

from . import rng
from . import scene as sc
from . import wavefront as wf

BLOCK_RAYS = 1 << 22


def control(x):
    """``hold`` of the control: bfloat16 between bounces."""
    return x.to(torch.bfloat16).to(torch.float32)


def _blocks(ref: sc.RefScene, spp: int):
    """(first ray id, rays) of each block of whole samples."""
    w, h = sc.image_size(ref.cam)
    n_pix = w * h
    per = max(BLOCK_RAYS // n_pix, 1)
    return [(s * n_pix, min(per, spp - s) * n_pix) for s in range(0, spp, per)]


def hdri_rows(ref: sc.RefScene, stream, seed, depth):
    """[depth * 7, R] environment samples (direction, emission, pdf) of each
    bounce, and their [depth, R] texel ids; None where the scene has no
    importance-sampled environment beside its quad lights."""
    if ref.env is None or ref.tables.n_lights == 0:
        return None, None
    rows, ids = [], []
    for b in range(depth):
        xi1 = rng.uniform(seed, stream, b, rng.HDRI_ROW)
        xi2 = rng.uniform(seed, stream, b, rng.HDRI_COL)
        d, em, pdf, tid = sc.sample_direction(ref.env, xi1, xi2)
        rows += d + em + [pdf]
        ids.append(tid)
    return torch.stack(rows).contiguous(), torch.stack(ids)


def _rays(ref, start, n, seed, device):
    ids = start + torch.arange(n, dtype=torch.int64, device=device)
    o, d, tm = sc.camera_rays(ref.cam, ids, seed)
    return ids, o, d, tm


def _miss_colour(ref: sc.RefScene, m_dir, primary):
    """The miss shader: the environment's bilinear texels (hidden from
    camera rays under the phantom rule), or the flat background."""
    if ref.env is None:
        bg = ref.cam["background"]
        return [torch.full_like(m_dir[0], float(bg[c])) for c in range(3)]
    fx, fy, base = sc.miss_footprint(ref.env, m_dir)
    col = sc.blend(sc.footprint_texels(ref.env, base), fx, fy)
    if ref.cam.get("phantom_hdri"):
        col = [torch.where(primary, 0.0, c) for c in col]
    return col


def _safe_dir(m_dir, missed):
    return [torch.where(missed, m_dir[0], 0.0), torch.where(missed, m_dir[1], 0.0),
            torch.where(missed, m_dir[2], 1.0)]


def _radiance(ref, out, flags):
    missed = (flags & wf.FLAG_MISSED) != 0
    primary = (flags & wf.FLAG_PRIMARY) != 0
    col = _miss_colour(ref, _safe_dir(out[3:6], missed), primary)
    return torch.stack([out[c] + torch.where(missed, out[6 + c] * col[c], 0.0)
                        for c in range(3)], dim=-1)


def _forward_block(ref, start, n, seed, hold, device):
    """[n, 3] radiance of the camera rays [start, start + n)."""
    depth = ref.cam["max_depth"]
    ids, o, d, tm = _rays(ref, start, n, seed, device)
    hdri, _ = hdri_rows(ref, ids, seed, depth)
    out, flags = wf.bounce_loop(ref.tables, o, d, tm, ids, seed, depth, hdri=hdri,
                                hold=hold)
    return _radiance(ref, out, flags)


def framebuffer(ref: sc.RefScene, seed, hold=wf.keep, device="cuda"):
    """[H * W, 3] sums of every sample's radiance, added in sample order."""
    w, h = sc.image_size(ref.cam)
    accum = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    for start, n in _blocks(ref, ref.cam["spp"]):
        rows = _forward_block(ref, start, n, seed, hold, device)
        for vs in rows.reshape(n // (w * h), w * h, 3).unbind(0):
            accum = hold(accum.add_(vs))
    return accum


def frame(ref: sc.RefScene, seed, hold=wf.keep, device="cuda"):
    """The tonemapped picture [H, W, 3] in [0, 0.999] (gamma 2)."""
    w, h = sc.image_size(ref.cam)
    lin = framebuffer(ref, seed, hold, device).reshape(h, w, 3) / float(ref.cam["spp"])
    g = torch.where(lin > 0, torch.sqrt(torch.clamp_min(lin, 1e-12)), 0.0)
    return torch.clamp(g, 0.0, 0.999)


def _env_miss_terms(ref, out, flags, g3):
    """Miss colour [3, R] (0 where the ray did not miss; the phantom rule
    applied), the cotangent of the miss direction [3, R] by autograd of the
    bilinear weights, and the texels' [H, W, 3] float64 cotangent."""
    env = ref.env
    missed = (flags & wf.FLAG_MISSED) != 0
    primary = (flags & wf.FLAG_PRIMARY) != 0
    safe = _safe_dir(out[3:6], missed)
    lam = torch.where(missed, g3 * out[6:9], 0.0)
    if ref.cam.get("phantom_hdri"):
        lam = torch.where(primary, 0.0, lam)
    texel_grad = sc.miss_texel_grad(env, safe, lam)
    _, _, base = sc.miss_footprint(env, safe)
    q = sc.footprint_texels(env, base)
    with torch.enable_grad():
        sd = [x.detach().requires_grad_(True) for x in safe]
        fx, fy, _ = sc.miss_footprint(env, sd)
        col = torch.stack(sc.blend(q, fx, fy))
        if ref.cam.get("phantom_hdri"):
            col = torch.where(primary, 0.0, col)
        mc = torch.where(missed, col, 0.0)
        lmd = torch.stack(torch.autograd.grad((lam * mc).sum(), sd))
    return mc.detach(), lmd, texel_grad


def _grad_block(ref, start, n, seed, g3, hold, device):
    """The gradients of <radiance, g3> over the camera rays [start, start + n),
    float64: dict(color, even_color, odd_color, fuzz, ior[, env_data]).  The
    pathwise and fused tiers compute the same gradients; the reference
    takes them under an environment, the product tier without one."""
    tb, depth = ref.tables, ref.cam["max_depth"]
    ids, o, d, tm = _rays(ref, start, n, seed, device)
    hdri, tex_ids = hdri_rows(ref, ids, seed, depth)
    pathwise = ref.tier in ("pathwise", "fused")
    if ref.tier not in ("product", "pathwise", "fused") or pathwise != (ref.env is not None):
        raise ValueError(f"the plain reference has no {ref.tier!r} tier for this scene")
    f_rows = wf.PW_STASH_F_ROWS if pathwise else wf.STASH_F_ROWS
    stash_f = torch.zeros((depth, f_rows, n), dtype=torch.float32, device=device)
    stash_i = torch.empty((depth, wf.STASH_I_ROWS, n), dtype=torch.int32, device=device)
    stash_i[:, 0] = wf.SLOT_NONE
    stash_i[:, 1] = wf.LSLOT_NONE
    stash_i[:, 2] = 0
    out, flags = wf.bounce_loop(tb, o, d, tm, ids, seed, depth, stash=(stash_f, stash_i),
                                pathwise=pathwise, hdri=hdri, hold=hold)
    g = {}
    if not pathwise:
        missed = (flags & wf.FLAG_MISSED) != 0
        bg = ref.cam["background"]
        miss_col = torch.stack([torch.where(missed, float(bg[c]), 0.0) for c in range(3)])
        cols = wf.product_reverse(stash_f, stash_i, g3, miss_col, ref.n_tex)
        g["fuzz"] = torch.zeros(ref.n_mat, dtype=torch.float64, device=device)
        g["ior"] = torch.zeros(ref.n_mat, dtype=torch.float64, device=device)
    else:
        mc, lmd, texel_grad = _env_miss_terms(ref, out, flags, g3)
        cols, fuzz, ior, eout = wf.pathwise_reverse(
            tb, stash_f, stash_i, g3, mc, ids, seed, wf.MISS_STREAM, ref.n_tex, ref.n_mat,
            lmd=lmd, hdri=hdri)
        g["fuzz"], g["ior"] = fuzz.double(), ior.double()
        if eout is not None:
            h, w = ref.env.data.shape[:2]
            flat = texel_grad.reshape(h * w, 3)
            for c in range(3):
                flat[:, c].index_add_(0, tex_ids.reshape(-1), eout[:, c].reshape(-1).double())
        g["env_data"] = texel_grad
    g["color"], g["even_color"], g["odd_color"] = (cols[:, k].double() for k in range(3))
    return g


def grad_step(ref: sc.RefScene, seed, target, hold=wf.keep, device="cuda"):
    """(loss, gradients dict) of mean((framebuffer / spp - target)^2)."""
    w, h = sc.image_size(ref.cam)
    spp = ref.cam["spp"]
    fb = framebuffer(ref, seed, hold, device).reshape(h, w, 3)
    resid = fb / spp - target
    loss = torch.mean(resid * resid)
    g_fb = (2.0 / (w * h * 3 * spp)) * resid.reshape(w * h, 3)
    grads = {}
    for start, n in _blocks(ref, spp):
        g3 = g_fb.t().repeat(1, n // (w * h))
        for k, v in _grad_block(ref, start, n, seed, g3, hold, device).items():
            grads[k] = grads[k] + v if k in grads else v
    return loss, {k: v.float() for k, v in grads.items()}
