"""Wavefront megakernel: the whole bounce loop in one CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_wavefront.py`` (forward
specialization).  One launch traces a chunk of camera rays through every
bounce: planar + sphere closest hit, box-volume free flight, miss capture
for the deferred miss shader, emission with the allowLightHits bit,
scatter for the five material kinds, checker texture, and NEE toward a
uniformly picked quad light with a shadow sweep and balance-heuristic MIS.
The RNG is the PCG3D counter scheme of ``core/rng.py``, recomputed per ray
inside the kernel.

Three things live here:

  * ``build_tables`` — scene -> PT/ST/VT/LT float tables, same row layout
    as the JAX package's (columns are the real primitive counts, with no
    padding);
  * ``trace_megakernel`` — the kernel wrapper.  A CUDA tensor launches
    ``csrc/wavefront.cu`` (built at first use by ``ops/_build.py``) or
    raises; a CPU tensor runs the plain version, and only because it lies
    on the CPU.  There is no fallback from one to the other;
  * ``trace_megakernel_plain`` — the same function of the same tables and
    rays written with ``[R]`` tensors and Python loops over primitives and
    bounces.  The tests use it and the chip check holds the kernel against
    it; nothing on the render path calls it when the rays are on a GPU.

Not ported yet (``applicable`` is False or the caller raises): marble
noise, HDRI-NEE rows, decision recording, the resumable variant, the
gradient variants, sphere segment culling (ROADMAP.md queue B).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng as rngmod
from ..core import vec as vec_consts
from ..core.vec3 import V3
from ..geometry import packs

BIG = float(packs.BIG)
EPS_HIT = float(np.float32(vec_consts.EPS_HIT))
EPS_PARALLEL = float(np.float32(1e-8))
FIREFLY = 20.0

# Table row counts ---------------------------------------------------------
PT_ROWS = 31  # planar: n(3) d q(3) vxw(3) wxu(3) rad2 kind [14 mat rows] + tex id + mat id
ST_ROWS = 23  # sphere: c(3) vel(3) rad2 [14 mat rows] + tex id + mat id
VT_ROWS = 25  # volume: w2l(12) bmin(3) bmax(3) nid mat tex col(3) + tex id
LT_ROWS = 17  # light: q(3) u(3) v(3) n(3) area em(3) + tex id

# From this many spheres on, the renderer orders rays in 32x32 pixel
# buckets (render/renderer.scene_tiled).  The JAX package also switches
# its sphere sweep to Morton-sorted culled segments there; the port keeps
# the threshold so both packages give a ray the same stream id.
SPH_CULL_MIN = 64

# Output flag word bits
FLAG_MISSED = 1
FLAG_PRIMARY = 2
FLAG_ALIVE = 4
FLAG_ALLOW = 8

# Kernel launches made by trace_megakernel (CUDA tensors only).
LAUNCHES = 0


class Tables(NamedTuple):
    pt: torch.Tensor  # [PT_ROWS, max(n_planar, 1)] f32
    st: torch.Tensor  # [ST_ROWS, max(n_sphere, 1)] f32
    vt: torch.Tensor  # [VT_ROWS, max(n_vol, 1)] f32
    lt: torch.Tensor  # [LT_ROWS, max(n_lights, 1)] f32
    n_planar: int
    n_sphere: int
    n_vol: int
    n_lights: int


def applicable(scene, max_prims: int = 1024) -> bool:
    """Can this scene run through the megakernel?"""
    return (
        not scene.meshes
        and scene.env is None
        and not scene.has_image
        and not scene.has_noise
        and scene.planar.d.shape[0] <= max_prims
        and scene.spheres.radius.shape[0] <= max_prims
        and scene.n_volumes <= 4
        and scene.n_lights <= 8
        # the in-kernel volume window is box-only
        and (scene.n_volumes == 0
             or bool((scene.volumes.kind == packs.VOL_BOX).all()))
    )


# -----------------------------------------------------------------------------
# Table packing
# -----------------------------------------------------------------------------

def _stack_rows(rows, n_rows, n, device):
    if n == 0:
        return torch.zeros((n_rows, 1), dtype=torch.float32, device=device)
    return torch.stack([r.to(torch.float32) for r in rows], dim=0).contiguous()


def _mat_rows(materials, textures, mat_ids):
    mat_ids = mat_ids.long()
    tex = materials.tex[mat_ids].long()
    texkind = textures.kind[tex]
    scale = torch.where(texkind == 1, textures.inv_scale[tex],
                        textures.noise_scale[tex])
    return [
        materials.kind[mat_ids], texkind,
        materials.fuzz[mat_ids], materials.ior[mat_ids],
        textures.color[:, 0][tex], textures.color[:, 1][tex], textures.color[:, 2][tex],
        textures.even_color[:, 0][tex], textures.even_color[:, 1][tex], textures.even_color[:, 2][tex],
        textures.odd_color[:, 0][tex], textures.odd_color[:, 1][tex], textures.odd_color[:, 2][tex],
        scale,
        tex,       # gradient kernels: cotangent routing
        mat_ids,   # gradient kernels: fuzz/ior cotangent routing
    ]


def build_tables(scene) -> Tables:
    """Scene -> (PT, ST, VT, LT) tables + counts, on the scene's device.
    Spheres keep the order they were built in."""
    dev = scene.device
    p = scene.planar
    n_planar = int(p.d.shape[0])
    rows = []
    if n_planar:
        vxw = torch.linalg.cross(p.v, p.w, dim=-1)
        wxu = torch.linalg.cross(p.w, p.u, dim=-1)
        rows = [
            p.normal[:, 0], p.normal[:, 1], p.normal[:, 2], p.d,
            p.q[:, 0], p.q[:, 1], p.q[:, 2],
            vxw[:, 0], vxw[:, 1], vxw[:, 2],
            wxu[:, 0], wxu[:, 1], wxu[:, 2],
            p.radius * p.radius, p.kind,
        ] + _mat_rows(scene.materials, scene.textures, p.mat)
    pt = _stack_rows(rows, PT_ROWS, n_planar, dev)

    s = scene.spheres
    n_sphere = int(s.radius.shape[0])
    rows = []
    if n_sphere:
        rows = [
            s.center[:, 0], s.center[:, 1], s.center[:, 2],
            s.velocity[:, 0], s.velocity[:, 1], s.velocity[:, 2],
            s.radius * s.radius,
        ] + _mat_rows(scene.materials, scene.textures, s.mat)
    st = _stack_rows(rows, ST_ROWS, n_sphere, dev)

    v = scene.volumes
    n_vol = scene.n_volumes
    rows = []
    if n_vol:
        m = v.world_to_local.reshape(n_vol, 12)
        vmat = v.mat.long()
        vtex = scene.materials.tex[vmat].long()
        rows = (
            [m[:, i] for i in range(12)]
            + [v.box_min[:, i] for i in range(3)]
            + [v.box_max[:, i] for i in range(3)]
            + [v.neg_inv_density, scene.materials.kind[vmat],
               scene.textures.kind[vtex]]
            + [scene.textures.color[:, i][vtex] for i in range(3)]
            + [vtex]
        )
    vt = _stack_rows(rows, VT_ROWS, n_vol, dev)

    n_lights = scene.n_lights
    rows = []
    if n_lights:
        ltex = scene.materials.tex[scene.light_mat.long()].long()
        rows = (
            [scene.light_q[:, i] for i in range(3)]
            + [scene.light_u[:, i] for i in range(3)]
            + [scene.light_v[:, i] for i in range(3)]
            + [scene.light_normal[:, i] for i in range(3)]
            + [scene.light_area]
            + [scene.textures.color[:, i][ltex] for i in range(3)]
            + [ltex]
        )
    lt = _stack_rows(rows, LT_ROWS, n_lights, dev)
    return Tables(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights)


# -----------------------------------------------------------------------------
# Plain PyTorch version
# -----------------------------------------------------------------------------
# Written to repeat the kernel's arithmetic operation for operation (same
# order of products and sums).  The kernel is built without fused
# multiply-add contraction (ops/_build.py), so on one GPU the two give the
# same numbers; a contracted build differs by an ulp here and there, which
# is enough to flip a discrete decision on some rays.

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _planar_sweep(tb, kinds, o, d, t_best, hitk, hidx):
    pt = tb.pt
    for j, kind in enumerate(kinds):
        nx, ny, nz = pt[0, j], pt[1, j], pt[2, j]
        denom = d[0] * nx + d[1] * ny + d[2] * nz
        not_par = torch.abs(denom) >= EPS_PARALLEL
        t = (pt[3, j] - (o[0] * nx + o[1] * ny + o[2] * nz)) / torch.where(
            not_par, denom, 1.0)
        if kind == packs.KIND_PLANE:
            t_ok = (t > EPS_HIT) & (t < t_best)
        else:
            t_ok = (t >= EPS_HIT) & (t <= t_best)
        rx = o[0] + t * d[0] - pt[4, j]
        ry = o[1] + t * d[1] - pt[5, j]
        rz = o[2] + t * d[2] - pt[6, j]
        alpha = rx * pt[7, j] + ry * pt[8, j] + rz * pt[9, j]
        beta = rx * pt[10, j] + ry * pt[11, j] + rz * pt[12, j]
        if kind == packs.KIND_QUAD:
            interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
        elif kind == packs.KIND_TRI:
            interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (alpha + beta <= 1.0)
        elif kind == packs.KIND_CIRCLE:
            interior = (rx * rx + ry * ry + rz * rz) <= pt[13, j]
        else:
            interior = torch.ones_like(not_par)
        upd = not_par & t_ok & interior
        t_best = torch.where(upd, t, t_best)
        hitk = torch.where(upd, 2, hitk)
        hidx = torch.where(upd, j, hidx)
    return t_best, hitk, hidx


def _sphere_sweep(tb, o, d, tmv, t_best, hitk, hidx):
    st = tb.st
    if not tb.n_sphere:
        return t_best, hitk, hidx
    a_coef = _dot3(d, d)
    inv_a = 1.0 / a_coef
    for j in range(tb.n_sphere):
        ocx = (st[0, j] + tmv * st[3, j]) - o[0]
        ocy = (st[1, j] + tmv * st[4, j]) - o[1]
        ocz = (st[2, j] + tmv * st[5, j]) - o[2]
        h = d[0] * ocx + d[1] * ocy + d[2] * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - st[6, j]
        disc = h * h - a_coef * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        r0 = (h - sq) * inv_a
        r1 = (h + sq) * inv_a
        ok0 = (r0 > EPS_HIT) & (r0 < t_best)
        ok1 = (r1 > EPS_HIT) & (r1 < t_best)
        root = torch.where(ok0, r0, r1)
        upd = (disc >= 0.0) & (ok0 | ok1)
        t_best = torch.where(upd, root, t_best)
        hitk = torch.where(upd, 1, hitk)
        hidx = torch.where(upd, j, hidx)
    return t_best, hitk, hidx


def _volume_scatter(tb, o, d, t_cap, vi, u):
    vt = tb.vt
    near = torch.full_like(t_cap, -BIG)
    far = torch.full_like(t_cap, BIG)
    for i in range(3):
        ol = (vt[4 * i + 0, vi] * o[0] + vt[4 * i + 1, vi] * o[1]
              + vt[4 * i + 2, vi] * o[2] + vt[4 * i + 3, vi])
        dl = (vt[4 * i + 0, vi] * d[0] + vt[4 * i + 1, vi] * d[1]
              + vt[4 * i + 2, vi] * d[2])
        safe = torch.where(torch.abs(dl) < 1e-12,
                           torch.where(dl < 0, -1e-12, 1e-12), dl)
        inv = 1.0 / safe
        ta = (vt[12 + i, vi] - ol) * inv
        tb_ = (vt[15 + i, vi] - ol) * inv
        near = torch.maximum(near, torch.minimum(ta, tb_))
        far = torch.minimum(far, torch.maximum(ta, tb_))
    crosses = far > near
    t0c = torch.clamp_min(near, EPS_HIT)
    t1c = torch.minimum(far, t_cap)
    inside = crosses & (t0c < t1c)
    ray_len = torch.sqrt(torch.clamp_min(_dot3(d, d), 1e-20))
    dist_inside = (t1c - t0c) * ray_len
    # 1e-38 is a float32 denormal: the floor keeps log finite at u == 0
    hit_dist = vt[18, vi] * torch.log(torch.clamp_min(u, 1e-38))
    accept = inside & (hit_dist <= dist_inside)
    return accept, t0c + hit_dist / ray_len


def _occluded(tb, kinds, o, d, t_cap, seed, stream, bounce, purpose_base):
    zero_i = torch.zeros_like(stream, dtype=torch.int32)
    t_best, hitk, _ = _planar_sweep(tb, kinds, o, d, t_cap, zero_i, zero_i)
    t_best, hitk, _ = _sphere_sweep(tb, o, d, torch.zeros_like(t_cap),
                                    t_best, hitk, zero_i)
    blocked = hitk > 0
    for vi in range(tb.n_vol):
        u = rngmod.uniform(seed, stream, bounce, purpose_base + 32 * vi)
        acc, _ = _volume_scatter(tb, o, d, torch.minimum(t_best, t_cap), vi, u)
        blocked = blocked | acc
    return blocked


def _wavefront_fwd_plain(tb: Tables, o, d, tm, stream, seed, max_depth):
    """Plain version on component lists.  Returns ([9, R] f32 rows:
    radiance, miss direction, miss throughput; [R] i32 flag word)."""
    f32 = torch.float32
    zero = torch.zeros_like(tm)
    one = torch.ones_like(tm)
    o, d = list(o), list(d)
    tp = [one.clone(), one.clone(), one.clone()]
    rad = [zero.clone(), zero.clone(), zero.clone()]
    m_dir = [zero.clone(), zero.clone(), zero.clone()]
    m_tp = [zero.clone(), zero.clone(), zero.clone()]
    alive = torch.ones_like(tm, dtype=torch.bool)
    allow = alive.clone()
    missed = torch.zeros_like(alive)
    m_prim = torch.zeros_like(alive)
    zero_i = torch.zeros_like(stream, dtype=torch.int32)
    use_nee = tb.n_lights > 0
    two_pi = float(np.float32(2.0 * np.pi))
    inv_pi = float(np.float32(1.0 / np.pi))
    # planar kinds as host ints: one read, not one per primitive and sweep
    kinds = [int(k) for k in tb.pt[14, :tb.n_planar].tolist()]

    for bounce in range(max_depth):
        if not bool(alive.any()):
            # every ray died before the last bounce: a further bounce would
            # leave allowLightHits set on all of them
            allow = torch.ones_like(alive)
            break
        # dead lanes sweep with t_cap = 0 and so find nothing
        t = torch.where(alive, BIG, 0.0).to(f32)
        t, hitk, hidx = _planar_sweep(tb, kinds, o, d, t, zero_i, zero_i)
        t, hitk, hidx = _sphere_sweep(tb, o, d, tm, t, hitk, hidx)
        hit = (hitk > 0) & alive

        is_vol = torch.zeros_like(alive)
        vwin = zero_i
        for vi in range(tb.n_vol):
            u = rngmod.uniform(seed, stream, bounce, 64 + 32 * vi)
            t_limit = torch.where(hit, t, BIG)
            acc, t_v = _volume_scatter(tb, o, d, t_limit, vi, u)
            win = acc & (~hit | (t_v < t))
            t = torch.where(win, t_v, t)
            hit = hit | win
            is_vol = is_vol | win
            vwin = torch.where(win, vi, vwin)
            hitk = torch.where(win, 3, hitk)

        lit = alive & ~hit
        for c in range(3):
            m_dir[c] = torch.where(lit, d[c], m_dir[c])
            m_tp[c] = torch.where(lit, tp[c], m_tp[c])
        if bounce == 0:
            m_prim = lit
        missed = missed | lit

        t_rec = torch.where(hit, t, 1.0)
        p = [o[c] + t_rec * d[c] for c in range(3)]

        # winner constants, gathered by index (the kernel reads them from
        # its tables once the sweeps are over)
        is_sphere = hitk == 1
        is_planar = hitk == 2
        pj = torch.where(is_planar, hidx, 0).long()
        sj = torch.where(is_sphere, hidx, 0).long()
        vj = vwin.long()

        def pick(prow, srow, vval):
            out = torch.where(is_vol, vval, zero) if tb.n_vol else zero
            if tb.n_planar:
                out = torch.where(is_planar, tb.pt[prow][pj], out)
            if tb.n_sphere:
                out = torch.where(is_sphere, tb.st[srow][sj], out)
            return out

        vrow = (lambda r: tb.vt[r][vj]) if tb.n_vol else (lambda r: zero)
        matkind = pick(15, 7, vrow(19))
        texkind = pick(16, 8, vrow(20))
        fuzz = pick(17, 9, zero)
        ior = torch.clamp_min(pick(18, 10, one), 1e-3)
        col = [pick(19 + c, 11 + c, vrow(21 + c)) for c in range(3)]
        even = [pick(22 + c, 14 + c, zero) for c in range(3)]
        odd = [pick(25 + c, 17 + c, zero) for c in range(3)]
        inv_scale = pick(28, 20, zero)

        if tb.n_sphere:
            sc = [tb.st[c][sj] + tm * tb.st[3 + c][sj] for c in range(3)]
            inv_rad = 1.0 / torch.sqrt(torch.clamp_min(tb.st[6][sj], 1e-20))
        outn = []
        for c in range(3):
            n_c = tb.pt[c][pj] if tb.n_planar else zero
            n_c = torch.where(is_planar, n_c, zero)
            if tb.n_sphere:
                n_c = torch.where(is_sphere, (p[c] - sc[c]) * inv_rad, n_c)
            outn.append(n_c)
        ddn = _dot3(d, outn)
        front = (ddn < 0.0) | is_vol
        flip = torch.where(front, 1.0, -1.0)
        nrm = [outn[c] * flip for c in range(3)]
        nrm[0] = torch.where(is_vol, one, nrm[0])
        nrm[1] = torch.where(is_vol, zero, nrm[1])
        nrm[2] = torch.where(is_vol, zero, nrm[2])

        lat = (torch.floor(inv_scale * p[0] + 1e-4)
               + torch.floor(inv_scale * p[1] + 1e-4)
               + torch.floor(inv_scale * p[2] + 1e-4))
        is_even = lat - 2.0 * torch.floor(lat * 0.5) == 0.0
        is_checker = texkind == 1.0
        albedo = [
            torch.where(is_checker, torch.where(is_even, even[c], odd[c]), col[c])
            for c in range(3)
        ]

        su1, su2, _ = rngmod.uniform3(seed, stream, bounce, rngmod.SCATTER_U)
        zr = 1.0 - 2.0 * su1
        phi = two_pi * su2
        rrr = torch.sqrt(torch.clamp_min(1.0 - zr * zr, 0.0))
        ru = [rrr * torch.cos(phi), rrr * torch.sin(phi), zr]
        ufr = rngmod.uniform(seed, stream, bounce, rngmod.FRESNEL)

        lam = [nrm[c] + ru[c] for c in range(3)]
        near0 = ((torch.abs(lam[0]) < 1e-8) & (torch.abs(lam[1]) < 1e-8)
                 & (torch.abs(lam[2]) < 1e-8))
        lam = [torch.where(near0, nrm[c], lam[c]) for c in range(3)]

        ddn_f = _dot3(d, nrm)
        rfl = [d[c] - nrm[c] * (2.0 * ddn_f) for c in range(3)]
        rlen = torch.sqrt(torch.clamp_min(_dot3(rfl, rfl), 1e-20))
        met = [rfl[c] / rlen + ru[c] * fuzz for c in range(3)]
        metal_ok = _dot3(met, nrm) > 0.0

        ri = torch.where(front, 1.0 / ior, ior)
        dlen = torch.sqrt(torch.clamp_min(_dot3(d, d), 1e-20))
        ud = [d[c] / dlen for c in range(3)]
        udn = _dot3(ud, nrm)
        cos_t = torch.clamp_max(-udn, 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        cannot = ri * sin_t > 1.0
        r0s = (1.0 - ri) / (1.0 + ri)
        r0s = r0s * r0s
        omc = torch.clamp_min(1.0 - cos_t, 0.0)
        omc2 = omc * omc
        schl = r0s + (1.0 - r0s) * omc2 * omc2 * omc
        do_refl = cannot | (schl > ufr)
        perp = [(ud[c] + nrm[c] * cos_t) * ri for c in range(3)]
        parl = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - _dot3(perp, perp)), 1e-20))
        refr = [perp[c] + nrm[c] * parl for c in range(3)]
        drefl = [ud[c] - nrm[c] * (2.0 * udn) for c in range(3)]
        diel = [torch.where(do_refl, drefl[c], refr[c]) for c in range(3)]

        is_lam = matkind == 0.0
        is_met = matkind == 1.0
        is_die = matkind == 2.0
        is_light = matkind == 3.0
        new_d = [
            torch.where(is_lam, lam[c],
                        torch.where(is_met, met[c],
                                    torch.where(is_die, diel[c], ru[c])))
            for c in range(3)
        ]
        atten = [torch.where(is_die, one, albedo[c]) for c in range(3)]
        scattered = ~is_light & ((is_met & metal_ok) | ~is_met)

        emit_mask = alive & hit & allow & is_light
        for c in range(3):
            rad[c] = rad[c] + torch.where(emit_mask, tp[c] * albedo[c], 0.0)

        use_mis = (alive & hit & is_lam) if use_nee else torch.zeros_like(alive)
        if use_nee:
            # The clamp floors (1e-20, 1e-12, cos_l < 1e-3) are the JAX
            # kernel's: the gradient kernels differentiate against them.
            nl = tb.n_lights
            up = rngmod.uniform(seed, stream, bounce, rngmod.LIGHT_PICK)
            li = torch.clamp_max(torch.floor(up * float(nl)), float(nl - 1)).long()
            ua, ub, _ = rngmod.uniform3(seed, stream, bounce, rngmod.LIGHT_U)
            lsel = [tb.lt[f][li] for f in range(LT_ROWS)]
            lp = [lsel[c] + ua * lsel[3 + c] + ub * lsel[6 + c] for c in range(3)]
            tl = [lp[c] - p[c] for c in range(3)]
            dist = torch.sqrt(torch.clamp_min(_dot3(tl, tl), 1e-20))
            ld = [tl[c] / dist for c in range(3)]
            cos_th = _dot3(nrm, ld)
            facing = cos_th > 0.0
            # inactive shadow lanes sweep with t_cap = 0 and find nothing
            shadow_cap = torch.where(use_mis & facing, dist - EPS_HIT, zero)
            blocked = _occluded(tb, kinds, p, ld, shadow_cap, seed, stream,
                                bounce, 65)
            cos_l = torch.abs(-(lsel[9] * ld[0] + lsel[10] * ld[1] + lsel[11] * ld[2]))
            grazing = cos_l < 1e-3
            pdf_l = (dist * dist) / torch.clamp_min(cos_l * lsel[12], 1e-20)
            pdf_b = torch.clamp_min(cos_th, 0.0) * inv_pi
            weight = pdf_l / torch.clamp_min(pdf_l + pdf_b, 1e-20)
            scale = cos_th / torch.clamp_min(pdf_l, 1e-12) * weight * float(nl)
            ok = facing & ~blocked & ~grazing & use_mis
            for c in range(3):
                contrib = torch.clamp_max(lsel[13 + c] * atten[c] * scale, FIREFLY)
                rad[c] = rad[c] + torch.where(ok, tp[c] * contrib, 0.0)

        alive = alive & hit & scattered
        for c in range(3):
            tp[c] = torch.where(alive, tp[c] * atten[c], tp[c])
            o[c] = torch.where(alive, p[c], o[c])
            d[c] = torch.where(alive, new_d[c], d[c])
        allow = ~use_mis

    out = torch.stack(rad + m_dir + m_tp, dim=0)
    flags = (missed.to(torch.int32) * FLAG_MISSED
             + m_prim.to(torch.int32) * FLAG_PRIMARY
             + alive.to(torch.int32) * FLAG_ALIVE
             + allow.to(torch.int32) * FLAG_ALLOW)
    return out, flags


# -----------------------------------------------------------------------------
# Kernel wrapper
# -----------------------------------------------------------------------------

_P = ctypes.c_void_p
_ARGTYPES = (
    [_P] * 4 + [ctypes.c_int] * 4        # tables, counts
    + [_P] * 8                           # ox oy oz dx dy dz tm stream
    + [_P, _P]                           # out rows, flags
    + [ctypes.c_longlong, ctypes.c_uint, ctypes.c_int]  # R, seed, depth
    + [_P]                               # CUDA stream
)


def _kernel(fmad: bool = False):
    from . import _build

    lib = _build.load("wavefront", fmad=fmad).lib
    fn = lib.wavefront_fwd_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _wavefront_fwd_cuda(tb: Tables, o, d, tm, stream, seed, max_depth,
                        fmad: bool = False):
    """Launch the kernel on PyTorch's current stream.  Does not
    synchronize.  Returns ([9, R] f32, [R] i32).

    The inputs may be freed by the caller right after the call: PyTorch's
    allocator hands their memory only to later work on the same stream."""
    global LAUNCHES
    rays = list(o) + list(d) + [tm]
    r = tm.shape[0]
    dev = tm.device
    for a in rays:
        if a.device != dev or a.dtype != torch.float32 or a.shape != (r,) \
                or not a.is_contiguous():
            raise ValueError(
                "rays must be contiguous float32 [R] tensors on one CUDA "
                f"device, got {a.dtype} {tuple(a.shape)} on {a.device}")
    if stream.device != dev or stream.dtype != torch.int32 \
            or stream.shape != (r,) or not stream.is_contiguous():
        raise ValueError("stream must be a contiguous int32 [R] tensor "
                         "(the unsigned 32-bit ray counter's bit pattern)")
    for tab, rows in ((tb.pt, PT_ROWS), (tb.st, ST_ROWS), (tb.vt, VT_ROWS),
                      (tb.lt, LT_ROWS)):
        if tab.device != dev or tab.dtype != torch.float32 \
                or tab.shape[0] != rows or not tab.is_contiguous():
            raise ValueError("tables must be contiguous float32 on the rays' device")
    if tb.n_vol > 4 or tb.n_lights > 8:
        raise ValueError("the kernel takes at most 4 volumes and 8 lights")
    if not 0 < max_depth:
        raise ValueError("max_depth must be positive")

    out = torch.empty((9, r), dtype=torch.float32, device=dev)
    flags = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return out, flags
    fn = _kernel(fmad)
    with torch.cuda.device(dev):
        err = fn(
            tb.pt.data_ptr(), tb.st.data_ptr(), tb.vt.data_ptr(),
            tb.lt.data_ptr(), tb.n_planar, tb.n_sphere, tb.n_vol, tb.n_lights,
            *[a.data_ptr() for a in rays], stream.data_ptr(),
            out.data_ptr(), flags.data_ptr(),
            r, int(seed) & 0xFFFFFFFF, int(max_depth),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wavefront_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, flags


def stream_to_i32(stream):
    """Ray counter (any integer dtype, values mod 2**32) -> the int32
    tensor with the same 32-bit pattern, which is what the kernel reads."""
    if stream.dtype == torch.int32:
        return stream.contiguous()
    s = stream.to(torch.int64) & 0xFFFFFFFF
    return (s - ((s >> 31) << 32)).to(torch.int32).contiguous()


def wavefront_fwd(tb: Tables, o, d, tm, stream, seed, max_depth):
    """Forward bounce loop on prepared tables.  CUDA rays launch the
    kernel (or raise); CPU rays run the plain version."""
    stream = stream_to_i32(stream)
    if tm.is_cuda:
        return _wavefront_fwd_cuda(tb, o, d, tm, stream, seed, max_depth)
    return _wavefront_fwd_plain(tb, o, d, tm, stream, seed, max_depth)


def _unpack(out, flags):
    return (V3(out[0], out[1], out[2]), V3(out[3], out[4], out[5]),
            V3(out[6], out[7], out[8]), flags)


def _check_scene(scene):
    if not applicable(scene):
        raise NotImplementedError(
            "scene is outside the forward megakernel's gate (meshes, image "
            "or noise textures, environments, non-box media, or too many "
            "primitives): see ROADMAP.md queues A and B")


def trace_megakernel(scene, cam, o: V3, d: V3, tm, stream, seed):
    """Full bounce loop for a ray megabatch.  Returns (radiance V3,
    miss_dir V3, miss_tp V3, flags [R] i32) where ``flags`` is
    ``missed | 2*miss_primary | 4*alive | 8*allowLightHits``; the caller
    applies the deferred miss shader (integrator/wavefront.trace)."""
    _check_scene(scene)
    tb = build_tables(scene)
    return _unpack(*wavefront_fwd(tb, o, d, tm, stream, seed, cam.max_depth))


def trace_megakernel_plain(scene, cam, o: V3, d: V3, tm, stream, seed):
    """``trace_megakernel`` through the plain PyTorch version, on whatever
    device the rays lie."""
    _check_scene(scene)
    tb = build_tables(scene)
    return _unpack(*_wavefront_fwd_plain(
        tb, o, d, tm, stream_to_i32(stream), seed, cam.max_depth))
