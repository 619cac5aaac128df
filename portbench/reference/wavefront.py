"""The bounce loop, its stash, and the two reverse sweeps, in plain PyTorch.

A frozen copy of the program's plain versions of its forward kernel, its
stash-writing gradient forward (product-chain and pathwise rows) and its two
reverse sweeps, trimmed to what the benchmark's configurations hold: quads
and planes, static spheres, box volumes, lambertian, metal, dielectric,
light and isotropic materials, solid and checker textures, one or more quad
lights with NEE and balance-heuristic MIS, and the environment's own NEE
sample (HDRI rows).  Written with ``[R]`` tensors and Python loops over
primitives and bounces, every operation in the kernels' order.

``hold`` rounds what a ray carries from one bounce to the next (origin,
direction, throughput, radiance): ``keep`` for the reference, a round trip
through bfloat16 for the control (``jobs.control``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng as rngmod
from .scene import LT_ROWS, Tables

BIG = float(np.float32(3.0e38))
EPS_HIT = float(np.float32(1e-3))
EPS_PARALLEL = float(np.float32(1e-8))
FIREFLY = 20.0
KIND_QUAD, KIND_TRI, KIND_CIRCLE, KIND_PLANE = 0, 1, 2, 3
FLAG_MISSED, FLAG_PRIMARY, FLAG_ALIVE, FLAG_ALLOW = 1, 2, 4, 8
STASH_F_ROWS, STASH_I_ROWS = 12, 3
PW_STASH_F_ROWS = 19
SLOT_NONE, LSLOT_NONE, MSLOT_NONE = -3, -9, -9
MK_EMIT, MK_ALIVE_NEXT, MK_LIT, MK_CLAMPED = 1, 2, 4, 8
PW_EMIT, PW_ALIVE_NEXT, PW_LIT, PW_BLK_A, PW_FRONT = 1, 2, 4, 8, 16
PW_METAL, PW_DIELECTRIC, PW_HIT, PW_USE_MIS, PW_BLK_H = 32, 64, 128, 256, 512
PW_VOLUME, PW_VOL_SHIFT = 1024, 11
HDRI_ROWS = 7
MISS_FLAT, MISS_SKY, MISS_STREAM = 0, 1, 2


def keep(x):
    """``hold`` of the reference: what a ray carries stays float32."""
    return x


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
        if kind == KIND_PLANE:
            t_ok = (t > EPS_HIT) & (t < t_best)
        else:
            t_ok = (t >= EPS_HIT) & (t <= t_best)
        rx = o[0] + t * d[0] - pt[4, j]
        ry = o[1] + t * d[1] - pt[5, j]
        rz = o[2] + t * d[2] - pt[6, j]
        alpha = rx * pt[7, j] + ry * pt[8, j] + rz * pt[9, j]
        beta = rx * pt[10, j] + ry * pt[11, j] + rz * pt[12, j]
        if kind == KIND_QUAD:
            interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
        elif kind == KIND_TRI:
            interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (alpha + beta <= 1.0)
        elif kind == KIND_CIRCLE:
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
    t_best, hitk, _ = _sphere_sweep(tb, o, d, torch.zeros_like(t_cap), t_best, hitk, zero_i)
    blocked = hitk > 0
    for vi in range(tb.n_vol):
        u = rngmod.uniform(seed, stream, bounce, purpose_base + 32 * vi)
        acc, _ = _volume_scatter(tb, o, d, torch.minimum(t_best, t_cap), vi, u)
        blocked = blocked | acc
    return blocked


def bounce_loop(tb: Tables, o, d, tm, stream, seed, max_depth, stash=None,
                pathwise=False, hdri=None, hold=keep):
    """The bounce loop on component lists.  Returns ([9, R] f32 rows:
    radiance, miss direction, miss throughput; [R] i32 flag word).

    ``hdri``: [max_depth * 7, R] rows of HDRI NEE (``jobs.hdri_rows``), or
    None.

    ``stash``: (stash_f [D, 12, R] f32, stash_i [D, 3, R] i32) holding inert
    rows; the rows of every bounce a ray enters are written into it.  With
    ``pathwise`` the stash is [D, 19, R] and [D, 3, R] in the pathwise
    layout.  The radiance does not depend on either."""
    f32 = torch.float32
    zero = torch.zeros_like(tm)
    one = torch.ones_like(tm)
    o, d = [hold(x) for x in o], [hold(x) for x in d]
    tp = [one.clone(), one.clone(), one.clone()]
    rad = [zero.clone(), zero.clone(), zero.clone()]
    m_dir = [zero.clone(), zero.clone(), zero.clone()]
    m_tp = [zero.clone(), zero.clone(), zero.clone()]
    flags0 = torch.full_like(stream, FLAG_ALIVE | FLAG_ALLOW, dtype=torch.int32)
    alive = (flags0 & FLAG_ALIVE) != 0
    allow = (flags0 & FLAG_ALLOW) != 0
    missed = (flags0 & FLAG_MISSED) != 0
    m_prim = (flags0 & FLAG_PRIMARY) != 0
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
            m_prim = m_prim | lit
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
        blk_a = blk_h = torch.zeros_like(alive)
        if stash is not None and not pathwise:
            em_su = [zero, zero, zero]
            alb_su = [zero, zero, zero]
            clamped = [torch.zeros_like(alive)] * 3
            lslot = torch.full_like(zero_i, LSLOT_NONE)
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
            blk_a = blocked
            cos_l = torch.abs(-(lsel[9] * ld[0] + lsel[10] * ld[1] + lsel[11] * ld[2]))
            grazing = cos_l < 1e-3
            pdf_l = (dist * dist) / torch.clamp_min(cos_l * lsel[12], 1e-20)
            pdf_b = torch.clamp_min(cos_th, 0.0) * inv_pi
            weight = pdf_l / torch.clamp_min(pdf_l + pdf_b, 1e-20)
            scale = cos_th / torch.clamp_min(pdf_l, 1e-12) * weight * float(nl)
            ok = facing & ~blocked & ~grazing & use_mis
            for c in range(3):
                raw = lsel[13 + c] * atten[c] * scale
                contrib = torch.clamp_max(raw, FIREFLY)
                rad[c] = rad[c] + torch.where(ok, tp[c] * contrib, 0.0)
                if stash is not None and not pathwise:
                    kept = ok & (raw < FIREFLY)
                    em_su[c] = torch.where(kept, lsel[13 + c] * scale, 0.0)
                    alb_su[c] = torch.where(kept, atten[c] * scale, 0.0)
                    clamped[c] = ok & ~kept
            if stash is not None and not pathwise:
                lslot = torch.where(use_mis, (lsel[16] * 3.0).to(torch.int32),
                                    LSLOT_NONE)

        if hdri is not None and use_nee:
            # NEE toward the environment: the sample comes in as rows; the
            # shadow ray is capped at 3e38 (inactive lanes at 0 find nothing)
            hrow = [hdri[bounce * HDRI_ROWS + c] for c in range(HDRI_ROWS)]
            hd, hem, pdf_h = hrow[0:3], hrow[3:6], hrow[6]
            cos_h = _dot3(nrm, hd)
            facing_h = cos_h > 0.0
            shadow_cap_h = torch.where(use_mis & facing_h, 3.0e38, zero)
            blocked_h = _occluded(tb, kinds, p, hd, shadow_cap_h, seed, stream,
                                  bounce, 66)
            blk_h = blocked_h
            pdf_bh = torch.clamp_min(cos_h, 0.0) * inv_pi
            weight_h = pdf_h / torch.clamp_min(pdf_h + pdf_bh, 1e-20)
            scale_h = cos_h / torch.clamp_min(pdf_h, 1e-12) * weight_h
            ok_h = facing_h & ~blocked_h & use_mis
            for c in range(3):
                contrib = torch.clamp_max(hem[c] * atten[c] * scale_h, FIREFLY)
                rad[c] = rad[c] + torch.where(ok_h, tp[c] * contrib, 0.0)

        if stash is not None and pathwise:
            # The reverse sweep recomputes the NEE chain and every random
            # draw; of the shadow sweep only the outcome is kept, as a bit.
            # Lanes that did not enter this bounce keep inert rows.
            stash_f, stash_i = stash
            hit_a = alive & hit
            variant = torch.where(is_checker, torch.where(is_even, 1.0, 2.0), 0.0)
            tex_id = pick(29, 21, vrow(24))
            mat_id = pick(30, 22, zero + float(MSLOT_NONE))
            rows = (tp + atten + p + d + nrm
                    + [fuzz, ior,
                       torch.where(is_sphere & hit_a, flip * inv_rad, zero)
                       if tb.n_sphere else zero,
                       t_rec])
            for r_, v in enumerate(rows):
                stash_f[bounce, r_] = torch.where(alive, v, 0.0)
            # a dielectric's albedo never enters (atten = 1)
            slot = torch.where(hit_a & ~is_die,
                               (tex_id * 3.0 + variant).to(torch.int32), SLOT_NONE)
            mslot = torch.where(hit_a, mat_id.to(torch.int32), MSLOT_NONE)
            i32 = torch.int32
            mk = (emit_mask.to(i32) * PW_EMIT
                  + (hit_a & scattered).to(i32) * PW_ALIVE_NEXT
                  + lit.to(i32) * PW_LIT
                  + (alive & blk_a).to(i32) * PW_BLK_A
                  + (alive & front).to(i32) * PW_FRONT
                  + (hit_a & is_met).to(i32) * PW_METAL
                  + (hit_a & is_die).to(i32) * PW_DIELECTRIC
                  + hit_a.to(i32) * PW_HIT
                  + use_mis.to(i32) * PW_USE_MIS
                  + (alive & blk_h).to(i32) * PW_BLK_H
                  + (hit_a & is_vol).to(i32) * PW_VOLUME
                  + torch.where(hit_a & is_vol, vwin, 0).to(i32) * (1 << PW_VOL_SHIFT))
            stash_i[bounce, 0] = slot
            stash_i[bounce, 1] = mslot
            stash_i[bounce, 2] = mk
        elif stash is not None:
            # rows of the lanes that entered this bounce; the others keep
            # inert rows (a dead lane can still "hit" a volume: its free
            # flight is not capped)
            stash_f, stash_i = stash
            hit_a = alive & hit
            variant = torch.where(is_checker, torch.where(is_even, 1.0, 2.0), 0.0)
            tex_id = pick(29, 21, vrow(24))
            slot = torch.where(hit_a,
                               (tex_id * 3.0 + variant).to(torch.int32), SLOT_NONE)
            mk = (emit_mask.to(torch.int32) * MK_EMIT
                  + (hit_a & scattered).to(torch.int32) * MK_ALIVE_NEXT
                  + lit.to(torch.int32) * MK_LIT)
            for c in range(3):
                stash_f[bounce, 0 + c] = torch.where(alive, tp[c], 0.0)
                stash_f[bounce, 3 + c] = torch.where(hit_a, atten[c], 0.0)
                stash_f[bounce, 6 + c] = em_su[c]
                stash_f[bounce, 9 + c] = alb_su[c]
                mk = mk + clamped[c].to(torch.int32) * (MK_CLAMPED << c)
            stash_i[bounce, 0] = slot
            stash_i[bounce, 1] = lslot
            stash_i[bounce, 2] = mk

        alive = alive & hit & scattered
        for c in range(3):
            tp[c] = hold(torch.where(alive, tp[c] * atten[c], tp[c]))
            o[c] = hold(torch.where(alive, p[c], o[c]))
            d[c] = hold(torch.where(alive, new_d[c], d[c]))
            rad[c] = hold(rad[c])
        allow = ~use_mis

    out = torch.stack(rad + m_dir + m_tp, dim=0)
    flags = (missed.to(torch.int32) * FLAG_MISSED
             + m_prim.to(torch.int32) * FLAG_PRIMARY
             + alive.to(torch.int32) * FLAG_ALIVE
             + allow.to(torch.int32) * FLAG_ALLOW)
    return out, flags


def product_reverse(stash_f, stash_i, g3, miss_col, n_tex):
    """Plain version of the reverse sweep: the product-chain adjoint

        R_k = s_k + aeff_k * R_{k+1}
        s_c = alb*emit + alb*em_su + FIREFLY*clamped_c + miss_col*lit
        cot_alb_c = g_c T_c (R_c*alive_next + emit + em_su_c)  -> slot
        cot_lem_c = g_c T_c alb_su_c                            -> light slot

    from the last bounce to the first.  ``g3`` [3, R] is the cotangent of
    the rays' radiance.  Returns [n_tex, 3 variants, 3 channels] f32.  The
    per-ray terms are float32 as in the kernel; they are summed in float64,
    so this is the more exact of the two."""
    depth = stash_f.shape[0]
    null = 9 * n_tex   # bin of the rows without a slot
    acc = torch.zeros(null + 1, dtype=torch.float64, device=stash_f.device)
    rk = [torch.zeros_like(g3[0]) for _ in range(3)]
    for k in range(depth - 1, -1, -1):
        sf = stash_f[k]
        slot, lslot, mk = stash_i[k, 0], stash_i[k, 1], stash_i[k, 2]
        emitf = ((mk & MK_EMIT) > 0).to(torch.float32)
        alive_nf = ((mk & MK_ALIVE_NEXT) > 0).to(torch.float32)
        litf = ((mk & MK_LIT) > 0).to(torch.float32)
        a_bin, l_bin = slot.long() * 3, lslot.long() * 3
        for c in range(3):
            t_c, alb, em_su, alb_su = sf[c], sf[3 + c], sf[6 + c], sf[9 + c]
            clampf = ((mk & (MK_CLAMPED << c)) > 0).to(torch.float32)
            s_c = alb * emitf + alb * em_su + FIREFLY * clampf + miss_col[c] * litf
            cotb = g3[c] * t_c
            cot_alb = cotb * (rk[c] * alive_nf + emitf + em_su)
            cot_lem = cotb * alb_su
            acc.index_add_(0, torch.where(slot >= 0, a_bin + c, null),
                           cot_alb.double())
            acc.index_add_(0, torch.where(lslot >= 0, l_bin + c, null),
                           cot_lem.double())
            aeff = alb * alive_nf + (1.0 - alive_nf)
            rk[c] = s_c + aeff * rk[c]
    return acc[:null].to(torch.float32).reshape(n_tex, 3, 3)


def _volume_entry(tb, o, d, vi):
    """Entry slab of box volume ``vi`` for the pathwise volume adjoint:
    (near, ne[3], inv_e, act_e) where near = max_i min(ta, tb) is the
    window's entry distance, ne the world-to-local row of the axis that
    gives it, inv_e = 1 / (ne . d) with the 1e-12 guard of the window, and
    act_e whether that guard was idle.  The scatter distance is
    t = max(near, eps) + K / |d| with K from the random draw alone, so
    dt/do = -ne inv_e and dt/dd = -near ne inv_e act_e."""
    vt = tb.vt
    zero = torch.zeros_like(o[0])
    near = torch.full_like(zero, -BIG)
    tmins, invs, acts = [], [], []
    for i in range(3):
        ol = (vt[4 * i + 0, vi] * o[0] + vt[4 * i + 1, vi] * o[1]
              + vt[4 * i + 2, vi] * o[2] + vt[4 * i + 3, vi])
        dl = (vt[4 * i + 0, vi] * d[0] + vt[4 * i + 1, vi] * d[1]
              + vt[4 * i + 2, vi] * d[2])
        act = torch.abs(dl) >= 1e-12
        safe = torch.where(act, dl, torch.where(dl < 0, -1e-12, 1e-12))
        inv = 1.0 / safe
        ta = (vt[12 + i, vi] - ol) * inv
        tb_ = (vt[15 + i, vi] - ol) * inv
        tmins.append(torch.minimum(ta, tb_))
        invs.append(inv)
        acts.append(act)
        near = torch.maximum(near, tmins[i])
    ne = [zero, zero, zero]
    inv_e, act_e = zero, zero
    chosen = torch.zeros_like(zero, dtype=torch.bool)
    for i in range(3):
        wsel = ~chosen & (tmins[i] == near)
        ne = [torch.where(wsel, vt[4 * i + c, vi], ne[c]) for c in range(3)]
        inv_e = torch.where(wsel, invs[i], inv_e)
        act_e = torch.where(wsel & acts[i], 1.0, act_e)
        chosen = chosen | wsel
    return near, ne, inv_e, act_e


def pathwise_reverse(tb: Tables, stash_f, stash_i, g3, miss_col, stream,
                     seed, miss_mode, n_tex, n_mat, lmd=None, hdri=None):
    """Plain version of the pathwise reverse sweep: the pathwise kernel's
    arithmetic step by step on ``[R]`` tensors (not ``torch.autograd`` of
    the forward).  From the last bounce to the first it carries the adjoints
    of the throughput (ltp), the ray origin (lo) and the direction (ld), and
    per bounce

      * recomputes the scatter draw, the Fresnel draw and the light sample
        from (seed, stream, bounce), and the NEE chain with the forward's
        clamp floors, and takes the partials of the NEE scale with respect
        to the hit point and the normal;
      * reverses the scatter: lambertian (normal + draw), metal (reflect,
        normalise, + fuzz * draw -> d(fuzz)), dielectric (reflect or
        refract on the unit direction, the branch recomputed -> d(ior));
      * takes the derivative of the miss colour by the miss direction (sky),
        or adds the cotangent of the miss direction ``lmd`` [3, R] (an
        environment, ``miss_mode`` ``MISS_STREAM``);
      * with ``hdri`` rows (the fused kernel's), recomputes the HDRI NEE
        term: its albedo and clamp parts, the normal's adjoint, and the
        cotangent of each bounce's environment sample (``eout``);
      * sends the hit point's adjoint back through the hit distance by the
        implicit rule dt/do = -n / (n . d), dt/dd = t dt/do (surfaces), or
        through the entry slab and the free-flight length (volumes);
      * adds the cotangents of the albedo (per texture slot), of the light's
        emission (per light slot) and of fuzz and ior (per material).

    ``g3`` [3, R] is the cotangent of the rays' radiance, ``miss_col``
    [3, R] the gradient forward's.  Returns ([n_tex, 3 variants, 3 channels],
    fuzz [n_mat], ior [n_mat], eout [D, 3, R] or None) f32.  Per-ray terms
    are float32 as in the kernel; they are summed in float64."""
    depth = stash_f.shape[0]
    n_col = 9 * n_tex
    null = n_col + 2 * n_mat          # bin of the rows without a slot
    acc = torch.zeros(null + 2, dtype=torch.float64, device=stash_f.device)
    zero = torch.zeros_like(g3[0])
    g = [g3[0], g3[1], g3[2]]
    lo_ = [zero, zero, zero]
    ldv = [zero, zero, zero]
    ltp = [zero, zero, zero]
    two_pi = float(np.float32(2.0 * np.pi))
    inv_pi = float(np.float32(1.0 / np.pi))
    sky_s = (0.5, 0.7, 1.0)
    use_nee = tb.n_lights > 0
    use_sky = int(miss_mode) == MISS_SKY
    stream_miss = int(miss_mode) == MISS_STREAM
    eout = (torch.zeros((depth, 3) + tuple(g3[0].shape), dtype=torch.float32,
                        device=g3.device) if hdri is not None else None)

    def fl(cond):
        return cond.to(torch.float32)

    for k in range(depth - 1, -1, -1):
        sf = stash_f[k]
        T = [sf[c] for c in range(3)]
        alb = [sf[3 + c] for c in range(3)]
        pv = [sf[6 + c] for c in range(3)]
        din = [sf[9 + c] for c in range(3)]
        nv = [sf[12 + c] for c in range(3)]
        # inert rows hold 0: the floor keeps 1 / ior finite there
        io_ = torch.clamp_min(sf[16], 1e-3)
        dndp, tk = sf[17], sf[18]
        slot, mslot, mk = stash_i[k, 0], stash_i[k, 1], stash_i[k, 2]
        emitf = fl((mk & PW_EMIT) > 0)
        Af = fl((mk & PW_ALIVE_NEXT) > 0)
        litf = fl((mk & PW_LIT) > 0)
        blkb = (mk & PW_BLK_A) > 0
        frontb = (mk & PW_FRONT) > 0
        metf = fl((mk & PW_METAL) > 0)
        dief = fl((mk & PW_DIELECTRIC) > 0)
        hitf = fl((mk & PW_HIT) > 0)
        misb = (mk & PW_USE_MIS) > 0

        su1, su2, _ = rngmod.uniform3(seed, stream, k, rngmod.SCATTER_U)
        zr = 1.0 - 2.0 * su1
        phi = two_pi * su2
        rrr = torch.sqrt(torch.clamp_min(1.0 - zr * zr, 0.0))
        ru = [rrr * torch.cos(phi), rrr * torch.sin(phi), zr]
        ufr = rngmod.uniform(seed, stream, k, rngmod.FRESNEL)

        # ---- NEE recompute (operation for operation the forward's) and the
        # partials of its scale with respect to (p, n)
        em_su = [zero, zero, zero]
        alb_su = [zero, zero, zero]
        clampf = [zero, zero, zero]
        lp_nee = [zero, zero, zero]
        ln_nee = [zero, zero, zero]
        lslot = torch.full_like(slot, LSLOT_NONE)
        if use_nee:
            nl = float(tb.n_lights)
            up = rngmod.uniform(seed, stream, k, rngmod.LIGHT_PICK)
            li = torch.clamp_max(torch.floor(up * nl), nl - 1.0).long()
            ua, ub, _ = rngmod.uniform3(seed, stream, k, rngmod.LIGHT_U)
            lsel = [tb.lt[f][li] for f in range(LT_ROWS)]
            lpnt = [lsel[c] + ua * lsel[3 + c] + ub * lsel[6 + c] for c in range(3)]
            tl = [lpnt[c] - pv[c] for c in range(3)]
            tl2 = _dot3(tl, tl)
            dist = torch.sqrt(torch.clamp_min(tl2, 1e-20))
            ldir = [tl[c] / dist for c in range(3)]
            cos_th = _dot3(nv, ldir)
            facing = cos_th > 0.0
            zlc = -(lsel[9] * ldir[0] + lsel[10] * ldir[1] + lsel[11] * ldir[2])
            cos_l = torch.abs(zlc)
            grazing = cos_l < 1e-3
            s2v = cos_l * lsel[12]
            s2 = torch.clamp_min(s2v, 1e-20)
            pdf_l = (dist * dist) / s2
            qv = torch.clamp_min(pdf_l, 1e-12)
            pdf_b = torch.clamp_min(cos_th, 0.0) * inv_pi
            rv = torch.clamp_min(pdf_l + pdf_b, 1e-20)
            weight = pdf_l / rv
            scale = cos_th / qv * weight * nl
            ok = facing & ~blkb & ~grazing & misb
            okf = fl(ok)
            W = zero
            for c in range(3):
                uf = torch.where(lsel[13 + c] * alb[c] * scale < FIREFLY, okf, zero)
                em_su[c] = lsel[13 + c] * scale * uf
                alb_su[c] = alb[c] * scale * uf
                clampf[c] = okf - uf
                W = W + g[c] * T[c] * lsel[13 + c] * alb[c] * uf
            lslot = torch.where(ok, (lsel[16] * 3.0).to(torch.int32), LSLOT_NONE)
            # Lanes that are not ok are set to 1 before the partials: with
            # both pdfs near 0 inv_qr^2 is infinite, and the W = 0 of such a
            # lane cannot cancel it (0 * inf is NaN).
            one = torch.ones_like(zero)
            dist = torch.where(ok, dist, one)
            pdf_l = torch.where(ok, pdf_l, one)
            pdf_b = torch.where(ok, pdf_b, one)
            qv = torch.where(ok, qv, one)
            rv = torch.where(ok, rv, one)
            s2 = torch.where(ok, s2, one)
            # scale = nL cos_th pdf_l / (q r)
            q_act = fl(pdf_l > 1e-12)
            r_act = fl(pdf_l + pdf_b > 1e-20)
            s2_act = fl(s2v > 1e-20)
            inv_qr = 1.0 / (qv * rv)
            ds_dcos = nl * pdf_l * inv_qr
            ds_dpl = nl * cos_th * (
                inv_qr - pdf_l * (q_act * rv + qv * r_act) * inv_qr * inv_qr)
            ds_dpb = -nl * cos_th * pdf_l * r_act * inv_qr / rv
            dpb_dcos = torch.where(cos_th > 0.0, inv_pi, 0.0)
            c_cos = W * (ds_dcos + ds_dpb * dpb_dcos)
            c_pl = W * ds_dpl
            c_dist = c_pl * (2.0 * dist / s2)
            c_cosl = c_pl * (-(dist * dist) * lsel[12] * s2_act / (s2 * s2))
            sgn_z = torch.where(zlc >= 0.0, 1.0, -1.0)
            lam_ld = [c_cos * nv[c] - c_cosl * sgn_z * lsel[9 + c] for c in range(3)]
            ln_nee = [c_cos * ldir[c] for c in range(3)]
            ldd = _dot3(ldir, lam_ld)
            dist_act = fl(tl2 > 1e-20)
            lam_tl = [(lam_ld[c] - dist_act * ldir[c] * ldd) / dist
                      + c_dist * dist_act * ldir[c] for c in range(3)]
            lp_nee = [-lam_tl[c] for c in range(3)]

        # ---- HDRI NEE: the sample comes in as rows and the shadow outcome
        # as a bit; no hit-point term (a solid-angle pdf), the normal's, and
        # the cotangent of the sample's texel (eout).  Its albedo and clamp
        # parts fold into em_su and clampf, which treat both NEE terms alike.
        if hdri is not None and use_nee:
            hrow = [hdri[k * HDRI_ROWS + c] for c in range(HDRI_ROWS)]
            hdv, hemr, pdf_h = hrow[0:3], hrow[3:6], hrow[6]
            cos_h = _dot3(nv, hdv)
            blkh_b = (mk & PW_BLK_H) > 0
            ok_h = (cos_h > 0.0) & ~blkh_b & misb
            okf_h = fl(ok_h)
            pdf_bh = torch.clamp_min(cos_h, 0.0) * inv_pi
            qh = torch.clamp_min(pdf_h, 1e-12)
            rh = torch.clamp_min(pdf_h + pdf_bh, 1e-20)
            scale_h = cos_h / qh * (pdf_h / rh)
            W_h = zero
            for c in range(3):
                uf_h = torch.where(hemr[c] * alb[c] * scale_h < FIREFLY, okf_h, zero)
                em_su[c] = em_su[c] + hemr[c] * scale_h * uf_h
                clampf[c] = clampf[c] + (okf_h - uf_h)
                eout[k, c] = g[c] * T[c] * alb[c] * scale_h * uf_h
                W_h = W_h + g[c] * T[c] * hemr[c] * alb[c] * uf_h
            # lanes that are not ok set to 1 first (0 * inf is NaN)
            one = torch.ones_like(zero)
            pdf_hs = torch.where(ok_h, pdf_h, one)
            qh_s = torch.where(ok_h, qh, one)
            rh_s = torch.where(ok_h, rh, one)
            r_act_h = fl(pdf_h + pdf_bh > 1e-20)
            inv_qr_h = 1.0 / (qh_s * rh_s)
            ds_dcos_h = pdf_hs * inv_qr_h
            ds_dpbh = -cos_h * pdf_hs * r_act_h * inv_qr_h / rh_s
            dpbh_dcos = torch.where(cos_h > 0.0, inv_pi, 0.0)
            c_cos_h = W_h * (ds_dcos_h + ds_dpbh * dpbh_dcos)
            ln_nee = [ln_nee[c] + c_cos_h * hdv[c] for c in range(3)]

        # ---- scatter Jacobians, reversed (u = adjoint of the next direction)
        u = ldv
        lamf = (1.0 - metf) * (1.0 - dief)
        # metal: new_d = rfl / |rfl| + fuzz * ru
        ddn_f = _dot3(din, nv)
        rfl = [din[c] - nv[c] * (2.0 * ddn_f) for c in range(3)]
        rlen = torch.sqrt(torch.clamp_min(_dot3(rfl, rfl), 1e-20))
        rhat = [rfl[c] / rlen for c in range(3)]
        cot_fuzz = Af * metf * _dot3(ru, u)
        rhu = _dot3(rhat, u)
        vv = [(u[c] - rhat[c] * rhu) / rlen for c in range(3)]
        nvv = _dot3(nv, vv)
        l_din_met = [vv[c] - 2.0 * nv[c] * nvv for c in range(3)]
        l_n_met = [-2.0 * din[c] * nvv - 2.0 * ddn_f * vv[c] for c in range(3)]
        # dielectric: reflect or refract the unit direction; the branch is
        # recomputed from the same bits as the forward's
        dlen = torch.sqrt(torch.clamp_min(_dot3(din, din), 1e-20))
        ud = [din[c] / dlen for c in range(3)]
        udn = _dot3(ud, nv)
        cos_t = torch.clamp_max(-udn, 1.0)
        ct_act = fl(-udn < 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        ri = torch.where(frontb, 1.0 / io_, io_)
        cannot = ri * sin_t > 1.0
        r0s = (1.0 - ri) / (1.0 + ri)
        r0s = r0s * r0s
        omc = torch.clamp_min(1.0 - cos_t, 0.0)
        omc2 = omc * omc
        schl = r0s + (1.0 - r0s) * omc2 * omc2 * omc
        do_refl = cannot | (schl > ufr)
        nu = _dot3(nv, u)
        l_ud_r = [u[c] - 2.0 * nv[c] * nu for c in range(3)]
        l_n_r = [-2.0 * ud[c] * nu - 2.0 * udn * u[c] for c in range(3)]
        perp = [(ud[c] + nv[c] * cos_t) * ri for c in range(3)]
        xv = 1.0 - _dot3(perp, perp)
        parl = -torch.sqrt(torch.clamp_min(torch.abs(xv), 1e-20))
        sx_act = torch.where(xv >= 0.0, 1.0, -1.0) * fl(torch.abs(xv) > 1e-20)
        l_parl = nu
        l_perp = [u[c] - sx_act * (l_parl / parl) * perp[c] for c in range(3)]
        npp = _dot3(nv, l_perp)
        l_ud_t = [ri * (l_perp[c] - ct_act * nv[c] * npp) for c in range(3)]
        l_n_t = [ri * (cos_t * l_perp[c] - ct_act * ud[c] * npp) + parl * u[c]
                 for c in range(3)]
        cot_ri = ((ud[0] + nv[0] * cos_t) * l_perp[0]
                  + (ud[1] + nv[1] * cos_t) * l_perp[1]
                  + (ud[2] + nv[2] * cos_t) * l_perp[2])
        reflf = fl(do_refl)
        dri = torch.where(frontb, -1.0 / (io_ * io_), 1.0)
        cot_ior = Af * dief * (1.0 - reflf) * cot_ri * dri
        l_ud = [reflf * l_ud_r[c] + (1.0 - reflf) * l_ud_t[c] for c in range(3)]
        l_n_die = [reflf * l_n_r[c] + (1.0 - reflf) * l_n_t[c] for c in range(3)]
        udu = _dot3(ud, l_ud)
        l_din_die = [(l_ud[c] - ud[c] * udu) / dlen for c in range(3)]

        l_n_s = [Af * (lamf * u[c] + metf * l_n_met[c] + dief * l_n_die[c])
                 for c in range(3)]
        l_din_s = [Af * (metf * l_din_met[c] + dief * l_din_die[c])
                   for c in range(3)]

        # ---- cotangents of the colours, and the throughput adjoint
        cot_alb = [g[c] * T[c] * (emitf + em_su[c]) + ltp[c] * T[c] * Af
                   for c in range(3)]
        cot_lem = [g[c] * T[c] * alb_su[c] for c in range(3)]
        # the miss colour's derivative by the miss direction (on a lit row
        # the stashed direction is the miss direction)
        if use_sky:
            dl2 = torch.clamp_min(_dot3(din, din), 1e-20)
            dlm = torch.sqrt(dl2)
            w_sky = (g[0] * T[0] * (sky_s[0] - 1.0) + g[1] * T[1] * (sky_s[1] - 1.0)
                     + g[2] * T[2] * (sky_s[2] - 1.0))
            l_d_sky = [litf * w_sky * 0.5
                       * ((1.0 if c == 1 else 0.0) / dlm - din[1] * din[c] / (dl2 * dlm))
                       for c in range(3)]
        elif stream_miss:
            l_d_sky = [litf * lmd[c] for c in range(3)]
        else:
            l_d_sky = [zero, zero, zero]
        ltp = [ltp[c] * (Af * alb[c] + (1.0 - Af))
               + g[c] * (alb[c] * emitf + em_su[c] * alb[c] + FIREFLY * clampf[c])
               + litf * g[c] * miss_col[c] for c in range(3)]

        # ---- the hit point's and the normal's adjoints, back through the
        # hit distance
        lam_n = [l_n_s[c] + ln_nee[c] for c in range(3)]
        lam_p = [Af * lo_[c] + lp_nee[c] + dndp * lam_n[c] for c in range(3)]
        den = _dot3(nv, din)
        dsafe = torch.where(torch.abs(den) > 1e-20, den, 1.0)
        dlp = _dot3(din, lam_p)
        bb_c = [lam_p[c] - nv[c] * dlp / dsafe for c in range(3)]
        ld_t = [tk * bb_c[c] for c in range(3)]
        if tb.n_vol:
            volf = (mk & PW_VOLUME) > 0
            vidx = (mk >> PW_VOL_SHIFT) & 3
            o_rec = [pv[c] - tk * din[c] for c in range(3)]
            near_v, inv_v, act_v = zero, zero, zero
            ne_v = [zero, zero, zero]
            for vi in range(tb.n_vol):
                vm = volf & (vidx == vi)
                nr, ne_, inv_e, act_e = _volume_entry(tb, o_rec, din, vi)
                near_v = torch.where(vm, nr, near_v)
                ne_v = [torch.where(vm, ne_[c], ne_v[c]) for c in range(3)]
                inv_v = torch.where(vm, inv_e, inv_v)
                act_v = torch.where(vm, act_e, act_v)
            # origin inside the box: the entry clamps to the constant eps
            # and the slab term drops out
            ent = fl(near_v >= EPS_HIT)
            t0c_v = torch.clamp_min(near_v, EPS_HIT)
            dl2v = torch.clamp_min(_dot3(din, din), 1e-20)
            for c in range(3):
                bvol = lam_p[c] - ent * ne_v[c] * inv_v * dlp
                lvol = (tk * lam_p[c] - ent * act_v * near_v * ne_v[c] * inv_v * dlp
                        - (tk - t0c_v) * din[c] * dlp / dl2v)
                bb_c[c] = torch.where(volf, bvol, bb_c[c])
                ld_t[c] = torch.where(volf, lvol, ld_t[c])
        bb = [hitf * bb_c[c] for c in range(3)]
        lo_ = [(1.0 - Af) * lo_[c] + bb[c] for c in range(3)]
        ldv = [(1.0 - Af) * ldv[c] + l_din_s[c] + hitf * ld_t[c] + l_d_sky[c]
               for c in range(3)]

        # ---- sums per slot
        a_bin, l_bin = slot.long() * 3, lslot.long() * 3
        for c in range(3):
            acc.index_add_(0, torch.where(slot >= 0, a_bin + c, null),
                           cot_alb[c].double())
            acc.index_add_(0, torch.where(lslot >= 0, l_bin + c, null),
                           cot_lem[c].double())
        m_bin = torch.where(mslot >= 0, n_col + 2 * mslot.long(), null)
        acc.index_add_(0, m_bin, cot_fuzz.double())
        acc.index_add_(0, m_bin + 1, cot_ior.double())
    out = acc[:null].to(torch.float32)
    mats = out[n_col:].reshape(n_mat, 2)
    return (out[:n_col].reshape(n_tex, 3, 3), mats[:, 0].contiguous(),
            mats[:, 1].contiguous(), eout)


# -----------------------------------------------------------------------------