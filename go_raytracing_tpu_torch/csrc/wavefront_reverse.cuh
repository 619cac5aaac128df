// The pathwise reverse sweep of one ray, shared by the pathwise reverse
// kernel (wavefront_grad_pathwise.cu, B5b: the stash comes from device
// memory) and the fused gradient kernel (wavefront_grad_fused.cu, B4: the
// stash is the thread's own, in local memory, rows of entered bounces
// only).  See
// wavefront_grad_pathwise.cu for what it computes and how the sums are kept
// in a fixed order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_common.cuh"

namespace {

using namespace wf;

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// Adds v[0..N-1] of every lane with key >= 0 to acc[key + c].  Called by all
// 32 lanes of a warp together; acc is the warp's own row.
template <int N>
__device__ __forceinline__ void warp_add(float* acc, int key, const float* v,
                                         int lane) {
    unsigned todo = __ballot_sync(FULL_MASK, key >= 0);
    while (todo) {
        const int leader = __ffs(todo) - 1;
        const int s = __shfl_sync(FULL_MASK, key, leader);
        const bool mine = key == s;
#pragma unroll
        for (int c = 0; c < N; ++c) {
            float x = mine ? v[c] : 0.0f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                x += __shfl_xor_sync(FULL_MASK, x, off);
            // one lane owns the row: its adds are in program order
            if (lane == 0) acc[s + c] += x;
        }
        todo &= ~__ballot_sync(FULL_MASK, mine);
    }
}

// B5b's tiles, summing lane by lane: adds v[0..N-1] to acc[(key + c) *
// STRIDE] where key >= 0; acc is the lane's own column of the block's
// [n_acc, STRIDE] accumulators, so its adds are in the lane's program order.
template <int N, int STRIDE>
__device__ __forceinline__ void lane_add(float* acc, int key, const float* v) {
    if (key < 0) return;
#pragma unroll
    for (int c = 0; c < N; ++c) acc[(key + c) * STRIDE] += v[c];
}

// Entry slab of box volume vi for a ray (o, d): near = max_i min(ta, tb),
// the world-to-local row ne of the axis that gives it, inv_e = 1 / (ne.d)
// with the window's 1e-12 guard, act_e whether the guard was idle.
__device__ __forceinline__ void volume_entry(const float* __restrict__ vt, int vc,
                                             int vi, const float o[3],
                                             const float d[3], float& near,
                                             float ne[3], float& inv_e,
                                             float& act_e) {
    const float* V = vt + vi;
    float tmins[3], invs[3];
    bool acts[3];
    near = -BIG;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float m0 = V[(4 * i + 0) * vc], m1 = V[(4 * i + 1) * vc];
        const float m2 = V[(4 * i + 2) * vc], m3 = V[(4 * i + 3) * vc];
        const float ol = m0 * o[0] + m1 * o[1] + m2 * o[2] + m3;
        const float dl = m0 * d[0] + m1 * d[1] + m2 * d[2];
        acts[i] = fabsf(dl) >= 1e-12f;
        const float safe = acts[i] ? dl : ((dl < 0.0f) ? -1e-12f : 1e-12f);
        invs[i] = 1.0f / safe;
        const float ta = (V[(12 + i) * vc] - ol) * invs[i];
        const float tb = (V[(15 + i) * vc] - ol) * invs[i];
        tmins[i] = fminf(ta, tb);
        near = fmaxf(near, tmins[i]);
    }
    ne[0] = ne[1] = ne[2] = 0.0f;
    inv_e = 0.0f;
    act_e = 0.0f;
    bool chosen = false;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        if (!chosen && tmins[i] == near) {
#pragma unroll
            for (int c = 0; c < 3; ++c) ne[c] = V[(4 * i + c) * vc];
            inv_e = invs[i];
            act_e = acts[i] ? 1.0f : 0.0f;
            chosen = true;
        }
    }
}

// What the sweep reads besides a ray's stash.
struct RevScene {
    const float* lt;  // light table [17, lc]
    int n_lights, lc;
    const float* vt;  // volume table [25, vc]
    int n_vol, vc;
    int n_col, n_acc;  // 9 * textures colour sums, then 2 a material
    int miss_mode;     // 0 flat, 1 sky, 2 per-ray colour and direction cotangent
};

constexpr int REV_TILE = 128;   // threads (and rays) of a tile of B5b's

// The miss mode of a sweep whose miss colour came from an environment map:
// the colour (mc) and the cotangent of the miss direction (lmd) are rows.
constexpr int REV_MISS_SKY = 1;
constexpr int REV_MISS_STREAM = 2;

// One ray's reverse sweep, from the last bounce to the first; every lane of
// a warp calls it with the same depth (warp_add is collective).  F_ROWS is
// the stash's float rows a bounce: PW_F_ROWS, or PW_F_ROWS_MARBLE in a scene
// with marble, whose winners' dmarble/dp (textures.marble_grad, at the
// stashed point and scale) joins the hit point's adjoint: at the top of each
// bounce the warp takes its lanes' marble points in turns (marble_warp, the
// bits one lane alone computes), so a bounce costs one evaluation a marble
// lane shared by 28 lanes, not a whole evaluation wherever one lane of the
// warp met marble.  FUSED: the fused kernel's own stash, which holds the
// `len` bounces the ray entered and nothing after them (PW_F_ROWS, or
// PW_F_ROWS_FUSED_MARBLE with dmarble/dp as rows 19-21); the sweep starts at
// the deepest bounce a lane of the warp entered.  LANE_SUMS: the tiles of
// B5b without marble, whose rays stand in order of path length; each lane
// starts at its own ray's deepest bounce (`len`) and adds with lane_add into
// its own column of [n_acc, REV_TILE], not with the warp's warp_add.
//   f, q, zs: the ray's pathwise stash, float row r of bounce k at
//             f[(k * F_ROWS + r) * zs], int row r at q[(k * 3 + r) * zs];
//   g, mc:    the cotangent of the ray's radiance, its miss colour (0 if it
//             did not leave the scene);
//   lmd:      miss mode 2, the cotangent of its miss direction;
//   hd, hs:   the ray's HDRI rows (7 a bounce, stride hs) or null;
//   eout, es: with hd, the cotangent of each bounce's environment sample's
//             texel (3 a bounce, stride es), written for every bounce;
//   acc:      the warp's row of accumulators, or with LANE_SUMS the lane's
//             column;
//   len:      FUSED and LANE_SUMS: the bounces the ray entered.
template <int F_ROWS, bool FUSED = false, bool LANE_SUMS = false>
__device__ __forceinline__ void reverse_ray(
    const RevScene& R, bool valid, const float* f, const int* q, long long zs,
    int depth, const float g[3], const float mc[3], const float lmd[3],
    uint32_t sid, uint32_t seed, const float* hd, long long hs, float* eout,
    long long es, float* acc, int lane, int len = 0) {
    static_assert(!LANE_SUMS || (F_ROWS == PW_F_ROWS && !FUSED),
                  "the lane sums are B5b's without marble");
    const float nl = (float)R.n_lights;
    const float sky_s[3] = {0.5f, 0.7f, 1.0f};
    float lo[3] = {0.0f, 0.0f, 0.0f};
    float ldv[3] = {0.0f, 0.0f, 0.0f};
    float ltp[3] = {0.0f, 0.0f, 0.0f};

    int top = depth;
    if constexpr (LANE_SUMS) top = valid ? len : 0;
    if constexpr (FUSED) {
        // bounces no lane of the warp entered add nothing: their eout rows
        // are zeros
        top = __reduce_max_sync(FULL_MASK, valid ? len : 0);
        if (eout != nullptr && valid) {
            for (int k = top; k < depth; ++k) {
#pragma unroll
                for (int c = 0; c < 3; ++c) eout[((size_t)k * 3 + c) * es] = 0.0f;
            }
        }
    }
    for (int k = top - 1; k >= 0; --k) {
        int mk;
        if constexpr (FUSED) mk = valid && k < len ? q[((size_t)k * 3 + 2) * zs] : 0;
        else mk = valid ? q[((size_t)k * 3 + 2) * zs] : 0;
        // PW_F_ROWS_MARBLE: a marble winner's dmarble/dp, in the warp's
        // turns; all 32 lanes are here (mk is 0 on a lane without a ray)
        float dm[3] = {0.0f, 0.0f, 0.0f};
        if constexpr (F_ROWS == PW_F_ROWS_MARBLE) {
            const bool need = (mk & PW_MARBLE) != 0;
            float pm[3] = {0.0f, 0.0f, 0.0f}, sm = 0.0f;
            if (need) {
                const float* fk = f + (size_t)k * F_ROWS * zs;
#pragma unroll
                for (int c = 0; c < 3; ++c) pm[c] = fk[(6 + c) * zs];
                sm = fk[19 * zs];
            }
            marble_warp<true>(need, pm, sm, dm, lane);
        }
        float cot_alb[3] = {0.0f, 0.0f, 0.0f};
        float cot_lem[3] = {0.0f, 0.0f, 0.0f};
        float cot_mat[2] = {0.0f, 0.0f};  // fuzz, ior
        float cot_env[3] = {0.0f, 0.0f, 0.0f};
        int akey = -1, lkey = -1, mkey = -1;

        // mask 0: a bounce the ray never entered.  Such rows only trail, the
        // adjoints are 0 there and stay 0.
        if (mk != 0) {
            const float* fk = f + (size_t)k * F_ROWS * zs;
            float T[3], alb[3], pv[3], din[3], nv[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                T[c] = fk[(0 + c) * zs];
                alb[c] = fk[(3 + c) * zs];
                pv[c] = fk[(6 + c) * zs];
                din[c] = fk[(9 + c) * zs];
                nv[c] = fk[(12 + c) * zs];
            }
            const float io_ = fmaxf(fk[16 * zs], 1e-3f);
            const float dndp = fk[17 * zs];
            const float tk = fk[18 * zs];
            const int slot = q[((size_t)k * 3) * zs];
            const int mslot = q[((size_t)k * 3 + 1) * zs];
            const bool emit = mk & PW_EMIT;
            const bool alive_next = mk & PW_ALIVE_NEXT;
            const bool lit = mk & PW_LIT;
            const bool front = mk & PW_FRONT;
            const bool is_met = mk & PW_METAL;
            const bool is_die = mk & PW_DIELECTRIC;
            const bool hit = mk & PW_HIT;
            const float emitf = emit ? 1.0f : 0.0f;
            const float Af = alive_next ? 1.0f : 0.0f;
            const uint32_t bu = (uint32_t)k;

            // ---- NEE recompute and the partials of its scale --------------
            float em_su[3] = {0.0f, 0.0f, 0.0f};
            float alb_su[3] = {0.0f, 0.0f, 0.0f};
            float clampf[3] = {0.0f, 0.0f, 0.0f};
            float lp_nee[3] = {0.0f, 0.0f, 0.0f};
            float ln_nee[3] = {0.0f, 0.0f, 0.0f};
            if ((mk & PW_USE_MIS) && R.n_lights > 0) {
                const int lc = R.lc;
                const LightDir D = light_dir(R.lt, R.n_lights, lc, sid, seed, bu, pv, nv);
                const bool ok = D.cos_th > 0.0f && !(mk & PW_BLK_A) &&
                                !(D.cos_l < 1e-3f);
                if (ok) {
                    const float* L = D.L;
                    const NeeScale N = nee_scale(D, lc, R.n_lights);
                    float W = 0.0f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float em = L[(13 + c) * lc];
                        const float uf = (em * alb[c] * N.scale < FIREFLY) ? 1.0f : 0.0f;
                        em_su[c] = em * N.scale * uf;
                        alb_su[c] = alb[c] * N.scale * uf;
                        clampf[c] = 1.0f - uf;
                        W = W + g[c] * T[c] * em * alb[c] * uf;
                    }
                    const int ls = (int)(L[16 * lc] * 3.0f);
                    if (ls >= 0 && ls * 3 + 2 < R.n_col) lkey = ls * 3;
                    // scale = nL cos_th pdf_l / (q r)
                    const float area = L[12 * lc];
                    const float q_act = N.pdf_l > 1e-12f ? 1.0f : 0.0f;
                    const float r_act = N.pdf_l + N.pdf_b > 1e-20f ? 1.0f : 0.0f;
                    const float s2_act = N.s2v > 1e-20f ? 1.0f : 0.0f;
                    const float inv_qr = 1.0f / (N.qv * N.rv);
                    const float ds_dcos = nl * N.pdf_l * inv_qr;
                    const float ds_dpl =
                        nl * D.cos_th *
                        (inv_qr - N.pdf_l * (q_act * N.rv + N.qv * r_act) * inv_qr * inv_qr);
                    const float ds_dpb = -nl * D.cos_th * N.pdf_l * r_act * inv_qr / N.rv;
                    const float dpb_dcos = D.cos_th > 0.0f ? INV_PI : 0.0f;
                    const float c_cos = W * (ds_dcos + ds_dpb * dpb_dcos);
                    const float c_pl = W * ds_dpl;
                    const float c_dist = c_pl * (2.0f * D.dist / N.s2);
                    const float c_cosl =
                        c_pl * (-(D.dist * D.dist) * area * s2_act / (N.s2 * N.s2));
                    const float sgn_z = D.zlc >= 0.0f ? 1.0f : -1.0f;
                    float lam_ld[3];
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        lam_ld[c] = c_cos * nv[c] - c_cosl * sgn_z * L[(9 + c) * lc];
                        ln_nee[c] = c_cos * D.ld[c];
                    }
                    const float ldd = dot3(D.ld, lam_ld);
                    const float dist_act = D.tl2 > 1e-20f ? 1.0f : 0.0f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float lam_tl =
                            (lam_ld[c] - dist_act * D.ld[c] * ldd) / D.dist +
                            c_dist * dist_act * D.ld[c];
                        lp_nee[c] = -lam_tl;
                    }
                }
            }

            // ---- HDRI NEE: the sample is an input and the shadow outcome a
            // stash bit; no dependence on the hit point (a solid-angle pdf),
            // only on the normal, and the cotangent of the sample's texel.
            // Its albedo and clamp terms fold into em_su and clampf, which
            // treat both NEE terms alike.
            if (hd != nullptr && (mk & PW_USE_MIS)) {
                const float* hk = hd + (size_t)k * 7 * hs;
                const float hdv[3] = {hk[0], hk[hs], hk[2 * hs]};
                const float cos_h = dot3(nv, hdv);
                if (cos_h > 0.0f && !(mk & PW_BLK_H)) {
                    const float pdf_h = hk[6 * hs];
                    const float pdf_bh = fmaxf(cos_h, 0.0f) * INV_PI;
                    const float qh = fmaxf(pdf_h, 1e-12f);
                    const float rh = fmaxf(pdf_h + pdf_bh, 1e-20f);
                    const float wgt_h = pdf_h / rh;
                    const float scale_h = cos_h / qh * wgt_h;
                    float W_h = 0.0f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float hem = hk[(3 + c) * hs];
                        const float uf_h = (hem * alb[c] * scale_h < FIREFLY) ? 1.0f : 0.0f;
                        em_su[c] = em_su[c] + hem * scale_h * uf_h;
                        clampf[c] = clampf[c] + (1.0f - uf_h);
                        cot_env[c] = g[c] * T[c] * alb[c] * scale_h * uf_h;
                        W_h = W_h + g[c] * T[c] * hem * alb[c] * uf_h;
                    }
                    // scale_h = cos_h pdf_h / (q r)
                    const float r_act_h = pdf_h + pdf_bh > 1e-20f ? 1.0f : 0.0f;
                    const float inv_qr_h = 1.0f / (qh * rh);
                    const float ds_dcos_h = pdf_h * inv_qr_h;
                    const float ds_dpbh = -cos_h * pdf_h * r_act_h * inv_qr_h / rh;
                    const float dpbh_dcos = cos_h > 0.0f ? INV_PI : 0.0f;
                    const float c_cos_h = W_h * (ds_dcos_h + ds_dpbh * dpbh_dcos);
#pragma unroll
                    for (int c = 0; c < 3; ++c) ln_nee[c] = ln_nee[c] + c_cos_h * hdv[c];
                }
            }

            // ---- scatter Jacobians, reversed (u = adjoint of the next
            // direction); a ray that did not scatter on passes nothing
            float l_n_s[3] = {0.0f, 0.0f, 0.0f};
            float l_din_s[3] = {0.0f, 0.0f, 0.0f};
            if (alive_next) {
                const float* u = ldv;
                if (is_met) {
                    // new_d = rfl / |rfl| + fuzz * ru
                    float ru[3];
                    unit_sphere_draw(sid, seed, bu, ru);
                    cot_mat[0] = dot3(ru, u);
                    const float ddn_f = dot3(din, nv);
                    float rfl[3], rhat[3], vv[3];
#pragma unroll
                    for (int c = 0; c < 3; ++c) rfl[c] = din[c] - nv[c] * (2.0f * ddn_f);
                    const float rlen = sqrtf(fmaxf(dot3(rfl, rfl), 1e-20f));
#pragma unroll
                    for (int c = 0; c < 3; ++c) rhat[c] = rfl[c] / rlen;
                    const float rhu = dot3(rhat, u);
#pragma unroll
                    for (int c = 0; c < 3; ++c) vv[c] = (u[c] - rhat[c] * rhu) / rlen;
                    const float nvv = dot3(nv, vv);
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        l_din_s[c] = vv[c] - 2.0f * nv[c] * nvv;
                        l_n_s[c] = -2.0f * din[c] * nvv - 2.0f * ddn_f * vv[c];
                    }
                } else if (is_die) {
                    const float ufr = uniform3(sid, seed, bu, FRESNEL).x;
                    const Fresnel F = fresnel(din, nv, io_, front, ufr);
                    const float nu = dot3(nv, u);
                    float l_ud[3];
                    if (F.do_refl) {
#pragma unroll
                        for (int c = 0; c < 3; ++c) {
                            l_ud[c] = u[c] - 2.0f * nv[c] * nu;
                            l_n_s[c] = -2.0f * F.ud[c] * nu - 2.0f * F.udn * u[c];
                        }
                    } else {
                        float perp[3], xv, l_perp[3];
                        const float parl = refract_parts(F, nv, perp, xv);
                        const float ct_act = -F.udn < 1.0f ? 1.0f : 0.0f;
                        const float sx_act = (xv >= 0.0f ? 1.0f : -1.0f) *
                                             (fabsf(xv) > 1e-20f ? 1.0f : 0.0f);
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                            l_perp[c] = u[c] - sx_act * (nu / parl) * perp[c];
                        const float npp = dot3(nv, l_perp);
#pragma unroll
                        for (int c = 0; c < 3; ++c) {
                            l_ud[c] = F.ri * (l_perp[c] - ct_act * nv[c] * npp);
                            l_n_s[c] = F.ri * (F.cos_t * l_perp[c] - ct_act * F.ud[c] * npp) +
                                       parl * u[c];
                        }
                        const float cot_ri = (F.ud[0] + nv[0] * F.cos_t) * l_perp[0] +
                                             (F.ud[1] + nv[1] * F.cos_t) * l_perp[1] +
                                             (F.ud[2] + nv[2] * F.cos_t) * l_perp[2];
                        const float dri = front ? -1.0f / (io_ * io_) : 1.0f;
                        cot_mat[1] = cot_ri * dri;
                    }
                    const float udu = dot3(F.ud, l_ud);
#pragma unroll
                    for (int c = 0; c < 3; ++c) l_din_s[c] = (l_ud[c] - F.ud[c] * udu) / F.dlen;
                } else {
                    // lambertian: new_d = n + ru
#pragma unroll
                    for (int c = 0; c < 3; ++c) l_n_s[c] = u[c];
                }
                if ((is_met || is_die) && mslot >= 0 && R.n_col + 2 * mslot + 1 < R.n_acc)
                    mkey = R.n_col + 2 * mslot;
            }

            // ---- cotangents of the colours; the throughput adjoint --------
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                cot_alb[c] = g[c] * T[c] * (emitf + em_su[c]) + ltp[c] * T[c] * Af;
                cot_lem[c] = g[c] * T[c] * alb_su[c];
            }
            // a slot outside the accumulator would corrupt shared memory
            if (slot >= 0 && slot * 3 + 2 < R.n_col) akey = slot * 3;

            // the miss colour's derivative by the miss direction (on a lit
            // row the stashed direction is the miss direction): the sky's,
            // or the environment's, which comes in as a row
            float l_d_sky[3] = {0.0f, 0.0f, 0.0f};
            if (lit && R.miss_mode == REV_MISS_SKY) {
                const float dl2 = fmaxf(dot3(din, din), 1e-20f);
                const float dlm = sqrtf(dl2);
                const float w_sky = g[0] * T[0] * (sky_s[0] - 1.0f) +
                                    g[1] * T[1] * (sky_s[1] - 1.0f) +
                                    g[2] * T[2] * (sky_s[2] - 1.0f);
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    l_d_sky[c] = w_sky * 0.5f *
                                 ((c == 1 ? 1.0f : 0.0f) / dlm - din[1] * din[c] / (dl2 * dlm));
            } else if (lit && R.miss_mode == REV_MISS_STREAM) {
#pragma unroll
                for (int c = 0; c < 3; ++c) l_d_sky[c] = lmd[c];
            }
#pragma unroll
            for (int c = 0; c < 3; ++c)
                ltp[c] = ltp[c] * (alive_next ? alb[c] : 1.0f) +
                         g[c] * (alb[c] * emitf + em_su[c] * alb[c] + FIREFLY * clampf[c]) +
                         (lit ? g[c] * mc[c] : 0.0f);

            // ---- the hit point's adjoint, back through the hit distance ---
            float lam_p[3], bb[3], ld_t[3];
#pragma unroll
            for (int c = 0; c < 3; ++c)
                lam_p[c] = Af * lo[c] + lp_nee[c] + dndp * (l_n_s[c] + ln_nee[c]);
            if constexpr (F_ROWS == PW_F_ROWS_MARBLE ||
                          F_ROWS == PW_F_ROWS_FUSED_MARBLE) {
                if (mk & PW_MARBLE) {
                    // a marble winner: the marble is grayscale, so its
                    // value's cotangent is the sum of the albedo's three, and
                    // it moves with the hit point (dmarble/dp: from the
                    // warp's turns above, or the fused kernel's stash)
                    if constexpr (F_ROWS == PW_F_ROWS_FUSED_MARBLE) {
#pragma unroll
                        for (int c = 0; c < 3; ++c) dm[c] = fk[(19 + c) * zs];
                    }
                    const float cotm = cot_alb[0] + cot_alb[1] + cot_alb[2];
#pragma unroll
                    for (int c = 0; c < 3; ++c) lam_p[c] = lam_p[c] + cotm * dm[c];
                }
            }
            const float dlp = dot3(din, lam_p);
            if (mk & PW_VOLUME) {
                // t = max(near, eps) + K / |d|, K from the draw alone: the
                // entry slab's plane stands in for the surface
                const int vi = (mk >> PW_VOL_SHIFT) & 3;
                float o_rec[3], ne[3], near, inv_e, act_e;
#pragma unroll
                for (int c = 0; c < 3; ++c) o_rec[c] = pv[c] - tk * din[c];
                volume_entry(R.vt, R.vc, vi < R.n_vol ? vi : 0, o_rec, din, near, ne,
                             inv_e, act_e);
                // origin inside the box: the entry is the constant eps
                const float ent = near >= EPS_HIT ? 1.0f : 0.0f;
                const float t0c = fmaxf(near, EPS_HIT);
                const float dl2v = fmaxf(dot3(din, din), 1e-20f);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    bb[c] = lam_p[c] - ent * ne[c] * inv_e * dlp;
                    ld_t[c] = tk * lam_p[c] - ent * act_e * near * ne[c] * inv_e * dlp -
                              (tk - t0c) * din[c] * dlp / dl2v;
                }
            } else {
                const float den = dot3(nv, din);
                const float dsafe = fabsf(den) > 1e-20f ? den : 1.0f;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    bb[c] = lam_p[c] - nv[c] * dlp / dsafe;
                    ld_t[c] = tk * bb[c];
                }
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                lo[c] = (1.0f - Af) * lo[c] + (hit ? bb[c] : 0.0f);
                ldv[c] = (1.0f - Af) * ldv[c] + l_din_s[c] + (hit ? ld_t[c] : 0.0f) +
                         l_d_sky[c];
            }
        }

        if (eout != nullptr && valid) {
#pragma unroll
            for (int c = 0; c < 3; ++c) eout[((size_t)k * 3 + c) * es] = cot_env[c];
        }
        if constexpr (LANE_SUMS) {
            lane_add<3, REV_TILE>(acc, akey, cot_alb);
            lane_add<3, REV_TILE>(acc, lkey, cot_lem);
            lane_add<2, REV_TILE>(acc, mkey, cot_mat);
        } else {
            warp_add<3>(acc, akey, cot_alb, lane);
            warp_add<3>(acc, lkey, cot_lem, lane);
            warp_add<2>(acc, mkey, cot_mat, lane);
        }
    }
}

}  // namespace
