// The bounce loop of the wavefront megakernel, shared by the tracing kernels
// of wavefront.cu (forward, product and pathwise gradient forwards, record,
// and the resumable kernel, which runs a range of bounces from a carried
// path state) and by the fused gradient kernel of wavefront_grad_fused.cu,
// which runs the pathwise gradient forward into a stash in the thread's
// local memory.  See
// wavefront.cu for what it computes and why it is laid out so.
//
// Table layouts (row-major [rows, columns], one column per primitive) are
// those of ops/cuda_wavefront.build_tables.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_common.cuh"

namespace {

using namespace wf;

constexpr float EPS_PARALLEL = 1e-8f;

constexpr int PT_ROWS = 31;
constexpr int ST_ROWS = 23;
constexpr int VT_ROWS = 25;
constexpr int LT_ROWS = 17;
constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 16;
constexpr size_t SMEM_TABLE_LIMIT = 48 * 1024;

// RNG purposes of the volumes (core/rng.py)
constexpr uint32_t VOL_FLIGHT = 64;        // + 32 * volume index
constexpr uint32_t VOL_SHADOW = 65;        // area-light shadow ray, + 32 * index
constexpr uint32_t VOL_SHADOW_HDRI = 66;   // environment shadow ray, + 32 * index

// What a launch writes besides the forward's outputs.
constexpr int FWD = 0;        // nothing
constexpr int PRODUCT = 1;    // the product-chain stash and the miss colour
constexpr int PATHWISE = 2;   // the pathwise stash and the miss colour
constexpr int RECORD = 3;     // each bounce's outcome
constexpr int PATHWISE_MARBLE = 4;  // PATHWISE, and the marble's scale (row 19)

struct Tables {
    const float* pt;
    const float* st;
    const float* vt;
    const float* lt;
    int n_planar, n_sphere, n_vol, n_lights;
    int pc, sc, vc, lc;  // column counts (row strides), at least 1
};

// Outputs of the gradient forwards only.
struct Stash {
    float* f;        // product:  [depth, 12, n] T(3) alb(3) em_su(3) alb_su(3)
                     // pathwise: [depth, 19, n] T(3) alb(3) p(3) d(3) n(3)
                     //           fuzz ior dndp t; PATHWISE_MARBLE: [depth,
                     //           20, n], and the winner's marble scale
    int* i;          // [depth, 3, n]  slot, lslot or material id, mask
    long long n;     // rays (row stride)
};

// Output of the record only: [depth, n] each (ops/cuda_wavefront.py: DEC_*).
struct Record {
    unsigned char* code;  // winner kind | blocked area-light shadow ray << 2
                          // | blocked environment shadow ray << 3
    int* idx;             // winner's primitive or volume index
    long long n;          // rays (row stride)
};
constexpr int DEC_BLK_A = 4;
constexpr int DEC_BLK_H = 8;

// Input of HDRI next-event estimation (scenes with quad lights and an
// importance-sampled environment): per bounce 7 rows (direction 3, emission
// 3, solid-angle pdf) of the ray's environment sample, which depends on the
// ray's counter alone and is drawn in torch (lights/hdri.py, alias table).
// `rows` points at the ray's column of the [depth * 7, n] rows; nullptr
// when the scene has none.
struct Hdri {
    const float* rows;
    long long n;  // row stride
};

// Mask bits of stash row 2 (ops/cuda_wavefront.py: MK_*)
constexpr int MK_EMIT = 1;
constexpr int MK_ALIVE_NEXT = 2;
constexpr int MK_LIT = 4;
constexpr int MK_CLAMPED = 8;  // << channel
constexpr int LSLOT_NONE = -9;

__device__ __forceinline__ void stash_row(const Stash& Z, long long ray, int k,
                                          const float T[3], const float alb[3],
                                          const float em_su[3],
                                          const float alb_su[3], int slot,
                                          int lslot, int mk) {
    float* f = Z.f + (size_t)k * 12 * Z.n + ray;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        f[(0 + c) * Z.n] = T[c];
        f[(3 + c) * Z.n] = alb[c];
        f[(6 + c) * Z.n] = em_su[c];
        f[(9 + c) * Z.n] = alb_su[c];
    }
    int* q = Z.i + (size_t)k * 3 * Z.n + ray;
    q[0] = slot;
    q[Z.n] = lslot;
    q[2 * Z.n] = mk;
}

// One row of the pathwise stash (F_ROWS float rows a bounce); row 19, the
// marble scale, only in a stash of a scene with marble.
template <int F_ROWS>
__device__ __forceinline__ void stash_row_pathwise(
    const Stash& Z, long long ray, int k, const float T[3], const float alb[3],
    const float p[3], const float d[3], const float nrm[3], float fuzz,
    float ior, float dndp, float t, float mscale, int slot, int mslot, int mk) {
    float* f = Z.f + (size_t)k * F_ROWS * Z.n + ray;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        f[(0 + c) * Z.n] = T[c];
        f[(3 + c) * Z.n] = alb[c];
        f[(6 + c) * Z.n] = p[c];
        f[(9 + c) * Z.n] = d[c];
        f[(12 + c) * Z.n] = nrm[c];
    }
    f[15 * Z.n] = fuzz;
    f[16 * Z.n] = ior;
    f[17 * Z.n] = dndp;
    f[18 * Z.n] = t;
    if constexpr (F_ROWS == PW_F_ROWS_MARBLE) f[19 * Z.n] = mscale;
    int* q = Z.i + (size_t)k * 3 * Z.n + ray;
    q[0] = slot;
    q[Z.n] = mslot;
    q[2 * Z.n] = mk;
}

// Planar sweep in table order.  Plane kind: strict t > eps, t < best; the
// other kinds take >= and <=, so on an exact tie the later primitive wins.
// ANY: return at the first hit (shadow rays).  Returns whether t_best moved.
template <bool ANY>
__device__ __forceinline__ bool planar_sweep(const Tables& S, const float o[3],
                                             const float d[3], float& t_best,
                                             int& hidx) {
    bool found = false;
    const int pc = S.pc;
    for (int j = 0; j < S.n_planar; ++j) {
        const float* P = S.pt + j;
        const float nx = P[0], ny = P[pc], nz = P[2 * pc];
        const float denom = d[0] * nx + d[1] * ny + d[2] * nz;
        const bool not_par = fabsf(denom) >= EPS_PARALLEL;
        const float t = (P[3 * pc] - (o[0] * nx + o[1] * ny + o[2] * nz)) /
                        (not_par ? denom : 1.0f);
        const float kind = P[14 * pc];
        const bool t_ok = (kind == 3.0f) ? (t > EPS_HIT && t < t_best)
                                         : (t >= EPS_HIT && t <= t_best);
        if (!(not_par && t_ok)) continue;
        const float rx = o[0] + t * d[0] - P[4 * pc];
        const float ry = o[1] + t * d[1] - P[5 * pc];
        const float rz = o[2] + t * d[2] - P[6 * pc];
        const float alpha = rx * P[7 * pc] + ry * P[8 * pc] + rz * P[9 * pc];
        const float beta = rx * P[10 * pc] + ry * P[11 * pc] + rz * P[12 * pc];
        bool interior;
        if (kind == 0.0f) {
            interior = alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
        } else if (kind == 1.0f) {
            interior = alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f &&
                       alpha + beta <= 1.0f;
        } else if (kind == 2.0f) {
            interior = (rx * rx + ry * ry + rz * rz) <= P[13 * pc];
        } else {
            interior = true;
        }
        if (!interior) continue;
        t_best = t;
        hidx = j;
        found = true;
        if (ANY) return true;
    }
    return found;
}

// Serial strict-< sphere sweep in table order, spheres taken at time tmv.
template <bool ANY>
__device__ __forceinline__ bool sphere_sweep(const Tables& S, const float o[3],
                                             const float d[3], float tmv,
                                             float& t_best, int& hidx) {
    if (S.n_sphere == 0) return false;
    bool found = false;
    const int sc = S.sc;
    const float a_coef = dot3(d, d);
    const float inv_a = 1.0f / a_coef;
    for (int j = 0; j < S.n_sphere; ++j) {
        const float* Q = S.st + j;
        const float ocx = (Q[0] + tmv * Q[3 * sc]) - o[0];
        const float ocy = (Q[sc] + tmv * Q[4 * sc]) - o[1];
        const float ocz = (Q[2 * sc] + tmv * Q[5 * sc]) - o[2];
        const float h = d[0] * ocx + d[1] * ocy + d[2] * ocz;
        const float c = ocx * ocx + ocy * ocy + ocz * ocz - Q[6 * sc];
        const float disc = h * h - a_coef * c;
        if (!(disc >= 0.0f)) continue;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float r0 = (h - sq) * inv_a;
        const float r1 = (h + sq) * inv_a;
        const bool ok0 = r0 > EPS_HIT && r0 < t_best;
        const bool ok1 = r1 > EPS_HIT && r1 < t_best;
        if (!(ok0 || ok1)) continue;
        t_best = ok0 ? r0 : r1;
        hidx = j;
        found = true;
        if (ANY) return true;
    }
    return found;
}

// Free-flight sample inside box volume vi, limited to t_cap.
__device__ __forceinline__ bool volume_scatter(const Tables& S, const float o[3],
                                               const float d[3], float t_cap,
                                               int vi, float u, float& t_out) {
    const float* V = S.vt + vi;
    const int vc = S.vc;
    float near = -BIG, far = BIG;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float m0 = V[(4 * i + 0) * vc], m1 = V[(4 * i + 1) * vc];
        const float m2 = V[(4 * i + 2) * vc], m3 = V[(4 * i + 3) * vc];
        const float ol = m0 * o[0] + m1 * o[1] + m2 * o[2] + m3;
        const float dl = m0 * d[0] + m1 * d[1] + m2 * d[2];
        const float safe =
            (fabsf(dl) < 1e-12f) ? ((dl < 0.0f) ? -1e-12f : 1e-12f) : dl;
        const float inv = 1.0f / safe;
        const float ta = (V[(12 + i) * vc] - ol) * inv;
        const float tb = (V[(15 + i) * vc] - ol) * inv;
        near = fmaxf(near, fminf(ta, tb));
        far = fminf(far, fmaxf(ta, tb));
    }
    const bool crosses = far > near;
    const float t0c = fmaxf(near, EPS_HIT);
    const float t1c = fminf(far, t_cap);
    const bool inside = crosses && (t0c < t1c);
    const float ray_len = sqrtf(fmaxf(dot3(d, d), 1e-20f));
    const float dist_inside = (t1c - t0c) * ray_len;
    // 1e-38f is a denormal: the floor keeps log finite at u == 0
    const float hit_dist = V[18 * vc] * logf(fmaxf(u, 1e-38f));
    t_out = t0c + hit_dist / ray_len;
    return inside && (hit_dist <= dist_inside);
}

// Shadow ray: any surface within t_cap (spheres at time 0), or a volume
// scatter event on the way (its draw keyed on `purpose` + 32 * volume).
__device__ __forceinline__ bool occluded(const Tables& S, const float o[3],
                                         const float d[3], float t_cap,
                                         uint32_t sid, uint32_t seed,
                                         uint32_t bounce, uint32_t purpose) {
    float t_best = t_cap;
    int dummy = 0;
    if (planar_sweep<true>(S, o, d, t_best, dummy)) return true;
    if (sphere_sweep<true>(S, o, d, 0.0f, t_best, dummy)) return true;
    for (int vi = 0; vi < S.n_vol; ++vi) {
        const float u = uniform3(sid, seed, bounce, purpose + 32u * vi).x;
        float t_v;
        if (volume_scatter(S, o, d, fminf(t_best, t_cap), vi, u, t_v)) return true;
    }
    return false;
}

// Flag word of a path state (ops/cuda_wavefront.py: FLAG_*).
constexpr int FLAG_MISSED = 1;
constexpr int FLAG_PRIMARY = 2;
constexpr int FLAG_ALIVE = 4;
constexpr int FLAG_ALLOW = 8;

// Bounces [b_start, b_end) of one ray from the path state in o, d, tp, rad,
// m_dir, m_tp and flags (FLAG_*), which it leaves updated.  A camera ray
// starts at bounce 0 with tp 1, rad, m_dir, m_tp 0 and flags alive | allow;
// the resumable kernel hands in the state a launch over [0, b_start) left.
// Every random draw is keyed on the absolute bounce, so the result does not
// depend on where the loop was cut.  The stash and the record (b_start 0
// only) are [b_end, ...]; the HDRI rows [(b_end - b_start) * 7, ...].
template <int MODE>
__device__ __forceinline__ void trace_ray(const Tables& S, float o[3], float d[3],
                                          float tp[3], float tmv, uint32_t sid,
                                          uint32_t seed, int b_start, int b_end,
                                          float rad[3], float m_dir[3],
                                          float m_tp[3], int& flags,
                                          const Stash& Z, const Record& D,
                                          long long ray, const Hdri& H) {
    bool alive = flags & FLAG_ALIVE, allow = flags & FLAG_ALLOW;
    bool missed = flags & FLAG_MISSED, m_prim = flags & FLAG_PRIMARY;
    const bool use_nee = S.n_lights > 0;
    constexpr bool STASH = MODE == PRODUCT;
    constexpr bool PW = MODE == PATHWISE || MODE == PATHWISE_MARBLE;
    constexpr int F_ROWS = MODE == PATHWISE_MARBLE ? PW_F_ROWS_MARBLE : PW_F_ROWS;
    constexpr bool GRAD = MODE == PRODUCT || PW;
    const float zero3[3] = {0.0f, 0.0f, 0.0f};
    int stashed = b_start;  // stash rows (or record rows) written so far

    int b = b_start;
    for (; b < b_end && alive; ++b) {
        const uint32_t bu = (uint32_t)b;

        // ---- closest hit -------------------------------------------------
        float t = BIG;
        int hitk = 0, hidx = 0;
        if (planar_sweep<false>(S, o, d, t, hidx)) hitk = 2;
        if (sphere_sweep<false>(S, o, d, tmv, t, hidx)) hitk = 1;
        bool hit = hitk > 0;

        bool is_vol = false;
        for (int vi = 0; vi < S.n_vol; ++vi) {
            const float u = uniform3(sid, seed, bu, VOL_FLIGHT + 32u * vi).x;
            const float t_limit = hit ? t : BIG;
            float t_v;
            const bool acc = volume_scatter(S, o, d, t_limit, vi, u, t_v);
            if (acc && (!hit || t_v < t)) {
                t = t_v;
                hit = true;
                is_vol = true;
                hidx = vi;
                hitk = 3;
            }
        }

        // ---- miss: record for the deferred miss shader and stop ----------
        if (!hit) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                m_dir[c] = d[c];
                m_tp[c] = tp[c];
            }
            m_prim = m_prim || (b == 0);
            missed = true;
            alive = false;
            allow = true;
            if constexpr (STASH) {
                // the reverse sweep adds the miss colour at this bounce
                stash_row(Z, ray, b, tp, zero3, zero3, zero3, SLOT_NONE,
                          LSLOT_NONE, MK_LIT);
                stashed = b + 1;
            }
            if constexpr (PW) {
                // the rows a masked loop would leave on a lane without a
                // hit: the reverse sweep reads T and d (the miss direction)
                const float pm[3] = {o[0] + 1.0f * d[0], o[1] + 1.0f * d[1],
                                     o[2] + 1.0f * d[2]};
                stash_row_pathwise<F_ROWS>(Z, ray, b, tp, zero3, pm, d, zero3,
                                           0.0f, 1e-3f, 0.0f, 1.0f, 0.0f, SLOT_NONE,
                                           MSLOT_NONE, PW_LIT);
                stashed = b + 1;
            }
            // RECORD: the miss reads as no hit, like the bounces after it
            break;
        }

        float p[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) p[c] = o[c] + t * d[c];

        // ---- winner constants -------------------------------------------
        float outn[3], col[3], even[3], odd[3];
        float matkind, texkind, fuzz, ior, inv_scale;
        float tex_id = 0.0f;  // read by the gradient forwards only
        float mat_id = (float)MSLOT_NONE, dndp = 0.0f;  // pathwise only
        if (hitk == 2) {
            const float* P = S.pt + hidx;
            const int pc = S.pc;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                outn[c] = P[c * pc];
                col[c] = P[(19 + c) * pc];
                even[c] = P[(22 + c) * pc];
                odd[c] = P[(25 + c) * pc];
            }
            matkind = P[15 * pc];
            texkind = P[16 * pc];
            fuzz = P[17 * pc];
            ior = P[18 * pc];
            inv_scale = P[28 * pc];
            if constexpr (GRAD) tex_id = P[29 * pc];
            if constexpr (PW) mat_id = P[30 * pc];
        } else if (hitk == 1) {
            const float* Q = S.st + hidx;
            const int sc = S.sc;
            const float inv_rad = 1.0f / sqrtf(fmaxf(Q[6 * sc], 1e-20f));
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float center = Q[c * sc] + tmv * Q[(3 + c) * sc];
                outn[c] = (p[c] - center) * inv_rad;
                col[c] = Q[(11 + c) * sc];
                even[c] = Q[(14 + c) * sc];
                odd[c] = Q[(17 + c) * sc];
            }
            matkind = Q[7 * sc];
            texkind = Q[8 * sc];
            fuzz = Q[9 * sc];
            ior = Q[10 * sc];
            inv_scale = Q[20 * sc];
            if constexpr (GRAD) tex_id = Q[21 * sc];
            if constexpr (PW) {
                mat_id = Q[22 * sc];
                dndp = inv_rad;  // times flip, below
            }
        } else {
            const float* V = S.vt + hidx;
            const int vc = S.vc;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                outn[c] = 0.0f;
                col[c] = V[(21 + c) * vc];
                even[c] = 0.0f;
                odd[c] = 0.0f;
            }
            matkind = V[19 * vc];
            texkind = V[20 * vc];
            fuzz = 0.0f;
            ior = 1.0f;
            inv_scale = 0.0f;
            if constexpr (GRAD) tex_id = V[24 * vc];
        }
        ior = fmaxf(ior, 1e-3f);

        const float ddn = dot3(d, outn);
        const bool front = (ddn < 0.0f) || is_vol;
        const float flip = front ? 1.0f : -1.0f;
        float nrm[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) nrm[c] = outn[c] * flip;
        if (is_vol) {
            nrm[0] = 1.0f;
            nrm[1] = 0.0f;
            nrm[2] = 0.0f;
        }

        // ---- texture ----------------------------------------------------
        float albedo[3] = {col[0], col[1], col[2]};
        float variant = 0.0f;  // 0 solid, 1 checker even, 2 checker odd
        if (texkind == 1.0f) {
            const float lat = floorf(inv_scale * p[0] + 1e-4f) +
                              floorf(inv_scale * p[1] + 1e-4f) +
                              floorf(inv_scale * p[2] + 1e-4f);
            const bool is_even = (lat - 2.0f * floorf(lat * 0.5f)) == 0.0f;
#pragma unroll
            for (int c = 0; c < 3; ++c) albedo[c] = is_even ? even[c] : odd[c];
            variant = is_even ? 1.0f : 2.0f;
        } else if (texkind == 2.0f) {
            // marble: its scale sits in the checker's scale row
            const float m = marble(p, inv_scale);
#pragma unroll
            for (int c = 0; c < 3; ++c) albedo[c] = m;
        }

        // ---- scatter ----------------------------------------------------
        float ru[3];
        unit_sphere_draw(sid, seed, bu, ru);

        const bool is_lam = matkind == 0.0f;
        const bool is_met = matkind == 1.0f;
        const bool is_die = matkind == 2.0f;
        const bool is_light = matkind == 3.0f;

        float new_d[3];
        bool scattered = !is_light;
        if (is_lam) {
            float lam[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) lam[c] = nrm[c] + ru[c];
            const bool near0 = fabsf(lam[0]) < 1e-8f && fabsf(lam[1]) < 1e-8f &&
                               fabsf(lam[2]) < 1e-8f;
#pragma unroll
            for (int c = 0; c < 3; ++c) new_d[c] = near0 ? nrm[c] : lam[c];
        } else if (is_met) {
            const float ddn_f = dot3(d, nrm);
            float rfl[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) rfl[c] = d[c] - nrm[c] * (2.0f * ddn_f);
            const float rlen = sqrtf(fmaxf(dot3(rfl, rfl), 1e-20f));
#pragma unroll
            for (int c = 0; c < 3; ++c) new_d[c] = rfl[c] / rlen + ru[c] * fuzz;
            scattered = dot3(new_d, nrm) > 0.0f;
        } else if (is_die) {
            const float ufr = uniform3(sid, seed, bu, FRESNEL).x;
            const Fresnel F = fresnel(d, nrm, ior, front, ufr);
            if (F.do_refl) {
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    new_d[c] = F.ud[c] - nrm[c] * (2.0f * F.udn);
            } else {
                float perp[3], xv;
                const float parl = refract_parts(F, nrm, perp, xv);
#pragma unroll
                for (int c = 0; c < 3; ++c) new_d[c] = perp[c] + nrm[c] * parl;
            }
        } else {
            // light (never scatters) and isotropic: uniform direction
#pragma unroll
            for (int c = 0; c < 3; ++c) new_d[c] = ru[c];
        }
        float atten[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) atten[c] = is_die ? 1.0f : albedo[c];

        // ---- emission (the light's albedo is its emission) ----------------
        const bool emits = allow && is_light;
        if (emits) {
#pragma unroll
            for (int c = 0; c < 3; ++c) rad[c] = rad[c] + tp[c] * albedo[c];
        }

        // ---- next-event estimation toward one quad light ------------------
        // The clamp floors (1e-20, 1e-12, cos_l < 1e-3) are the JAX
        // kernel's: the gradient kernels differentiate against them.
        const bool use_mis = use_nee && is_lam;
        // gradient forward: d(contribution)/d(albedo), d(contribution)/
        // d(emission) where the sample counts and the clamp does not bite
        float em_su[3] = {0.0f, 0.0f, 0.0f};
        float alb_su[3] = {0.0f, 0.0f, 0.0f};
        int lslot = LSLOT_NONE, mk = 0;
        if (use_mis) {
            const int lc = S.lc;
            const LightDir light = light_dir(S.lt, S.n_lights, lc, sid, seed, bu, p, nrm);
            const float* L = light.L;
            if constexpr (STASH) lslot = (int)(L[16 * lc] * 3.0f);
            if (light.cos_th > 0.0f) {
                bool dark = light.cos_l < 1e-3f;  // grazing the light's plane
                if constexpr (PW || MODE == RECORD) {
                    // the shadow ray's outcome is kept whatever the angle
                    if (occluded(S, p, light.ld, light.dist - EPS_HIT, sid, seed, bu,
                                 VOL_SHADOW)) {
                        mk |= PW ? PW_BLK_A : DEC_BLK_A;
                        dark = true;
                    }
                } else {
                    dark = dark || occluded(S, p, light.ld, light.dist - EPS_HIT,
                                            sid, seed, bu, VOL_SHADOW);
                }
                if (!dark) {
                    const float scale = nee_scale(light, lc, S.n_lights).scale;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float raw = L[(13 + c) * lc] * atten[c] * scale;
                        const float contrib = fminf(raw, FIREFLY);
                        rad[c] = rad[c] + tp[c] * contrib;
                        if constexpr (STASH) {
                            if (raw < FIREFLY) {
                                em_su[c] = L[(13 + c) * lc] * scale;
                                alb_su[c] = atten[c] * scale;
                            } else {
                                mk |= MK_CLAMPED << c;
                            }
                        }
                    }
                }
            }
        }

        // ---- next-event estimation toward the environment ------------------
        // The sample (direction, emission, pdf) comes in as rows; the shadow
        // ray is capped at 3e38, the MIS weight is the balance heuristic with
        // the lambertian pdf, and the firefly clamp applies as above.
        if (H.rows != nullptr && use_mis) {
            const float* hr = H.rows + (size_t)(b - b_start) * 7 * H.n;
            const float hd[3] = {hr[0], hr[H.n], hr[2 * H.n]};
            const float cos_h = dot3(nrm, hd);
            if (cos_h > 0.0f) {
                if (occluded(S, p, hd, 3.0e38f, sid, seed, bu, VOL_SHADOW_HDRI)) {
                    if constexpr (PW) mk |= PW_BLK_H;
                    if constexpr (MODE == RECORD) mk |= DEC_BLK_H;
                } else {
                    const float pdf_h = hr[6 * H.n];
                    const float pdf_bh = fmaxf(cos_h, 0.0f) * INV_PI;
                    const float weight_h = pdf_h / fmaxf(pdf_h + pdf_bh, 1e-20f);
                    const float scale_h = cos_h / fmaxf(pdf_h, 1e-12f) * weight_h;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const float contrib =
                            fminf(hr[(3 + c) * H.n] * atten[c] * scale_h, FIREFLY);
                        rad[c] = rad[c] + tp[c] * contrib;
                    }
                }
            }
        }

        if constexpr (STASH) {
            // noise textures (kind 2) have no trainable colour
            const int slot = (texkind != 2.0f)
                                 ? (int)(tex_id * 3.0f + variant) : SLOT_NONE;
            mk |= (emits ? MK_EMIT : 0) | (scattered ? MK_ALIVE_NEXT : 0);
            stash_row(Z, ray, b, tp, atten, em_su, alb_su, slot, lslot, mk);
            stashed = b + 1;
        }
        if constexpr (PW) {
            // a dielectric's albedo never enters (atten = 1) and a noise
            // texture has no trainable colour
            const int slot = (!is_die && texkind != 2.0f)
                                 ? (int)(tex_id * 3.0f + variant) : SLOT_NONE;
            mk |= (emits ? PW_EMIT : 0) | (scattered ? PW_ALIVE_NEXT : 0) |
                  (front ? PW_FRONT : 0) | (is_met ? PW_METAL : 0) |
                  (is_die ? PW_DIELECTRIC : 0) | PW_HIT |
                  (use_mis ? PW_USE_MIS : 0) |
                  (is_vol ? (PW_VOLUME | (hidx << PW_VOL_SHIFT)) : 0) |
                  // the reverse sweep's dmarble/dp (dielectrics: atten 1)
                  ((!is_die && texkind == 2.0f) ? PW_MARBLE : 0);
            stash_row_pathwise<F_ROWS>(Z, ray, b, tp, atten, p, d, nrm, fuzz, ior,
                                       flip * dndp, t, inv_scale, slot, (int)mat_id,
                                       mk);
            stashed = b + 1;
        }
        if constexpr (MODE == RECORD) {
            const size_t at = (size_t)b * D.n + ray;
            D.code[at] = (unsigned char)(hitk | (mk & (DEC_BLK_A | DEC_BLK_H)));
            D.idx[at] = hidx;
            stashed = b + 1;
        }

        // ---- state update -------------------------------------------------
        alive = scattered;
        if (alive) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                tp[c] = tp[c] * atten[c];
                o[c] = p[c];
                d[c] = new_d[c];
            }
        }
        allow = !use_mis;
    }
    // A ray that died before the last bounce would have allowLightHits set
    // again by the next bounce of a masked wavefront loop.
    if (!alive && b < b_end) allow = true;

    if constexpr (STASH) {
        // bounces never entered: inert rows
        for (int k = stashed; k < b_end; ++k)
            stash_row(Z, ray, k, zero3, zero3, zero3, zero3, SLOT_NONE,
                      LSLOT_NONE, 0);
    }
    if constexpr (PW) {
        for (int k = stashed; k < b_end; ++k)
            stash_row_pathwise<F_ROWS>(Z, ray, k, zero3, zero3, zero3, zero3, zero3,
                                       0.0f, 0.0f, 0.0f, 0.0f, 0.0f, SLOT_NONE,
                                       MSLOT_NONE, 0);
    }
    if constexpr (MODE == RECORD) {
        // the bounce of a miss and the bounces never entered: no hit
        for (int k = stashed; k < b_end; ++k) {
            D.code[(size_t)k * D.n + ray] = 0;
            D.idx[(size_t)k * D.n + ray] = 0;
        }
    }

    flags = (missed ? FLAG_MISSED : 0) | (m_prim ? FLAG_PRIMARY : 0) |
            (alive ? FLAG_ALIVE : 0) | (allow ? FLAG_ALLOW : 0);
}

// Miss shader of the gradient forwards: the flat background (mode 0), the
// sky gradient of the miss direction (1, the formula of the JAX kernel), or
// a per-ray colour computed outside the kernel (2, an environment map; the
// stash-writing forwards then leave it to the caller and write 0).
constexpr int MISS_FLAT = 0;
constexpr int MISS_SKY = 1;
constexpr int MISS_STREAM = 2;

struct Miss {
    int mode;
    float bg[3];
};

__device__ __forceinline__ void miss_colour(const Miss& M, const float m_dir[3],
                                            float col[3]) {
    if (M.mode == MISS_SKY) {
        const float dl = sqrtf(fmaxf(dot3(m_dir, m_dir), 1e-20f));
        const float aa = 0.5f * (m_dir[1] / dl + 1.0f);
        col[0] = (1.0f - aa) + aa * 0.5f;
        col[1] = (1.0f - aa) + aa * 0.7f;
        col[2] = (1.0f - aa) + aa * 1.0f;
    } else if (M.mode == MISS_FLAT) {
#pragma unroll
        for (int c = 0; c < 3; ++c) col[c] = M.bg[c];
    } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) col[c] = 0.0f;
    }
}

}  // namespace
