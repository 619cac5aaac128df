// Wavefront megakernel for Hopper (sm_90a): the whole bounce loop of the
// path tracer in one kernel, one thread per ray.  Three instantiations of
// one template:
//
//   wavefront_kernel<FWD>       the forward render.  Replaces the forward
//       specialization of make_kernel in the JAX package's
//       go_raytracing_tpu/ops/pallas_wavefront.py (launched by _call
//       through pl.pallas_call, entry point trace_megakernel).
//   wavefront_kernel<PRODUCT>   the gradient forward of the product-chain
//       tier: the same bounce loop, and per bounce the 12 float + 3 int
//       stash rows that the reverse sweep (wavefront_grad.cu) reads, and
//       the miss colour.  Replaces make_kernel(grad_mode=True, phase="fwd")
//       of the same file (launched by _call_grad_fwd, entry point
//       grad_fwd_stash), product rows.
//   wavefront_kernel<PATHWISE>  the gradient forward of the pathwise tier
//       (scenes with metal or glass): the same bounce loop, and per bounce
//       the 19 float + 3 int rows that the pathwise reverse sweep
//       (wavefront_grad_pathwise.cu) reads: throughput, attenuation, hit
//       point, incoming direction, normal, fuzz, IOR, d(normal)/d(point),
//       hit distance; albedo slot, material id, mask.  Replaces
//       make_kernel(grad_mode=True, pathwise=True, phase="fwd"), without
//       the marble row.  It stores no NEE rows: the reverse sweep
//       recomputes that chain, and of the shadow sweep only the outcome is
//       kept, as a mask bit.
//
// The radiance of all three is the same by construction.
//
// The forward first.
//
// What bounds it on this card: by the roofline's count the two bounds lie
// close together.  A ray moves 18 rows of 4 bytes (8 in, 10 out) once; a
// bounce sweeps all primitives for the closest hit and, from a lambertian
// hit, once more for the shadow ray, at 12 to 73 float operations a
// candidate.  For the Cornell box that is about 900 counted operations
// and 72 bytes a ray, and the card does 20 operations in the time of one
// byte.  What the kernel really waits for is neither: the sweep is a chain
// of dependent divides and compares, each bounce hashes five PCG3D
// counters in integer arithmetic, and the threads of a warp part ways
// after the first scatter.  See PERF.md for the measured times.
//
// What the design does about that:
//   * ray state lives in registers for the whole path; nothing goes back
//     to device memory between bounces, so the bytes stay at the 72;
//   * a thread leaves the bounce loop as soon as its ray dies or misses,
//     and skips the shadow sweep unless the hit is a lambertian surface
//     facing the light (the TPU kernel runs every lane of a 4096-ray block
//     through every step with masks; the numbers are the same);
//   * the sweep keeps only the winner's index and reads its 14 material
//     constants once after the sweep, instead of selecting them per
//     primitive; the shadow sweep stops at the first blocker;
//   * the scalar tables are copied to shared memory once per block (a
//     grid-stride loop lets one block trace many ray tiles), where every
//     thread of a warp reads the same word: a broadcast.  Tables above
//     48 KB stay in device memory and come through the cache;
//   * built without --use_fast_math: log(max(u, 1e-38)) needs denormals,
//     and division and sqrt stay IEEE; and with -fmad=false, so that the
//     kernel rounds like its plain PyTorch version (ops/_build.py).
//
// The gradient forward moves five times the bytes: 15 stash rows a bounce
// besides the forward's 18 and the 3 miss colour rows, 384 bytes a ray at
// depth 5 (the pathwise rows: 22 a bounce, 524 bytes a ray), so the stash
// writes bound it.  The design: the stash is
// [depth, row, ray] with the ray innermost, so the 32 stores of a warp to
// one row are one 128-byte line; a thread writes the rows of the bounces it
// enters as it goes and, after its loop, inert rows (floats 0, slots
// negative, mask 0) for the bounces it never entered, so every word of the
// stash is defined and the reverse sweep needs no length per ray.  The
// stores sit behind `if constexpr`, so the forward instantiation carries
// none of them, and the product instantiation none of the pathwise rows.
// What the pathwise reverse sweep recomputes (random draws, the Fresnel
// decision, the light sample) comes from wavefront_common.cuh in both.
//
// Table layouts (row-major [rows, columns], one column per primitive) are
// those of ops/cuda_wavefront.build_tables.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_common.cuh"

namespace {

using namespace wf;

constexpr float BIG = 3.0e38f;
constexpr float EPS_PARALLEL = 1e-8f;

constexpr int PT_ROWS = 31;
constexpr int ST_ROWS = 23;
constexpr int VT_ROWS = 25;
constexpr int LT_ROWS = 17;
constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 16;
constexpr size_t SMEM_TABLE_LIMIT = 48 * 1024;

// RNG purposes of the volumes (core/rng.py)
constexpr uint32_t VOL_FLIGHT = 64;   // + 32 * volume index
constexpr uint32_t VOL_SHADOW = 65;   // + 32 * volume index

// What a launch writes besides the forward's outputs.
constexpr int FWD = 0;        // nothing
constexpr int PRODUCT = 1;    // the product-chain stash and the miss colour
constexpr int PATHWISE = 2;   // the pathwise stash and the miss colour

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
                     //           fuzz ior dndp t
    int* i;          // [depth, 3, n]  slot, lslot or material id, mask
    long long n;     // rays (row stride)
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

// One row of the pathwise stash.
__device__ __forceinline__ void stash_row_pathwise(
    const Stash& Z, long long ray, int k, const float T[3], const float alb[3],
    const float p[3], const float d[3], const float nrm[3], float fuzz,
    float ior, float dndp, float t, int slot, int mslot, int mk) {
    float* f = Z.f + (size_t)k * PW_F_ROWS * Z.n + ray;
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
// scatter event on the way.
__device__ __forceinline__ bool occluded(const Tables& S, const float o[3],
                                         const float d[3], float t_cap,
                                         uint32_t sid, uint32_t seed,
                                         uint32_t bounce) {
    float t_best = t_cap;
    int dummy = 0;
    if (planar_sweep<true>(S, o, d, t_best, dummy)) return true;
    if (sphere_sweep<true>(S, o, d, 0.0f, t_best, dummy)) return true;
    for (int vi = 0; vi < S.n_vol; ++vi) {
        const float u = uniform3(sid, seed, bounce, VOL_SHADOW + 32u * vi).x;
        float t_v;
        if (volume_scatter(S, o, d, fminf(t_best, t_cap), vi, u, t_v)) return true;
    }
    return false;
}

template <int MODE>
__device__ __forceinline__ void trace_ray(const Tables& S, float o[3], float d[3],
                                          float tmv, uint32_t sid, uint32_t seed,
                                          int max_depth, float rad[3],
                                          float m_dir[3], float m_tp[3],
                                          int& flags, const Stash& Z,
                                          long long ray) {
    float tp[3] = {1.0f, 1.0f, 1.0f};
    bool alive = true, allow = true, missed = false, m_prim = false;
    const bool use_nee = S.n_lights > 0;
    constexpr bool STASH = MODE == PRODUCT;
    const float zero3[3] = {0.0f, 0.0f, 0.0f};
    int stashed = 0;  // stash rows written so far

    int b = 0;
    for (; b < max_depth && alive; ++b) {
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
            m_prim = (b == 0);
            missed = true;
            alive = false;
            allow = true;
            if constexpr (STASH) {
                // the reverse sweep adds the miss colour at this bounce
                stash_row(Z, ray, b, tp, zero3, zero3, zero3, SLOT_NONE,
                          LSLOT_NONE, MK_LIT);
                stashed = b + 1;
            }
            if constexpr (MODE == PATHWISE) {
                // the rows a masked loop would leave on a lane without a
                // hit: the reverse sweep reads T and d (the miss direction)
                const float pm[3] = {o[0] + 1.0f * d[0], o[1] + 1.0f * d[1],
                                     o[2] + 1.0f * d[2]};
                stash_row_pathwise(Z, ray, b, tp, zero3, pm, d, zero3, 0.0f,
                                   1e-3f, 0.0f, 1.0f, SLOT_NONE, MSLOT_NONE,
                                   PW_LIT);
                stashed = b + 1;
            }
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
            if constexpr (MODE != FWD) tex_id = P[29 * pc];
            if constexpr (MODE == PATHWISE) mat_id = P[30 * pc];
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
            if constexpr (MODE != FWD) tex_id = Q[21 * sc];
            if constexpr (MODE == PATHWISE) {
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
            if constexpr (MODE != FWD) tex_id = V[24 * vc];
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
            const LightDir D = light_dir(S.lt, S.n_lights, lc, sid, seed, bu, p, nrm);
            const float* L = D.L;
            if constexpr (STASH) lslot = (int)(L[16 * lc] * 3.0f);
            if (D.cos_th > 0.0f) {
                bool dark = D.cos_l < 1e-3f;  // grazing the light's plane
                if constexpr (MODE == PATHWISE) {
                    // the shadow ray's outcome is stashed whatever the angle
                    if (occluded(S, p, D.ld, D.dist - EPS_HIT, sid, seed, bu)) {
                        mk |= PW_BLK_A;
                        dark = true;
                    }
                } else {
                    dark = dark ||
                           occluded(S, p, D.ld, D.dist - EPS_HIT, sid, seed, bu);
                }
                if (!dark) {
                    const float scale = nee_scale(D, lc, S.n_lights).scale;
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

        if constexpr (STASH) {
            // noise textures (kind 2) have no trainable colour
            const int slot = (texkind != 2.0f)
                                 ? (int)(tex_id * 3.0f + variant) : SLOT_NONE;
            mk |= (emits ? MK_EMIT : 0) | (scattered ? MK_ALIVE_NEXT : 0);
            stash_row(Z, ray, b, tp, atten, em_su, alb_su, slot, lslot, mk);
            stashed = b + 1;
        }
        if constexpr (MODE == PATHWISE) {
            // a dielectric's albedo never enters (atten = 1) and a noise
            // texture has no trainable colour
            const int slot = (!is_die && texkind != 2.0f)
                                 ? (int)(tex_id * 3.0f + variant) : SLOT_NONE;
            mk |= (emits ? PW_EMIT : 0) | (scattered ? PW_ALIVE_NEXT : 0) |
                  (front ? PW_FRONT : 0) | (is_met ? PW_METAL : 0) |
                  (is_die ? PW_DIELECTRIC : 0) | PW_HIT |
                  (use_mis ? PW_USE_MIS : 0) |
                  (is_vol ? (PW_VOLUME | (hidx << PW_VOL_SHIFT)) : 0);
            stash_row_pathwise(Z, ray, b, tp, atten, p, d, nrm, fuzz, ior,
                               flip * dndp, t, slot, (int)mat_id, mk);
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
    if (!alive && b < max_depth) allow = true;

    if constexpr (STASH) {
        // bounces never entered: inert rows
        for (int k = stashed; k < max_depth; ++k)
            stash_row(Z, ray, k, zero3, zero3, zero3, zero3, SLOT_NONE,
                      LSLOT_NONE, 0);
    }
    if constexpr (MODE == PATHWISE) {
        for (int k = stashed; k < max_depth; ++k)
            stash_row_pathwise(Z, ray, k, zero3, zero3, zero3, zero3, zero3, 0.0f,
                               0.0f, 0.0f, 0.0f, SLOT_NONE, MSLOT_NONE, 0);
    }

    flags = (missed ? 1 : 0) | (m_prim ? 2 : 0) | (alive ? 4 : 0) | (allow ? 8 : 0);
}

// Miss shader of the gradient forward: the flat background, or the sky
// gradient of the miss direction (the formula of the JAX kernel).
struct Miss {
    int use_sky;
    float bg[3];
};

template <int MODE>
__global__ void __launch_bounds__(THREADS)
wavefront_kernel(Tables G, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oz,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ dz, const float* __restrict__ tm,
                 const uint32_t* __restrict__ stream, float* __restrict__ out,
                 int* __restrict__ flags_out, long long n_rays, uint32_t seed,
                 int max_depth, int tables_in_smem, Stash Z, Miss M,
                 float* __restrict__ miss_col) {
    extern __shared__ float smem[];
    Tables S = G;
    if (tables_in_smem) {
        const int n_pt = PT_ROWS * G.pc, n_st = ST_ROWS * G.sc;
        const int n_vt = VT_ROWS * G.vc, n_lt = LT_ROWS * G.lc;
        float* s_pt = smem;
        float* s_st = s_pt + n_pt;
        float* s_vt = s_st + n_st;
        float* s_lt = s_vt + n_vt;
        for (int k = threadIdx.x; k < n_pt; k += blockDim.x) s_pt[k] = G.pt[k];
        for (int k = threadIdx.x; k < n_st; k += blockDim.x) s_st[k] = G.st[k];
        for (int k = threadIdx.x; k < n_vt; k += blockDim.x) s_vt[k] = G.vt[k];
        for (int k = threadIdx.x; k < n_lt; k += blockDim.x) s_lt[k] = G.lt[k];
        S.pt = s_pt;
        S.st = s_st;
        S.vt = s_vt;
        S.lt = s_lt;
        __syncthreads();
    }

    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_rays;
         i += step) {
        float o[3] = {ox[i], oy[i], oz[i]};
        float d[3] = {dx[i], dy[i], dz[i]};
        float rad[3] = {0.0f, 0.0f, 0.0f};
        float m_dir[3] = {0.0f, 0.0f, 0.0f};
        float m_tp[3] = {0.0f, 0.0f, 0.0f};
        int flags;
        trace_ray<MODE>(S, o, d, tm[i], stream[i], seed, max_depth, rad, m_dir,
                        m_tp, flags, Z, i);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            out[(0 + c) * n_rays + i] = rad[c];
            out[(3 + c) * n_rays + i] = m_dir[c];
            out[(6 + c) * n_rays + i] = m_tp[c];
        }
        flags_out[i] = flags;
        if constexpr (MODE != FWD) {
            float col[3] = {0.0f, 0.0f, 0.0f};
            if (flags & 1) {
                if (M.use_sky) {
                    const float dl = sqrtf(fmaxf(dot3(m_dir, m_dir), 1e-20f));
                    const float aa = 0.5f * (m_dir[1] / dl + 1.0f);
                    col[0] = (1.0f - aa) + aa * 0.5f;
                    col[1] = (1.0f - aa) + aa * 0.7f;
                    col[2] = (1.0f - aa) + aa * 1.0f;
                } else {
#pragma unroll
                    for (int c = 0; c < 3; ++c) col[c] = M.bg[c];
                }
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) miss_col[c * n_rays + i] = col[c];
        }
    }
}

template <int MODE>
int launch(const float* pt, const float* st, const float* vt, const float* lt,
           int n_planar, int n_sphere, int n_vol, int n_lights, const float* ox,
           const float* oy, const float* oz, const float* dx, const float* dy,
           const float* dz, const float* tm, const void* stream, float* out,
           int* flags, long long n_rays, unsigned int seed, int max_depth,
           void* cuda_stream, Stash Z, Miss M, float* miss_col) {
    Tables G;
    G.pt = pt;
    G.st = st;
    G.vt = vt;
    G.lt = lt;
    G.n_planar = n_planar;
    G.n_sphere = n_sphere;
    G.n_vol = n_vol;
    G.n_lights = n_lights;
    G.pc = n_planar > 0 ? n_planar : 1;
    G.sc = n_sphere > 0 ? n_sphere : 1;
    G.vc = n_vol > 0 ? n_vol : 1;
    G.lc = n_lights > 0 ? n_lights : 1;

    const size_t table_bytes =
        sizeof(float) * ((size_t)PT_ROWS * G.pc + (size_t)ST_ROWS * G.sc +
                         (size_t)VT_ROWS * G.vc + (size_t)LT_ROWS * G.lc);
    const int in_smem = table_bytes <= SMEM_TABLE_LIMIT;

    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;

    long long blocks = (n_rays + THREADS - 1) / THREADS;
    const long long cap = (long long)sms * BLOCKS_PER_SM;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;

    wavefront_kernel<MODE><<<(unsigned int)blocks, THREADS,
                              in_smem ? table_bytes : (size_t)0,
                              (cudaStream_t)cuda_stream>>>(
        G, ox, oy, oz, dx, dy, dz, tm, (const uint32_t*)stream, out, flags,
        n_rays, seed, max_depth, in_smem, Z, M, miss_col);
    return (int)cudaGetLastError();
}

}  // namespace

// All three launch on the given stream, do not synchronize, allocate nothing and
// return cudaGetLastError() (0 on success).
extern "C" int wavefront_fwd_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, float* out, int* flags, long long n_rays,
    unsigned int seed, int max_depth, void* cuda_stream) {
    return launch<FWD>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights, ox,
                         oy, oz, dx, dy, dz, tm, stream, out, flags, n_rays, seed,
                         max_depth, cuda_stream, Stash{nullptr, nullptr, 0},
                         Miss{0, {0.0f, 0.0f, 0.0f}}, nullptr);
}

// miss_col [3, n_rays], stash_f [max_depth, 12, n_rays] and stash_i
// [max_depth, 3, n_rays] are written in full.
extern "C" int wavefront_grad_fwd_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, float* out, int* flags, float* miss_col,
    float* stash_f, int* stash_i, long long n_rays, unsigned int seed,
    int max_depth, int use_sky, float bg_r, float bg_g, float bg_b,
    void* cuda_stream) {
    return launch<PRODUCT>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                           ox, oy, oz, dx, dy, dz, tm, stream, out, flags, n_rays,
                           seed, max_depth, cuda_stream,
                           Stash{stash_f, stash_i, n_rays},
                           Miss{use_sky, {bg_r, bg_g, bg_b}}, miss_col);
}

// The pathwise tier's: as above with stash_f [max_depth, 19, n_rays].
extern "C" int wavefront_grad_fwd_pathwise_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, float* out, int* flags, float* miss_col,
    float* stash_f, int* stash_i, long long n_rays, unsigned int seed,
    int max_depth, int use_sky, float bg_r, float bg_g, float bg_b,
    void* cuda_stream) {
    return launch<PATHWISE>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                            ox, oy, oz, dx, dy, dz, tm, stream, out, flags,
                            n_rays, seed, max_depth, cuda_stream,
                            Stash{stash_f, stash_i, n_rays},
                            Miss{use_sky, {bg_r, bg_g, bg_b}}, miss_col);
}
