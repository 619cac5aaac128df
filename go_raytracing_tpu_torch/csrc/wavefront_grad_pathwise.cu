// Pathwise reverse sweep for Hopper (sm_90a): the adjoint of the bounce loop
// for scenes with metal and glass, whose scatter directions depend on
// trainable parameters (fuzz, IOR) and whose colours are also reached
// through hit positions.
//
// Replaces: make_kernel(grad_mode=True, pathwise=True, phase="rev") in the
// JAX package's go_raytracing_tpu/ops/pallas_wavefront.py (launched by
// _call_grad_rev through pl.pallas_call, entry point
// grad_rev_stash(pathwise=True)), without its HDRI, marble and environment
// blocks.
//
// It reads what the pathwise gradient forward (wavefront.cu,
// wavefront_kernel<PATHWISE>) stashed per ray and bounce, the loss cotangent
// g of the ray's radiance, the ray's miss colour and counter, and the light
// and volume tables.  Per ray, from the last bounce to the first, it carries
// three adjoints in registers (of the throughput ltp, of the ray origin lo,
// of the ray direction ld) and
//
//   * draws the bounce's scatter direction, Fresnel number and light sample
//     again from the counter, recomputes the NEE chain with the forward's
//     floors and takes the partials of its scale by hit point and normal;
//   * reverses the scatter: lambertian (normal + draw), metal (reflect,
//     normalise, + fuzz * draw: d/dfuzz), dielectric (reflect or refract the
//     unit direction, the branch decided again: d/dior);
//   * differentiates the sky colour by the miss direction;
//   * sends the hit point's adjoint through the hit distance by the implicit
//     rule dt/do = -n / (n.d), dt/dd = t dt/do, or, for a volume, through
//     the entry slab and the free-flight length;
//   * sums the cotangents of albedo (texture slot) and emission (light slot),
//     3 channels each into 9 accumulators a texture, and of fuzz and ior into
//     2 accumulators a material.
//
// What bounds it: bytes by the count (22 rows a bounce and 7 rows once, 468
// bytes a ray at depth 5, against a few hundred operations an entered
// bounce), but the dependent chain of divisions and square roots, four PCG3D
// hashes a bounce and the keyed reduction are what it waits for; see PERF.md
// for the measured time.  The design: one thread per ray, rows with the ray
// innermost (a warp's load of a row is one 128-byte line); a row a ray never
// entered (mask 0) is skipped, which changes nothing since such rows only
// trail and the adjoints are still 0 there; the tables are small and read
// through the cache.  The sums use the scheme of wavefront_grad.cu: inside a
// warp the lanes that share a key are added by a butterfly of shuffles in a
// fixed order, lane 0 adds the warp's sum to the warp's own accumulator row
// in shared memory, the block adds its warps' rows in order and writes one
// row of partial sums, the wrapper adds the blocks' rows.  No device atomics,
// a grid that depends on the ray count alone: the same bits on every run.
// Only lanes with something to add take part in a key's loop, so a bounce
// costs one pass per distinct key present in the warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_common.cuh"

namespace {

using namespace wf;

constexpr float BIG = 3.0e38f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RAYS_PER_THREAD = 8;
constexpr int BLOCK_RAYS = THREADS * RAYS_PER_THREAD;
constexpr size_t SMEM_LIMIT = 48 * 1024;
// Most accumulators (9 a texture + 2 a material) a block's shared memory
// holds (ops/cuda_wavefront.py: GRAD_PATHWISE_MAX_ACC).
constexpr int MAX_ACC = (int)(SMEM_LIMIT / (WARPS * sizeof(float)));
constexpr unsigned FULL = 0xFFFFFFFFu;

// Adds v[0..N-1] of every lane with key >= 0 to acc[key + c].  Called by all
// 32 lanes of a warp together; acc is the warp's own row.
template <int N>
__device__ __forceinline__ void warp_add(float* acc, int key, const float* v,
                                         int lane) {
    unsigned todo = __ballot_sync(FULL, key >= 0);
    while (todo) {
        const int leader = __ffs(todo) - 1;
        const int s = __shfl_sync(FULL, key, leader);
        const bool mine = key == s;
#pragma unroll
        for (int c = 0; c < N; ++c) {
            float x = mine ? v[c] : 0.0f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                x += __shfl_xor_sync(FULL, x, off);
            // one lane owns the row: its adds are in program order
            if (lane == 0) acc[s + c] += x;
        }
        todo &= ~__ballot_sync(FULL, mine);
    }
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

__global__ void __launch_bounds__(THREADS)
wavefront_grad_rev_pathwise_kernel(
    const float* __restrict__ lt, int n_lights, const float* __restrict__ vt,
    int n_vol, const float* __restrict__ stash_f, const int* __restrict__ stash_i,
    const float* __restrict__ g3, const float* __restrict__ miss_col,
    const uint32_t* __restrict__ stream, float* __restrict__ partial,
    long long n_rays, uint32_t seed, int depth, int n_col, int n_acc,
    int use_sky) {
    extern __shared__ float smem[];  // [WARPS, n_acc]
    for (int j = threadIdx.x; j < WARPS * n_acc; j += THREADS) smem[j] = 0.0f;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    float* acc = smem + (threadIdx.x >> 5) * n_acc;
    const long long base = (long long)blockIdx.x * BLOCK_RAYS + threadIdx.x;
    const size_t n = (size_t)n_rays;
    const int lc = n_lights > 0 ? n_lights : 1;
    const int vc = n_vol > 0 ? n_vol : 1;
    const float nl = (float)n_lights;
    const float sky_s[3] = {0.5f, 0.7f, 1.0f};

    for (int it = 0; it < RAYS_PER_THREAD; ++it) {
        const long long i = base + (long long)it * THREADS;
        const bool valid = i < n_rays;  // the warp's lanes stay together
        float g[3] = {0.0f, 0.0f, 0.0f}, mc[3] = {0.0f, 0.0f, 0.0f};
        uint32_t sid = 0;
        if (valid) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                g[c] = g3[c * n + i];
                mc[c] = miss_col[c * n + i];
            }
            sid = stream[i];
        }
        float lo[3] = {0.0f, 0.0f, 0.0f};
        float ldv[3] = {0.0f, 0.0f, 0.0f};
        float ltp[3] = {0.0f, 0.0f, 0.0f};

        for (int k = depth - 1; k >= 0; --k) {
            const int mk = valid ? stash_i[((size_t)k * 3 + 2) * n + i] : 0;
            float cot_alb[3] = {0.0f, 0.0f, 0.0f};
            float cot_lem[3] = {0.0f, 0.0f, 0.0f};
            float cot_mat[2] = {0.0f, 0.0f};  // fuzz, ior
            int akey = -1, lkey = -1, mkey = -1;

            // mask 0: a bounce the ray never entered.  Such rows only trail,
            // the adjoints are 0 there and stay 0.
            if (mk != 0) {
                const float* f = stash_f + (size_t)k * PW_F_ROWS * n + i;
                const int* q = stash_i + (size_t)k * 3 * n + i;
                float T[3], alb[3], pv[3], din[3], nv[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    T[c] = f[(0 + c) * n];
                    alb[c] = f[(3 + c) * n];
                    pv[c] = f[(6 + c) * n];
                    din[c] = f[(9 + c) * n];
                    nv[c] = f[(12 + c) * n];
                }
                const float io_ = fmaxf(f[16 * n], 1e-3f);
                const float dndp = f[17 * n];
                const float tk = f[18 * n];
                const int slot = q[0];
                const int mslot = q[n];
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

                // ---- NEE recompute and the partials of its scale ----------
                float em_su[3] = {0.0f, 0.0f, 0.0f};
                float alb_su[3] = {0.0f, 0.0f, 0.0f};
                float clampf[3] = {0.0f, 0.0f, 0.0f};
                float lp_nee[3] = {0.0f, 0.0f, 0.0f};
                float ln_nee[3] = {0.0f, 0.0f, 0.0f};
                if ((mk & PW_USE_MIS) && n_lights > 0) {
                    const LightDir D =
                        light_dir(lt, n_lights, lc, sid, seed, bu, pv, nv);
                    const bool ok = D.cos_th > 0.0f && !(mk & PW_BLK_A) &&
                                    !(D.cos_l < 1e-3f);
                    if (ok) {
                        const float* L = D.L;
                        const NeeScale N = nee_scale(D, lc, n_lights);
                        float W = 0.0f;
#pragma unroll
                        for (int c = 0; c < 3; ++c) {
                            const float em = L[(13 + c) * lc];
                            const float uf =
                                (em * alb[c] * N.scale < FIREFLY) ? 1.0f : 0.0f;
                            em_su[c] = em * N.scale * uf;
                            alb_su[c] = alb[c] * N.scale * uf;
                            clampf[c] = 1.0f - uf;
                            W = W + g[c] * T[c] * em * alb[c] * uf;
                        }
                        const int ls = (int)(L[16 * lc] * 3.0f);
                        if (ls >= 0 && ls * 3 + 2 < n_col) lkey = ls * 3;
                        // scale = nL cos_th pdf_l / (q r)
                        const float area = L[12 * lc];
                        const float q_act = N.pdf_l > 1e-12f ? 1.0f : 0.0f;
                        const float r_act =
                            N.pdf_l + N.pdf_b > 1e-20f ? 1.0f : 0.0f;
                        const float s2_act = N.s2v > 1e-20f ? 1.0f : 0.0f;
                        const float inv_qr = 1.0f / (N.qv * N.rv);
                        const float ds_dcos = nl * N.pdf_l * inv_qr;
                        const float ds_dpl =
                            nl * D.cos_th *
                            (inv_qr - N.pdf_l * (q_act * N.rv + N.qv * r_act) *
                                          inv_qr * inv_qr);
                        const float ds_dpb =
                            -nl * D.cos_th * N.pdf_l * r_act * inv_qr / N.rv;
                        const float dpb_dcos = D.cos_th > 0.0f ? INV_PI : 0.0f;
                        const float c_cos = W * (ds_dcos + ds_dpb * dpb_dcos);
                        const float c_pl = W * ds_dpl;
                        const float c_dist = c_pl * (2.0f * D.dist / N.s2);
                        const float c_cosl =
                            c_pl * (-(D.dist * D.dist) * area * s2_act /
                                    (N.s2 * N.s2));
                        const float sgn_z = D.zlc >= 0.0f ? 1.0f : -1.0f;
                        float lam_ld[3];
#pragma unroll
                        for (int c = 0; c < 3; ++c) {
                            lam_ld[c] = c_cos * nv[c] -
                                        c_cosl * sgn_z * L[(9 + c) * lc];
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
                        for (int c = 0; c < 3; ++c)
                            rfl[c] = din[c] - nv[c] * (2.0f * ddn_f);
                        const float rlen = sqrtf(fmaxf(dot3(rfl, rfl), 1e-20f));
#pragma unroll
                        for (int c = 0; c < 3; ++c) rhat[c] = rfl[c] / rlen;
                        const float rhu = dot3(rhat, u);
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                            vv[c] = (u[c] - rhat[c] * rhu) / rlen;
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
                                l_n_s[c] = F.ri * (F.cos_t * l_perp[c] -
                                                   ct_act * F.ud[c] * npp) +
                                           parl * u[c];
                            }
                            const float cot_ri =
                                (F.ud[0] + nv[0] * F.cos_t) * l_perp[0] +
                                (F.ud[1] + nv[1] * F.cos_t) * l_perp[1] +
                                (F.ud[2] + nv[2] * F.cos_t) * l_perp[2];
                            const float dri = front ? -1.0f / (io_ * io_) : 1.0f;
                            cot_mat[1] = cot_ri * dri;
                        }
                        const float udu = dot3(F.ud, l_ud);
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                            l_din_s[c] = (l_ud[c] - F.ud[c] * udu) / F.dlen;
                    } else {
                        // lambertian: new_d = n + ru
#pragma unroll
                        for (int c = 0; c < 3; ++c) l_n_s[c] = u[c];
                    }
                    if ((is_met || is_die) && mslot >= 0 &&
                        n_col + 2 * mslot + 1 < n_acc)
                        mkey = n_col + 2 * mslot;
                }

                // ---- cotangents of the colours; the throughput adjoint ----
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    cot_alb[c] = g[c] * T[c] * (emitf + em_su[c]) + ltp[c] * T[c] * Af;
                    cot_lem[c] = g[c] * T[c] * alb_su[c];
                }
                // a slot outside the accumulator would corrupt shared memory
                if (slot >= 0 && slot * 3 + 2 < n_col) akey = slot * 3;

                // the sky colour's derivative by the miss direction (on a lit
                // row the stashed direction is the miss direction)
                float l_d_sky[3] = {0.0f, 0.0f, 0.0f};
                if (use_sky && lit) {
                    const float dl2 = fmaxf(dot3(din, din), 1e-20f);
                    const float dlm = sqrtf(dl2);
                    const float w_sky = g[0] * T[0] * (sky_s[0] - 1.0f) +
                                        g[1] * T[1] * (sky_s[1] - 1.0f) +
                                        g[2] * T[2] * (sky_s[2] - 1.0f);
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                        l_d_sky[c] = w_sky * 0.5f *
                                     ((c == 1 ? 1.0f : 0.0f) / dlm -
                                      din[1] * din[c] / (dl2 * dlm));
                }
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    ltp[c] = ltp[c] * (alive_next ? alb[c] : 1.0f) +
                             g[c] * (alb[c] * emitf + em_su[c] * alb[c] +
                                     FIREFLY * clampf[c]) +
                             (lit ? g[c] * mc[c] : 0.0f);

                // ---- the hit point's adjoint, back through the hit distance
                float lam_p[3], bb[3], ld_t[3];
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    lam_p[c] = Af * lo[c] + lp_nee[c] +
                               dndp * (l_n_s[c] + ln_nee[c]);
                const float dlp = dot3(din, lam_p);
                if (mk & PW_VOLUME) {
                    // t = max(near, eps) + K / |d|, K from the draw alone: the
                    // entry slab's plane stands in for the surface
                    const int vi = (mk >> PW_VOL_SHIFT) & 3;
                    float o_rec[3], ne[3], near, inv_e, act_e;
#pragma unroll
                    for (int c = 0; c < 3; ++c) o_rec[c] = pv[c] - tk * din[c];
                    volume_entry(vt, vc, vi < n_vol ? vi : 0, o_rec, din, near, ne,
                                 inv_e, act_e);
                    // origin inside the box: the entry is the constant eps
                    const float ent = near >= EPS_HIT ? 1.0f : 0.0f;
                    const float t0c = fmaxf(near, EPS_HIT);
                    const float dl2v = fmaxf(dot3(din, din), 1e-20f);
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        bb[c] = lam_p[c] - ent * ne[c] * inv_e * dlp;
                        ld_t[c] = tk * lam_p[c] -
                                  ent * act_e * near * ne[c] * inv_e * dlp -
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
                    ldv[c] = (1.0f - Af) * ldv[c] + l_din_s[c] +
                             (hit ? ld_t[c] : 0.0f) + l_d_sky[c];
                }
            }

            warp_add<3>(acc, akey, cot_alb, lane);
            warp_add<3>(acc, lkey, cot_lem, lane);
            warp_add<2>(acc, mkey, cot_mat, lane);
        }
    }

    __syncthreads();
    for (int j = threadIdx.x; j < n_acc; j += THREADS) {
        float x = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) x += smem[w * n_acc + j];
        partial[(size_t)blockIdx.x * n_acc + j] = x;
    }
}

}  // namespace

// Rays one block sweeps: the wrapper sizes `partial` as
// [ceil(n_rays / this), n_acc].
extern "C" int wavefront_grad_rev_pathwise_block_rays() { return BLOCK_RAYS; }

// lt [17, max(n_lights, 1)] and vt [25, max(n_vol, 1)] f32 (the tables of
// ops/cuda_wavefront.build_tables), stash_f [depth, 19, n_rays] f32, stash_i
// [depth, 3, n_rays] i32, g3 and miss_col [3, n_rays] f32, stream [n_rays]
// u32 in; partial [ceil(n_rays / BLOCK_RAYS), n_acc] f32 out, written in
// full: n_col = 9 * textures colour sums first, then (fuzz, ior) a material.
// Launches on the given stream, does not synchronize, allocates nothing.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// sizes the kernel does not take.
extern "C" int wavefront_grad_rev_pathwise_launch(
    const float* lt, int n_lights, const float* vt, int n_vol,
    const float* stash_f, const int* stash_i, const float* g3,
    const float* miss_col, const void* stream, float* partial, long long n_rays,
    unsigned int seed, int depth, int n_col, int n_acc, int use_sky,
    void* cuda_stream) {
    if (n_rays < 1 || depth < 1 || n_col < 0 || n_acc < n_col || n_acc < 1 ||
        n_acc > MAX_ACC || n_lights < 0 || n_lights > 8 || n_vol < 0 || n_vol > 4)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (n_rays + BLOCK_RAYS - 1) / BLOCK_RAYS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    wavefront_grad_rev_pathwise_kernel<<<(unsigned int)blocks, THREADS,
                                         (size_t)WARPS * n_acc * sizeof(float),
                                         (cudaStream_t)cuda_stream>>>(
        lt, n_lights, vt, n_vol, stash_f, stash_i, g3, miss_col,
        (const uint32_t*)stream, partial, n_rays, seed, depth, n_col, n_acc,
        use_sky);
    return (int)cudaGetLastError();
}
