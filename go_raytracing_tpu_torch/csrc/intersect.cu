// Closest-hit kernels of the standard integrator for Hopper (sm_90a): the
// whole primitive table swept per ray, two rays a thread for the planar
// primitives and four for the spheres.  Four kernels, two templates:
//
//   planar_kernel<-1, GATE>  closest hit (t, idx, hit) over all quads,
//       triangles, circles and planes.  Replaces _planar_kernel /
//       planar_closest of the JAX package's go_raytracing_tpu/ops/pallas_intersect.py.
//   sphere_kernel<false>  the same over moving spheres taken at the ray's
//       time, stable oc-form quadratic.  Replaces _sphere_kernel /
//       sphere_closest.
//   planar_kernel<N_ATTR, GATE>  the planar closest hit and the winner's
//       attributes: normal, alpha, beta, kindpack, fuzz, ior, colour, planar
//       kind and, for scenes with a checker texture, even and odd colour and
//       scale (N_ATTR 12 unrolled, 0 any count of 12 to 20).  Replaces
//       _planar_attr_kernel / planar_closest_attrs.
//   sphere_kernel<true>   the sphere closest hit and the winner's attributes:
//       centre at the ray's time, radius^2, kindpack, fuzz, ior, colour (and
//       the checker rows).  Replaces _sphere_attr_kernel / sphere_closest_attrs.
//
// The attribute kernel is the closest-hit kernel plus what it writes after the
// sweep, so each pair is one template; the plain instantiations carry none of
// the attribute code.
//
// What bounds them on this card: a live ray moves 7 or 8 input rows and 2 words
// and a byte (plus 10 to 19 attribute rows) once, 37 to 113 bytes, a ray that
// can hit nothing its t_max and its outputs, and a live ray does 12 (planar)
// or 23 (sphere) float operations a primitive before the first test can
// reject it.  With the Cornell box's 18 quads the bytes bound the kernel; from
// about a hundred primitives on the sweep's arithmetic does.  Built with
// -fmad=false, a multiply and an add are two instructions, so a sweep bound by
// operations reaches at most about half of the bound, which counts a fused
// multiply-add as two operations at 67 TFLOP/s.
//
// What the design does about it:
//   * the ray and the running winner live in registers; the table is staged
//     through shared memory in tiles of TILE primitives, so a table of any
//     size is swept (there is no limit on the primitive count) and every
//     thread of a warp reads the same word, a broadcast; a table of one tile
//     is staged once a block;
//   * the planar table is staged a primitive a record of 16 floats, so that a
//     primitive's normal, offset and kind come in two 16-byte reads;
//   * the planar sweep reads a ray's t_max first: a ray that can hit nothing
//     (dead lanes and inactive shadow rays come in with t_max = -1) loads
//     nothing more; the block moves its live rays to its first slots (ballots
//     and counts in shared memory), so a warp sweeps only live rays, and the
//     results come back to ray order through shared memory, every output
//     written whole in one pass;
//   * the planar sweep holds PLANAR_K = 2 rays a thread, the sphere sweep
//     SPHERE_K = 4: a primitive's words are read from shared memory once for
//     several tests, whose independent chains keep the SM's pipelines busy;
//   * where t_min > 0 (every caller of the integrator), the planar sweep skips
//     the division of a candidate whose numerator and denominator are not of
//     one strict sign (the launch picks that instantiation from t_min);
//   * a sphere block stages no tile when none of its rays is active, and a
//     warp with no active ray sweeps none (a dead ray in a live warp is
//     tested with it: no root lies in (t_min, t_max)); both templates take
//     one block a run of rays, no grid-stride loop, so the hardware evens the
//     blocks out over the SMs;
//   * a primitive is left as soon as one test rejects it; the interior test
//     of a planar primitive and the square root of a sphere run only for
//     candidates that passed the interval test;
//   * the sweep keeps the winner's index (and, for planar primitives, its
//     alpha and beta); the winner's constants are read once after the sweep
//     (the TPU kernel selects all of them per primitive);
//   * strict t < t_best and table order for every ray: on an exact tie the
//     first primitive wins, as in the TPU kernel;
//   * built with -fmad=false like the other kernels of the package, so each
//     rounds like its plain PyTorch version (ops/_build.py).
//
// Tables are row-major [rows, n_prims], one column a primitive:
//   planar geometry (15 rows): normal(3) d q(3) v x w(3) w x u(3) radius^2 kind
//   sphere geometry  (7 rows): centre(3) velocity(3) radius^2
//   constants       (14 rows): kindpack fuzz ior colour(3) even(3) odd(3)
//                              scale texture-id
// Outputs: t [R] (BIG on a miss), idx [R] (0 on a miss), hit [R] bytes, and
// attrs [n_attr, R] (zeros on a miss).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr float EPS_PARALLEL = 1e-8f;

constexpr int THREADS = 128;
constexpr int TILE = 128;          // primitives staged at a time
constexpr int SPHERE_K = 4;        // rays a thread of the sphere sweep
constexpr int PLANAR_ROWS = 15;
constexpr int SPHERE_ROWS = 7;
constexpr int CONST_ROWS = 14;
constexpr int PLANAR_GEO_ATTRS = 5;   // normal(3) alpha beta
constexpr int PLANAR_KIND_ATTR = 11;  // after 6 constants
constexpr int PLANAR_MAX_ATTRS = 20;
constexpr int SPHERE_GEO_ATTRS = 4;   // centre(3) radius^2

// The planar sweep's rays a thread (1 and 4 measured slower on the H100).
constexpr int PLANAR_K = 2;
constexpr int PLANAR_RUN = THREADS * PLANAR_K;   // rays a block
constexpr int PLANAR_REC = 16;   // floats of a primitive's staged record

struct Rays {
    const float* ox;
    const float* oy;
    const float* oz;
    const float* dx;
    const float* dy;
    const float* dz;
    const float* tm;     // spheres only
    const float* t_max;
    long long n;
};

struct Out {
    float* t;
    int* idx;
    uint8_t* hit;
    float* attrs;        // [n_attr, n] or null
    int n_attr;
};

// Copy columns [j0, j0 + nt) of a [ROWS, n_prims] table into the tile.
template <int ROWS>
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ geo,
                                      int n_prims, int j0, int nt) {
#pragma unroll
    for (int row = 0; row < ROWS; ++row)
        for (int col = threadIdx.x; col < nt; col += blockDim.x)
            tile[row * TILE + col] = geo[(long long)row * n_prims + j0 + col];
}

// Offset of planar geometry row r (0-14) in a primitive's staged record:
// n(3) d | q(3) kind | v x w(3) radius^2 | w x u(3) pad, so that the sweep
// reads the first eight as two 16-byte words.
__device__ constexpr int at(int r) {
    return r < 7 ? r : r == 14 ? 7 : r == 13 ? 11 : r < 10 ? r + 1 : r + 2;
}

// Columns [j0, j0 + nt) of the planar geometry into the tile, a record a
// primitive.
__device__ __forceinline__ void stage_planar(float* tile, const float* __restrict__ geo,
                                             int n_prims, int j0, int nt) {
    for (int e = threadIdx.x; e < nt * PLANAR_REC; e += blockDim.x) {
        const int j = e / PLANAR_REC, r = e % PLANAR_REC;
        const int row = r < 7 ? r : r == 7 ? 14 : r == 11 ? 13 : r < 11 ? r - 1
                        : r < 15 ? r - 2 : -1;
        tile[e] = row < 0 ? 0.0f : geo[(long long)row * n_prims + j0 + j];
    }
}

// One primitive of the sweep against one ray: moves (t_best, idx_best,
// alpha_best, beta_best) when the primitive is hit nearer.  GATE (t_min > 0):
// a candidate whose numerator and denominator are not of one strict sign gives
// t <= 0 (or NaN), which fails t >= t_min however it rounds, so its division
// is skipped; the quotient that is taken is the same IEEE quotient.
template <bool GATE>
__device__ __forceinline__ void planar_test(const float* P, float nx, float ny, float nz,
                                            float pd, float kind, const float o[3],
                                            const float d[3], float t_min, float t_max,
                                            int j, float& t_best, int& idx_best,
                                            float& alpha_best, float& beta_best) {
    const float denom = d[0] * nx + d[1] * ny + d[2] * nz;
    const bool not_par = fabsf(denom) >= EPS_PARALLEL;
    float t;
    if constexpr (GATE) {
        const float num = pd - (o[0] * nx + o[1] * ny + o[2] * nz);
        if (!(not_par && ((num > 0.0f && denom > 0.0f) || (num < 0.0f && denom < 0.0f))))
            return;
        t = num / denom;
    } else {
        t = (pd - (o[0] * nx + o[1] * ny + o[2] * nz)) / (not_par ? denom : 1.0f);
    }
    const bool t_ok = (kind == 3.0f) ? (t > t_min && t < t_max)
                                     : (t >= t_min && t <= t_max);
    if (!(not_par && t_ok && t < t_best)) return;
    const float rx = o[0] + t * d[0] - P[at(4)];
    const float ry = o[1] + t * d[1] - P[at(5)];
    const float rz = o[2] + t * d[2] - P[at(6)];
    const float alpha = rx * P[at(7)] + ry * P[at(8)] + rz * P[at(9)];
    const float beta = rx * P[at(10)] + ry * P[at(11)] + rz * P[at(12)];
    bool interior;
    if (kind == 0.0f) {
        interior = alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
    } else if (kind == 1.0f) {
        interior = alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && alpha + beta <= 1.0f;
    } else if (kind == 2.0f) {
        interior = (rx * rx + ry * ry + rz * rz) <= P[at(13)];
    } else {
        interior = kind == 3.0f;
    }
    if (!interior) return;
    t_best = t;
    idx_best = j;
    alpha_best = alpha;
    beta_best = beta;
}

// The winner's attributes: normal(3) alpha beta | kindpack fuzz ior colour(3)
// | planar kind | even(3) odd(3) scale (texture id), i.e. geometry rows 0-2,
// constants rows 0-5, geometry row 14, constants rows 6-13, read from device
// memory (measured faster than from a copy staged beside the geometry).
// N_ATTR 0: W.n_attr rows.
template <int N_ATTR>
__device__ __forceinline__ void planar_attrs(const Out& W, long long n, long long i,
                                             const float* __restrict__ geo,
                                             const float* __restrict__ con, int n_prims,
                                             int idx, float alpha, float beta) {
    const bool hit = idx >= 0;
    const int col = hit ? idx : 0;
#pragma unroll
    for (int k = 0; k < (N_ATTR ? N_ATTR : PLANAR_MAX_ATTRS); ++k) {
        if (!N_ATTR && k >= W.n_attr) break;
        float v = 0.0f;
        if (hit) {
            if (k == 3) {
                v = alpha;
            } else if (k == 4) {
                v = beta;
            } else {
                const bool g = k < 3 || k == PLANAR_KIND_ATTR;
                const int row = k < 3 ? k
                                : k == PLANAR_KIND_ATTR ? PLANAR_ROWS - 1
                                : k < PLANAR_KIND_ATTR ? k - PLANAR_GEO_ATTRS
                                : k - PLANAR_KIND_ATTR - 1 + 6;
                v = (g ? geo : con)[(long long)row * n_prims + col];
            }
        }
        W.attrs[(long long)k * n + i] = v;
    }
}

// A block takes a run of PLANAR_RUN rays, base + s for slot s; thread tid's
// chain c is slot c * THREADS + tid.  The block's live rays (t_max >= t_min)
// are moved to its first slots in ray order, so that a warp whose slots hold
// none sweeps nothing, and their results come back to ray order through
// shared memory, so that every output is written whole.  N_ATTR: -1 the
// closest hit alone, else the attribute rows (0: W.n_attr of them).
template <int N_ATTR, bool GATE>
__global__ void __launch_bounds__(THREADS)
planar_kernel(const float* __restrict__ geo, const float* __restrict__ con,
              int n_prims, Rays R, float t_min, Out W) {
    constexpr bool ATTRS = N_ATTR >= 0;
    constexpr int K = PLANAR_K;
    constexpr int WARPS = THREADS / 32;
    __shared__ __align__(16) float tile[PLANAR_REC * TILE];
    __shared__ int live_in[K * WARPS];   // live rays of each (chain, warp)
    __shared__ int slot[PLANAR_RUN];     // slot s holds ray base + slot[s]
    __shared__ float res_t[PLANAR_RUN], res_alpha[ATTRS ? PLANAR_RUN : 1],
        res_beta[ATTRS ? PLANAR_RUN : 1];
    __shared__ int res_idx[PLANAR_RUN];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long base = (long long)blockIdx.x * PLANAR_RUN;

    // t_max first: a ray that can hit nothing (dead lanes and inactive shadow
    // rays come in with t_max = -1) never loads its origin or direction
    float t_max[K];
    bool active[K];
    unsigned ballot[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
        const long long i = base + c * THREADS + tid;
        t_max[c] = -1.0f;
        if (i < R.n) {
            t_max[c] = R.t_max[i];
            if (t_max[c] >= BIG) t_max[c] = BIG;
        }
        active[c] = i < R.n && t_max[c] >= t_min;
        ballot[c] = __ballot_sync(0xffffffffu, active[c]);
        if (lane == 0) live_in[c * WARPS + warp] = __popc(ballot[c]);
    }
    stage_planar(tile, geo, n_prims, 0, min(TILE, n_prims));
    __syncthreads();
    int count = 0, before[K] = {};
#pragma unroll
    for (int q = 0; q < K * WARPS; ++q) {
#pragma unroll
        for (int c = 0; c < K; ++c)
            if (q == c * WARPS + warp) before[c] = count;
        count += live_in[q];
    }
    const bool moved = count < PLANAR_RUN;   // block-uniform; all live: slot s is ray s
    if (moved) {
#pragma unroll
        for (int c = 0; c < K; ++c)
            if (active[c])
                slot[before[c] + __popc(ballot[c] & ((1u << lane) - 1u))] = c * THREADS + tid;
        __syncthreads();
    }

    float o[K][3], d[K][3], t_best[K], alpha_best[K], beta_best[K];
    int idx_best[K], off[K];
    bool valid[K], sweep[K];
    bool any_sweep = false;
#pragma unroll
    for (int c = 0; c < K; ++c) {
        const int s = c * THREADS + tid;
        valid[c] = s < count;
        off[c] = moved && valid[c] ? slot[s] : s;
        o[c][0] = o[c][1] = o[c][2] = 0.0f;
        d[c][0] = d[c][1] = d[c][2] = 0.0f;
        if (valid[c]) {
            const long long i = base + off[c];
            o[c][0] = R.ox[i]; o[c][1] = R.oy[i]; o[c][2] = R.oz[i];
            d[c][0] = R.dx[i]; d[c][1] = R.dy[i]; d[c][2] = R.dz[i];
            if (moved) {
                t_max[c] = R.t_max[i];
                if (t_max[c] >= BIG) t_max[c] = BIG;
            }
        }
        t_best[c] = BIG;
        idx_best[c] = -1;
        alpha_best[c] = beta_best[c] = 0.0f;
        // warp-uniform: a chain no lane of the warp holds is not swept
        sweep[c] = __any_sync(0xffffffffu, valid[c]);
        any_sweep |= sweep[c];
    }

    for (int j0 = 0; j0 < n_prims; j0 += TILE) {
        const int nt = min(TILE, n_prims - j0);
        if (j0 > 0) {   // tables of more than a tile: the tile loads are block-wide
            __syncthreads();
            stage_planar(tile, geo, n_prims, j0, nt);
            __syncthreads();
        }
        if (!any_sweep) continue;
        for (int j = 0; j < nt; ++j) {
            const float* P = tile + PLANAR_REC * j;
            const float4 n_d = reinterpret_cast<const float4*>(P)[0];
            const float kind = reinterpret_cast<const float4*>(P)[1].w;
#pragma unroll
            for (int c = 0; c < K; ++c)
                if (sweep[c])
                    planar_test<GATE>(P, n_d.x, n_d.y, n_d.z, n_d.w, kind, o[c], d[c], t_min,
                                      t_max[c], j0 + j, t_best[c], idx_best[c],
                                      alpha_best[c], beta_best[c]);
        }
    }

    if (moved) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
            if (!valid[c]) continue;
            res_t[off[c]] = t_best[c];
            res_idx[off[c]] = idx_best[c];
            if constexpr (ATTRS) {
                res_alpha[off[c]] = alpha_best[c];
                res_beta[off[c]] = beta_best[c];
            }
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < K; ++c) {
            const int s = c * THREADS + tid;
            t_best[c] = active[c] ? res_t[s] : BIG;
            idx_best[c] = active[c] ? res_idx[s] : -1;
            if constexpr (ATTRS) {
                alpha_best[c] = active[c] ? res_alpha[s] : 0.0f;
                beta_best[c] = active[c] ? res_beta[s] : 0.0f;
            }
        }
    }

    // every ray of the run, in ray order: a ray that was not swept misses
#pragma unroll
    for (int c = 0; c < K; ++c) {
        const long long i = base + c * THREADS + tid;
        if (i >= R.n) continue;
        const bool hit = idx_best[c] >= 0;
        W.t[i] = t_best[c];
        W.idx[i] = hit ? idx_best[c] : 0;
        W.hit[i] = hit ? 1 : 0;
        if constexpr (ATTRS)
            planar_attrs<N_ATTR>(W, R.n, i, geo, con, n_prims, idx_best[c], alpha_best[c],
                                 beta_best[c]);
    }
}

// A thread's SPHERE_K rays are base + k * THREADS, so each load and store of
// the rays stays coalesced.
template <bool ATTRS>
__global__ void __launch_bounds__(THREADS)
sphere_kernel(const float* __restrict__ geo, const float* __restrict__ con,
              int n_prims, Rays R, float t_min, Out W) {
    __shared__ float tile[SPHERE_ROWS * TILE];
    const long long base = (long long)blockIdx.x * (THREADS * SPHERE_K) + threadIdx.x;
    float o[SPHERE_K][3], d[SPHERE_K][3], tmv[SPHERE_K], t_max[SPHERE_K];
    float a_coef[SPHERE_K], inv_a[SPHERE_K], t_best[SPHERE_K];
    int idx_best[SPHERE_K];
    bool any_active = false;
#pragma unroll
    for (int k = 0; k < SPHERE_K; ++k) {
        const long long i = base + k * THREADS;
        o[k][0] = o[k][1] = o[k][2] = 0.0f;
        d[k][0] = d[k][1] = 0.0f;
        d[k][2] = 1.0f;
        tmv[k] = 0.0f;
        t_max[k] = -1.0f;
        if (i < R.n) {
            o[k][0] = R.ox[i]; o[k][1] = R.oy[i]; o[k][2] = R.oz[i];
            d[k][0] = R.dx[i]; d[k][1] = R.dy[i]; d[k][2] = R.dz[i];
            tmv[k] = R.tm[i];
            t_max[k] = R.t_max[i];
            if (t_max[k] >= BIG) t_max[k] = BIG;
        }
        any_active |= t_max[k] >= t_min;
        a_coef[k] = d[k][0] * d[k][0] + d[k][1] * d[k][1] + d[k][2] * d[k][2];
        inv_a[k] = 1.0f / a_coef[k];
        t_best[k] = BIG;
        idx_best[k] = -1;
    }
    // block-uniform: the tile loads need every thread of the block
    const bool block_active = __syncthreads_or(any_active);
    const bool warp_active = __any_sync(0xffffffffu, any_active);

    for (int j0 = 0; block_active && j0 < n_prims; j0 += TILE) {
        const int nt = min(TILE, n_prims - j0);
        __syncthreads();
        stage<SPHERE_ROWS>(tile, geo, n_prims, j0, nt);
        __syncthreads();
        if (!warp_active) continue;
        for (int j = 0; j < nt; ++j) {
            const float cx = tile[j], cy = tile[TILE + j], cz = tile[2 * TILE + j];
            const float vx = tile[3 * TILE + j], vy = tile[4 * TILE + j];
            const float vz = tile[5 * TILE + j], r2 = tile[6 * TILE + j];
#pragma unroll
            for (int k = 0; k < SPHERE_K; ++k) {
                const float ocx = (cx + tmv[k] * vx) - o[k][0];
                const float ocy = (cy + tmv[k] * vy) - o[k][1];
                const float ocz = (cz + tmv[k] * vz) - o[k][2];
                const float h = d[k][0] * ocx + d[k][1] * ocy + d[k][2] * ocz;
                const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
                const float disc = h * h - a_coef[k] * c;
                if (!(disc >= 0.0f)) continue;
                const float sq = sqrtf(fmaxf(disc, 0.0f));
                const float r0 = (h - sq) * inv_a[k];
                const float r1 = (h + sq) * inv_a[k];
                const bool ok0 = r0 > t_min && r0 < t_max[k];
                const bool ok1 = r1 > t_min && r1 < t_max[k];
                if (!(ok0 || ok1)) continue;
                const float root = ok0 ? r0 : r1;
                if (!(root < t_best[k])) continue;
                t_best[k] = root;
                idx_best[k] = j0 + j;
            }
        }
    }

#pragma unroll
    for (int k = 0; k < SPHERE_K; ++k) {
        const long long i = base + k * THREADS;
        if (i >= R.n) continue;
        const bool hit = idx_best[k] >= 0;
        W.t[i] = t_best[k];
        W.idx[i] = hit ? idx_best[k] : 0;
        W.hit[i] = hit ? 1 : 0;
        if (ATTRS) {
            // centre at the ray's time (3) radius^2 | kindpack fuzz ior
            // colour(3) even(3) odd(3) scale (texture id): constants rows 0-13
            const long long col = hit ? idx_best[k] : 0;
            for (int a = 0; a < W.n_attr; ++a) {
                float v = 0.0f;
                if (hit) {
                    if (a < 3)
                        v = geo[(long long)a * n_prims + col] +
                            tmv[k] * geo[(long long)(a + 3) * n_prims + col];
                    else if (a == 3)
                        v = geo[6LL * n_prims + col];
                    else
                        v = con[(long long)(a - SPHERE_GEO_ATTRS) * n_prims + col];
                }
                W.attrs[(long long)a * R.n + i] = v;
            }
        }
    }
}

template <int N_ATTR>
int launch_planar(const float* geo, const float* con, int n_prims, Rays R,
                  float t_min, Out W, void* cuda_stream) {
    // one block a run of PLANAR_RUN rays, as the sphere kernels
    const long long blocks = (R.n + PLANAR_RUN - 1) / PLANAR_RUN;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // the sign gate is exact only where t_min > 0
    auto kernel = t_min > 0.0f ? planar_kernel<N_ATTR, true> : planar_kernel<N_ATTR, false>;
    kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)cuda_stream>>>(
        geo, con, n_prims, R, t_min, W);
    return (int)cudaGetLastError();
}

template <bool ATTRS>
int launch_sphere(const float* geo, const float* con, int n_prims, Rays R,
                  float t_min, Out W, void* cuda_stream) {
    // one block a run of THREADS * SPHERE_K rays: the hardware hands blocks
    // to the SMs as they free up, so no SM is left with a longer tail
    const long long blocks = (R.n + THREADS * SPHERE_K - 1) / (THREADS * SPHERE_K);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    sphere_kernel<ATTRS><<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)cuda_stream>>>(
        geo, con, n_prims, R, t_min, W);
    return (int)cudaGetLastError();
}

}  // namespace

// All four launch on the given stream, do not synchronize, allocate nothing
// and return cudaGetLastError() (0 on success).  n_prims >= 1, n_rays >= 1.
extern "C" int planar_closest_launch(
    const float* geo, int n_prims, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* t_max, long long n_rays, float t_min, float* t_out,
    int* idx_out, uint8_t* hit_out, void* cuda_stream) {
    return launch_planar<-1>(
        geo, nullptr, n_prims, Rays{ox, oy, oz, dx, dy, dz, nullptr, t_max, n_rays},
        t_min, Out{t_out, idx_out, hit_out, nullptr, 0}, cuda_stream);
}

extern "C" int sphere_closest_launch(
    const float* geo, int n_prims, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* tm, const float* t_max, long long n_rays, float t_min,
    float* t_out, int* idx_out, uint8_t* hit_out, void* cuda_stream) {
    return launch_sphere<false>(
        geo, nullptr, n_prims, Rays{ox, oy, oz, dx, dy, dz, tm, t_max, n_rays},
        t_min, Out{t_out, idx_out, hit_out, nullptr, 0}, cuda_stream);
}

// attrs [n_attr, n_rays]; planar: 12 <= n_attr <= 20, sphere: 10 <= n_attr <= 18.
extern "C" int planar_closest_attrs_launch(
    const float* geo, const float* con, int n_prims, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* t_max, long long n_rays, float t_min,
    float* t_out, int* idx_out, uint8_t* hit_out, float* attrs, int n_attr,
    void* cuda_stream) {
    if (n_attr < 12 || n_attr > PLANAR_MAX_ATTRS) return (int)cudaErrorInvalidValue;
    const Rays R{ox, oy, oz, dx, dy, dz, nullptr, t_max, n_rays};
    const Out W{t_out, idx_out, hit_out, attrs, n_attr};
    // 12 rows, a scene without a checker, unrolled (5 % under the rows counted
    // at run time on a Cornell chunk's launches; with a checker's 19 rows the
    // count at run time read the same, PERF.md section 6)
    if (n_attr == 12) return launch_planar<12>(geo, con, n_prims, R, t_min, W, cuda_stream);
    return launch_planar<0>(geo, con, n_prims, R, t_min, W, cuda_stream);
}

extern "C" int sphere_closest_attrs_launch(
    const float* geo, const float* con, int n_prims, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tm, const float* t_max, long long n_rays,
    float t_min, float* t_out, int* idx_out, uint8_t* hit_out, float* attrs,
    int n_attr, void* cuda_stream) {
    if (n_attr < 10 || n_attr > 18) return (int)cudaErrorInvalidValue;
    return launch_sphere<true>(
        geo, con, n_prims, Rays{ox, oy, oz, dx, dy, dz, tm, t_max, n_rays},
        t_min, Out{t_out, idx_out, hit_out, attrs, n_attr}, cuda_stream);
}

// Blocks of planar_kernel that an SM holds at once (the gated instantiation of
// the closest hit alone, or with 12 attribute rows), and its threads a block.
extern "C" int planar_occupancy(int attrs, int* blocks_per_sm, int* threads) {
    *threads = THREADS;
    const void* fn = attrs ? (const void*)planar_kernel<12, true>
                           : (const void*)planar_kernel<-1, true>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS, 0);
}

// Blocks of sphere_kernel (alone, or with the attributes) that an SM holds at
// once, from its registers and shared memory, and its threads a block.
// Returns a CUDA error code (0 on success).
extern "C" int sphere_occupancy(int attrs, int* blocks_per_sm, int* threads) {
    *threads = THREADS;
    const void* fn = attrs ? (const void*)sphere_kernel<true>
                           : (const void*)sphere_kernel<false>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS, 0);
}
