// Closest-hit kernels of the standard integrator for Hopper (sm_90a): one
// thread a ray (four rays for the spheres), the whole primitive table swept
// per ray.  Four kernels, two templates:
//
//   planar_kernel<false>  closest hit (t, idx, hit) over all quads, triangles,
//       circles and planes.  Replaces _planar_kernel / planar_closest of the
//       JAX package's go_raytracing_tpu/ops/pallas_intersect.py.
//   sphere_kernel<false>  the same over moving spheres taken at the ray's
//       time, stable oc-form quadratic.  Replaces _sphere_kernel /
//       sphere_closest.
//   planar_kernel<true>   the planar closest hit and the winner's attributes:
//       normal, alpha, beta, kindpack, fuzz, ior, colour, planar kind and,
//       for scenes with a checker texture, even and odd colour and scale.
//       Replaces _planar_attr_kernel / planar_closest_attrs.
//   sphere_kernel<true>   the sphere closest hit and the winner's attributes:
//       centre at the ray's time, radius^2, kindpack, fuzz, ior, colour (and
//       the checker rows).  Replaces _sphere_attr_kernel / sphere_closest_attrs.
//
// The attribute kernel is the closest-hit kernel plus what it writes after the
// sweep, so each pair is one template behind a compile-time flag; the plain
// instantiations carry none of the attribute code.
//
// What bounds them on this card: a ray moves 7 or 8 input rows and 2 words and
// a byte (plus 10 to 19 attribute rows) once, 37 to 113 bytes, and does 12
// (planar) or 23 (sphere) float operations a primitive before the first
// test can reject it.  With the Cornell box's 18 quads the bytes bound the
// kernel; from about a hundred primitives on the sweep's arithmetic does.
// Built with -fmad=false, a multiply and an add are two instructions, so a
// sweep bound by operations reaches at most about half of the bound, which
// counts a fused multiply-add as two operations at 67 TFLOP/s.
//
// What the design does about it:
//   * the ray and the running winner live in registers; the table is staged
//     through shared memory in tiles of TILE primitives, so a table of any
//     size is swept (there is no limit on the primitive count) and every
//     thread of a warp reads the same word, a broadcast;
//   * the sphere sweep holds SPHERE_K = 4 rays a thread: a sphere's 7 rows
//     are read from shared memory once for 4 tests (7 loads a test before,
//     7/4 now), and the 4 independent test chains keep the SM's pipelines
//     busy (2 and 8 rays a thread measured slower on the H100);
//   * a block stages no tile when none of its rays is active, and a warp with
//     no active ray sweeps none; one block a run of rays, no grid-stride
//     loop, so the hardware evens the blocks out over the SMs;
//   * a primitive is left as soon as one test rejects it; the interior test
//     of a planar primitive and the square root of a sphere run only for
//     candidates that passed the interval test;
//   * the sweep keeps the winner's index (and, for planar primitives, its
//     alpha and beta); the winner's constants are read once after the sweep
//     (the TPU kernel selects all of them per primitive);
//   * a ray whose t_max lies below t_min (dead lanes and inactive shadow rays
//     come in with t_max = -1) can hit nothing: the planar sweep skips it, the
//     sphere sweep tests it with its warp (no root lies in (t_min, t_max));
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
constexpr int BLOCKS_PER_SM = 16;
constexpr int TILE = 128;          // primitives staged at a time
constexpr int SPHERE_K = 4;        // rays a thread of the sphere sweep
constexpr int PLANAR_ROWS = 15;
constexpr int SPHERE_ROWS = 7;
constexpr int PLANAR_GEO_ATTRS = 5;   // normal(3) alpha beta
constexpr int PLANAR_KIND_ATTR = 11;  // after 6 constants
constexpr int SPHERE_GEO_ATTRS = 4;   // centre(3) radius^2

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

template <bool ATTRS>
__global__ void __launch_bounds__(THREADS)
planar_kernel(const float* __restrict__ geo, const float* __restrict__ con,
              int n_prims, Rays R, float t_min, Out W) {
    __shared__ float tile[PLANAR_ROWS * TILE];
    const long long step = (long long)gridDim.x * blockDim.x;
    // every thread of a block takes the same number of turns: the tile
    // loads are block-wide
    for (long long base = (long long)blockIdx.x * blockDim.x; base < R.n;
         base += step) {
        const long long i = base + threadIdx.x;
        const bool live = i < R.n;
        float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
        float t_max = -1.0f;
        if (live) {
            o[0] = R.ox[i]; o[1] = R.oy[i]; o[2] = R.oz[i];
            d[0] = R.dx[i]; d[1] = R.dy[i]; d[2] = R.dz[i];
            t_max = R.t_max[i];
            if (t_max >= BIG) t_max = BIG;
        }
        const bool active = live && t_max >= t_min;
        float t_best = BIG, alpha_best = 0.0f, beta_best = 0.0f;
        int idx_best = -1;

        for (int j0 = 0; j0 < n_prims; j0 += TILE) {
            const int nt = min(TILE, n_prims - j0);
            __syncthreads();
            stage<PLANAR_ROWS>(tile, geo, n_prims, j0, nt);
            __syncthreads();
            if (!active) continue;
            for (int j = 0; j < nt; ++j) {
                const float* P = tile + j;
                const float nx = P[0], ny = P[TILE], nz = P[2 * TILE];
                const float denom = d[0] * nx + d[1] * ny + d[2] * nz;
                const bool not_par = fabsf(denom) >= EPS_PARALLEL;
                const float t = (P[3 * TILE] - (o[0] * nx + o[1] * ny + o[2] * nz)) /
                                (not_par ? denom : 1.0f);
                const float kind = P[14 * TILE];
                const bool t_ok = (kind == 3.0f) ? (t > t_min && t < t_max)
                                                 : (t >= t_min && t <= t_max);
                if (!(not_par && t_ok && t < t_best)) continue;
                const float rx = o[0] + t * d[0] - P[4 * TILE];
                const float ry = o[1] + t * d[1] - P[5 * TILE];
                const float rz = o[2] + t * d[2] - P[6 * TILE];
                const float alpha = rx * P[7 * TILE] + ry * P[8 * TILE] + rz * P[9 * TILE];
                const float beta = rx * P[10 * TILE] + ry * P[11 * TILE] + rz * P[12 * TILE];
                bool interior;
                if (kind == 0.0f) {
                    interior = alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f &&
                               beta <= 1.0f;
                } else if (kind == 1.0f) {
                    interior = alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f &&
                               alpha + beta <= 1.0f;
                } else if (kind == 2.0f) {
                    interior = (rx * rx + ry * ry + rz * rz) <= P[13 * TILE];
                } else {
                    interior = kind == 3.0f;
                }
                if (!interior) continue;
                t_best = t;
                idx_best = j0 + j;
                if (ATTRS) {
                    alpha_best = alpha;
                    beta_best = beta;
                }
            }
        }

        if (!live) continue;
        const bool hit = idx_best >= 0;
        W.t[i] = t_best;
        W.idx[i] = hit ? idx_best : 0;
        W.hit[i] = hit ? 1 : 0;
        if (ATTRS) {
            // normal(3) alpha beta | kindpack fuzz ior colour(3) | planar kind
            // | even(3) odd(3) scale (texture id): constants rows 0-5, 6-13
            const long long col = hit ? idx_best : 0;
            for (int k = 0; k < W.n_attr; ++k) {
                float v = 0.0f;
                if (hit) {
                    if (k < 3) v = geo[(long long)k * n_prims + col];
                    else if (k == 3) v = alpha_best;
                    else if (k == 4) v = beta_best;
                    else if (k < PLANAR_KIND_ATTR)
                        v = con[(long long)(k - PLANAR_GEO_ATTRS) * n_prims + col];
                    else if (k == PLANAR_KIND_ATTR)
                        v = geo[14LL * n_prims + col];
                    else
                        v = con[(long long)(k - PLANAR_KIND_ATTR - 1 + 6) * n_prims + col];
                }
                W.attrs[(long long)k * R.n + i] = v;
            }
        }
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

int grid_size(long long n_rays, unsigned int* blocks_out) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    long long blocks = (n_rays + THREADS - 1) / THREADS;
    const long long cap = (long long)sms * BLOCKS_PER_SM;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    *blocks_out = (unsigned int)blocks;
    return 0;
}

template <bool ATTRS>
int launch_planar(const float* geo, const float* con, int n_prims, Rays R,
                  float t_min, Out W, void* cuda_stream) {
    unsigned int blocks = 1;
    const int err = grid_size(R.n, &blocks);
    if (err != 0) return err;
    planar_kernel<ATTRS><<<blocks, THREADS, 0, (cudaStream_t)cuda_stream>>>(
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
    return launch_planar<false>(
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
    if (n_attr < 12 || n_attr > 20) return (int)cudaErrorInvalidValue;
    return launch_planar<true>(
        geo, con, n_prims, Rays{ox, oy, oz, dx, dy, dz, nullptr, t_max, n_rays},
        t_min, Out{t_out, idx_out, hit_out, attrs, n_attr}, cuda_stream);
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

// Blocks of sphere_kernel (alone, or with the attributes) that an SM holds at
// once, from its registers and shared memory, and its threads a block.
// Returns a CUDA error code (0 on success).
extern "C" int sphere_occupancy(int attrs, int* blocks_per_sm, int* threads) {
    *threads = THREADS;
    const void* fn = attrs ? (const void*)sphere_kernel<true>
                           : (const void*)sphere_kernel<false>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS, 0);
}
