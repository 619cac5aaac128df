// Pathwise reverse sweep for Hopper (sm_90a): the adjoint of the bounce loop
// for scenes with metal and glass, whose scatter directions depend on
// trainable parameters (fuzz, IOR) and whose colours are also reached
// through hit positions.
//
// Replaces: make_kernel(grad_mode=True, pathwise=True, phase="rev") in the
// JAX package's go_raytracing_tpu/ops/pallas_wavefront.py (launched by
// _call_grad_rev through pl.pallas_call, entry point
// grad_rev_stash(pathwise=True)), its marble block (dmarble/dp) included:
// two instantiations, the stash's 19 float rows a bounce and the 20 of a
// scene with marble, so a scene without marble runs no code of it.  Its
// HDRI block runs only in the fused kernel (wavefront_grad_fused.cu): a
// scene with an environment and quad lights never takes the two-phase route.
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
//   * differentiates the sky colour by the miss direction, or, under an
//     environment map, adds the miss direction's cotangent, which comes in
//     as a row (miss_cfg ("stream",) of the JAX kernel);
//   * on a marble winner, adds the marble's derivative by the hit point
//     (7 octaves of the noise's analytic gradient, textures.marble_grad)
//     times the albedo's summed cotangent into the hit point's adjoint;
//   * sends the hit point's adjoint through the hit distance by the implicit
//     rule dt/do = -n / (n.d), dt/dd = t dt/do, or, for a volume, through
//     the entry slab and the free-flight length;
//   * sums the cotangents of albedo (texture slot) and emission (light slot),
//     3 channels each into 9 accumulators a texture, and of fuzz and ior into
//     2 accumulators a material.
//
// What bounds it: bytes by the count (22 rows a bounce and 7 rows once, 468
// bytes a ray at depth 5, against a few hundred operations an entered
// bounce; a marble winner adds one row and about 4,800 operations, 7
// octaves of 8 hashed corners with their gradient), but the dependent chain
// of divisions and square roots, four PCG3D hashes a bounce and the keyed
// reduction are what it waits for; see PERF.md for the measured time.
// The design: blocks of 256 threads, a thread sweeping 8 rays one after the
// other (a block's 2,048 rays give one row of partial sums), the rays of a
// warp's 32 lanes side by side, rows with the ray innermost (a warp's load
// of a row is one 128-byte line); a row a ray never entered (mask 0) is
// skipped, which changes nothing since such rows only trail and the adjoints
// are still 0 there; the tables are small and read through the cache.  With
// marble, one lane a ray held the whole warp for a lane's marble derivative
// (56 hashed corners in one dependent chain): the warp takes its marble
// lanes' points in turns, 28 lanes a point (marble_warp, wavefront_common.cuh,
// the same bits), so the partial sums are those of one lane a ray, bit for
// bit.  The sums use the scheme of wavefront_grad.cu: inside a
// warp the lanes that share a key are added by a butterfly of shuffles in a
// fixed order, lane 0 adds the warp's sum to the warp's own accumulator row
// in shared memory, the block adds its warps' rows in order and writes one
// row of partial sums, the wrapper adds the blocks' rows.  No device atomics,
// a grid that depends on the ray count alone: the same bits on every run.
// Only lanes with something to add take part in a key's loop, so a bounce
// costs one pass per distinct key present in the warp.  The per-ray sweep
// lives in wavefront_reverse.cuh, which the fused kernel shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_reverse.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RAYS_PER_THREAD = 8;
constexpr int BLOCK_RAYS = THREADS * RAYS_PER_THREAD;
constexpr size_t SMEM_LIMIT = 48 * 1024;
// Most accumulators (9 a texture + 2 a material) a block's shared memory
// holds (ops/cuda_wavefront.py: GRAD_PATHWISE_MAX_ACC).
constexpr int MAX_ACC = (int)(SMEM_LIMIT / (WARPS * sizeof(float)));

template <int F_ROWS>
__global__ void __launch_bounds__(THREADS)
wavefront_grad_rev_pathwise_kernel(
    RevScene R, const float* __restrict__ stash_f, const int* __restrict__ stash_i,
    const float* __restrict__ g3, const float* __restrict__ miss_col,
    const float* __restrict__ lmd, const uint32_t* __restrict__ stream,
    float* __restrict__ partial, long long n_rays, uint32_t seed, int depth) {
    extern __shared__ float smem[];  // [WARPS, n_acc]
    const int n_acc = R.n_acc;
    for (int j = threadIdx.x; j < WARPS * n_acc; j += THREADS) smem[j] = 0.0f;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    float* acc = smem + (threadIdx.x >> 5) * n_acc;
    const long long base = (long long)blockIdx.x * BLOCK_RAYS + threadIdx.x;
    const size_t n = (size_t)n_rays;

    for (int it = 0; it < RAYS_PER_THREAD; ++it) {
        const long long i = base + (long long)it * THREADS;
        const bool valid = i < n_rays;  // the warp's lanes stay together
        float g[3] = {0.0f, 0.0f, 0.0f}, mc[3] = {0.0f, 0.0f, 0.0f};
        float lm[3] = {0.0f, 0.0f, 0.0f};
        uint32_t sid = 0;
        const long long at = valid ? i : 0;
        if (valid) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                g[c] = g3[c * n + i];
                mc[c] = miss_col[c * n + i];
                if (lmd != nullptr) lm[c] = lmd[c * n + i];
            }
            sid = stream[i];
        }
        reverse_ray<F_ROWS>(R, valid, stash_f + at, stash_i + at, n_rays, depth, g,
                            mc, lm, sid, seed, nullptr, 0, nullptr, 0, acc, lane);
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

// Blocks an SM holds at once (marble: the instantiation of a scene with
// marble) with `smem_bytes` of accumulators a block, and its threads a
// block.  Returns a CUDA error code (0 on success).
extern "C" int wavefront_grad_rev_pathwise_occupancy(int marble, int smem_bytes,
                                                     int* blocks_per_sm, int* threads) {
    *threads = THREADS;
    const void* fn = marble ? (const void*)wavefront_grad_rev_pathwise_kernel<PW_F_ROWS_MARBLE>
                            : (const void*)wavefront_grad_rev_pathwise_kernel<PW_F_ROWS>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS,
                                                              (size_t)smem_bytes);
}

// lt [17, max(n_lights, 1)] and vt [25, max(n_vol, 1)] f32 (the tables of
// ops/cuda_wavefront.build_tables), stash_f [depth, f_rows, n_rays] f32 (f_rows
// 19, or 20 in a scene with marble: the winner's marble scale), stash_i
// [depth, 3, n_rays] i32, g3 and miss_col [3, n_rays] f32, stream [n_rays]
// u32 in; miss_mode 0 flat, 1 sky, 2 environment, with lmd [3, n_rays] f32
// the cotangent of the miss direction (null otherwise); partial
// [ceil(n_rays / BLOCK_RAYS), n_acc] f32 out, written in full: n_col = 9 *
// textures colour sums first, then (fuzz, ior) a material.  Launches on the
// given stream, does not synchronize, allocates nothing.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for sizes the
// kernel does not take.
extern "C" int wavefront_grad_rev_pathwise_launch(
    const float* lt, int n_lights, const float* vt, int n_vol,
    const float* stash_f, const int* stash_i, const float* g3,
    const float* miss_col, const float* lmd, const void* stream, float* partial,
    long long n_rays, unsigned int seed, int depth, int n_col, int n_acc,
    int miss_mode, int f_rows, void* cuda_stream) {
    if (n_rays < 1 || depth < 1 || n_col < 0 || n_acc < n_col || n_acc < 1 ||
        n_acc > MAX_ACC || n_lights < 0 || n_lights > 8 || n_vol < 0 || n_vol > 4 ||
        miss_mode < 0 || miss_mode > 2 || (miss_mode == 2) != (lmd != nullptr) ||
        (f_rows != PW_F_ROWS && f_rows != PW_F_ROWS_MARBLE))
        return (int)cudaErrorInvalidValue;
    const long long blocks = (n_rays + BLOCK_RAYS - 1) / BLOCK_RAYS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const RevScene R{lt, n_lights, n_lights > 0 ? n_lights : 1,
                     vt, n_vol, n_vol > 0 ? n_vol : 1, n_col, n_acc, miss_mode};
    const size_t smem = (size_t)WARPS * n_acc * sizeof(float);
    if (f_rows == PW_F_ROWS_MARBLE)
        wavefront_grad_rev_pathwise_kernel<PW_F_ROWS_MARBLE>
            <<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)cuda_stream>>>(
                R, stash_f, stash_i, g3, miss_col, lmd, (const uint32_t*)stream,
                partial, n_rays, seed, depth);
    else
        wavefront_grad_rev_pathwise_kernel<PW_F_ROWS>
            <<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)cuda_stream>>>(
                R, stash_f, stash_i, g3, miss_col, lmd, (const uint32_t*)stream,
                partial, n_rays, seed, depth);
    return (int)cudaGetLastError();
}
