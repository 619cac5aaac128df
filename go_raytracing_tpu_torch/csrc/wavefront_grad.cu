// Product-chain reverse sweep for Hopper (sm_90a): the adjoint of the
// bounce loop for scenes whose scatter directions do not depend on a
// trainable parameter (lambertian, light and isotropic materials).
//
// Replaces: make_kernel(grad_mode=True, phase="rev"), product branch, in the
// JAX package's go_raytracing_tpu/ops/pallas_wavefront.py (launched by
// _call_grad_rev through pl.pallas_call, entry point grad_rev_stash).
//
// It reads what the gradient forward (wavefront.cu, wavefront_kernel<true>)
// stashed per ray and bounce, the loss cotangent g of the ray's radiance and
// the ray's miss colour, and nothing else: no tables, no random numbers.
// Per ray, from the last bounce to the first,
//
//     s_c    = alb_c*emit + alb_c*em_su_c + FIREFLY*clamped_c + miss_c*lit
//     cot_alb_c = g_c T_c (R_c*alive_next + emit + em_su_c)   -> slot
//     cot_lem_c = g_c T_c alb_su_c                            -> lslot
//     R_c    = s_c + (alive_next ? alb_c : 1) * R_c
//
// and the cotangents are summed per slot (texture x variant) and channel.
//
// What bounds it: bytes.  A ray reads 15 rows a bounce and 6 rows once, 324
// bytes at depth 5, and does a few dozen operations on them.  The design:
// one thread per ray and rows with the ray innermost, so a warp's load of
// one row is one 128-byte line.  The sums never touch device memory with an
// atomic: inside a warp the lanes that share a slot are added by a butterfly
// of shuffles, whose order is fixed; lane 0 adds the warp's sum to the warp's
// own accumulator row in shared memory; the block adds its warps' rows in
// order and writes one row of partial sums; the wrapper adds the blocks'
// rows.  A block owns a fixed span of rays, so the grid depends on the ray
// count alone and the result is the same bit for bit on every run and card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float FIREFLY = 20.0f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RAYS_PER_THREAD = 8;
constexpr int BLOCK_RAYS = THREADS * RAYS_PER_THREAD;
constexpr size_t SMEM_LIMIT = 48 * 1024;
// Most accumulators (9 a texture) a block's shared memory holds.
constexpr int MAX_ACC = (int)(SMEM_LIMIT / (WARPS * sizeof(float)));
constexpr unsigned FULL = 0xFFFFFFFFu;

// Mask bits of stash row 2 (ops/cuda_wavefront.py: MK_*)
constexpr int MK_EMIT = 1;
constexpr int MK_ALIVE_NEXT = 2;
constexpr int MK_LIT = 4;
constexpr int MK_CLAMPED = 8;  // << channel

// Adds v[0..2] of every lane with slot >= 0 to acc[slot * 3 + c].  Called by
// all 32 lanes of a warp together; acc is the warp's own row.
__device__ __forceinline__ void warp_add(float* acc, int slot, const float v[3],
                                         int lane) {
    unsigned todo = __ballot_sync(FULL, slot >= 0);
    while (todo) {
        const int leader = __ffs(todo) - 1;
        const int s = __shfl_sync(FULL, slot, leader);
        const bool mine = slot == s;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float x = mine ? v[c] : 0.0f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                x += __shfl_xor_sync(FULL, x, off);
            // one lane owns the row: its adds are in program order
            if (lane == 0) acc[s * 3 + c] += x;
        }
        todo &= ~__ballot_sync(FULL, mine);
    }
}

__global__ void __launch_bounds__(THREADS)
wavefront_grad_rev_kernel(const float* __restrict__ stash_f,
                          const int* __restrict__ stash_i,
                          const float* __restrict__ g3,
                          const float* __restrict__ miss_col,
                          float* __restrict__ partial, long long n_rays,
                          int depth, int n_acc) {
    extern __shared__ float smem[];  // [WARPS, n_acc]
    for (int j = threadIdx.x; j < WARPS * n_acc; j += THREADS) smem[j] = 0.0f;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    float* acc = smem + (threadIdx.x >> 5) * n_acc;
    const long long base = (long long)blockIdx.x * BLOCK_RAYS + threadIdx.x;
    const size_t n = (size_t)n_rays;

    for (int it = 0; it < RAYS_PER_THREAD; ++it) {
        const long long i = base + (long long)it * THREADS;
        const bool valid = i < n_rays;  // the warp's lanes stay together
        float g[3], mc[3], R[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            g[c] = valid ? g3[c * n + i] : 0.0f;
            mc[c] = valid ? miss_col[c * n + i] : 0.0f;
        }
        for (int k = depth - 1; k >= 0; --k) {
            float T[3], alb[3], em_su[3], alb_su[3];
            int slot = -3, lslot = -9, mk = 0;
            const float* f = stash_f + (size_t)k * 12 * n + i;
            const int* q = stash_i + (size_t)k * 3 * n + i;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                T[c] = valid ? f[(0 + c) * n] : 0.0f;
                alb[c] = valid ? f[(3 + c) * n] : 0.0f;
                em_su[c] = valid ? f[(6 + c) * n] : 0.0f;
                alb_su[c] = valid ? f[(9 + c) * n] : 0.0f;
            }
            if (valid) {
                slot = q[0];
                lslot = q[n];
                mk = q[2 * n];
            }
            // a slot outside the accumulator would corrupt shared memory
            if (slot * 3 + 2 >= n_acc) slot = -3;
            if (lslot * 3 + 2 >= n_acc) lslot = -9;
            const float emitf = (mk & MK_EMIT) ? 1.0f : 0.0f;
            const float alive_nf = (mk & MK_ALIVE_NEXT) ? 1.0f : 0.0f;
            const float litf = (mk & MK_LIT) ? 1.0f : 0.0f;
            float cot_alb[3], cot_lem[3], s[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float clampf = (mk & (MK_CLAMPED << c)) ? 1.0f : 0.0f;
                s[c] = alb[c] * emitf + alb[c] * em_su[c] + FIREFLY * clampf +
                       mc[c] * litf;
                const float cotb = g[c] * T[c];
                cot_alb[c] = cotb * (R[c] * alive_nf + emitf + em_su[c]);
                cot_lem[c] = cotb * alb_su[c];
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float aeff = alb[c] * alive_nf + (1.0f - alive_nf);
                R[c] = s[c] + aeff * R[c];
            }
            warp_add(acc, slot, cot_alb, lane);
            warp_add(acc, lslot, cot_lem, lane);
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
extern "C" int wavefront_grad_rev_block_rays() { return BLOCK_RAYS; }

// stash_f [depth, 12, n_rays] f32, stash_i [depth, 3, n_rays] i32, g3 and
// miss_col [3, n_rays] f32 in; partial [ceil(n_rays / BLOCK_RAYS), n_acc] f32
// out, written in full.  Launches on the given stream, does not synchronize,
// allocates nothing.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take.
extern "C" int wavefront_grad_rev_launch(
    const float* stash_f, const int* stash_i, const float* g3,
    const float* miss_col, float* partial, long long n_rays, int depth,
    int n_acc, void* cuda_stream) {
    if (n_rays < 1 || depth < 1 || n_acc < 1 || n_acc > MAX_ACC)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (n_rays + BLOCK_RAYS - 1) / BLOCK_RAYS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    wavefront_grad_rev_kernel<<<(unsigned int)blocks, THREADS,
                                (size_t)WARPS * n_acc * sizeof(float),
                                (cudaStream_t)cuda_stream>>>(
        stash_f, stash_i, g3, miss_col, partial, n_rays, depth, n_acc);
    return (int)cudaGetLastError();
}
