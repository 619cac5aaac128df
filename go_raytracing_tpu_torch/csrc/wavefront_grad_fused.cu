// Fused pathwise gradient kernel for Hopper (sm_90a): a chunk's forward and
// reverse sweep in one launch, one thread per ray, the stash in the thread's
// own local memory.
//
// Replaces: make_kernel(grad_mode=True, pathwise=True, use_hdri=True,
// miss_cfg=("stream",)) in the JAX package's
// go_raytracing_tpu/ops/pallas_wavefront.py (launched by _call_grad through
// pl.pallas_call, entry point grad_megakernel), without its marble block.
// Its use: scenes with an HDRI environment and quad lights, whose lambertian
// hits sample the environment as well as a light (HDRI next-event
// estimation).  Those scenes never take the two-phase route (stash-writing
// forward, then reverse sweep): the environment's texel cotangents of every
// bounce come out of the reverse sweep here, as `eout` rows, and are summed
// per texel outside the kernel (core/segsum.py).
//
// Per ray the thread
//   * runs the pathwise gradient forward (wavefront_trace.cuh, the bounce
//     loop of wavefront_kernel<PATHWISE>, with the HDRI rows) and writes its
//     stash rows (19 float + 3 int a bounce) into a local array: the radiance
//     is the forward kernel's with the same HDRI rows, bit for bit;
//   * adds the miss term: the per-ray environment colour mc (or the sky or
//     the background), times the miss throughput;
//   * runs the pathwise reverse sweep (wavefront_reverse.cuh) over that
//     stash, with the HDRI rows, the miss colour and the cotangent of the miss
//     direction (both computed in torch from the miss records of a forward
//     launch), and writes the per-bounce texel cotangents.
//
// What bounds it: by the count, the bytes of the inputs (18 ray and
// cotangent rows, 6 environment rows, 7 HDRI rows a bounce) and the 3 eout
// rows a bounce; the stash, 22 rows a bounce (880 bytes a ray at depth 10),
// never leaves the SM's caches unless they overflow.  What it waits for is
// the forward's sweeps and the reverse's dependent chain, as in B1 and B5b.
// A simple design, not a fast one: the TPU kernel's block layout (a block of
// rays stepping through every bounce with masks) is not carried over.
//   * Local arrays sized by one compile-time depth cap, FUSED_MAX_DEPTH (50,
//     the JAX package's GRAD_DEPTH_MAX).  A thread touches only the first
//     `depth` bounces of them, and local memory is interleaved by thread, so
//     a shallow path moves the same bytes as it would with a smaller cap.
//   * The sums are those of wavefront_grad_pathwise.cu: warp butterflies in a
//     fixed order, one accumulator row a warp in shared memory, one row of
//     partial sums a block, added in the wrapper.  The scene tables sit in
//     shared memory after the accumulators when both fit in 48 KB, else in
//     device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_trace.cuh"
#include "wavefront_reverse.cuh"

namespace {

constexpr int FUSED_THREADS = 256;
constexpr int FUSED_WARPS = FUSED_THREADS / 32;
constexpr int FUSED_RAYS_PER_THREAD = 4;
constexpr int FUSED_BLOCK_RAYS = FUSED_THREADS * FUSED_RAYS_PER_THREAD;
constexpr size_t FUSED_SMEM_LIMIT = 48 * 1024;
constexpr int FUSED_MAX_ACC =
    (int)(FUSED_SMEM_LIMIT / (FUSED_WARPS * sizeof(float)));
constexpr int FUSED_MAX_DEPTH = 50;

__global__ void __launch_bounds__(FUSED_THREADS)
wavefront_grad_fused_kernel(Tables G, const float* __restrict__ ox,
                            const float* __restrict__ oy, const float* __restrict__ oz,
                            const float* __restrict__ dx, const float* __restrict__ dy,
                            const float* __restrict__ dz, const float* __restrict__ tm,
                            const uint32_t* __restrict__ stream,
                            const float* __restrict__ g3,
                            const float* __restrict__ env_rows,
                            const float* __restrict__ hdri, Miss M,
                            float* __restrict__ rad_out, float* __restrict__ eout,
                            float* __restrict__ partial, long long n_rays,
                            uint32_t seed, int depth, int n_col, int n_acc,
                            int tables_in_smem) {
    extern __shared__ float smem[];  // [FUSED_WARPS, n_acc] then the tables
    for (int j = threadIdx.x; j < FUSED_WARPS * n_acc; j += FUSED_THREADS) smem[j] = 0.0f;
    Tables S = G;
    if (tables_in_smem) {
        const int n_pt = PT_ROWS * G.pc, n_st = ST_ROWS * G.sc;
        const int n_vt = VT_ROWS * G.vc, n_lt = LT_ROWS * G.lc;
        float* s_pt = smem + FUSED_WARPS * n_acc;
        float* s_st = s_pt + n_pt;
        float* s_vt = s_st + n_st;
        float* s_lt = s_vt + n_vt;
        for (int k = threadIdx.x; k < n_pt; k += FUSED_THREADS) s_pt[k] = G.pt[k];
        for (int k = threadIdx.x; k < n_st; k += FUSED_THREADS) s_st[k] = G.st[k];
        for (int k = threadIdx.x; k < n_vt; k += FUSED_THREADS) s_vt[k] = G.vt[k];
        for (int k = threadIdx.x; k < n_lt; k += FUSED_THREADS) s_lt[k] = G.lt[k];
        S.pt = s_pt;
        S.st = s_st;
        S.vt = s_vt;
        S.lt = s_lt;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    float* acc = smem + (threadIdx.x >> 5) * n_acc;
    const size_t n = (size_t)n_rays;
    const RevScene R{S.lt, S.n_lights, S.lc, S.vt, S.n_vol, S.vc, n_col, n_acc,
                     M.mode};
    const long long base = (long long)blockIdx.x * FUSED_BLOCK_RAYS + threadIdx.x;

    float sf[FUSED_MAX_DEPTH * PW_F_ROWS];
    int si[FUSED_MAX_DEPTH * 3];
    const Stash Z{sf, si, 1};

    for (int it = 0; it < FUSED_RAYS_PER_THREAD; ++it) {
        const long long i = base + (long long)it * FUSED_THREADS;
        const bool valid = i < n_rays;  // the warp's lanes stay together
        float g[3] = {0.0f, 0.0f, 0.0f}, mc[3] = {0.0f, 0.0f, 0.0f};
        float lmd[3] = {0.0f, 0.0f, 0.0f};
        uint32_t sid = 0;
        const float* hd = nullptr;
        if (valid) {
            float o[3] = {ox[i], oy[i], oz[i]};
            float d[3] = {dx[i], dy[i], dz[i]};
            float rad[3] = {0.0f, 0.0f, 0.0f};
            float m_dir[3] = {0.0f, 0.0f, 0.0f};
            float m_tp[3] = {0.0f, 0.0f, 0.0f};
            int flags;
            sid = stream[i];
            hd = hdri != nullptr ? hdri + i : nullptr;
            trace_ray<PATHWISE>(S, o, d, tm[i], sid, seed, depth, rad, m_dir, m_tp,
                                flags, Z, Record{nullptr, nullptr, 0}, 0,
                                Hdri{hd, n_rays});
            if (flags & 1) {
                if (M.mode == MISS_STREAM) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) mc[c] = env_rows[c * n + i];
                } else {
                    miss_colour(M, m_dir, mc);
                }
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                rad_out[c * n + i] = rad[c] + m_tp[c] * mc[c];
                g[c] = g3[c * n + i];
                if (M.mode == MISS_STREAM) lmd[c] = env_rows[(3 + c) * n + i];
            }
        }
        // an invalid lane reads no stash (mask 0 at every bounce)
        reverse_ray(R, valid, sf, si, 1, depth, g, mc, lmd, sid, seed, hd, n_rays,
                    eout != nullptr && valid ? eout + i : nullptr, n_rays, acc, lane);
    }

    __syncthreads();
    for (int j = threadIdx.x; j < n_acc; j += FUSED_THREADS) {
        float x = 0.0f;
#pragma unroll
        for (int w = 0; w < FUSED_WARPS; ++w) x += smem[w * n_acc + j];
        partial[(size_t)blockIdx.x * n_acc + j] = x;
    }
}

}  // namespace

// Rays one block traces: the wrapper sizes `partial` as
// [ceil(n_rays / this), n_acc].
extern "C" int wavefront_grad_fused_block_rays() { return FUSED_BLOCK_RAYS; }

// Deepest path the kernel takes.
extern "C" int wavefront_grad_fused_max_depth() { return FUSED_MAX_DEPTH; }

// The tables of ops/cuda_wavefront.build_tables and the rays (as
// wavefront_fwd_launch), g3 [3, n_rays] f32 the cotangent of the radiance,
// env_rows [6, n_rays] f32 (miss_mode 2: the per-ray miss colour and the
// cotangent of the miss direction; null otherwise), hdri [depth * 7,
// n_rays] f32 or null; out: rad [3, n_rays] f32 (the radiance with the miss
// term), eout [depth * 3, n_rays] f32 (with hdri, else null: the cotangent of
// each bounce's environment sample's texel), partial [ceil(n_rays /
// FUSED_BLOCK_RAYS), n_acc] f32, all written in full.  Launches on the given
// stream, does not synchronize, allocates nothing.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for sizes the
// kernel does not take.
extern "C" int wavefront_grad_fused_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, const float* g3, const float* env_rows, const float* hdri,
    int miss_mode, float bg_r, float bg_g, float bg_b, float* rad, float* eout,
    float* partial, long long n_rays, unsigned int seed, int depth, int n_col,
    int n_acc, void* cuda_stream) {
    if (n_rays < 1 || depth < 1 || depth > FUSED_MAX_DEPTH || n_col < 0 ||
        n_acc < n_col || n_acc < 1 || n_acc > FUSED_MAX_ACC || n_lights < 0 ||
        n_lights > 8 || n_vol < 0 || n_vol > 4 || miss_mode < 0 || miss_mode > 2 ||
        (miss_mode == MISS_STREAM) != (env_rows != nullptr) ||
        (hdri != nullptr) != (eout != nullptr) || (hdri != nullptr && n_lights < 1))
        return (int)cudaErrorInvalidValue;
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
    const size_t acc_bytes = sizeof(float) * (size_t)FUSED_WARPS * n_acc;
    const size_t table_bytes =
        sizeof(float) * ((size_t)PT_ROWS * G.pc + (size_t)ST_ROWS * G.sc +
                         (size_t)VT_ROWS * G.vc + (size_t)LT_ROWS * G.lc);
    const int in_smem = acc_bytes + table_bytes <= FUSED_SMEM_LIMIT;
    const size_t smem = acc_bytes + (in_smem ? table_bytes : 0);
    const long long blocks = (n_rays + FUSED_BLOCK_RAYS - 1) / FUSED_BLOCK_RAYS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const Miss M{miss_mode, {bg_r, bg_g, bg_b}};
    wavefront_grad_fused_kernel<<<(unsigned int)blocks, FUSED_THREADS, smem,
                                  (cudaStream_t)cuda_stream>>>(
        G, ox, oy, oz, dx, dy, dz, tm, (const uint32_t*)stream, g3, env_rows, hdri, M,
        rad, eout, partial, n_rays, seed, depth, n_col, n_acc, in_smem);
    return (int)cudaGetLastError();
}
