// Fused pathwise gradient kernel for Hopper (sm_90a): a chunk's forward and
// reverse sweep in one launch, one thread per ray, the stash in the thread's
// own local memory.
//
// Replaces: make_kernel(grad_mode=True, pathwise=True, use_hdri=True,
// miss_cfg=("stream",)) in the JAX package's
// go_raytracing_tpu/ops/pallas_wavefront.py (launched by _call_grad through
// pl.pallas_call, entry point grad_megakernel), its marble block included
// (two instantiations: a stash of 19 float rows a bounce, and of 22 in a
// scene with marble, whose reverse sweep adds dmarble/dp).  Its use: scenes
// with an HDRI environment and quad lights, whose lambertian hits sample the
// environment as well as a light (HDRI next-event estimation).  Those
// scenes never take the two-phase route (stash-writing forward, then reverse
// sweep): the environment's texel cotangents of every bounce come out of the
// reverse sweep here, as `eout` rows, and are summed per texel outside the
// kernel (core/segsum.py).
//
// Per ray the thread
//   * runs the pathwise gradient forward (wavefront_trace.cuh, the bounce
//     loop of wavefront_kernel<PATHWISE>, with the HDRI rows, in its FUSED
//     modes) and writes its stash rows (19 or 22 float + 3 int a bounce) for
//     the bounces it enters into a local array: the radiance is the forward
//     kernel's with the same HDRI rows, bit for bit;
//   * adds the miss term: the per-ray environment colour mc (or the sky or
//     the background), times the miss throughput;
//   * runs the pathwise reverse sweep (wavefront_reverse.cuh) over that
//     stash, with the HDRI rows, the miss colour and the cotangent of the miss
//     direction (both computed in torch from the miss records of a forward
//     launch), and writes the per-bounce texel cotangents.
//
// What bounds it: by the count, the operations of both sweeps (the marble's
// above all: 7 octaves of 8 hashed lattice corners, a square root and a
// division each) and the bytes of the inputs (18 ray and cotangent rows, 6
// environment rows, 7 HDRI rows a sampling bounce) and of the 3 eout rows a
// bounce.  What it waits for is the forward's sweeps and the reverse's
// dependent chain, as in B1 and B5b, with the stash in local memory between
// them, and what the first design lost beside that: a block of 256 threads
// of 4 rays each that held 183 to 199 registers a thread with marble, so
// one block (8 warps) an SM, which drained to the warps of its longest
// paths before the next could start; the marble evaluated twice a hit
// (marble in the forward, its gradient on the same point in the reverse);
// and every bounce after a ray's death written as an inert row and swept.
//
// The design:
//   * one ray a thread, blocks of FUSED_THREADS (128), and a register target
//     of FUSED_MIN_BLOCKS blocks an SM (16 warps, no spill; 3 blocks measured
//     slower, 5 blocks (with spills) and blocks of 64 or 256 within a few per
//     cent either way, PERF.md): a finished block is replaced at once, and no
//     block waits on another's long paths;
//   * the marble once: the forward's FUSED_MARBLE mode evaluates a marble
//     winner's value and dmarble/dp together (marble_warp<true>: both in
//     turns across the warp, as B5a takes the marble; its value has
//     marble's bits), takes the albedo from it and stashes dmarble/dp in
//     three rows of its own, which the reverse sweep reads (no marble code
//     in the sweep);
//   * no inert bounces: the forward writes the rows of the bounces the ray
//     entered only, and the sweep starts at the deepest bounce a lane of the
//     warp entered (a warp maximum, so the collective adds stay collective).
//     The rows it skips had mask 0 and added nothing, so every sum is added
//     in the order it was; eout rows of bounces not entered are zeros.
//   * Local arrays sized by one compile-time depth cap, FUSED_MAX_DEPTH (50,
//     the JAX package's GRAD_DEPTH_MAX).  A thread touches only the rows of
//     the bounces it entered, and local memory is interleaved by thread, so
//     a shallow path moves the same bytes as it would with a smaller cap.
//   * The sums are those of wavefront_grad_pathwise.cu: warp butterflies in a
//     fixed order, one accumulator row a warp in shared memory, one row of
//     partial sums a block, added in the wrapper in a fixed order (the same
//     bits every launch; a block shape other than the first design's adds the
//     partial rows in another grouping).  The scene tables sit in shared
//     memory after the accumulators when both fit in 48 KB, else in device
//     memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_trace.cuh"
#include "wavefront_reverse.cuh"

namespace {

constexpr int FUSED_THREADS = 128;
constexpr int FUSED_WARPS = FUSED_THREADS / 32;
constexpr int FUSED_MIN_BLOCKS = 4;  // 16 warps an SM: at most 128 registers
constexpr size_t FUSED_SMEM_LIMIT = 48 * 1024;
constexpr int FUSED_MAX_ACC =
    (int)(FUSED_SMEM_LIMIT / (FUSED_WARPS * sizeof(float)));
constexpr int FUSED_MAX_DEPTH = 50;

template <int F_ROWS>
__global__ void __launch_bounds__(FUSED_THREADS, FUSED_MIN_BLOCKS)
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
    const long long i = (long long)blockIdx.x * FUSED_THREADS + threadIdx.x;
    const bool valid = i < n_rays;  // the warp's lanes stay together

    float sf[FUSED_MAX_DEPTH * F_ROWS];
    int si[FUSED_MAX_DEPTH * 3];
    const Stash Z{sf, si, 1};
    constexpr int MODE = F_ROWS == PW_F_ROWS_FUSED_MARBLE ? FUSED_MARBLE : FUSED;

    float g[3] = {0.0f, 0.0f, 0.0f}, mc[3] = {0.0f, 0.0f, 0.0f};
    float lmd[3] = {0.0f, 0.0f, 0.0f};
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    float tmv = 0.0f;
    uint32_t sid = 0;
    const float* hd = nullptr;
    if (valid) {
        o[0] = ox[i];
        o[1] = oy[i];
        o[2] = oz[i];
        d[0] = dx[i];
        d[1] = dy[i];
        d[2] = dz[i];
        tmv = tm[i];
        sid = stream[i];
        hd = hdri != nullptr ? hdri + i : nullptr;
    }
    float rad[3] = {0.0f, 0.0f, 0.0f};
    float m_dir[3] = {0.0f, 0.0f, 0.0f};
    float m_tp[3] = {0.0f, 0.0f, 0.0f};
    float tp[3] = {1.0f, 1.0f, 1.0f};
    // every lane runs the forward (a lane past the ray count with no ray),
    // so that the marble's turns across the warp find all 32 lanes
    int flags = valid ? FLAG_ALIVE | FLAG_ALLOW : 0;
    const int len = trace_ray<MODE>(S, o, d, tp, tmv, sid, seed, 0, depth, rad, m_dir,
                                    m_tp, flags, Z, Record{nullptr, nullptr, 0}, 0,
                                    Hdri{hd, n_rays});  // bounces entered
    if (valid) {
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
    reverse_ray<F_ROWS, true>(R, valid, sf, si, 1, depth, g, mc, lmd, sid, seed, hd,
                              n_rays, eout != nullptr && valid ? eout + i : nullptr,
                              n_rays, acc, lane, len);

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
extern "C" int wavefront_grad_fused_block_rays() { return FUSED_THREADS; }

// Deepest path the kernel takes.
extern "C" int wavefront_grad_fused_max_depth() { return FUSED_MAX_DEPTH; }

// The tables of ops/cuda_wavefront.build_tables and the rays (as
// wavefront_fwd_launch), g3 [3, n_rays] f32 the cotangent of the radiance,
// env_rows [6, n_rays] f32 (miss_mode 2: the per-ray miss colour and the
// cotangent of the miss direction; null otherwise), hdri [depth * 7,
// n_rays] f32 or null; out: rad [3, n_rays] f32 (the radiance with the miss
// term), eout [depth * 3, n_rays] f32 (with hdri, else null: the cotangent of
// each bounce's environment sample's texel), partial [ceil(n_rays /
// FUSED_THREADS), n_acc] f32, all written in full; noise: the scene has
// marble textures (the stash keeps their derivative by the hit point).
// Launches on the given stream, does not synchronize, allocates nothing.  Returns
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
    int n_acc, int noise, void* cuda_stream) {
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
    const long long blocks = (n_rays + FUSED_THREADS - 1) / FUSED_THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const Miss M{miss_mode, {bg_r, bg_g, bg_b}};
    if (noise)
        wavefront_grad_fused_kernel<PW_F_ROWS_FUSED_MARBLE>
            <<<(unsigned int)blocks, FUSED_THREADS, smem, (cudaStream_t)cuda_stream>>>(
                G, ox, oy, oz, dx, dy, dz, tm, (const uint32_t*)stream, g3, env_rows,
                hdri, M, rad, eout, partial, n_rays, seed, depth, n_col, n_acc, in_smem);
    else
        wavefront_grad_fused_kernel<PW_F_ROWS>
            <<<(unsigned int)blocks, FUSED_THREADS, smem, (cudaStream_t)cuda_stream>>>(
                G, ox, oy, oz, dx, dy, dz, tm, (const uint32_t*)stream, g3, env_rows,
                hdri, M, rad, eout, partial, n_rays, seed, depth, n_col, n_acc, in_smem);
    return (int)cudaGetLastError();
}

// Blocks an SM holds at once of the fused kernel (marble: its instantiation
// of a scene with marble) with `smem_bytes` of shared memory a block (the
// accumulators and the tables a launch stages), from its registers, and its
// threads a block.  Returns a CUDA error code (0 on success).
extern "C" int wavefront_grad_fused_occupancy(int marble, int smem_bytes,
                                              int* blocks_per_sm, int* threads) {
    *threads = FUSED_THREADS;
    const void* fn =
        marble ? (const void*)wavefront_grad_fused_kernel<PW_F_ROWS_FUSED_MARBLE>
               : (const void*)wavefront_grad_fused_kernel<PW_F_ROWS>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                              FUSED_THREADS,
                                                              (size_t)smem_bytes);
}
