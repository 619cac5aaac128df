// Wavefront megakernel for Hopper (sm_90a): the whole bounce loop of the
// path tracer in one kernel, one thread per ray.  Four instantiations of
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
//   wavefront_kernel<RECORD>    the forward, and per bounce the sweeps'
//       discrete outcome: the winner's kind and index, and whether the area
//       light's shadow ray was blocked.  Replaces make_kernel(rec_dec=True)
//       of the same file (launched by _call(rec_dec=True), entry point
//       trace_megakernel(record=True)).  The replay tier of the gradient
//       (render/grad.py) keeps the record and replays it differentiably.
//
// The radiance of all four is the same by construction.  The bounce loop
// itself (trace_ray and the sweeps) lives in wavefront_trace.cuh, which the
// fused gradient kernel (wavefront_grad_fused.cu) includes too.
//
// In a scene with quad lights and an importance-sampled environment the
// forward and the record also read 7 rows a bounce, the ray's environment
// sample (direction, emission, pdf), drawn outside from the ray's counter by
// an alias table (ops/cuda_wavefront.hdri_rows_for): a lambertian hit traces
// its shadow ray (capped at 3e38) and weighs it by the balance heuristic, as
// the JAX kernel's use_hdri block does; the record keeps the outcome in bit 3
// of its code byte.
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
// The record writes 5 bytes a ray and bounce (the index, and a byte of
// kind | blocked << 2), [depth, ray] with the ray innermost like the
// stash, for every bounce: zeros for those a ray never enters, so a record
// needs no length per ray.  It traces the shadow ray of every lambertian hit
// that faces the light, grazing or not (the forward skips the grazing ones,
// whose light sample counts for nothing), because the standard integrator
// records that ray's outcome too and the replay reads it.
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

#include "wavefront_trace.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(THREADS)
wavefront_kernel(Tables G, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oz,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ dz, const float* __restrict__ tm,
                 const uint32_t* __restrict__ stream, float* __restrict__ out,
                 int* __restrict__ flags_out, long long n_rays, uint32_t seed,
                 int max_depth, int tables_in_smem, Stash Z, Miss M,
                 float* __restrict__ miss_col, Record D,
                 const float* __restrict__ hdri) {
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
                        m_tp, flags, Z, D, i,
                        Hdri{hdri != nullptr ? hdri + i : nullptr, n_rays});
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            out[(0 + c) * n_rays + i] = rad[c];
            out[(3 + c) * n_rays + i] = m_dir[c];
            out[(6 + c) * n_rays + i] = m_tp[c];
        }
        flags_out[i] = flags;
        if constexpr (MODE == PRODUCT || MODE == PATHWISE) {
            float col[3] = {0.0f, 0.0f, 0.0f};
            if (flags & 1) miss_colour(M, m_dir, col);
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
           void* cuda_stream, Stash Z, Miss M, float* miss_col,
           Record D = Record{nullptr, nullptr, 0}, const float* hdri = nullptr) {
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
        n_rays, seed, max_depth, in_smem, Z, M, miss_col, D, hdri);
    return (int)cudaGetLastError();
}

}  // namespace

// All four launch on the given stream, do not synchronize, allocate nothing and
// return cudaGetLastError() (0 on success).  `hdri`: the [max_depth * 7,
// n_rays] rows of HDRI next-event estimation, or null (no environment
// sampling: a scene without quad lights or without an importance-sampled
// environment).
extern "C" int wavefront_fwd_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, const float* hdri, float* out, int* flags,
    long long n_rays, unsigned int seed, int max_depth, void* cuda_stream) {
    return launch<FWD>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights, ox,
                         oy, oz, dx, dy, dz, tm, stream, out, flags, n_rays, seed,
                         max_depth, cuda_stream, Stash{nullptr, nullptr, 0},
                         Miss{MISS_FLAT, {0.0f, 0.0f, 0.0f}}, nullptr,
                         Record{nullptr, nullptr, 0}, hdri);
}

// code and idx [max_depth, n_rays] are written in full.
extern "C" int wavefront_record_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, const float* hdri, float* out, int* flags,
    unsigned char* code, int* idx, long long n_rays, unsigned int seed,
    int max_depth, void* cuda_stream) {
    return launch<RECORD>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                          ox, oy, oz, dx, dy, dz, tm, stream, out, flags, n_rays,
                          seed, max_depth, cuda_stream, Stash{nullptr, nullptr, 0},
                          Miss{MISS_FLAT, {0.0f, 0.0f, 0.0f}}, nullptr,
                          Record{code, idx, n_rays}, hdri);
}

// miss_col [3, n_rays], stash_f [max_depth, 12, n_rays] and stash_i
// [max_depth, 3, n_rays] are written in full; miss_mode 0 flat (bg), 1 sky,
// 2 an environment (miss_col 0: the caller applies it).
extern "C" int wavefront_grad_fwd_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, float* out, int* flags, float* miss_col,
    float* stash_f, int* stash_i, long long n_rays, unsigned int seed,
    int max_depth, int miss_mode, float bg_r, float bg_g, float bg_b,
    void* cuda_stream) {
    return launch<PRODUCT>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                           ox, oy, oz, dx, dy, dz, tm, stream, out, flags, n_rays,
                           seed, max_depth, cuda_stream,
                           Stash{stash_f, stash_i, n_rays},
                           Miss{miss_mode, {bg_r, bg_g, bg_b}}, miss_col);
}

// The pathwise tier's: as above with stash_f [max_depth, 19, n_rays].
extern "C" int wavefront_grad_fwd_pathwise_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, float* out, int* flags, float* miss_col,
    float* stash_f, int* stash_i, long long n_rays, unsigned int seed,
    int max_depth, int miss_mode, float bg_r, float bg_g, float bg_b,
    void* cuda_stream) {
    return launch<PATHWISE>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                            ox, oy, oz, dx, dy, dz, tm, stream, out, flags,
                            n_rays, seed, max_depth, cuda_stream,
                            Stash{stash_f, stash_i, n_rays},
                            Miss{miss_mode, {bg_r, bg_g, bg_b}}, miss_col);
}
