// Wavefront megakernel for Hopper (sm_90a): the whole bounce loop of the
// path tracer in one kernel, one thread per ray.  Five modes of one
// template, and the resumable kernel (wavefront_resume_kernel, below); the
// forward, the record and the resumable kernel each have a culled
// instantiation for scenes with sphere segments (CULL, below), and the
// forward and the resumable kernel their own kernels for scenes without
// (forward_brute_kernel, resume_brute_kernel, below):
//
//   wavefront_kernel<FWD>       the forward render (forward_brute_kernel
//       below SPH_CULL_MIN spheres).  Replaces the forward
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
//       make_kernel(grad_mode=True, pathwise=True, phase="fwd"); in a
//       scene with marble wavefront_kernel<PATHWISE_MARBLE>, the same with
//       a 20th row, the winner's marble scale (mask bit 8192 marks a marble
//       winner in both).  It stores no NEE rows: the reverse sweep
//       recomputes that chain, and of the shadow sweep only the outcome is
//       kept, as a mask bit.
//   wavefront_kernel<RECORD>    the forward, and per bounce the sweeps'
//       discrete outcome: the winner's kind and index, and whether the area
//       light's shadow ray was blocked.  Replaces make_kernel(rec_dec=True)
//       of the same file (launched by _call(rec_dec=True), entry point
//       trace_megakernel(record=True)).  The replay tier of the gradient
//       (render/grad.py) keeps the record and replays it differentiably.
//
// The radiance of all five is the same by construction.  The bounce loop
// itself (trace_ray and the sweeps) lives in wavefront_trace.cuh, which the
// fused gradient kernel (wavefront_grad_fused.cu) includes too.
//
// Marble textures are evaluated in the bounce loop (wf::marble in
// wavefront_common.cuh, the in-kernel marble of the JAX kernel's has_noise
// branch): 7 octaves of 8 lattice corners, each a PCG3D hash, a normalized
// gradient and a dot product, about 3,300 operations a marble hit, so a
// scene of marble surfaces (perlin: one sphere, one plane) is bound by the
// marble's arithmetic, not by its sweeps.  On the product tier a marble
// winner's albedo slot is the null slot; the pathwise forward also stashes
// the winner's marble scale for the reverse sweep's dmarble/dp.
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
// What held the record back on this card, measured on `random` (363
// spheres, PERF.md): the sphere sweep itself, every sphere's quadratic for
// every ray-bounce and shadow ray in one dependent chain, some 8,400
// counted operations against 60 of shading.  The forward (B1) and the
// resumable kernel (B11) run the same sweep on the same scenes.  In a scene
// of SPH_CULL_MIN spheres and more all three sweep them culled, as the JAX
// kernel does (sphere_sweep_culled, wavefront_trace.cuh): the spheres in
// spatial order, in segments under a box each and the segments in groups
// under a box each (ops/cuda_wavefront.build_tables; very large spheres
// alone), a group's segment boxes tested only by the rays that reach the
// group's box, a segment swept only by the rays that reach its box, padded
// for the ray, within their current t; the winner is the least (t, scene
// index), so t, index and radiance are the brute sweep's bits.  The
// segment and group tables go to shared memory with the others.  Below
// SPH_CULL_MIN spheres, and in every other instantiation, the brute sweep.
//
// The forward and the resumable kernel below SPH_CULL_MIN spheres (B1 <0,
// false>, B11 <false>: forward_brute_kernel, resume_brute_kernel).  What
// held them back on this card, measured on the Cornell job's rays and on
// perlin's (PERF.md): latency, and lanes waiting on their warp's longest
// path (the same rays in order of path length took 31 % less on Cornell,
// 63 % less on perlin, whose marble is most of a bounce).  A lane that
// takes the next ray of its warp's batches when its own ends measured no
// better: it mixes camera rays with bounced ones, and the camera rays'
// coherence (one branch in every lane, the sign gate's skipped divisions)
// was worth more than the waiting it saved.  The design:
//   * without marble one ray a thread at six blocks an SM (24 warps at up
//     to 85 registers, no spill; was 20 at 96) and the planar sign gate in
//     the closest-hit and both shadow sweeps (trace_ray's GATE_ALL), as B2;
//   * with marble (brute_route, its own instantiation) the grid-stride
//     loop's turns taken by whole warps, every lane in the bounce loop
//     until its warp's last ray is done, and at each bounce the marble of
//     the lanes that hit it evaluated lane by lane where many do and in
//     turns across the warp (marble_warp, 28 lanes a point) where at most
//     FWD_MARBLE_TURNS / RESUME_MARBLE_TURNS do: after the first bounce
//     few lanes of a warp are still alive, and a lane's whole marble in one
//     dependent chain was what their warp waited on;
// every output is the parent's and the plain version's, bit for bit.
//
// The gradient forward moves five times the bytes: 15 stash rows a bounce
// besides the forward's 18 and the 3 miss colour rows, 384 bytes a ray at
// depth 5 (the pathwise rows: 22 a bounce, 23 with marble), so the stash
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
// The product-chain gradient forward (B2).  What held it back on this card,
// measured on the Cornell job's rays (PERF.md): not its bytes (its stores
// are 5 % of the launch) but latency: a warp waits on dependent divides and
// hashes, and on its lanes' longest path (the same rays in order of path
// length took 31 % less).  B5a's tiles a bounce at a time took 10 % more
// here: a block's bounce lasts as long as its slowest warp whatever the
// compaction saves, and half of Cornell's rays leave the box at once, in
// whole warps.  The design keeps one ray a thread and hides the latency
// with warps: six blocks an SM (24 warps at 80 registers, was 16 at 114;
// a few spilled words are cheaper than the warps they buy), and the planar
// sweeps' sign gate in the closest-hit and the shadow sweeps.  A scene with
// marble takes an instantiation of its own at the registers the compiler
// chooses: at 80 the marble's 56 hashed corners spill, and perlin's chunk
// took 12 % more than the parent's (PERF.md).
//
// The pathwise gradient forward of a scene with marble (B5a <4>).  What
// held it back on this card, measured (PERF.md): the marble itself, half
// the launch on marble-glossy: one lane a ray runs 56 hashed lattice
// corners in one dependent chain wherever one lane of its warp hits
// marble, and after the first bounce that is 2 to 8 lanes of a warp.  The
// design, behind `if constexpr` so that the other instantiations compile
// as before:
//   * the marble across the warp (marble_warp, wavefront_common.cuh): the
//     lanes of a warp take the same turns of the grid-stride loop and stay
//     in the bounce loop until its last ray is done, and at each bounce the
//     warp takes the marble points of its lanes one at a time, 28 lanes
//     evaluating a point's 56 corners together, added in the marble's own
//     order, so every stash row keeps its bits;
//   * four blocks an SM as its register target (16 warps, no spill).
// The pathwise gradient forward without marble (B5a <2>).  What held it
// back on this card, measured (PERF.md): a third of the launch went to
// lanes waiting on their warp's longest path (the same rays in order of
// their path length took 31 % less), a fifth to the stash's stores, 9 % to
// the planar sweeps' divisions; a register target measured nothing.  A
// lane that takes the next ray as soon as its path ends measured 2.2 times
// slower: its stores then go to as many sectors as lanes.  The design,
// behind `if constexpr` so that the other instantiations compile as before:
//   * tiles of THREADS rays, a bounce at a time (pathwise_tiles): after each
//     bounce the block moves the rays still alive to its first slots, in
//     order, through shared memory, so a warp whose slots hold no live ray
//     skips the bounce;
//   * the block's stash rows of a bounce are set in shared memory (inert
//     rows for every slot, each live ray overwriting its own) and written
//     whole, THREADS consecutive words a row, as the one-ray-a-thread
//     loop's coalesced stores were;
//   * the planar sweeps skip the division of a candidate whose signs
//     already fail (planar_sweep's GATE).
//
// Table layouts (row-major [rows, columns], one column per primitive) are
// those of ops/cuda_wavefront.build_tables.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront_trace.cuh"

namespace {

// Blocks of THREADS an SM the instantiations are built for: B5a's with
// marble four, 16 warps at up to 128 registers with no spill (measured on
// the H100 against five and six, PERF.md); B2 six, 24 warps at up to 85
// registers (measured against no target, five, seven and eight, PERF.md),
// and in a scene with marble PRODUCT_MARBLE_BLOCKS_PER_SM (its own
// instantiation, wavefront_kernel<PRODUCT, false, that>);
// the culled instantiations of the forward, the record and the resumable
// kernel (CULL: a scene with segments) six, 24 warps at up to 85
// registers, which random's tables in shared memory also allow (measured
// against no target, five and, for B11, four, PERF.md); the others
// MIN_BLOCKS_UNSET, which sets no minimum and
// leaves their registers to the compiler as before (a minimum of 1 is not
// the same: it took B1 from 96 to 122).
constexpr int PW_MARBLE_BLOCKS_PER_SM = 4;
constexpr int PRODUCT_BLOCKS_PER_SM = 6;
constexpr int CULL_BLOCKS_PER_SM = 6;
constexpr int MIN_BLOCKS_UNSET = 0;
constexpr int PRODUCT_MARBLE_BLOCKS_PER_SM = MIN_BLOCKS_UNSET;

// The brute instantiations of the forward and the resumable kernel (B1
// <0, false>, B11 <false>; forward_brute_kernel, resume_brute_kernel), one
// for scenes without marble and one for scenes with it: the blocks an SM
// each is built for (measured against five and seven, and with marble
// against four to six, PERF.md), and with marble the most lanes of a warp
// whose marble it takes in turns (trace_ray's MARBLE_TURNS; measured
// against 4 to 32).
constexpr int FWD_BRUTE_BLOCKS_PER_SM = 6;
constexpr int RESUME_BRUTE_BLOCKS_PER_SM = 6;
constexpr int FWD_MARBLE_TURNS = 16;
constexpr int FWD_MARBLE_BLOCKS_PER_SM = 5;
constexpr int RESUME_MARBLE_TURNS = 12;
constexpr int RESUME_MARBLE_BLOCKS_PER_SM = 5;

// The block's copy of the scalar tables in shared memory (when they fit),
// or the tables in device memory.  SEGMENTS: the culled sweep's segment
// and group tables too (the culled instantiations).
template <bool SEGMENTS = false>
__device__ __forceinline__ Tables stage_tables(const Tables& G, int tables_in_smem,
                                               float* smem) {
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
        if constexpr (SEGMENTS) {
            if (G.n_seg > 0) {
                const int n_box = 6 * G.n_seg, n_start = G.n_seg + 1;
                const int n_gbox = 6 * G.n_grp, n_gstart = G.n_grp + 1;
                float* s_box = s_lt + n_lt;
                float* s_gbox = s_box + n_box;
                int* s_start = (int*)(s_gbox + n_gbox);
                int* s_gstart = s_start + n_start;
                short* s_order = (short*)(s_gstart + n_gstart);
                for (int k = threadIdx.x; k < n_box; k += blockDim.x) s_box[k] = G.seg_box[k];
                for (int k = threadIdx.x; k < n_gbox; k += blockDim.x)
                    s_gbox[k] = G.grp_box[k];
                for (int k = threadIdx.x; k < n_start; k += blockDim.x)
                    s_start[k] = G.seg_start[k];
                for (int k = threadIdx.x; k < n_gstart; k += blockDim.x)
                    s_gstart[k] = G.grp_start[k];
                for (int k = threadIdx.x; k < G.n_sphere; k += blockDim.x)
                    s_order[k] = G.seg_order[k];
                S.seg_box = s_box;
                S.grp_box = s_gbox;
                S.seg_start = s_start;
                S.grp_start = s_gstart;
                S.seg_order = s_order;
            }
        }
        __syncthreads();
    }
    return S;
}

// B5a without marble: a block's rows in shared memory, after its tables:
// one bounce's stash rows of its THREADS slots, and the path state that
// moves between slots (origin, direction, throughput, radiance, time,
// stream, allow, slot).
constexpr int PW_I_ROWS = 3;
// Blocks an SM B5a <2> is built for (at most 102 registers: 87, no spill;
// five blocks read within 2 % of no target, PERF.md).
constexpr int PW_BLOCKS_PER_SM = 5;
constexpr int PW_STATE_ROWS = 16;
constexpr size_t PW_BLOCK_BYTES =
    sizeof(float) * (size_t)(PW_F_ROWS + PW_I_ROWS + PW_STATE_ROWS) * THREADS +
    sizeof(int) * (THREADS / 32);

// B5a without marble: the rays in tiles of THREADS, a bounce at a time.
// Each bounce every live ray runs trace_ray over that bounce alone (its
// draws keyed on the absolute bounce, so the path is the one-ray loop's bit
// for bit) into the block's rows; a ray whose path is over writes its
// outputs with the flag rule the one-ray loop applies after it; the rows go
// out whole; the rays still alive move to the first slots.
__device__ __forceinline__ void pathwise_tiles(
    const Tables& S, float* rows, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ tm,
    const uint32_t* __restrict__ stream, float* __restrict__ out, int* __restrict__ flags_out,
    long long n_rays, uint32_t seed, int max_depth, const Stash& Z, const Miss& M,
    float* __restrict__ miss_col) {
    float* stage_f = rows;
    int* stage_i = reinterpret_cast<int*>(stage_f + PW_F_ROWS * THREADS);
    float* state = reinterpret_cast<float*>(stage_i + PW_I_ROWS * THREADS);
    int* warp_live = reinterpret_cast<int*>(state + PW_STATE_ROWS * THREADS);
    const Stash B{stage_f, stage_i, THREADS};   // one bounce's rows of the block
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    for (long long base = (long long)blockIdx.x * THREADS; base < n_rays;
         base += (long long)gridDim.x * THREADS) {
        const int len = n_rays - base < THREADS ? (int)(n_rays - base) : THREADS;
        int live_n = len, slot = t;
        float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
        float tp[3] = {1.0f, 1.0f, 1.0f}, rad[3] = {0.0f, 0.0f, 0.0f};
        float tmv = 0.0f;
        uint32_t sid = 0;
        bool allow = true;
        if (t < len) {
            const long long i = base + t;
            o[0] = ox[i];
            o[1] = oy[i];
            o[2] = oz[i];
            d[0] = dx[i];
            d[1] = dy[i];
            d[2] = dz[i];
            tmv = tm[i];
            sid = stream[i];
        }
        for (int b = 0; b < max_depth; ++b) {
            // inert rows for every slot
#pragma unroll
            for (int r = 0; r < PW_F_ROWS; ++r) stage_f[r * THREADS + t] = 0.0f;
            stage_i[t] = SLOT_NONE;
            stage_i[THREADS + t] = MSLOT_NONE;
            stage_i[2 * THREADS + t] = 0;
            __syncthreads();
            bool alive = false;
            if (t < live_n) {
                float m_dir[3] = {0.0f, 0.0f, 0.0f}, m_tp[3] = {0.0f, 0.0f, 0.0f};
                int flags = FLAG_ALIVE | (allow ? FLAG_ALLOW : 0);
                trace_ray<PATHWISE>(S, o, d, tp, tmv, sid, seed, b, b + 1, rad, m_dir, m_tp,
                                    flags, B, Record{nullptr, nullptr, 0}, slot,
                                    Hdri{nullptr, n_rays});
                alive = flags & FLAG_ALIVE;
                allow = flags & FLAG_ALLOW;
                if (!alive || b + 1 == max_depth) {
                    // the path is over: a ray that died before the last
                    // bounce would have allow set again by the next one
                    if (!alive && b + 1 < max_depth) flags |= FLAG_ALLOW;
                    const long long i = base + slot;
                    float col[3] = {0.0f, 0.0f, 0.0f};
                    if (flags & FLAG_MISSED) miss_colour(M, m_dir, col);
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        out[(0 + c) * n_rays + i] = rad[c];
                        out[(3 + c) * n_rays + i] = m_dir[c];
                        out[(6 + c) * n_rays + i] = m_tp[c];
                        miss_col[c * n_rays + i] = col[c];
                    }
                    flags_out[i] = flags;
                    alive = false;
                }
            }
            __syncthreads();
            if (t < len) {
                float* f = Z.f + (size_t)b * PW_F_ROWS * Z.n + base + t;
                int* q = Z.i + (size_t)b * PW_I_ROWS * Z.n + base + t;
#pragma unroll
                for (int r = 0; r < PW_F_ROWS; ++r) f[r * Z.n] = stage_f[r * THREADS + t];
#pragma unroll
                for (int r = 0; r < PW_I_ROWS; ++r) q[r * Z.n] = stage_i[r * THREADS + t];
            }
            if (b + 1 == max_depth) break;
            // the rays still alive to the first slots, in order
            const unsigned live = __ballot_sync(0xFFFFFFFFu, alive);
            if (lane == 0) warp_live[warp] = __popc(live);
            __syncthreads();
            int at = __popc(live & ((1u << lane) - 1u)), total = 0;
            for (int w = 0; w < THREADS / 32; ++w) {
                if (w < warp) at += warp_live[w];
                total += warp_live[w];
            }
            if (alive) {
                float* s = state + at;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    s[c * THREADS] = o[c];
                    s[(3 + c) * THREADS] = d[c];
                    s[(6 + c) * THREADS] = tp[c];
                    s[(9 + c) * THREADS] = rad[c];
                }
                s[12 * THREADS] = tmv;
                s[13 * THREADS] = __uint_as_float(sid);
                s[14 * THREADS] = allow ? 1.0f : 0.0f;
                s[15 * THREADS] = __int_as_float(slot);
            }
            __syncthreads();
            live_n = total;
            if (t < live_n) {
                const float* s = state + t;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    o[c] = s[c * THREADS];
                    d[c] = s[(3 + c) * THREADS];
                    tp[c] = s[(6 + c) * THREADS];
                    rad[c] = s[(9 + c) * THREADS];
                }
                tmv = s[12 * THREADS];
                sid = __float_as_uint(s[13 * THREADS]);
                allow = s[14 * THREADS] != 0.0f;
                slot = __float_as_int(s[15 * THREADS]);
            }
        }
        __syncthreads();   // the rows and the state are refilled by the next tile
    }
}

constexpr int kernel_min_blocks(int mode, bool cull) {
    return cull                      ? CULL_BLOCKS_PER_SM
           : mode == PATHWISE_MARBLE ? PW_MARBLE_BLOCKS_PER_SM
           : mode == PATHWISE        ? PW_BLOCKS_PER_SM
           : mode == PRODUCT         ? PRODUCT_BLOCKS_PER_SM
                                     : MIN_BLOCKS_UNSET;
}

// CULL: the culled instantiation of the forward and the record, launched
// for tables with segments (launch(); the forward has no other); the others
// sweep every sphere.
// MIN_BLOCKS: the blocks an SM it is built for (B2 in a scene with marble:
// PRODUCT_MARBLE_BLOCKS_PER_SM).
template <int MODE, bool CULL, int MIN_BLOCKS = kernel_min_blocks(MODE, CULL)>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wavefront_kernel(Tables G, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oz,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ dz, const float* __restrict__ tm,
                 const uint32_t* __restrict__ stream, float* __restrict__ out,
                 int* __restrict__ flags_out, long long n_rays, uint32_t seed,
                 int max_depth, int tables_in_smem, Stash Z, Miss M,
                 float* __restrict__ miss_col, Record D,
                 const float* __restrict__ hdri) {
    // With marble every lane of a warp takes the same turns of the
    // grid-stride loop, those past the ray count with no ray, so that the
    // marble's turns across the warp (marble_warp) find all 32 lanes.
    constexpr bool WHOLE_WARPS = MODE == PATHWISE_MARBLE;
    extern __shared__ float smem[];
    const Tables S = stage_tables<CULL>(G, tables_in_smem, smem);
    if constexpr (MODE == PATHWISE) {
        // the block's rows follow its tables (PW_BLOCK_BYTES)
        const int tables = tables_in_smem ? PT_ROWS * G.pc + ST_ROWS * G.sc + VT_ROWS * G.vc +
                                                LT_ROWS * G.lc
                                          : 0;
        pathwise_tiles(S, smem + tables, ox, oy, oz, dx, dy, dz, tm, stream, out, flags_out,
                       n_rays, seed, max_depth, Z, M, miss_col);
    } else {
        const long long step = (long long)gridDim.x * blockDim.x;
        for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
             (WHOLE_WARPS ? i - (threadIdx.x & 31) : i) < n_rays; i += step) {
            const bool valid = !WHOLE_WARPS || i < n_rays;
            float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
            float tmv = 0.0f;
            uint32_t sid = 0;
            if (valid) {
                o[0] = ox[i];
                o[1] = oy[i];
                o[2] = oz[i];
                d[0] = dx[i];
                d[1] = dy[i];
                d[2] = dz[i];
                tmv = tm[i];
                sid = stream[i];
            }
            float tp[3] = {1.0f, 1.0f, 1.0f};
            float rad[3] = {0.0f, 0.0f, 0.0f};
            float m_dir[3] = {0.0f, 0.0f, 0.0f};
            float m_tp[3] = {0.0f, 0.0f, 0.0f};
            int flags = valid ? FLAG_ALIVE | FLAG_ALLOW : 0;
            trace_ray<MODE, CULL>(S, o, d, tp, tmv, sid, seed, 0, max_depth, rad, m_dir, m_tp,
                            flags, Z, D, i,
                            Hdri{hdri != nullptr && valid ? hdri + i : nullptr, n_rays});
            if (!valid) continue;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                out[(0 + c) * n_rays + i] = rad[c];
                out[(3 + c) * n_rays + i] = m_dir[c];
                out[(6 + c) * n_rays + i] = m_tp[c];
            }
            flags_out[i] = flags;
            if constexpr (MODE == PRODUCT || MODE == PATHWISE_MARBLE) {
                float col[3] = {0.0f, 0.0f, 0.0f};
                if (flags & 1) miss_colour(M, m_dir, col);
#pragma unroll
                for (int c = 0; c < 3; ++c) miss_col[c * n_rays + i] = col[c];
            }
        }
    }
}

// The resumable kernel: bounces [b_start, b_end) of a path state carried in
// and out.  Replaces make_kernel(resume=True) of the JAX package's
// go_raytracing_tpu/ops/pallas_wavefront.py (launched by _call_resume
// through pl.pallas_call, for the 'split' and 'compact' modes of
// trace_megakernel).  The bounce loop is trace_ray's, from the state it is
// handed: a ray's radiance over [0, k) then [k, depth) is the forward
// kernel's over [0, depth), bit for bit.
//
// What bounds it: the forward's work for the bounces it runs, plus the
// state it moves, 21 rows in and 19 out (160 bytes a ray against the
// forward's 72).  One thread a ray, as the forward.  Between its two
// launches the caller moves the survivors (a sort or a partition in torch),
// so that the second launch's warps hold live rays together.
struct ResumeIn {
    const float* o[3];
    const float* d[3];
    const float* tm;
    const uint32_t* stream;
    const float* tp[3];
    const float* rad[3];
    const int* flags;
    const float* m_dir[3];
    const float* m_tp[3];
};

struct ResumeOut {
    float* rad[3];
    float* m_dir[3];
    float* m_tp[3];
    int* flags;
    float* o[3];
    float* d[3];
    float* tp[3];
};

// Launched culled (CULL, tables with segments) only; below SPH_CULL_MIN
// spheres resume_brute_kernel takes the same state.
template <bool CULL>
__global__ void __launch_bounds__(THREADS, CULL ? CULL_BLOCKS_PER_SM : MIN_BLOCKS_UNSET)
wavefront_resume_kernel(Tables G, ResumeIn I, ResumeOut O, long long n_rays,
                        uint32_t seed, int b_start, int b_end, int tables_in_smem,
                        const float* __restrict__ hdri) {
    extern __shared__ float smem[];
    const Tables S = stage_tables<CULL>(G, tables_in_smem, smem);
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_rays;
         i += step) {
        float o[3], d[3], tp[3], rad[3], m_dir[3], m_tp[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            o[c] = I.o[c][i];
            d[c] = I.d[c][i];
            tp[c] = I.tp[c][i];
            rad[c] = I.rad[c][i];
            m_dir[c] = I.m_dir[c][i];
            m_tp[c] = I.m_tp[c][i];
        }
        int flags = I.flags[i];
        trace_ray<FWD, CULL>(S, o, d, tp, I.tm[i], I.stream[i], seed, b_start, b_end, rad,
                       m_dir, m_tp, flags, Stash{nullptr, nullptr, 0},
                       Record{nullptr, nullptr, 0}, i,
                       Hdri{hdri != nullptr ? hdri + i : nullptr, n_rays});
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            O.rad[c][i] = rad[c];
            O.m_dir[c][i] = m_dir[c];
            O.m_tp[c][i] = m_tp[c];
            O.o[c][i] = o[c];
            O.d[c][i] = d[c];
            O.tp[c][i] = tp[c];
        }
        O.flags[i] = flags;
    }
}

// The forward below SPH_CULL_MIN spheres (B1 <0, false>): one ray a thread
// in a grid-stride loop, the planar sign gate in every sweep.  TURNS > 0:
// the marble across the warp (trace_ray's MARBLE_TURNS), every lane in the
// bounce loop until its warp's last ray is done, the loop's turns taken by
// whole warps (lanes past the ray count hold none).
template <int TURNS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
forward_brute_kernel(Tables G, const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ tm, const uint32_t* __restrict__ stream,
                     float* __restrict__ out, int* __restrict__ flags_out, long long n_rays,
                     uint32_t seed, int max_depth, int tables_in_smem,
                     const float* __restrict__ hdri) {
    extern __shared__ float smem[];
    const Tables S = stage_tables(G, tables_in_smem, smem);
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         (TURNS > 0 ? i - (threadIdx.x & 31) : i) < n_rays; i += step) {
        const bool valid = TURNS == 0 || i < n_rays;
        float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
        float tmv = 0.0f;
        uint32_t sid = 0;
        if (valid) {
            o[0] = ox[i];
            o[1] = oy[i];
            o[2] = oz[i];
            d[0] = dx[i];
            d[1] = dy[i];
            d[2] = dz[i];
            tmv = tm[i];
            sid = stream[i];
        }
        float tp[3] = {1.0f, 1.0f, 1.0f};
        float rad[3] = {0.0f, 0.0f, 0.0f};
        float m_dir[3] = {0.0f, 0.0f, 0.0f};
        float m_tp[3] = {0.0f, 0.0f, 0.0f};
        int flags = valid ? FLAG_ALIVE | FLAG_ALLOW : 0;
        trace_ray<FWD, false, true, TURNS>(
            S, o, d, tp, tmv, sid, seed, 0, max_depth, rad, m_dir, m_tp, flags,
            Stash{nullptr, nullptr, 0}, Record{nullptr, nullptr, 0}, i,
            Hdri{hdri != nullptr && valid ? hdri + i : nullptr, n_rays});
        if (!valid) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            out[(0 + c) * n_rays + i] = rad[c];
            out[(3 + c) * n_rays + i] = m_dir[c];
            out[(6 + c) * n_rays + i] = m_tp[c];
        }
        flags_out[i] = flags;
    }
}

// The resumable kernel below SPH_CULL_MIN spheres (B11 <false>), as
// forward_brute_kernel: bounces [b_start, b_end) of the carried state.
template <int TURNS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
resume_brute_kernel(Tables G, ResumeIn I, ResumeOut O, long long n_rays, uint32_t seed,
                    int b_start, int b_end, int tables_in_smem,
                    const float* __restrict__ hdri) {
    extern __shared__ float smem[];
    const Tables S = stage_tables(G, tables_in_smem, smem);
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         (TURNS > 0 ? i - (threadIdx.x & 31) : i) < n_rays; i += step) {
        const bool valid = TURNS == 0 || i < n_rays;
        float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
        float tp[3] = {0.0f, 0.0f, 0.0f}, rad[3] = {0.0f, 0.0f, 0.0f};
        float m_dir[3] = {0.0f, 0.0f, 0.0f}, m_tp[3] = {0.0f, 0.0f, 0.0f};
        float tmv = 0.0f;
        uint32_t sid = 0;
        int flags = 0;   // a lane past the ray count: no ray, dead
        if (valid) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                o[c] = I.o[c][i];
                d[c] = I.d[c][i];
                tp[c] = I.tp[c][i];
                rad[c] = I.rad[c][i];
                m_dir[c] = I.m_dir[c][i];
                m_tp[c] = I.m_tp[c][i];
            }
            tmv = I.tm[i];
            sid = I.stream[i];
            flags = I.flags[i];
        }
        trace_ray<FWD, false, true, TURNS>(
            S, o, d, tp, tmv, sid, seed, b_start, b_end, rad, m_dir, m_tp, flags,
            Stash{nullptr, nullptr, 0}, Record{nullptr, nullptr, 0}, i,
            Hdri{hdri != nullptr && valid ? hdri + i : nullptr, n_rays});
        if (!valid) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            O.rad[c][i] = rad[c];
            O.m_dir[c][i] = m_dir[c];
            O.m_tp[c][i] = m_tp[c];
            O.o[c][i] = o[c];
            O.d[c][i] = d[c];
            O.tp[c][i] = tp[c];
        }
        O.flags[i] = flags;
    }
}

// The brute instantiations as built: for a scene without marble and with it.
using BruteForward = void (*)(Tables, const float*, const float*, const float*, const float*,
                              const float*, const float*, const float*, const uint32_t*, float*,
                              int*, long long, uint32_t, int, int, const float*);
using BruteResume = void (*)(Tables, ResumeIn, ResumeOut, long long, uint32_t, int, int, int,
                             const float*);

BruteForward forward_brute(bool marble) {
    return marble ? forward_brute_kernel<FWD_MARBLE_TURNS, FWD_MARBLE_BLOCKS_PER_SM>
                  : forward_brute_kernel<0, FWD_BRUTE_BLOCKS_PER_SM>;
}

BruteResume resume_brute(bool marble) {
    return marble ? resume_brute_kernel<RESUME_MARBLE_TURNS, RESUME_MARBLE_BLOCKS_PER_SM>
                  : resume_brute_kernel<0, RESUME_BRUTE_BLOCKS_PER_SM>;
}

// Tables, shared memory and grid of one launch: one thread a ray, at most
// BLOCKS_PER_SM blocks an SM (a grid-stride loop takes the rest).
struct Setup {
    Tables G;
    size_t smem_bytes;  // 0: the tables stay in device memory
    unsigned int blocks;
};

// `seg`: the culled sweep's segment and group tables (segments()) of the
// forward, record and resumable kernels; nullptr for the other launches.
int setup(const float* pt, const float* st, const float* vt, const float* lt,
          int n_planar, int n_sphere, int n_vol, int n_lights, long long n_rays,
          Setup& L, const Tables* seg = nullptr) {
    Tables& G = L.G;
    if (seg != nullptr) {
        G.seg_order = seg->seg_order;
        G.seg_start = seg->seg_start;
        G.seg_box = seg->seg_box;
        G.grp_start = seg->grp_start;
        G.grp_box = seg->grp_box;
        G.n_seg = seg->n_seg;
        G.n_grp = seg->n_grp;
        G.seg_c = seg->seg_c;
        G.seg_inv_r = seg->seg_inv_r;
    }
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

    const size_t seg_bytes =
        G.n_seg > 0 ? sizeof(float) * ((size_t)7 * G.n_seg + 1 + 7 * G.n_grp + 1) +
                          sizeof(short) * n_sphere
                    : 0;
    const size_t table_bytes =
        sizeof(float) * ((size_t)PT_ROWS * G.pc + (size_t)ST_ROWS * G.sc +
                         (size_t)VT_ROWS * G.vc + (size_t)LT_ROWS * G.lc) + seg_bytes;
    L.smem_bytes = table_bytes <= SMEM_TABLE_LIMIT ? table_bytes : 0;

    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;

    long long blocks = (n_rays + THREADS - 1) / THREADS;
    const long long cap = (long long)sms * BLOCKS_PER_SM;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    L.blocks = (unsigned int)blocks;
    return 0;
}


// Shared memory of a B5a <2> block: its tables (table_bytes, 0 when they
// stay in device memory) and its rows (PW_BLOCK_BYTES), within the 48 KB a
// block gets unasked; tables that would take it past stay in device memory.
size_t pathwise_smem(size_t table_bytes, int& tables_in_smem) {
    tables_in_smem = table_bytes > 0 && table_bytes + PW_BLOCK_BYTES <= SMEM_TABLE_LIMIT;
    return (tables_in_smem ? table_bytes : 0) + PW_BLOCK_BYTES;
}

template <int MODE>
int launch(const float* pt, const float* st, const float* vt, const float* lt,
           int n_planar, int n_sphere, int n_vol, int n_lights, const float* ox,
           const float* oy, const float* oz, const float* dx, const float* dy,
           const float* dz, const float* tm, const void* stream, float* out,
           int* flags, long long n_rays, unsigned int seed, int max_depth,
           void* cuda_stream, Stash Z, Miss M, float* miss_col,
           Record D = Record{nullptr, nullptr, 0}, const float* hdri = nullptr,
           const Tables* seg = nullptr, bool marble = false) {
    Setup L;
    const int err = setup(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                          n_rays, L, seg);
    if (err != 0) return err;
    // the forward comes here with segments only (forward_brute otherwise)
    auto kernel = wavefront_kernel<MODE, MODE == FWD>;
    if constexpr (MODE == RECORD) {
        if (L.G.n_seg > 0) kernel = wavefront_kernel<MODE, true>;
    }
    if constexpr (MODE == PRODUCT) {
        if (marble) kernel = wavefront_kernel<PRODUCT, false, PRODUCT_MARBLE_BLOCKS_PER_SM>;
    }
    size_t smem = L.smem_bytes;
    int tables_in_smem = smem > 0;
    if constexpr (MODE == PATHWISE) smem = pathwise_smem(smem, tables_in_smem);
    kernel<<<L.blocks, THREADS, smem, (cudaStream_t)cuda_stream>>>(
        L.G, ox, oy, oz, dx, dy, dz, tm, (const uint32_t*)stream, out, flags,
        n_rays, seed, max_depth, tables_in_smem, Z, M, miss_col, D, hdri);
    return (int)cudaGetLastError();
}

// The culled sweep's tables as ops/cuda_wavefront.build_tables makes them:
// seg_order [n_sphere] i16, seg_start [n_seg + 1] i32, seg_box [6, n_seg]
// f32, grp_start [n_grp + 1] i32, grp_box [6, n_grp] f32, and the scale of
// the padding (seg_c, seg_inv_r); or null with n_seg and n_grp 0 (the brute
// sweep).  Returns cudaErrorInvalidValue for counts or pointers that do not
// fit together.
int segments(const short* seg_order, const int* seg_start, const float* seg_box, int n_seg,
             const int* grp_start, const float* grp_box, int n_grp, float seg_c,
             float seg_inv_r, int n_sphere, Tables& seg) {
    const bool none = n_seg == 0 && n_grp == 0;
    const bool some = n_seg > 0 && n_seg <= n_sphere && n_sphere <= 32767 && n_grp > 0 &&
                      n_grp <= n_seg &&
                      seg_order != nullptr && seg_start != nullptr && seg_box != nullptr &&
                      grp_start != nullptr && grp_box != nullptr;
    if (!(none || some)) return (int)cudaErrorInvalidValue;
    seg.seg_order = seg_order;
    seg.seg_start = seg_start;
    seg.seg_box = seg_box;
    seg.grp_start = grp_start;
    seg.grp_box = grp_box;
    seg.n_seg = n_seg;
    seg.n_grp = n_grp;
    seg.seg_c = seg_c;
    seg.seg_inv_r = seg_inv_r;
    return 0;
}

}  // namespace

// All six launch on the given stream, do not synchronize, allocate nothing and
// return cudaGetLastError() (0 on success).  `hdri`: the [max_depth * 7,
// n_rays] rows of HDRI next-event estimation, or null (no environment
// sampling: a scene without quad lights or without an importance-sampled
// environment).  The forward, the record and the resumable kernel take the
// culled sweep's tables (segments(): seg_order ... seg_inv_r), or nulls and
// zeros; the forward and the resumable kernel `marble` 1 where the scene
// has a marble texture (without segments: its brute instantiation).
extern "C" int wavefront_fwd_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, const float* hdri, const short* seg_order, const int* seg_start,
    const float* seg_box, int n_seg, const int* grp_start, const float* grp_box, int n_grp,
    float seg_c, float seg_inv_r, float* out, int* flags,
    long long n_rays, unsigned int seed, int max_depth, int marble, void* cuda_stream) {
    Tables seg;
    int err = segments(seg_order, seg_start, seg_box, n_seg, grp_start, grp_box, n_grp,
                       seg_c, seg_inv_r, n_sphere, seg);
    if (err != 0) return err;
    if (n_seg == 0) {
        Setup L;
        err = setup(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights, n_rays, L);
        if (err != 0) return err;
        const BruteForward kernel = forward_brute(marble != 0);
        kernel<<<L.blocks, THREADS, L.smem_bytes, (cudaStream_t)cuda_stream>>>(
            L.G, ox, oy, oz, dx, dy, dz, tm, (const uint32_t*)stream, out, flags, n_rays, seed,
            max_depth, L.smem_bytes > 0, hdri);
        return (int)cudaGetLastError();
    }
    return launch<FWD>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights, ox,
                         oy, oz, dx, dy, dz, tm, stream, out, flags, n_rays, seed,
                         max_depth, cuda_stream, Stash{nullptr, nullptr, 0},
                         Miss{MISS_FLAT, {0.0f, 0.0f, 0.0f}}, nullptr,
                         Record{nullptr, nullptr, 0}, hdri, &seg);
}

// code and idx [max_depth, n_rays] are written in full.
extern "C" int wavefront_record_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, const float* hdri, const short* seg_order, const int* seg_start,
    const float* seg_box, int n_seg, const int* grp_start, const float* grp_box, int n_grp,
    float seg_c, float seg_inv_r, float* out, int* flags,
    unsigned char* code, int* idx, long long n_rays, unsigned int seed,
    int max_depth, void* cuda_stream) {
    Tables seg;
    const int err = segments(seg_order, seg_start, seg_box, n_seg, grp_start, grp_box, n_grp,
                             seg_c, seg_inv_r, n_sphere, seg);
    if (err != 0) return err;
    return launch<RECORD>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                          ox, oy, oz, dx, dy, dz, tm, stream, out, flags, n_rays,
                          seed, max_depth, cuda_stream, Stash{nullptr, nullptr, 0},
                          Miss{MISS_FLAT, {0.0f, 0.0f, 0.0f}}, nullptr,
                          Record{code, idx, n_rays}, hdri, &seg);
}

// miss_col [3, n_rays], stash_f [max_depth, 12, n_rays] and stash_i
// [max_depth, 3, n_rays] are written in full; miss_mode 0 flat (bg), 1 sky,
// 2 an environment (miss_col 0: the caller applies it); marble 1 where the
// scene has a marble texture (its instantiation: the same outputs).
extern "C" int wavefront_grad_fwd_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, float* out, int* flags, float* miss_col,
    float* stash_f, int* stash_i, long long n_rays, unsigned int seed,
    int max_depth, int miss_mode, float bg_r, float bg_g, float bg_b,
    int marble, void* cuda_stream) {
    return launch<PRODUCT>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                           ox, oy, oz, dx, dy, dz, tm, stream, out, flags, n_rays,
                           seed, max_depth, cuda_stream,
                           Stash{stash_f, stash_i, n_rays},
                           Miss{miss_mode, {bg_r, bg_g, bg_b}}, miss_col,
                           Record{nullptr, nullptr, 0}, nullptr, nullptr, marble != 0);
}

// The pathwise tier's: as above with stash_f [max_depth, f_rows, n_rays],
// f_rows 19, or 20 in a scene with marble (row 19: the winner's marble scale).
extern "C" int wavefront_grad_fwd_pathwise_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights,
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tm,
    const void* stream, float* out, int* flags, float* miss_col,
    float* stash_f, int* stash_i, long long n_rays, unsigned int seed,
    int max_depth, int miss_mode, float bg_r, float bg_g, float bg_b,
    int f_rows, void* cuda_stream) {
    const Stash Z{stash_f, stash_i, n_rays};
    const Miss M{miss_mode, {bg_r, bg_g, bg_b}};
    if (f_rows == PW_F_ROWS_MARBLE)
        return launch<PATHWISE_MARBLE>(pt, st, vt, lt, n_planar, n_sphere, n_vol,
                                       n_lights, ox, oy, oz, dx, dy, dz, tm, stream,
                                       out, flags, n_rays, seed, max_depth, cuda_stream,
                                       Z, M, miss_col);
    if (f_rows != PW_F_ROWS) return (int)cudaErrorInvalidValue;
    return launch<PATHWISE>(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                            ox, oy, oz, dx, dy, dz, tm, stream, out, flags,
                            n_rays, seed, max_depth, cuda_stream, Z, M, miss_col);
}

// The resumable kernel.  `in`: the addresses of the 21 [n_rays] rows of the
// path state (origin 3, direction 3, time, stream, throughput 3, radiance 3,
// flag word, miss direction 3, miss throughput 3); `out`: those of the 19
// rows it writes (radiance 3, miss direction 3, miss throughput 3, flag word,
// origin 3, direction 3, throughput 3); both arrays live in host memory.
// `hdri`: the [(b_end - b_start) * 7, n_rays] rows of HDRI NEE, or null;
// seg_order ... seg_inv_r: the culled sweep's tables, as the forward's.
extern "C" int wavefront_resume_launch(
    const float* pt, const float* st, const float* vt, const float* lt,
    int n_planar, int n_sphere, int n_vol, int n_lights, void* const* in,
    void* const* out, const float* hdri, const short* seg_order, const int* seg_start,
    const float* seg_box, int n_seg, const int* grp_start, const float* grp_box, int n_grp,
    float seg_c, float seg_inv_r, long long n_rays, unsigned int seed,
    int b_start, int b_end, int marble, void* cuda_stream) {
    Tables seg;
    int err = segments(seg_order, seg_start, seg_box, n_seg, grp_start, grp_box, n_grp, seg_c,
                       seg_inv_r, n_sphere, seg);
    if (err != 0) return err;
    Setup L;
    err = setup(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights, n_rays, L, &seg);
    if (err != 0) return err;
    ResumeIn I;
    ResumeOut O;
    for (int c = 0; c < 3; ++c) {
        I.o[c] = (const float*)in[c];
        I.d[c] = (const float*)in[3 + c];
        I.tp[c] = (const float*)in[8 + c];
        I.rad[c] = (const float*)in[11 + c];
        I.m_dir[c] = (const float*)in[15 + c];
        I.m_tp[c] = (const float*)in[18 + c];
        O.rad[c] = (float*)out[c];
        O.m_dir[c] = (float*)out[3 + c];
        O.m_tp[c] = (float*)out[6 + c];
        O.o[c] = (float*)out[10 + c];
        O.d[c] = (float*)out[13 + c];
        O.tp[c] = (float*)out[16 + c];
    }
    I.tm = (const float*)in[6];
    I.stream = (const uint32_t*)in[7];
    I.flags = (const int*)in[14];
    O.flags = (int*)out[9];
    if (L.G.n_seg > 0) {
        wavefront_resume_kernel<true><<<L.blocks, THREADS, L.smem_bytes,
                                        (cudaStream_t)cuda_stream>>>(
            L.G, I, O, n_rays, seed, b_start, b_end, L.smem_bytes > 0, hdri);
        return (int)cudaGetLastError();
    }
    const BruteResume kernel = resume_brute(marble != 0);
    kernel<<<L.blocks, THREADS, L.smem_bytes, (cudaStream_t)cuda_stream>>>(
        L.G, I, O, n_rays, seed, b_start, b_end, L.smem_bytes > 0, hdri);
    return (int)cudaGetLastError();
}

// Blocks an SM holds at once of the pathwise gradient forward (marble: its
// instantiation of a scene with marble) with `smem_bytes` of tables in
// shared memory (and, without marble, its rows), from its registers, and
// its threads a block.  Returns a
// CUDA error code (0 on success).
extern "C" int wavefront_pathwise_occupancy(int marble, int smem_bytes,
                                            int* blocks_per_sm, int* threads) {
    *threads = THREADS;
    const void* fn = marble ? (const void*)wavefront_kernel<PATHWISE_MARBLE, false>
                            : (const void*)wavefront_kernel<PATHWISE, false>;
    int tables_in_smem = 0;
    const size_t smem = marble ? (size_t)smem_bytes : pathwise_smem(smem_bytes, tables_in_smem);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS, smem);
}

// The same for the forward, the product-chain gradient forward, the record
// and the resumable kernel: `kernel` FWD (0), PRODUCT (1), RECORD (3),
// RESUME_KERNEL, PRODUCT_MARBLE_KERNEL (B2 in a scene with marble),
// FWD_MARBLE_KERNEL or RESUME_MARBLE_KERNEL (the brute B1 and B11 of a
// scene with marble); `culled` their culled instantiations (none for
// PRODUCT and the marble ones).
constexpr int RESUME_KERNEL = 7;
constexpr int PRODUCT_MARBLE_KERNEL = 8;
constexpr int FWD_MARBLE_KERNEL = 9;
constexpr int RESUME_MARBLE_KERNEL = 10;

extern "C" int wavefront_tracing_occupancy(int kernel, int culled, int smem_bytes,
                                           int* blocks_per_sm, int* threads) {
    *threads = THREADS;
    const void* fn = nullptr;
    if (kernel == FWD)
        fn = culled ? (const void*)wavefront_kernel<FWD, true> : (const void*)forward_brute(false);
    else if (kernel == FWD_MARBLE_KERNEL && !culled)
        fn = (const void*)forward_brute(true);
    else if (kernel == PRODUCT && !culled)
        fn = (const void*)wavefront_kernel<PRODUCT, false>;
    else if (kernel == PRODUCT_MARBLE_KERNEL && !culled)
        fn = (const void*)wavefront_kernel<PRODUCT, false, PRODUCT_MARBLE_BLOCKS_PER_SM>;
    else if (kernel == RECORD)
        fn = culled ? (const void*)wavefront_kernel<RECORD, true>
                    : (const void*)wavefront_kernel<RECORD, false>;
    else if (kernel == RESUME_KERNEL)
        fn = culled ? (const void*)wavefront_resume_kernel<true> : (const void*)resume_brute(false);
    else if (kernel == RESUME_MARBLE_KERNEL && !culled)
        fn = (const void*)resume_brute(true);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS,
                                                              (size_t)smem_bytes);
}
