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
//
// Without marble (B5b <19>), where its accumulators fit a column a lane, the
// kernel is a design of its own (wavefront_grad_rev_pathwise_tiles_kernel).
// What held the design above
// back on this card, measured on cornell-glossy's rays (PERF.md): the keyed
// sums, which loop over the keys a warp's lanes hold, a ballot and 5
// shuffles a channel each, three times a bounce (a column of sums a lane
// took a fifth off the launch), and lanes sweeping every bounce of their
// warp's longest path (the same rays in order of path length took 17 %
// less; sorted inside a tile of 128, 3 %).  The design:
//   * tiles of REV_TILE rays, one a thread, 8 tiles a block (1,024 rays, one
//     row of partial sums); each tile reads its rays' mask rows (coalesced),
//     counts the bounces each ray entered, and a stable counting sort in
//     shared memory gives slot t the tile's t-th longest ray, so a warp's
//     lanes hold rays of one length wherever the tile has them, and a lane
//     sweeps its own ray's bounces only;
//   * [n_acc, REV_TILE] floats in the 48 KB of a block (n_acc up to 93):
//     each lane adds its cotangents to its own column of accumulators, in
//     its program order (no key loop, no shuffle, no bank conflict: lane t's
//     column word of key j is at j * REV_TILE + t), and the block adds its
//     lanes' columns in a fixed order;
//   * the order of every sum depends on the ray count and the stash alone,
//     so a launch gives the same bits every run (not the warp sums' of the
//     render's order: the sums run in another order).
// Above 93 accumulators a scene without marble runs the design of the top
// (wavefront_grad_rev_pathwise_kernel<PW_F_ROWS>).

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

// B5b without marble: tiles of REV_TILE rays (see above).  LEN_KEYS sort
// keys (path lengths 0 .. LEN_KEYS - 1, longer paths share the last); after
// the [n_acc, REV_TILE] accumulators a block holds the keys' counts a warp,
// the counts of the longer keys, the tile's order and its rays' lengths.
constexpr int TILE_WARPS = REV_TILE / 32;
constexpr int TILE_RAYS_PER_THREAD = 8;
constexpr int TILE_BLOCK_RAYS = REV_TILE * TILE_RAYS_PER_THREAD;
constexpr int TILE_BLOCKS_PER_SM = 4;
constexpr int LEN_KEYS = 16;
constexpr size_t TILE_INT_BYTES = sizeof(int) * (TILE_WARPS * LEN_KEYS + LEN_KEYS + 2 * REV_TILE);

size_t tile_smem(int n_acc) { return sizeof(float) * (size_t)n_acc * REV_TILE + TILE_INT_BYTES; }

// The route of B5b <19> by its accumulators: the tiles where a column a lane
// fits, else the design of the top.
bool tile_lane_sums(int n_acc) { return tile_smem(n_acc) <= SMEM_LIMIT; }

__global__ void __launch_bounds__(REV_TILE, TILE_BLOCKS_PER_SM)
wavefront_grad_rev_pathwise_tiles_kernel(
    RevScene R, const float* __restrict__ stash_f, const int* __restrict__ stash_i,
    const float* __restrict__ g3, const float* __restrict__ miss_col,
    const float* __restrict__ lmd, const uint32_t* __restrict__ stream,
    float* __restrict__ partial, long long n_rays, uint32_t seed, int depth) {
    extern __shared__ float smem[];  // [n_acc, REV_TILE]
    const int n_acc = R.n_acc;
    const int n_floats = n_acc * REV_TILE;
    int* counts = reinterpret_cast<int*>(smem + n_floats);  // [TILE_WARPS, LEN_KEYS]
    int* above = counts + TILE_WARPS * LEN_KEYS;              // [LEN_KEYS]
    int* order = above + LEN_KEYS;                            // [REV_TILE]
    int* lens = order + REV_TILE;                             // [REV_TILE]
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    for (int j = t; j < n_floats; j += REV_TILE) smem[j] = 0.0f;
    float* acc = smem + t;
    const size_t n = (size_t)n_rays;

    for (int it = 0; it < TILE_RAYS_PER_THREAD; ++it) {
        const long long base =
            (long long)blockIdx.x * TILE_BLOCK_RAYS + (long long)it * REV_TILE;
        // the bounces ray base + t entered: its rows whose mask is not 0
        int len = 0;
        if (base + t < n_rays) {
            const int* q = stash_i + 2 * n + base + t;
            for (int k = 0; k < depth; ++k) len += q[(size_t)k * 3 * n] != 0;
        }
        const int key = len < LEN_KEYS ? len : LEN_KEYS - 1;
        __syncthreads();  // the last tile's order and counts are read
        for (int j = t; j < TILE_WARPS * LEN_KEYS; j += REV_TILE) counts[j] = 0;
        __syncthreads();
        const unsigned same = __match_any_sync(FULL_MASK, key);
        if (lane == __ffs(same) - 1) counts[warp * LEN_KEYS + key] = __popc(same);
        __syncthreads();
        if (t < LEN_KEYS) {
            int a = 0;
            for (int k = t + 1; k < LEN_KEYS; ++k)
                for (int w = 0; w < TILE_WARPS; ++w) a += counts[w * LEN_KEYS + k];
            above[t] = a;
        }
        __syncthreads();
        // stable, longest first: the longer keys, this key in lower warps,
        // then in this warp's lower lanes
        int pos = above[key] + __popc(same & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) pos += counts[w * LEN_KEYS + key];
        order[pos] = t;
        lens[pos] = len;
        __syncthreads();

        const long long i = base + order[t];
        const bool valid = i < n_rays;
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
        reverse_ray<PW_F_ROWS, false, true>(R, valid, stash_f + at, stash_i + at, n_rays,
                                             depth, g, mc, lm, sid, seed, nullptr, 0, nullptr,
                                             0, acc, lane, lens[t]);
    }

    __syncthreads();
    // a warp a key at a time: lane l adds words l, l + 32, ... of the key's
    // row, then the warp's butterfly; fixed order
    for (int j = warp; j < n_acc; j += TILE_WARPS) {
        const float* row = smem + (size_t)j * REV_TILE;
        float x = 0.0f;
#pragma unroll
        for (int m = 0; m < REV_TILE / 32; ++m) x += row[m * 32 + lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
        if (lane == 0) partial[(size_t)blockIdx.x * n_acc + j] = x;
    }
}

// B5b with marble (F_ROWS PW_F_ROWS_MARBLE), and without it above 93
// accumulators (PW_F_ROWS): the design of the top.
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

// Without marble: 1 where the kernel sums a column a lane (n_acc
// accumulators fit: the tiles), 0 where it sums a row a warp.
extern "C" int wavefront_grad_rev_pathwise_lane_sums(int n_acc) {
    return tile_lane_sums(n_acc) ? 1 : 0;
}

// Rays one block sweeps, of a stash of f_rows float rows a bounce at n_acc
// accumulators: the wrapper sizes `partial` as [ceil(n_rays / this), n_acc].
extern "C" int wavefront_grad_rev_pathwise_block_rays(int f_rows, int n_acc) {
    return f_rows == PW_F_ROWS && tile_lane_sums(n_acc) ? TILE_BLOCK_RAYS : BLOCK_RAYS;
}

// Blocks an SM holds at once (marble: the instantiation of a scene with
// marble) at n_acc accumulators, its threads a block and its shared bytes a
// block.  Returns a CUDA error code (0 on success).
extern "C" int wavefront_grad_rev_pathwise_occupancy(int marble, int n_acc, int* blocks_per_sm,
                                                     int* threads, int* smem_bytes) {
    const void* fn;
    size_t smem;
    if (!marble && tile_lane_sums(n_acc)) {
        fn = (const void*)wavefront_grad_rev_pathwise_tiles_kernel;
        smem = tile_smem(n_acc);
        *threads = REV_TILE;
    } else {
        fn = marble ? (const void*)wavefront_grad_rev_pathwise_kernel<PW_F_ROWS_MARBLE>
                    : (const void*)wavefront_grad_rev_pathwise_kernel<PW_F_ROWS>;
        smem = (size_t)WARPS * n_acc * sizeof(float);
        *threads = THREADS;
    }
    *smem_bytes = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, *threads, smem);
}

// lt [17, max(n_lights, 1)] and vt [25, max(n_vol, 1)] f32 (the tables of
// ops/cuda_wavefront.build_tables), stash_f [depth, f_rows, n_rays] f32 (f_rows
// 19, or 20 in a scene with marble: the winner's marble scale), stash_i
// [depth, 3, n_rays] i32, g3 and miss_col [3, n_rays] f32, stream [n_rays]
// u32 in; miss_mode 0 flat, 1 sky, 2 environment, with lmd [3, n_rays] f32
// the cotangent of the miss direction (null otherwise); partial
// [ceil(n_rays / block rays), n_acc] f32 out, written in full: n_col = 9 *
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
    const long long block_rays = wavefront_grad_rev_pathwise_block_rays(f_rows, n_acc);
    const long long blocks = (n_rays + block_rays - 1) / block_rays;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const RevScene R{lt, n_lights, n_lights > 0 ? n_lights : 1,
                     vt, n_vol, n_vol > 0 ? n_vol : 1, n_col, n_acc, miss_mode};
    const cudaStream_t cs = (cudaStream_t)cuda_stream;
    const size_t smem = (size_t)WARPS * n_acc * sizeof(float);
    if (f_rows == PW_F_ROWS_MARBLE)
        wavefront_grad_rev_pathwise_kernel<PW_F_ROWS_MARBLE>
            <<<(unsigned int)blocks, THREADS, smem, cs>>>(
                R, stash_f, stash_i, g3, miss_col, lmd, (const uint32_t*)stream,
                partial, n_rays, seed, depth);
    else if (tile_lane_sums(n_acc))
        wavefront_grad_rev_pathwise_tiles_kernel<<<(unsigned int)blocks, REV_TILE,
                                                   tile_smem(n_acc), cs>>>(
            R, stash_f, stash_i, g3, miss_col, lmd, (const uint32_t*)stream, partial,
            n_rays, seed, depth);
    else
        wavefront_grad_rev_pathwise_kernel<PW_F_ROWS>
            <<<(unsigned int)blocks, THREADS, smem, cs>>>(
                R, stash_f, stash_i, g3, miss_col, lmd, (const uint32_t*)stream,
                partial, n_rays, seed, depth);
    return (int)cudaGetLastError();
}
