// Row sums in a fixed order for Hopper (sm_90a): the backward pass of a
// row gather, out[k] = sum of g[i] over the i with idx[i] == k.
//
// Not a port of a TPU kernel: on the TPU the JAX package's gathers have
// deterministic backward passes of their own.  In PyTorch, index_select's
// backward adds rows with atomics (the order of the sums, and so the last
// bits of a gradient, change from run to run), and advanced indexing's
// backward walks each run of equal indices in one thread (seconds for a
// few-row table gathered by millions of rays).  materials/textures.take_rows
// uses this kernel instead, so that every gradient the port's autograd route
// returns has the same bits on every run.
//
// The sums never touch device memory with an atomic, as in the reverse
// sweeps (wavefront_grad.cu): inside a warp the lanes that share a row are
// added by a butterfly of shuffles, whose order is fixed; lane 0 adds the
// warp's sum to the warp's own accumulator row in shared memory; the block
// adds its warps' rows in order and writes one row of partial sums; the
// wrapper adds the blocks' rows (ops/cuda_rows.py).  A block owns a fixed
// span of input rows, so the grid depends on the row count alone.  A table
// with more accumulators (rows x columns) than a block's shared memory holds
// is summed in tiles of rows, one launch a tile.
//
// What bounds it: bytes.  An input row is read once (4 bytes of index, 4 a
// column); the tables are small, and a warp's rays mostly share a row, so the
// loop over a warp's distinct rows is short.
//
// A second kernel serves tables too large for a block's shared memory (an
// environment map's texels: core/segsum.py).  Its rows come sorted by key
// (a stable sort, in torch), so each key's rows are one run of the input:
// one warp a key, each lane adding every 32nd row of the run in float64,
// then a butterfly of shuffles in a fixed order.  The order of the sums
// depends on the run's length alone, so the sums have the same bits on every
// run; no atomics, and each key is written once (0 for an empty run).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_THREAD = 8;
constexpr int BLOCK_ROWS = THREADS * ROWS_PER_THREAD;
constexpr size_t SMEM_LIMIT = 48 * 1024;
// Accumulators (table rows x columns) of one tile.
constexpr int MAX_ACC = (int)(SMEM_LIMIT / (WARPS * sizeof(float)));
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS)
row_sums_kernel(const float* __restrict__ g, const long long* __restrict__ idx,
                float* __restrict__ partial, long long n, int cols,
                long long key0, int n_keys) {
    extern __shared__ float acc[];  // [WARPS][n_keys * cols]
    const int n_acc = n_keys * cols;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int k = threadIdx.x; k < WARPS * n_acc; k += THREADS) acc[k] = 0.0f;
    __syncthreads();
    float* mine = acc + warp * n_acc;

    const long long base = (long long)blockIdx.x * BLOCK_ROWS;
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        const long long i = base + (long long)j * THREADS + threadIdx.x;
        int slot = -1;
        if (i < n) {
            const long long k = idx[i] - key0;
            if (k >= 0 && k < n_keys) slot = (int)k;
        }
        unsigned todo = __ballot_sync(FULL, slot >= 0);
        while (todo) {
            const int leader = __ffs(todo) - 1;
            const int s = __shfl_sync(FULL, slot, leader);
            const bool same = slot == s;
            for (int c = 0; c < cols; ++c) {
                float x = same ? g[i * cols + c] : 0.0f;
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    x += __shfl_xor_sync(FULL, x, off);
                // one lane owns the row: its adds are in program order
                if (lane == 0) mine[s * cols + c] += x;
            }
            todo &= ~__ballot_sync(FULL, same);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_acc; k += THREADS) {
        float sum = 0.0f;
        for (int w = 0; w < WARPS; ++w) sum += acc[w * n_acc + k];
        partial[(size_t)blockIdx.x * n_acc + k] = sum;
    }
}

// Most columns sorted_segment_sums_kernel takes.
constexpr int SEG_MAX_COLS = 16;

__global__ void __launch_bounds__(THREADS)
sorted_segment_sums_kernel(const float* __restrict__ vals,
                           const long long* __restrict__ starts,
                           float* __restrict__ out, long long n, int cols,
                           long long n_keys) {
    const int lane = threadIdx.x & 31;
    const long long n_warps = (long long)gridDim.x * (THREADS / 32);
    for (long long key = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
         key < n_keys; key += n_warps) {
        const long long s = starts[key], e = starts[key + 1];
        double acc[SEG_MAX_COLS];
#pragma unroll
        for (int c = 0; c < SEG_MAX_COLS; ++c) acc[c] = 0.0;
        for (long long r = s + lane; r < e; r += 32) {
#pragma unroll
            for (int c = 0; c < SEG_MAX_COLS; ++c)
                if (c < cols) acc[c] += (double)vals[(size_t)c * n + r];
        }
#pragma unroll
        for (int c = 0; c < SEG_MAX_COLS; ++c) {
            if (c >= cols) break;
            double x = acc[c];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                x += __shfl_xor_sync(FULL, x, off);
            if (lane == 0) out[(size_t)key * cols + c] = (float)x;
        }
    }
}

}  // namespace

extern "C" int row_sums_block_rows() { return BLOCK_ROWS; }

extern "C" int row_sums_max_acc() { return MAX_ACC; }

// g [n, cols] f32 and idx [n] i64, contiguous; rows whose index lies outside
// [key0, key0 + n_keys) are skipped.  partial [ceil(n / BLOCK_ROWS),
// n_keys * cols] is written in full.  Launches on the given stream, does not
// synchronize, allocates nothing, and returns cudaGetLastError().
extern "C" int row_sums_launch(const float* g, const long long* idx, float* partial,
                               long long n, int cols, long long key0, int n_keys,
                               void* cuda_stream) {
    if (n_keys * cols > MAX_ACC || n_keys < 1 || cols < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
    if (blocks < 1) return 0;
    const size_t smem = sizeof(float) * (size_t)WARPS * n_keys * cols;
    row_sums_kernel<<<(unsigned int)blocks, THREADS, smem, (cudaStream_t)cuda_stream>>>(
        g, idx, partial, n, cols, key0, n_keys);
    return (int)cudaGetLastError();
}

extern "C" int sorted_segment_sums_max_cols() { return SEG_MAX_COLS; }

// vals [cols, n] f32 (the rows in key order), starts [n_keys + 1] i64 (key k's
// rows are starts[k] .. starts[k + 1] - 1) in; out [n_keys, cols] f32, written
// in full.  Launches on the given stream, does not synchronize, allocates
// nothing, and returns cudaGetLastError().
extern "C" int sorted_segment_sums_launch(const float* vals, const long long* starts,
                                          float* out, long long n, int cols,
                                          long long n_keys, void* cuda_stream) {
    if (cols < 1 || cols > SEG_MAX_COLS || n_keys < 1 || n < 0)
        return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    long long blocks = (n_keys * 32 + THREADS - 1) / THREADS;
    const long long cap = (long long)sms * 16;
    if (blocks > cap) blocks = cap;
    sorted_segment_sums_kernel<<<(unsigned int)blocks, THREADS, 0,
                                 (cudaStream_t)cuda_stream>>>(vals, starts, out, n,
                                                              cols, n_keys);
    return (int)cudaGetLastError();
}
