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
// Three more kernels give the per-key sums of tables too large for a block's
// shared memory (an environment map's or an atlas's texels: core/segsum.py),
// out[k] = sum over the rows i with ids[i] == k of the row's C columns, added
// in float64, written as float32, without atomics:
//
//   segment_keep_count_kernel, segment_keep_write_kernel: a block takes a
//     fixed span of 4,096 rows, marks the rows that add something (an id in
//     [0, n_keys), not every tested column zero: dropping such a row changes
//     no sum) in a bit mask and counts them; the wrapper takes the exclusive
//     prefix of the blocks' counts; the second kernel writes the kept rows'
//     (id, row) pairs, int32, in input order.  Most rows of a chunk carry a
//     zero cotangent (of hdri-test-nee's 90 M ray-bounces, 3.9 M carry
//     one), so the sort that follows (torch.sort, stable, int32 keys) sees a
//     fraction of them.
//   segment_span_sums_kernel: a warp takes a fixed span of 512 sorted rows,
//     16 consecutive ones a lane, and reads their columns through the sort's
//     permutation and the kept rows (the gathers fused).  A lane adds its
//     rows run by run; a run that begins and ends inside its rows is
//     written; the lanes' last runs are joined by a segmented scan of
//     shuffles, so the warp's work depends on its row count, not on how long
//     a key's run is.  A key wholly inside the span is written; the span's
//     first and last run go to a carry array (two entries a span, in key
//     order), which the same kernel sums again, a level up, until one span
//     is left.
//
// The order of each key's additions depends only on the kept rows' order and
// the span size, so the sums have the same bits on every run.  What bounds
// them: bytes, the ids as the caller holds them and the C float32 columns
// read once, and the n_keys x C output.

#include <cuda_runtime.h>
#include <climits>

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

// ---- per-key sums of large tables ---------------------------------------------

constexpr int KEEP_THREADS = 256;
constexpr int KEEP_WARPS = KEEP_THREADS / 32;
constexpr int KEEP_ITEMS = 16;                            // rows a thread
constexpr int KEEP_SPAN = KEEP_THREADS * KEEP_ITEMS;      // 4,096 rows a block
constexpr int KEEP_WORDS = KEEP_SPAN / 32;                // its mask words

constexpr int SUM_WARPS = 8;                              // warps a block
constexpr int SUM_T = 16;                                 // sorted rows a lane
constexpr int SUM_SPAN = 32 * SUM_T;                      // sorted rows a warp
constexpr int SEG_MAX_COLS = 16;

// Column c of flat row i = b * R + r (r < R) at p[c * sc + b * sb + r * sr].
template <typename V>
struct Cols {
    const V* p;
    long long sc, sb, sr;
    unsigned R;
    __device__ const V* row(unsigned i) const {
        const unsigned b = i / R;
        return p + b * sb + (long long)(i - b * R) * sr;
    }
};

// One bit a row of the block's span: its id lies in [0, n_keys) and one of
// its n_test tested columns is not zero.  ids [D, R]: block (x, y) takes
// rows x * KEEP_SPAN ... of ids[y].  counts[block] = the bits set.
template <typename ID>
__global__ void __launch_bounds__(KEEP_THREADS)
segment_keep_count_kernel(const ID* __restrict__ ids, Cols<float> test, int n_test,
                          long long n_keys, unsigned* __restrict__ mask,
                          int* __restrict__ counts) {
    __shared__ int warp_count[KEEP_WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long b = blockIdx.y;
    const long long blk = b * gridDim.x + blockIdx.x;
    const long long r0 = (long long)blockIdx.x * KEEP_SPAN;
    const long long R = test.R;
    unsigned keep_bits = 0;
#pragma unroll
    for (int j = 0; j < KEEP_ITEMS; ++j) {
        const long long r = r0 + j * KEEP_THREADS + threadIdx.x;
        if (r >= R) continue;
        const long long id = (long long)ids[b * R + r];
        bool keep = id >= 0 && id < n_keys;
        if (keep) {
            const float* q = test.p + b * test.sb + r * test.sr;
            bool any = false;
            for (int c = 0; c < n_test; ++c) any |= q[c * test.sc] != 0.0f;
            keep = any;
        }
        keep_bits |= (unsigned)keep << j;
    }
    int count = 0;
#pragma unroll
    for (int j = 0; j < KEEP_ITEMS; ++j) {
        const unsigned word = __ballot_sync(FULL, keep_bits >> j & 1u);
        if (lane == 0) mask[blk * KEEP_WORDS + j * KEEP_WARPS + warp] = word;
        count += __popc(word);
    }
    if (lane == 0) warp_count[warp] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
        for (int w = 0; w < KEEP_WARPS; ++w) s += warp_count[w];
        counts[blk] = s;
    }
}

// The kept rows of the block's span, in row order, from offsets[block] on:
// kept_ids the id (int32), kept_rows the flat row b * R + r.
template <typename ID>
__global__ void __launch_bounds__(KEEP_THREADS)
segment_keep_write_kernel(const ID* __restrict__ ids, long long R,
                          const unsigned* __restrict__ mask,
                          const long long* __restrict__ offsets, int* __restrict__ kept_ids,
                          int* __restrict__ kept_rows) {
    __shared__ unsigned words[KEEP_WORDS];
    __shared__ int before[KEEP_WORDS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long b = blockIdx.y;
    const long long blk = b * gridDim.x + blockIdx.x;
    const long long r0 = (long long)blockIdx.x * KEEP_SPAN;
    if (threadIdx.x < KEEP_WORDS) words[threadIdx.x] = mask[blk * KEEP_WORDS + threadIdx.x];
    __syncthreads();
    if (warp == 0) {   // exclusive prefix of the words' bit counts, 4 words a lane
        constexpr int PER = KEEP_WORDS / 32;
        int c[PER], s = 0;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            c[q] = __popc(words[lane * PER + q]);
            s += c[q];
        }
        int incl = s;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, off);
            if (lane >= off) incl += y;
        }
        int run = incl - s;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            before[lane * PER + q] = run;
            run += c[q];
        }
    }
    __syncthreads();
    const long long base = offsets[blk];
    const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
    for (int j = 0; j < KEEP_ITEMS; ++j) {
        const int w = j * KEEP_WARPS + warp;
        const unsigned word = words[w];
        if (word >> lane & 1u) {
            const long long i = b * R + r0 + j * KEEP_THREADS + threadIdx.x;
            const long long pos = base + before[w] + __popc(word & below);
            kept_ids[pos] = (int)ids[i];
            kept_rows[pos] = (int)i;
        }
    }
}

template <int CMAX>
__device__ __forceinline__ void put(float* out, long long n_keys, int cols, int key,
                                    const double* v) {
    if (key < 0 || key >= n_keys) return;
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
        if (c < cols) out[(long long)key * cols + c] = (float)v[c];
}

// One level of the sums.  keys [n] sorted int32; sorted row j's columns at
// vals.row(perm ? rows[perm[j]] : j).  Keys outside [0, n_keys) are summed
// and never written.  carry_keys null: the last level (n <= SUM_SPAN),
// every run written to out.  Otherwise span s
// writes its first run to carry entry 2s and its last to 2s + 1 (key, sum;
// a span of one run writes (key, 0) there), carry_vals [cols, carry_n].
template <typename V, int CMAX>
__global__ void __launch_bounds__(SUM_WARPS * 32)
segment_span_sums_kernel(const int* __restrict__ keys, const long long* __restrict__ perm,
                         const int* __restrict__ rows, Cols<V> vals, int cols, long long n,
                         long long n_keys, float* __restrict__ out,
                         int* __restrict__ carry_keys, double* __restrict__ carry_vals,
                         long long carry_n) {
    const int lane = threadIdx.x & 31;
    const long long span = (long long)blockIdx.x * SUM_WARPS + (threadIdx.x >> 5);
    if (span * SUM_SPAN >= n) return;          // the warp's lanes leave together
    const long long j0 = span * SUM_SPAN + (long long)lane * SUM_T;
    const int here = (int)max(0LL, min((long long)SUM_T, n - j0));
    int key[SUM_T];
    unsigned src[SUM_T];
#pragma unroll
    for (int t = 0; t < SUM_T; ++t) {
        key[t] = INT_MAX;                      // above every key: a lane past the end
        src[t] = 0;
        if (t < here) {
            const long long j = j0 + t;
            key[t] = keys[j];
            src[t] = perm ? (unsigned)rows[perm[j]] : (unsigned)j;
        }
    }
    // the lane's rows, run by run: the first run's sum kept (head), a run
    // between the first and the last written, the last run's sum in acc
    double acc[CMAX], head[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) acc[c] = head[c] = 0.0;
    const int hk = key[0];
    int ck = hk, runs = here > 0;
#pragma unroll
    for (int t = 0; t < SUM_T; ++t) {
        if (t < here) {
            if (key[t] != ck) {
                if (runs == 1) {
#pragma unroll
                    for (int c = 0; c < CMAX; ++c) head[c] = acc[c];
                } else {
                    put<CMAX>(out, n_keys, cols, ck, acc);
                }
                ++runs;
                ck = key[t];
#pragma unroll
                for (int c = 0; c < CMAX; ++c) acc[c] = 0.0;
            }
            const V* q = vals.row(src[t]);
#pragma unroll
            for (int c = 0; c < CMAX; ++c)
                if (c < cols) acc[c] += (double)q[c * vals.sc];
        }
    }
    const bool single = runs <= 1;
    const unsigned has = __ballot_sync(FULL, here > 0);
    const int last = 31 - __clz(has);          // lane 0 always has rows
    const int first_key = __shfl_sync(FULL, hk, 0);
    const int prev_ck = __shfl_up_sync(FULL, ck, 1);
    const int next_hk = __shfl_down_sync(FULL, hk, 1);
    // segmented inclusive scan of the lanes' last runs: a lane of one run
    // continues its left neighbour's last run when their keys agree
    bool start = lane == 0 || !single || prev_ck != ck;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const bool up_start = __shfl_up_sync(FULL, start, off);
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
            if (c >= cols) break;
            const double y = __shfl_up_sync(FULL, acc[c], off);
            if (lane >= off && !start) acc[c] = y + acc[c];
        }
        if (lane >= off) start = start || up_start;
    }
    double left[CMAX];                         // the left neighbour's scanned run
#pragma unroll
    for (int c = 0; c < CMAX; ++c) left[c] = c < cols ? __shfl_up_sync(FULL, acc[c], 1) : 0.0;
    const bool top = carry_keys == nullptr;
    auto first_run = [&](const double* v) {    // the span's first run
        if (top) {
            put<CMAX>(out, n_keys, cols, first_key, v);
            return;
        }
        carry_keys[2 * span] = first_key;
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
            if (c < cols) carry_vals[c * carry_n + 2 * span] = v[c];
    };
    if (here > 0) {
        if (!single) {   // the lane's first run ends in its rows
            if (lane > 0 && prev_ck == hk) {
#pragma unroll
                for (int c = 0; c < CMAX; ++c) head[c] = left[c] + head[c];
            }
            if (hk == first_key) first_run(head);
            else put<CMAX>(out, n_keys, cols, hk, head);
        }
        if (lane == last) {   // the span's last run
            if (ck == first_key) first_run(acc);
            if (!top) {
                carry_keys[2 * span + 1] = ck;
#pragma unroll
                for (int c = 0; c < CMAX; ++c)
                    if (c < cols) carry_vals[c * carry_n + 2 * span + 1] =
                        ck == first_key ? 0.0 : acc[c];
            } else if (ck != first_key) {
                put<CMAX>(out, n_keys, cols, ck, acc);
            }
        } else if (next_hk != ck) {   // the lane's last run ends in its rows
            if (ck == first_key) first_run(acc);
            else put<CMAX>(out, n_keys, cols, ck, acc);
        }
    }
}

template <typename V>
int launch_sums(const int* keys, const long long* perm, const int* rows, Cols<V> vals,
                int cols, long long n, long long n_keys, float* out, int* carry_keys,
                double* carry_vals, cudaStream_t s) {
    const long long spans = (n + SUM_SPAN - 1) / SUM_SPAN;
    const unsigned blocks = (unsigned)((spans + SUM_WARPS - 1) / SUM_WARPS);
    const long long carry_n = 2 * spans;
    if (cols <= 4)
        segment_span_sums_kernel<V, 4><<<blocks, SUM_WARPS * 32, 0, s>>>(
            keys, perm, rows, vals, cols, n, n_keys, out, carry_keys, carry_vals, carry_n);
    else
        segment_span_sums_kernel<V, SEG_MAX_COLS><<<blocks, SUM_WARPS * 32, 0, s>>>(
            keys, perm, rows, vals, cols, n, n_keys, out, carry_keys, carry_vals, carry_n);
    return (int)cudaGetLastError();
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


extern "C" int segment_keep_span() { return KEEP_SPAN; }

extern "C" int segment_sums_span() { return SUM_SPAN; }

extern "C" int segment_sums_max_cols() { return SEG_MAX_COLS; }

// ids [D, R] (int64 if ids64, else int32) in; n_test tested columns, column c
// of row (b, r) at test[c * sc + b * sb + r * sr].  mask [D * blocks *
// KEEP_WORDS] u32 and counts [D * blocks] i32 (blocks = ceil(R / KEEP_SPAN))
// written in full.  Launches on the given stream, does not synchronize,
// allocates nothing, and returns cudaGetLastError().
extern "C" int segment_keep_count_launch(const void* ids, int ids64, const float* test,
                                         int n_test, long long sc, long long sb, long long sr,
                                         int D, int R, long long n_keys, unsigned* mask,
                                         int* counts, void* cuda_stream) {
    if (D < 1 || D > 65535 || R < 1 || n_test < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((R + KEEP_SPAN - 1) / KEEP_SPAN, D);
    const Cols<float> cols{test, sc, sb, sr, (unsigned)R};
    const cudaStream_t s = (cudaStream_t)cuda_stream;
    if (ids64)
        segment_keep_count_kernel<long long><<<grid, KEEP_THREADS, 0, s>>>(
            (const long long*)ids, cols, n_test, n_keys, mask, counts);
    else
        segment_keep_count_kernel<int><<<grid, KEEP_THREADS, 0, s>>>(
            (const int*)ids, cols, n_test, n_keys, mask, counts);
    return (int)cudaGetLastError();
}

// The same ids and mask, offsets [D * blocks] i64 (the exclusive prefix of
// counts) in; kept_ids and kept_rows [sum of counts] i32 written in full.
extern "C" int segment_keep_write_launch(const void* ids, int ids64, int D, int R,
                                         const unsigned* mask, const long long* offsets,
                                         int* kept_ids, int* kept_rows, void* cuda_stream) {
    if (D < 1 || D > 65535 || R < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((R + KEEP_SPAN - 1) / KEEP_SPAN, D);
    const cudaStream_t s = (cudaStream_t)cuda_stream;
    if (ids64)
        segment_keep_write_kernel<long long><<<grid, KEEP_THREADS, 0, s>>>(
            (const long long*)ids, R, mask, offsets, kept_ids, kept_rows);
    else
        segment_keep_write_kernel<int><<<grid, KEEP_THREADS, 0, s>>>(
            (const int*)ids, R, mask, offsets, kept_ids, kept_rows);
    return (int)cudaGetLastError();
}

// One level of the per-key sums.  keys [n] i32 sorted; perm [n] i64 and rows
// i32 both given or both null; sorted row j's columns: column c of flat row
// i = b * R + r at vals[c * sc + b * sb + r * sr], f32 (vals64 0) or f64
// (vals64 1), i = perm ? rows[perm[j]] : j.  out [n_keys, cols]
// f32: the keys of this level's complete runs written.  carry_keys [2 *
// ceil(n / SUM_SPAN)] i32 and carry_vals [cols, the same] f64 written in
// full, or both null when n <= SUM_SPAN (the last level).  Launches on the
// given stream, does not synchronize, allocates nothing, and returns
// cudaGetLastError().
extern "C" int segment_sums_launch(const int* keys, const long long* perm, const int* rows,
                                   const void* vals, int vals64, long long sc, long long sb,
                                   long long sr, long long R, int cols, long long n,
                                   long long n_keys, float* out, int* carry_keys,
                                   double* carry_vals, void* cuda_stream) {
    if (cols < 1 || cols > SEG_MAX_COLS || n < 1 || n_keys < 1 || R < 1 || R > UINT_MAX ||
        (carry_keys == nullptr) != (n <= SUM_SPAN) || (perm == nullptr) != (rows == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)cuda_stream;
    if (vals64)
        return launch_sums<double>(keys, perm, rows,
                                   Cols<double>{(const double*)vals, sc, sb, sr, (unsigned)R},
                                   cols, n, n_keys, out, carry_keys, carry_vals, s);
    return launch_sums<float>(keys, perm, rows,
                              Cols<float>{(const float*)vals, sc, sb, sr, (unsigned)R}, cols,
                              n, n_keys, out, carry_keys, carry_vals, s);
}
