// Closest-hit and any-hit kernels over an instanced triangle mesh, for
// Hopper (sm_90a): one thread a ray, a loop over the instances.  Two kernels,
// one per size class of the prototype (geometry/mesh_bvh.py builds the tables
// of one), each with a closest-hit and an any-hit instantiation:
//
//   mesh_sweep   prototypes of at most 16,384 triangles.  Replaces
//       _kernel / intersect_mesh_kernel of the JAX package's
//       go_raytracing_tpu/ops/pallas_mesh.py (its pallas_call in _call).
//       Per instance: the local ray, then a slab-test ladder of root, coarse
//       (2,048 triangles), tile (128), subtile (32) and leaf (8) boxes in
//       leaf order, each clipped by the running best (far > near), and
//       Moller-Trumbore (|a| < 1e-8 parallel) on the 8 triangles of each leaf
//       entered, accepting t_min <= t < t_best.  The first triangle and the
//       earlier instance win a tie.
//   mesh_stream  larger prototypes.  Replaces _kernel / intersect_mesh_stream
//       of go_raytracing_tpu/ops/pallas_mesh_stream.py (its pallas_call in
//       _call).  Per instance: the local ray and its root-box interval
//       [t_en, t_ex], the exit clipped by the best hit of the instances
//       before; a gate per 2,048-triangle segment and a test per cull slot
//       (tps 128-triangle tiles), both far >= near; then Baldwin-Weber
//       (|den| < 1e-12 parallel) on every triangle of each slot entered,
//       accepting t_min <= t < t_cap.  Within an instance the least t and, at
//       equal t, the lowest leaf-order id wins; across instances the earlier.
//       The TPU kernel packs (id << 5 | instance) into one word and so takes
//       at most 31 instances; here tri and inst are two words and the
//       instance count is not limited.  The one limit left: the id travels
//       as float32 in row 9, exact up to 2^24 triangles.
//
// What bounds them on this card: the work is data-dependent.  A live ray
// reads 28 bytes, a dead one 4, and each writes 13; the tables (at most 576 KB
// of triangles for the sweep, 7.2 MB for the 112,128-triangle stream of
// cornell-lucy) sit in L2, so the bytes are small beside the arithmetic:
// about 42 operations a local ray, 25 a box test, 55 a Moller-Trumbore test,
// 17 a Baldwin-Weber plane test and 24 more for the barycentrics of a
// triangle whose t passes, times what each ray's cull lets through
// (chip_smoke.py counts them).  So operations bound them, and divergence
// between the rays of a warp (each walks its own boxes) is what keeps them
// from the float32 peak.
//
// What the design does about it:
//   * the cull is exact per ray: a box is entered by the rays that hit it,
//     not by every ray of a block as on the TPU (whose vector unit wants
//     4,096 rays on one path), so no ray tests a triangle its own box test
//     has already ruled out;
//   * mesh_sweep stages the whole box hierarchy of the prototype (at most
//     8 coarse, 128 tile, 512 subtile and 2,048 leaf boxes, 64.7 KB) into
//     shared memory once per block, and each block then walks a grid-stride
//     run of rays; triangles are read through the read-only cache;
//   * mesh_stream reads its tile rows (tile-major, 13 rows of 128 triangles)
//     through the read-only cache: the rays of a warp come sorted by the
//     instance they enter, where and heading where (the integrator's
//     _mesh_sort_key), so they mostly read the same tile at the same time;
//   * the clip of an instance's exit by the best hit so far ends most rays'
//     later instances at the root test; in any-hit mode the first hit ends
//     the ray's loop;
//   * a ray whose t_max is not above t_min can hit nothing (dead lanes,
//     inactive shadow rays and rays that reach no instance come in with -1):
//     its miss is written before the instance loop, its origin and direction
//     unread;
//   * boxes that hold padding alone are skipped by the triangle count: the
//     TPU kernels' padding boxes (+-3e38, min above max) pass a min/max slab
//     test, so those kernels enter them and test zero triangles, which
//     changes no result;
//   * built with -fmad=false like the other kernels of the package, so each
//     rounds like its plain PyTorch version (ops/_build.py).
//
// Tables: w2l [I, 3, 4], root [6] (min xyz, max xyz); mesh_sweep: boxes
// [n, 2, 3] (min row, max row) and k_tri [9, t_pad] (v0, e1, e2 rows);
// mesh_stream: segment boxes [S, 6], slot boxes [S, 6, 16] and tile rows
// [S * 16 * tps, 16, 128].  Outputs: t [R] (BIG on a miss, 0 for an any-hit
// hit), tri [R] and inst [R] (0 on a miss), hit [R] bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 8;

constexpr int COARSE = 16;     // tiles per coarse segment
constexpr int TILE_SUBS = 4;   // subtiles per tile
constexpr int SUB_LEAVES = 4;  // leaves per subtile
constexpr int LEAF = 8;        // triangles per leaf

constexpr int SEG_TILES = 16;  // slots per stream segment
constexpr int ROWS = 16;       // rows per stream triangle
constexpr int TILE = 128;      // triangles per stream tile

struct Rays {
    const float* ox;
    const float* oy;
    const float* oz;
    const float* dx;
    const float* dy;
    const float* dz;
    const float* t_max;
    long long n;
};

struct Out {
    float* t;
    int* tri;
    int* inst;
    uint8_t* hit;
};

struct LocalRay {
    float o[3], d[3], inv[3];
};

__device__ __forceinline__ LocalRay local_ray(const float* __restrict__ w2l, int ii,
                                              const float o[3], const float d[3]) {
    LocalRay L;
    const float* m = w2l + ii * 12;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float m0 = __ldg(m + i * 4), m1 = __ldg(m + i * 4 + 1);
        const float m2 = __ldg(m + i * 4 + 2), m3 = __ldg(m + i * 4 + 3);
        L.o[i] = m0 * o[0] + m1 * o[1] + m2 * o[2] + m3;
        const float dl = m0 * d[0] + m1 * d[1] + m2 * d[2];
        L.d[i] = dl;
        const float safe = fabsf(dl) < 1e-12f ? (dl < 0.0f ? -1e-12f : 1e-12f) : dl;
        L.inv[i] = 1.0f / safe;
    }
    return L;
}

// Slab test of one box (lo[0..2], hi[0..2]) from near/far in; returns the
// clipped interval in near/far.
__device__ __forceinline__ void slab(const float* lo, const float* hi,
                                     const LocalRay& L, float& near, float& far) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float ta = (lo[i] - L.o[i]) * L.inv[i];
        const float tb = (hi[i] - L.o[i]) * L.inv[i];
        near = fmaxf(near, fminf(ta, tb));
        far = fminf(far, fmaxf(ta, tb));
    }
}

// The ladder's test: a box [2, 3] clipped by the running best, far > near.
__device__ __forceinline__ bool enters(const float* box, const LocalRay& L,
                                       float t_min, float t_best) {
    float near = t_min, far = t_best;
    slab(box, box + 3, L, near, far);
    return far > near;
}

__device__ __forceinline__ void write_out(Out W, long long i, float t_best, int tri,
                                          int inst, bool any_hit) {
    const bool hit = tri >= 0;
    W.t[i] = hit ? (any_hit ? 0.0f : t_best) : BIG;
    W.tri[i] = hit ? tri : 0;
    W.inst[i] = hit ? inst : 0;
    W.hit[i] = hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// mesh_sweep
// ---------------------------------------------------------------------------

struct SweepMesh {
    const float* w2l;       // [I, 12]
    int n_inst;
    const float* root;      // [6]
    const float* coarse;    // [n_coarse, 6]
    const float* tile;      // [n_coarse * 16, 6]
    const float* sub;       // [.. * 4, 6]
    const float* leaf;      // [.. * 4, 6]
    int n_coarse;
    const float* ktri;      // [9, t_pad]
    int t_pad;
    int n_tris;             // boxes past it hold padding alone
};

template <bool ANY>
__global__ void __launch_bounds__(THREADS)
mesh_sweep_kernel(SweepMesh M, Rays R, float t_min, Out W) {
    extern __shared__ float boxes[];
    const int n_tiles = M.n_coarse * COARSE;
    const int n_subs = n_tiles * TILE_SUBS;
    const int n_leaves = n_subs * SUB_LEAVES;
    float* s_coarse = boxes;
    float* s_tile = s_coarse + M.n_coarse * 6;
    float* s_sub = s_tile + n_tiles * 6;
    float* s_leaf = s_sub + n_subs * 6;
    for (int k = threadIdx.x; k < M.n_coarse * 6; k += blockDim.x) s_coarse[k] = M.coarse[k];
    for (int k = threadIdx.x; k < n_tiles * 6; k += blockDim.x) s_tile[k] = M.tile[k];
    for (int k = threadIdx.x; k < n_subs * 6; k += blockDim.x) s_sub[k] = M.sub[k];
    for (int k = threadIdx.x; k < n_leaves * 6; k += blockDim.x) s_leaf[k] = M.leaf[k];
    float root[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) root[k] = __ldg(M.root + k);
    __syncthreads();

    const float* __restrict__ kt = M.ktri;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < R.n;
         i += step) {
        float t_best = R.t_max[i];
        if (t_best >= BIG) t_best = BIG;
        int tri_best = -1, inst_best = -1;
        if (!(t_best > t_min)) {   // every test would fail
            write_out(W, i, BIG, -1, -1, ANY);
            continue;
        }
        const float o[3] = {R.ox[i], R.oy[i], R.oz[i]};
        const float d[3] = {R.dx[i], R.dy[i], R.dz[i]};

        for (int ii = 0; ii < M.n_inst; ++ii) {
            if (ANY && tri_best >= 0) break;   // t_best is 0: every test fails
            const LocalRay L = local_ray(M.w2l, ii, o, d);
            if (!enters(root, L, t_min, t_best)) continue;
            for (int ci = 0; ci < M.n_coarse; ++ci) {
                if (!enters(s_coarse + ci * 6, L, t_min, t_best)) continue;
                for (int k = 0; k < COARSE; ++k) {
                    const int ti = ci * COARSE + k;
                    if (ti * TILE >= M.n_tris) break;
                    if (!enters(s_tile + ti * 6, L, t_min, t_best)) continue;
                    for (int kk = 0; kk < TILE_SUBS; ++kk) {
                        const int si = ti * TILE_SUBS + kk;
                        if (si * (TILE / TILE_SUBS) >= M.n_tris) break;
                        if (!enters(s_sub + si * 6, L, t_min, t_best)) continue;
                        for (int ll = 0; ll < SUB_LEAVES; ++ll) {
                            const int li = si * SUB_LEAVES + ll;
                            if (li * LEAF >= M.n_tris) break;
                            if (!enters(s_leaf + li * 6, L, t_min, t_best)) continue;
                            for (int jj = 0; jj < LEAF; ++jj) {
                                const int j = li * LEAF + jj;
                                const float v0x = __ldg(kt + j);
                                const float v0y = __ldg(kt + M.t_pad + j);
                                const float v0z = __ldg(kt + 2 * M.t_pad + j);
                                const float e1x = __ldg(kt + 3 * M.t_pad + j);
                                const float e1y = __ldg(kt + 4 * M.t_pad + j);
                                const float e1z = __ldg(kt + 5 * M.t_pad + j);
                                const float e2x = __ldg(kt + 6 * M.t_pad + j);
                                const float e2y = __ldg(kt + 7 * M.t_pad + j);
                                const float e2z = __ldg(kt + 8 * M.t_pad + j);
                                // Moller-Trumbore, operation for operation as
                                // the TPU kernel and the plain version
                                const float hx = L.d[1] * e2z - L.d[2] * e2y;
                                const float hy = L.d[2] * e2x - L.d[0] * e2z;
                                const float hz = L.d[0] * e2y - L.d[1] * e2x;
                                const float a = e1x * hx + e1y * hy + e1z * hz;
                                const bool parallel = fabsf(a) < 1e-8f;
                                const float f = 1.0f / (parallel ? 1.0f : a);
                                const float sx = L.o[0] - v0x;
                                const float sy = L.o[1] - v0y;
                                const float sz = L.o[2] - v0z;
                                const float u = f * (sx * hx + sy * hy + sz * hz);
                                const float qx = sy * e1z - sz * e1y;
                                const float qy = sz * e1x - sx * e1z;
                                const float qz = sx * e1y - sy * e1x;
                                const float v = f * (L.d[0] * qx + L.d[1] * qy + L.d[2] * qz);
                                const float tc = f * (e2x * qx + e2y * qy + e2z * qz);
                                if (!parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                                    u + v <= 1.0f && tc >= t_min && tc < t_best) {
                                    t_best = ANY ? 0.0f : tc;
                                    tri_best = j;
                                    inst_best = ii;
                                }
                            }
                        }
                    }
                }
            }
        }
        write_out(W, i, t_best, tri_best, inst_best, ANY);
    }
}

// ---------------------------------------------------------------------------
// mesh_stream
// ---------------------------------------------------------------------------

struct StreamMesh {
    const float* w2l;       // [I, 12]
    int n_inst;
    const float* root;      // [6]
    const float* segbox;    // [S, 6]
    const float* slotbox;   // [S, 6, 16]
    int n_seg;
    int tps;                // tiles per slot
    const float* tri;       // [S * 16 * tps, 16, 128]
    int n_tris;             // slots past it hold padding alone
};

template <bool ANY>
__global__ void __launch_bounds__(THREADS)
mesh_stream_kernel(StreamMesh M, Rays R, float t_min, Out W) {
    const long long step = (long long)gridDim.x * blockDim.x;
    float root[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) root[k] = __ldg(M.root + k);

    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < R.n;
         i += step) {
        float t_cap = R.t_max[i];
        if (t_cap >= BIG) t_cap = BIG;
        float acc_t = BIG;
        int acc_id = -1, acc_inst = -1;
        if (!(t_cap > t_min)) {    // no t passes t_min <= t < t_cap
            write_out(W, i, BIG, -1, -1, ANY);
            continue;
        }
        const float o[3] = {R.ox[i], R.oy[i], R.oz[i]};
        const float d[3] = {R.dx[i], R.dy[i], R.dz[i]};

        for (int ii = 0; ii < M.n_inst; ++ii) {
            const LocalRay L = local_ray(M.w2l, ii, o, d);
            float near0 = t_min, t_ex = t_cap;
            slab(root, root + 3, L, near0, t_ex);
            const float far0 = fminf(t_ex, acc_t);
            // every later test clips inside [near0, far0]
            if (!(far0 >= near0)) continue;
            float best_t = BIG;
            int best_id = -1;
            for (int s = 0; s < M.n_seg; ++s) {
                const float* sb = M.segbox + s * 6;
                float s_near = near0, s_far = far0;
                {
                    const float lo[3] = {__ldg(sb), __ldg(sb + 1), __ldg(sb + 2)};
                    const float hi[3] = {__ldg(sb + 3), __ldg(sb + 4), __ldg(sb + 5)};
                    slab(lo, hi, L, s_near, s_far);
                }
                if (!(s_far >= s_near)) continue;
                const float* tb = M.slotbox + (long long)s * 6 * SEG_TILES;
                for (int k = 0; k < SEG_TILES; ++k) {
                    if (((long long)s * SEG_TILES + k) * M.tps * TILE >= M.n_tris) break;
                    const float lo[3] = {__ldg(tb + k), __ldg(tb + SEG_TILES + k),
                                         __ldg(tb + 2 * SEG_TILES + k)};
                    const float hi[3] = {__ldg(tb + 3 * SEG_TILES + k),
                                         __ldg(tb + 4 * SEG_TILES + k),
                                         __ldg(tb + 5 * SEG_TILES + k)};
                    float near = near0, far = far0;
                    slab(lo, hi, L, near, far);
                    if (!(far >= near)) continue;
                    const long long slot = (long long)s * SEG_TILES + k;
                    for (int dt = 0; dt < M.tps; ++dt) {
                        const float* __restrict__ T =
                            M.tri + (slot * M.tps + dt) * (ROWS * TILE);
                        for (int l = 0; l < TILE; ++l) {
                            const float n0 = __ldg(T + l);
                            const float n1 = __ldg(T + TILE + l);
                            const float n2 = __ldg(T + 2 * TILE + l);
                            // Baldwin-Weber, operation for operation as the
                            // TPU kernel and the plain version
                            const float den = n0 * L.d[0] + n1 * L.d[1] + n2 * L.d[2];
                            const float num = __ldg(T + 10 * TILE + l) -
                                              (n0 * L.o[0] + n1 * L.o[1] + n2 * L.o[2]);
                            const bool parallel = fabsf(den) < 1e-12f;
                            const float tc = num / (parallel ? 1.0f : den);
                            if (parallel || !(tc >= t_min) || !(tc < t_cap)) continue;
                            const float px = L.o[0] + tc * L.d[0];
                            const float py = L.o[1] + tc * L.d[1];
                            const float pz = L.o[2] + tc * L.d[2];
                            const float u = __ldg(T + 3 * TILE + l) * px +
                                            __ldg(T + 4 * TILE + l) * py +
                                            __ldg(T + 5 * TILE + l) * pz +
                                            __ldg(T + 11 * TILE + l);
                            const float v = __ldg(T + 6 * TILE + l) * px +
                                            __ldg(T + 7 * TILE + l) * py +
                                            __ldg(T + 8 * TILE + l) * pz +
                                            __ldg(T + 12 * TILE + l);
                            if (!(u >= 0.0f && v >= 0.0f && u + v <= 1.0f)) continue;
                            const int oid = (int)__ldg(T + 9 * TILE + l);
                            if (ANY) {
                                write_out(W, i, 0.0f, oid, ii, true);
                                goto next_ray;
                            }
                            if (tc < best_t || (tc == best_t && oid < best_id)) {
                                best_t = tc;
                                best_id = oid;
                            }
                        }
                    }
                }
            }
            if (best_t < acc_t) {
                acc_t = best_t;
                acc_id = best_id;
                acc_inst = ii;
            }
        }
        write_out(W, i, acc_t, acc_id, acc_inst, ANY);
    next_ray:;
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

template <bool ANY>
int launch_sweep(SweepMesh M, Rays R, float t_min, Out W, cudaStream_t stream) {
    unsigned int blocks = 1;
    int err = grid_size(R.n, &blocks);
    if (err != 0) return err;
    const int n_tiles = M.n_coarse * COARSE;
    const size_t smem =
        (size_t)(M.n_coarse + n_tiles * (1 + TILE_SUBS + TILE_SUBS * SUB_LEAVES)) * 6 *
        sizeof(float);
    if (smem > 48 * 1024) {
        err = (int)cudaFuncSetAttribute(mesh_sweep_kernel<ANY>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
        if (err != 0) return err;
    }
    mesh_sweep_kernel<ANY><<<blocks, THREADS, smem, stream>>>(M, R, t_min, W);
    return (int)cudaGetLastError();
}

template <bool ANY>
int launch_stream(StreamMesh M, Rays R, float t_min, Out W, cudaStream_t stream) {
    unsigned int blocks = 1;
    const int err = grid_size(R.n, &blocks);
    if (err != 0) return err;
    mesh_stream_kernel<ANY><<<blocks, THREADS, 0, stream>>>(M, R, t_min, W);
    return (int)cudaGetLastError();
}

}  // namespace

// Both launch on the given stream, do not synchronize, allocate nothing and
// return cudaGetLastError() (0 on success).  n_rays >= 1.
extern "C" int mesh_sweep_launch(
    const float* w2l, int n_inst, const float* root, const float* coarsebox,
    const float* tilebox, const float* subtilebox, const float* leafbox,
    int n_coarse, const float* ktri, int t_pad, int n_tris, const float* ox,
    const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const float* t_max, long long n_rays, float t_min, int any_hit, float* t_out,
    int* tri_out, int* inst_out, uint8_t* hit_out, void* cuda_stream) {
    if (n_coarse < 1 || n_coarse > 8) return (int)cudaErrorInvalidValue;
    const SweepMesh M{w2l, n_inst, root, coarsebox, tilebox, subtilebox, leafbox,
                      n_coarse, ktri, t_pad, n_tris};
    const Rays R{ox, oy, oz, dx, dy, dz, t_max, n_rays};
    const Out W{t_out, tri_out, inst_out, hit_out};
    const cudaStream_t s = (cudaStream_t)cuda_stream;
    return any_hit ? launch_sweep<true>(M, R, t_min, W, s)
                   : launch_sweep<false>(M, R, t_min, W, s);
}

extern "C" int mesh_stream_launch(
    const float* w2l, int n_inst, const float* root, const float* segbox,
    const float* slotbox, int n_seg, int tps, const float* tri, int n_tris,
    const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* t_max, long long n_rays, float t_min,
    int any_hit, float* t_out, int* tri_out, int* inst_out, uint8_t* hit_out,
    void* cuda_stream) {
    if (n_seg < 1 || tps < 1) return (int)cudaErrorInvalidValue;
    const StreamMesh M{w2l, n_inst, root, segbox, slotbox, n_seg, tps, tri, n_tris};
    const Rays R{ox, oy, oz, dx, dy, dz, t_max, n_rays};
    const Out W{t_out, tri_out, inst_out, hit_out};
    const cudaStream_t s = (cudaStream_t)cuda_stream;
    return any_hit ? launch_stream<true>(M, R, t_min, W, s)
                   : launch_stream<false>(M, R, t_min, W, s);
}
