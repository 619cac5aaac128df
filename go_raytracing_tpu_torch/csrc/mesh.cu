// Closest-hit and any-hit kernels over an instanced triangle mesh, for
// Hopper (sm_90a), a loop over the instances.  Two kernels, one per size
// class of the prototype (geometry/mesh_bvh.py builds the tables of one),
// each with a closest-hit and an any-hit instantiation:
//
//   mesh_sweep   prototypes of at most 16,384 triangles, one warp a run of
//       32 rays.  Replaces _kernel / intersect_mesh_kernel of the JAX
//       package's go_raytracing_tpu/ops/pallas_mesh.py (its pallas_call in
//       _call).  Per instance: the local ray, then a slab-test ladder of
//       root, coarse (2,048 triangles), tile (128), subtile (32) and leaf (8)
//       boxes in leaf order, each clipped by the running best (far > near),
//       and Moller-Trumbore (|a| < 1e-8 parallel) on the 8 triangles of each
//       leaf entered, accepting t_min <= t < t_best.  The first triangle and
//       the earlier instance win a tie.
//   mesh_stream  larger prototypes, one warp a run of 32 rays.  Replaces
//       _kernel / intersect_mesh_stream of
//       go_raytracing_tpu/ops/pallas_mesh_stream.py (its pallas_call in
//       _call).  Per instance: the local ray and its root-box interval
//       [t_en, t_ex], the exit clipped by the best hit of the instances
//       before; a gate per 2,048-triangle segment and a test per cull slot
//       (tps 128-triangle tiles), both far >= near; then Baldwin-Weber
//       (|den| < 1e-12 parallel) on every triangle of each slot entered,
//       accepting t_min <= t < t_cap.  Within an instance the least t and, at
//       equal t, the lowest leaf-order id wins; across instances the earlier.
//       The TPU kernel packs (id << 5 | instance) into one word and so takes
//       at most 31 instances; here tri and inst are two words and the
//       instance count is not limited.  The limits left: the id travels as
//       float32 in row 9, exact up to 2^24 triangles, and a lane keeps its
//       segments in 64 bits (the tables have at most 56 segments: 896 slots).
//
// What bounds them on this card: the work is data-dependent.  A live ray
// reads 28 bytes, a dead one 4, and each writes 13; the tables (at most 576 KB
// of triangles for the sweep, 7.2 MB for the 112,128-triangle stream of
// cornell-lucy) sit in L2, so the bytes are small beside the arithmetic:
// about 42 operations a local ray, 25 a box test, 55 a Moller-Trumbore test,
// 17 a Baldwin-Weber plane test and 24 more for the barycentrics of a
// triangle whose t passes, times what each ray's cull lets through
// (chip_smoke.py counts them).  So operations bound them.  Built with
// -fmad=false, a multiply and an add are two instructions: a kernel bound by
// operations reaches at most about half of a bound that counts a fused
// multiply-add as two operations at 67 TFLOP/s.  What kept them further off
// was the rays of a warp walking different boxes: lanes idle while others
// test.
//
// What the design does about it:
//   * the cull is exact per ray: a box is entered by the rays that hit it,
//     not by every ray of a block as on the TPU (whose vector unit wants
//     4,096 rays on one path), so no ray tests a triangle its own box test
//     has already ruled out;
//   * mesh_sweep stages the whole box hierarchy of the prototype (at most
//     8 coarse, 128 tile, 512 subtile and 2,048 leaf boxes, 64.7 KB) into
//     shared memory once per block, and each warp then walks a grid-stride
//     run of 32-ray runs; triangles are read through the read-only cache.
//     Each lane runs its own ray's ladder down to the tiles, in order; below
//     a tile some lane entered, the warp turns the roles round where its
//     rays' leaves differ: it tests the (ray, leaf) pairs four at a time,
//     8 lanes a pair and one triangle a lane, and each ray then takes its
//     pairs' results in leaf order, so the winner is the one-ray ladder's
//     bit for bit (sweep_tile); where the warp's rays share their leaves
//     (coherent camera rays) each lane walks their union for its own ray;
//     built for four blocks an SM (80 registers, no spill);
//   * mesh_stream is warp-cooperative.  Each lane tests its own ray's root
//     box and segment gates (every gate of an instance in one unrolled loop,
//     no vote between them).  The warp then walks, in table order, the union
//     of what its lanes entered, and turns the roles round wherever lanes
//     would otherwise idle: a slot test puts the 16 slot boxes of a segment
//     on the lanes of each half-warp and broadcasts two rays at a time
//     (shuffles), and a tile's sweep puts 4 of its 128 triangles on each
//     lane, all 13 rows in registers, and broadcasts each ray that entered
//     the slot in turn.  So a tile costs the warp four tests for each ray
//     that entered it, not 128 a lane whatever its lanes entered (with one
//     lane a ray, the lanes that had not entered a slot would idle through
//     its 128-triangle loop).  The lanes' winners meet in
//     warp reductions (__reduce_min_sync on t's bits made monotone, then on
//     the id); the rays' sort (the integrator's _mesh_sort_key) still keeps
//     the union of a warp's slots small;
//   * the tiles come through shared memory: each warp stages the 13 used
//     rows of a tile (6.5 KB) with cp.async into one of its two buffers while
//     it sweeps the other; 2 warps a block and 8 blocks an SM (16 warps,
//     213 KB of shared memory, at most 128 registers a thread);
//   * a quotient of zero or of numbers of opposite signs fails t >= t_min
//     (> 0) however it rounds, so its division is skipped; the division that
//     remains is IEEE's, so t keeps its bits;
//   * one warp a run of 32 rays and one block a run of 64, no grid-stride
//     loop: the sorted rays put hits and misses in runs, and the hardware
//     hands the next block to whichever SM frees up first;
//   * the clip of an instance's exit by the best hit so far ends most rays'
//     later instances at the root test; in any-hit mode a lane's first hit
//     ends its tests, and the warp leaves an instance when no lane is left;
//   * a ray whose t_max is not above t_min can hit nothing (dead lanes,
//     inactive shadow rays and rays that reach no instance come in with -1):
//     its miss is written before the instance loop, its origin and direction
//     unread, and a warp of such rays does nothing else;
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
#include <climits>

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

constexpr unsigned FULL = 0xffffffffu;
constexpr int SUB = TILE / TILE_SUBS;            // triangles per subtile
constexpr int TILE_LEAVES = TILE / LEAF;          // 16 leaves a tile
constexpr int SWEEP_WARPS = THREADS / 32;        // warps a block
// A warp's scratch in shared memory: each lane's subtile and leaf nears of
// the tile swept (+inf where the box is missed whatever the running best),
// and the tile's (ray, leaf) pairs, (lane << 4 | leaf) as 16 bits.
constexpr int NEAR_FLOATS = TILE_SUBS + TILE_LEAVES;   // 20 a lane
constexpr int MAX_PAIRS = 32 * TILE_LEAVES;
constexpr int SWEEP_WARP_FLOATS = 32 * NEAR_FLOATS + MAX_PAIRS / 2;
// A tile whose (ray, leaf) pairs number at least this many times the
// leaves any of the warp's rays enters is walked one lane a ray (sweep_tile).
constexpr int WALK_PER_LANE = 8;
// Blocks an SM the sweep is built for (its register target).
constexpr int SWEEP_BLOCKS_PER_SM = 4;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The box hierarchy's floats in shared memory (root, coarse, tile, subtile
// and leaf boxes, 6 floats each).
__host__ __device__ __forceinline__ int sweep_box_floats(int n_coarse) {
    const int n_tiles = n_coarse * COARSE;
    return (1 + n_coarse + n_tiles * (1 + TILE_SUBS + TILE_SUBS * SUB_LEAVES)) * 6;
}

// Moller-Trumbore of triangle j (|a| < 1e-8 parallel), operation for
// operation as the TPU kernel and the plain version: does the ray hit it at
// t_min <= t (t in tc)?
__device__ __forceinline__ bool moller_trumbore(const float* __restrict__ kt, int t_pad, int j,
                                                const float o[3], const float d[3],
                                                float t_min, float& tc) {
    const float v0x = __ldg(kt + j);
    const float v0y = __ldg(kt + t_pad + j);
    const float v0z = __ldg(kt + 2 * t_pad + j);
    const float e1x = __ldg(kt + 3 * t_pad + j);
    const float e1y = __ldg(kt + 4 * t_pad + j);
    const float e1z = __ldg(kt + 5 * t_pad + j);
    const float e2x = __ldg(kt + 6 * t_pad + j);
    const float e2y = __ldg(kt + 7 * t_pad + j);
    const float e2z = __ldg(kt + 8 * t_pad + j);
    const float hx = d[1] * e2z - d[2] * e2y;
    const float hy = d[2] * e2x - d[0] * e2z;
    const float hz = d[0] * e2y - d[1] * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const bool parallel = fabsf(a) < 1e-8f;
    const float f = 1.0f / (parallel ? 1.0f : a);
    const float sx = o[0] - v0x;
    const float sy = o[1] - v0y;
    const float sz = o[2] - v0z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (d[0] * qx + d[1] * qy + d[2] * qz);
    tc = f * (e2x * qx + e2y * qy + e2z * qz);
    return !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && tc >= t_min;
}

// One tile of one instance for the lanes whose ray entered it (`in_t`),
// each lane's running best (tb, tri_best, inst_best) updated exactly as a
// one-ray ladder (the plain version's) updates it.  The ladder below a tile is a scan
// in leaf order: a subtile is entered when the running best at its start
// lies past its near end (and the box is met at all), a leaf of an entered
// subtile when the running best at its start lies past its own, and a
// leaf entered moves the best to its least t (the first triangle at that
// t) if that is below the best.  The slab intervals and the triangle tests
// do not depend on the running best, only the scan's decisions do, and the
// best only falls: so
//   1. each lane finds, from its best at the tile's start, the leaves its
//      scan could enter (the others it will not) and keeps its subtile and
//      leaf nears in shared memory;
//   2. the warp tests those (ray, leaf) pairs with the roles turned round:
//      four pairs a round, 8 lanes a pair, one triangle a lane, the ray's
//      local origin and direction shuffled from its lane, and the pair's
//      least (t, leaf-order index) met in 3 shuffles (any hit: the first
//      hit of the leaf);
//   3. each pair's owner takes the pair's result in its scan, pairs coming
//      in leaf order, so every decision sees the running best the ladder's
//      does and the winner is its bits.
// With one lane a ray the lanes of a warp stand in different leaves, each
// idling through the others' 8-triangle loops; here a tile costs the warp a
// round for every four leaves its rays enter.
template <bool ANY>
__device__ __forceinline__ void sweep_tile(const SweepMesh& M, const float* s_sub,
                                           const float* s_leaf, int ti, bool in_t,
                                           const LocalRay& L, float t_min, int ii, int lane,
                                           float* nears, unsigned short* pairs, float& tb,
                                           int& tri_best, int& inst_best) {
    const float* __restrict__ kt = M.ktri;
    // 1. this lane's leaves that its best at the tile's start lets in
    unsigned mask = 0;
    float* mine = nears + lane * NEAR_FLOATS;
    if (in_t) {
        for (int kk = 0; kk < TILE_SUBS; ++kk) {
            const int si = ti * TILE_SUBS + kk;
            float sn = t_min, sf = inf_f();
            if (si * SUB < M.n_tris) slab(s_sub + si * 6, s_sub + si * 6 + 3, L, sn, sf);
            const bool sub_met = si * SUB < M.n_tris && sf > sn;
            mine[kk] = sub_met ? sn : inf_f();
            if (!(sub_met && tb > sn)) continue;
            for (int ll = 0; ll < SUB_LEAVES; ++ll) {
                const int li = si * SUB_LEAVES + ll;
                if (li * LEAF >= M.n_tris) break;
                float ln = t_min, lf = inf_f();
                slab(s_leaf + li * 6, s_leaf + li * 6 + 3, L, ln, lf);
                const int l = kk * SUB_LEAVES + ll;
                mine[TILE_SUBS + l] = lf > ln ? ln : inf_f();
                if (lf > ln && tb > ln) mask |= 1u << l;
            }
        }
    }
    const int cnt = __popc(mask);
    const unsigned any_leaf = __reduce_or_sync(FULL, mask);
    const int n_pairs_all = __reduce_add_sync(FULL, (unsigned)cnt);
    if (WALK_PER_LANE * __popc(any_leaf) <= n_pairs_all) {
        // coherent rays (they share most leaves): each lane walks the union
        // of the warp's leaves for its own ray, one leaf after another, the
        // lanes whose ray skips a leaf idling through it; the exact scan as
        // below
        int cur = -1;
        bool in_sub = false;
        for (unsigned u = any_leaf; u; u &= u - 1) {
            const int l = __ffs(u) - 1;
            if (!((mask >> l) & 1u)) continue;
            if ((l >> 2) != cur) {
                cur = l >> 2;
                in_sub = tb > mine[cur];
            }
            if (!(in_sub && tb > mine[TILE_SUBS + l])) continue;
            for (int jj = 0; jj < LEAF; ++jj) {
                const int j = ti * TILE + l * LEAF + jj;
                float tc;
                if (moller_trumbore(kt, M.t_pad, j, L.o, L.d, t_min, tc) && tc < tb) {
                    tb = ANY ? 0.0f : tc;
                    tri_best = j;
                    inst_best = ii;
                    if (ANY) break;
                }
            }
        }
        return;
    }
    // the pair list: this lane's pairs at the warp's prefix of pair counts
    int at = cnt;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const int up = __shfl_up_sync(FULL, at, s);
        if (lane >= s) at += up;
    }
    const int n_pairs = __shfl_sync(FULL, at, 31);
    at -= cnt;
    for (unsigned m = mask; m; m &= m - 1) pairs[at++] = (unsigned short)(lane << 4 | (__ffs(m) - 1));
    __syncwarp();

    // 2. and 3. four pairs a round
    const float tb_start = tb;
    int cur_sub = -1;
    bool sub_in = false;
    for (int base = 0; base < n_pairs; base += 4) {
        const int p = base + (lane >> 3);
        const int e = p < n_pairs ? pairs[p] : (lane << 4);
        const int owner = e >> 4;
        const int j = ti * TILE + (e & 15) * LEAF + (lane & 7);
        float o[3], d[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            o[c] = __shfl_sync(FULL, L.o[c], owner);
            d[c] = __shfl_sync(FULL, L.d[c], owner);
        }
        float tc;
        const bool hit = moller_trumbore(kt, M.t_pad, j, o, d, t_min, tc);
        // the pair's result: its leaf's least t and, at that t, the first
        // triangle; any hit: the first hit below the owner's best, which
        // before its first hit is its best at the tile's start
        const float cap = ANY ? __shfl_sync(FULL, tb_start, owner) : inf_f();
        const bool ok = p < n_pairs && hit && (!ANY || tc < cap);
        float rt = ok ? tc : inf_f();
        int ri = ok ? j : INT_MAX;
#pragma unroll
        for (int s = 1; s < 8; s <<= 1) {
            const float ot = __shfl_xor_sync(FULL, rt, s);
            const int oi = __shfl_xor_sync(FULL, ri, s);
            if (ANY ? oi < ri : (ot < rt || (ot == rt && oi < ri))) {
                rt = ot;
                ri = oi;
            }
        }
        // each owner takes its pairs of the round in leaf order
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int e_q = __shfl_sync(FULL, e, 8 * q);
            const float t_q = __shfl_sync(FULL, rt, 8 * q);
            const int i_q = __shfl_sync(FULL, ri, 8 * q);
            if (base + q < n_pairs && lane == (e_q >> 4)) {
                const int l = e_q & 15;
                if ((l >> 2) != cur_sub) {   // the subtile's test, at its start
                    cur_sub = l >> 2;
                    sub_in = tb > mine[cur_sub];
                }
                if (sub_in && tb > mine[TILE_SUBS + l] && i_q != INT_MAX && t_q < tb) {
                    tb = ANY ? 0.0f : t_q;
                    tri_best = i_q;
                    inst_best = ii;
                }
            }
        }
    }
    __syncwarp();   // the pair list is refilled by the next tile
}

// One warp a run of 32 rays (the integrator sorts them, so a run holds rays
// that enter the same instance in the same region heading the same way),
// one lane a ray for the ladder above the tiles: per instance the local ray
// and the root box, per coarse segment its box, per tile its box, each
// clipped by the lane's running best, in the ladder's order; each tile that
// some lane enters is swept by the whole warp (sweep_tile).
template <bool ANY>
__global__ void __launch_bounds__(THREADS, SWEEP_BLOCKS_PER_SM)
mesh_sweep_kernel(SweepMesh M, Rays R, float t_min, Out W) {
    extern __shared__ float boxes[];
    const int n_tiles = M.n_coarse * COARSE;
    const int n_subs = n_tiles * TILE_SUBS;
    const int n_leaves = n_subs * SUB_LEAVES;
    float* s_root = boxes;
    float* s_coarse = s_root + 6;
    float* s_tile = s_coarse + M.n_coarse * 6;
    float* s_sub = s_tile + n_tiles * 6;
    float* s_leaf = s_sub + n_subs * 6;
    if (threadIdx.x < 6) s_root[threadIdx.x] = M.root[threadIdx.x];
    for (int k = threadIdx.x; k < M.n_coarse * 6; k += blockDim.x) s_coarse[k] = M.coarse[k];
    for (int k = threadIdx.x; k < n_tiles * 6; k += blockDim.x) s_tile[k] = M.tile[k];
    for (int k = threadIdx.x; k < n_subs * 6; k += blockDim.x) s_sub[k] = M.sub[k];
    for (int k = threadIdx.x; k < n_leaves * 6; k += blockDim.x) s_leaf[k] = M.leaf[k];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* nears = boxes + sweep_box_floats(M.n_coarse) + warp * SWEEP_WARP_FLOATS;
    unsigned short* pairs = reinterpret_cast<unsigned short*>(nears + 32 * NEAR_FLOATS);
    __syncthreads();

    const long long runs = (R.n + 31) / 32;
    for (long long run = (long long)blockIdx.x * SWEEP_WARPS + warp; run < runs;
         run += (long long)gridDim.x * SWEEP_WARPS) {
        const long long i = run * 32 + lane;
        const bool live = i < R.n;
        float tb = live ? R.t_max[i] : -1.0f;
        if (tb >= BIG) tb = BIG;
        const bool alive = live && tb > t_min;
        if (live && !alive) write_out(W, i, BIG, -1, -1, ANY);   // every test would fail
        if (!__any_sync(FULL, alive)) continue;
        float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
        if (alive) {
            o[0] = R.ox[i]; o[1] = R.oy[i]; o[2] = R.oz[i];
            d[0] = R.dx[i]; d[1] = R.dy[i]; d[2] = R.dz[i];
        }
        int tri_best = -1, inst_best = -1;
        for (int ii = 0; ii < M.n_inst; ++ii) {
            // any hit: a lane's best is 0 after its hit, and every test fails
            const bool open = alive && !(ANY && tri_best >= 0);
            if (!__any_sync(FULL, open)) break;
            const LocalRay L = local_ray(M.w2l, ii, o, d);
            const bool in_root = open && enters(s_root, L, t_min, tb);
            if (!__any_sync(FULL, in_root)) continue;
            for (int ci = 0; ci < M.n_coarse; ++ci) {
                const bool in_c = in_root && enters(s_coarse + ci * 6, L, t_min, tb);
                if (!__any_sync(FULL, in_c)) continue;
                for (int k = 0; k < COARSE; ++k) {
                    const int ti = ci * COARSE + k;
                    if (ti * TILE >= M.n_tris) break;
                    const bool in_t = in_c && enters(s_tile + ti * 6, L, t_min, tb);
                    if (!__any_sync(FULL, in_t)) continue;
                    sweep_tile<ANY>(M, s_sub, s_leaf, ti, in_t, L, t_min, ii, lane, nears,
                                    pairs, tb, tri_best, inst_best);
                }
            }
        }
        if (alive) write_out(W, i, tb, tri_best, inst_best, ANY);
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

constexpr int STREAM_WARPS = 2;                     // warps a block
constexpr int STREAM_THREADS = 32 * STREAM_WARPS;
constexpr int STREAM_MIN_BLOCKS = 8;                // resident blocks an SM
constexpr int USED_ROWS = 13;                       // rows 0-12 of a tile are read
constexpr int STAGE_FLOATS = USED_ROWS * TILE;      // one staged tile, 6,656 B
constexpr int STAGES = 2;                           // a warp's buffers
constexpr int MAX_SEGMENTS = 64;                    // a lane's segment bits
constexpr size_t STREAM_SMEM = (size_t)STREAM_WARPS * STAGES * STAGE_FLOATS * sizeof(float);

// Copy the used rows of one tile into a warp's buffer: 13 rows of 512 B, one
// 16-byte cp.async a lane and row, then one commit group.
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ tri,
                                           long long tile, int lane) {
    const float* src = tri + tile * (ROWS * TILE) + lane * 4;
    float* to = dst + lane * 4;
#pragma unroll
    for (int r = 0; r < USED_ROWS; ++r) {
        const unsigned s = (unsigned)__cvta_generic_to_shared(to + r * TILE);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(src + r * TILE) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_staged() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
    __syncwarp();   // the other lanes' copies are visible from here on
}

// The slots of segment `seg` that each ray of `rays` (a mask of the warp's
// lanes, each of which entered the segment) enters, the roles turned round as
// in the sweep: lane k of each half-warp holds slot k's box, and two rays at
// a time are broadcast to the halves.  Returns this lane's own slot bits.
__device__ __forceinline__ unsigned slots_entered(const StreamMesh& M, int seg, unsigned rays,
                                                  const LocalRay& L, float near0,
                                                  float far0, int lane) {
    const int k = lane & (SEG_TILES - 1);
    const float* tb = M.slotbox + (long long)seg * 6 * SEG_TILES;
    const bool real = ((long long)seg * SEG_TILES + k) * M.tps * TILE < M.n_tris;
    const float lo[3] = {__ldg(tb + k), __ldg(tb + SEG_TILES + k), __ldg(tb + 2 * SEG_TILES + k)};
    const float hi[3] = {__ldg(tb + 3 * SEG_TILES + k), __ldg(tb + 4 * SEG_TILES + k),
                         __ldg(tb + 5 * SEG_TILES + k)};
    unsigned mine = 0;
    while (rays) {
        const int r0 = __ffs(rays) - 1;
        rays &= rays - 1;
        const bool two = rays != 0;
        const int r1 = two ? __ffs(rays) - 1 : r0;
        if (two) rays &= rays - 1;
        const int src = lane < SEG_TILES ? r0 : r1;
        LocalRay R;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            R.o[i] = __shfl_sync(FULL, L.o[i], src);
            R.inv[i] = __shfl_sync(FULL, L.inv[i], src);
        }
        float near = __shfl_sync(FULL, near0, src), far = __shfl_sync(FULL, far0, src);
        slab(lo, hi, R, near, far);
        const unsigned got =
            __ballot_sync(FULL, real && (lane < SEG_TILES || two) && far >= near);
        if (lane == r0) mine = got & 0xffffu;
        if (two && lane == r1) mine = got >> SEG_TILES;
    }
    return mine;
}

// The tiles a warp sweeps for one instance: those of every slot that some
// lane of the warp entered, segment by segment and slot by slot in table
// order.  Everything but `segs`, `mine` and `in` is the same in every lane.
struct SlotWalk {
    unsigned long long segs;   // segments this lane entered
    unsigned long long todo;   // segments some lane entered, not yet walked
    unsigned pending;          // slots of the segment walked, not handed out
    unsigned mine;             // slots of that segment this lane entered
    int seg;                   // the segment walked
    int slot, dt;              // the slot being handed out and its next tile
    bool in;                   // this lane entered `slot`
};

// Starts the walk of one instance: each lane's gates of all segments (at most
// 64), from [near0, far0]; a lane with `want` clear enters none.
__device__ __forceinline__ SlotWalk start_walk(const StreamMesh& M, const LocalRay& L,
                                               float near0, float far0, bool want) {
    SlotWalk w{0ull, 0ull, 0u, 0u, 0, 0, M.tps, false};
    if (want) {
#pragma unroll 4
        for (int s = 0; s < M.n_seg; ++s) {
            const float* sb = M.segbox + s * 6;
            const float lo[3] = {__ldg(sb), __ldg(sb + 1), __ldg(sb + 2)};
            const float hi[3] = {__ldg(sb + 3), __ldg(sb + 4), __ldg(sb + 5)};
            float s_near = near0, s_far = far0;
            slab(lo, hi, L, s_near, s_far);
            if (s_far >= s_near) w.segs |= 1ull << s;
        }
    }
    w.todo = (unsigned long long)__reduce_or_sync(FULL, (unsigned)w.segs) |
             (unsigned long long)__reduce_or_sync(FULL, (unsigned)(w.segs >> 32)) << 32;
    return w;
}

// Hands out the next tile (and whether this lane entered its slot); false
// when the instance has no tile left.  A lane with `want` clear (any hit:
// its ray has hit) enters no further slot.  Called by the whole warp.
__device__ __forceinline__ bool next_tile(SlotWalk& w, const StreamMesh& M,
                                          const LocalRay& L, float near0, float far0,
                                          bool want, int lane, long long& tile, bool& in) {
    if (w.dt < M.tps) {
        tile = (long long)w.slot * M.tps + w.dt++;
        in = w.in;
        return true;
    }
    while (w.pending == 0) {
        if (w.todo == 0) return false;
        w.seg = __ffsll((long long)w.todo) - 1;
        w.todo &= w.todo - 1;
        const unsigned rays = __ballot_sync(FULL, want && ((w.segs >> w.seg) & 1ull));
        if (rays == 0) continue;
        w.mine = slots_entered(M, w.seg, rays, L, near0, far0, lane);
        w.pending = __reduce_or_sync(FULL, w.mine);
    }
    const int k = __ffs(w.pending) - 1;
    w.pending &= w.pending - 1;
    w.slot = w.seg * SEG_TILES + k;
    w.in = (w.mine >> k) & 1u;
    w.dt = 1;
    tile = (long long)w.slot * M.tps;
    in = w.in;
    return true;
}

// Baldwin-Weber of the rays in `rays` (a mask of the warp's lanes) against a
// staged tile, the roles turned round: each lane holds four triangles of the
// tile (l = lane + 32 q), each ray in turn is broadcast from its lane, and
// the warp tests it against all 128 triangles at once, so a tile costs the
// warp four tests a ray that entered it, not 128 a lane.  The lanes' own
// winners meet in a warp reduction: the least t (its float bits, made
// monotone, by __reduce_min_sync), then the lowest id at that t.  Any hit:
// a ray takes the first lane's hit.  The owning lane keeps the result.
template <bool ANY>
__device__ __forceinline__ void sweep_tile(const float* __restrict__ T, int lane, unsigned rays,
                                           const LocalRay& L, float t_cap, float t_min,
                                           bool pos_t_min, float& best_t, int& best_id) {
    // this lane's four triangles, all 13 rows, in registers for the tile
    float n0[4], n1[4], n2[4], dp[4], U[3][4], V[3][4], Uo[4], Vo[4];
    int id[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int l = lane + 32 * q;
        n0[q] = T[l];
        n1[q] = T[TILE + l];
        n2[q] = T[2 * TILE + l];
        dp[q] = T[10 * TILE + l];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            U[k][q] = T[(3 + k) * TILE + l];
            V[k][q] = T[(6 + k) * TILE + l];
        }
        Uo[q] = T[11 * TILE + l];
        Vo[q] = T[12 * TILE + l];
        id[q] = (int)T[9 * TILE + l];
    }
    while (rays) {
        const int r = __ffs(rays) - 1;
        rays &= rays - 1;
        float o[3], d[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            o[k] = __shfl_sync(FULL, L.o[k], r);
            d[k] = __shfl_sync(FULL, L.d[k], r);
        }
        const float cap = __shfl_sync(FULL, t_cap, r);
        float lt = __int_as_float(0x7f800000);   // +inf: no hit yet
        int lid = INT_MAX;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            // operation for operation as the TPU kernel and the plain version
            const float den = n0[q] * d[0] + n1[q] * d[1] + n2[q] * d[2];
            const float num = dp[q] - (n0[q] * o[0] + n1[q] * o[1] + n2[q] * o[2]);
            const bool parallel = fabsf(den) < 1e-12f;
            // with t_min > 0 a quotient of zero or of numbers of opposite
            // signs fails t >= t_min however it rounds: skip its division
            const bool same_sign = num != 0.0f && ((num > 0.0f) == (den > 0.0f));
            if (parallel || (pos_t_min && !same_sign)) continue;
            const float tc = num / den;
            if (!(tc >= t_min) || !(tc < cap)) continue;
            const float px = o[0] + tc * d[0];
            const float py = o[1] + tc * d[1];
            const float pz = o[2] + tc * d[2];
            const float u = U[0][q] * px + U[1][q] * py + U[2][q] * pz + Uo[q];
            const float v = V[0][q] * px + V[1][q] * py + V[2][q] * pz + Vo[q];
            if (!(u >= 0.0f && v >= 0.0f && u + v <= 1.0f)) continue;
            if (tc < lt || (tc == lt && id[q] < lid)) {
                lt = tc;
                lid = id[q];
            }
        }
        if (ANY) {
            const unsigned hits = __ballot_sync(FULL, lid != INT_MAX);
            if (hits) {
                const int first = __shfl_sync(FULL, lid, __ffs(hits) - 1);
                if (lane == r) best_id = first;
            }
        } else {
            // float order as int order (an accepted t is never NaN; -0 and +0
            // are one key, as they are one t); INT_MAX: no hit
            const int bits = __float_as_int(lt);
            const int key = lid == INT_MAX ? INT_MAX
                            : lt == 0.0f  ? 0
                            : bits >= 0   ? bits
                                          : bits ^ 0x7fffffff;
            const int kmin = __reduce_min_sync(FULL, key);
            if (kmin != INT_MAX) {
                const int idmin = __reduce_min_sync(FULL, key == kmin ? lid : INT_MAX);
                const unsigned won = __ballot_sync(FULL, key == kmin && lid == idmin);
                const float tw = __shfl_sync(FULL, lt, __ffs(won) - 1);
                if (lane == r && (tw < best_t || (tw == best_t && idmin < best_id))) {
                    best_t = tw;
                    best_id = idmin;
                }
            }
        }
    }
}

// One warp a run of 32 rays, one lane a ray.  Per instance each lane finds
// its local ray and root interval; the warp then walks the union of the
// slots its lanes entered (SlotWalk), staging each tile's rows into its own
// buffers with cp.async, the next tile in flight while the current one is
// swept, and sweeps each tile for the lanes that entered its slot.
template <bool ANY>
__global__ void __launch_bounds__(STREAM_THREADS, STREAM_MIN_BLOCKS)
mesh_stream_kernel(StreamMesh M, Rays R, float t_min, Out W) {
    extern __shared__ float4 staged[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* buf = reinterpret_cast<float*>(staged) + warp * STAGES * STAGE_FLOATS;
    const long long i = ((long long)blockIdx.x * STREAM_WARPS + warp) * 32 + lane;
    const bool live = i < R.n;
    float t_cap = live ? R.t_max[i] : -1.0f;
    if (t_cap >= BIG) t_cap = BIG;
    const bool alive = live && t_cap > t_min;
    if (live && !alive) write_out(W, i, BIG, -1, -1, ANY);   // no t passes
    if (!__any_sync(FULL, alive)) return;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
    if (alive) {
        o[0] = R.ox[i]; o[1] = R.oy[i]; o[2] = R.oz[i];
        d[0] = R.dx[i]; d[1] = R.dy[i]; d[2] = R.dz[i];
    }
    float root[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) root[k] = __ldg(M.root + k);
    const bool pos_t_min = t_min > 0.0f;

    float acc_t = BIG;
    int acc_id = -1, acc_inst = -1;
    for (int ii = 0; ii < M.n_inst; ++ii) {
        const bool open = alive && !(ANY && acc_id >= 0);
        if (ANY && !__any_sync(FULL, open)) break;
        const LocalRay L = local_ray(M.w2l, ii, o, d);
        float near0 = t_min, t_ex = t_cap;
        slab(root, root + 3, L, near0, t_ex);
        const float far0 = fminf(t_ex, acc_t);
        // every later test clips inside [near0, far0]
        bool want = open && far0 >= near0;
        if (!__any_sync(FULL, want)) continue;
        float best_t = BIG;
        int best_id = -1;
        SlotWalk w = start_walk(M, L, near0, far0, want);
        long long cur = 0;
        bool cur_in = false;
        bool have = next_tile(w, M, L, near0, far0, want, lane, cur, cur_in);
        int b = 0;
        if (have) stage_tile(buf, M.tri, cur, lane);
        while (have) {
            long long nxt = 0;
            bool nxt_in = false;
            const bool more = next_tile(w, M, L, near0, far0, want, lane, nxt, nxt_in);
            if (more) {
                stage_tile(buf + (b ^ 1) * STAGE_FLOATS, M.tri, nxt, lane);
                wait_staged<1>();
            } else {
                wait_staged<0>();
            }
            const unsigned rays = __ballot_sync(FULL, cur_in && want);
            if (rays)
                sweep_tile<ANY>(buf + b * STAGE_FLOATS, lane, rays, L, t_cap, t_min,
                                pos_t_min, best_t, best_id);
            __syncwarp();   // every lane is done with buf[b] before it is refilled
            if (ANY) {
                want = want && best_id < 0;
                if (!__any_sync(FULL, want)) {
                    wait_staged<0>();
                    break;
                }
            }
            cur = nxt;
            cur_in = nxt_in;
            have = more;
            b ^= 1;
        }
        if (ANY) {
            if (best_id >= 0) {
                acc_id = best_id;
                acc_inst = ii;
            }
        } else if (best_t < acc_t) {
            acc_t = best_t;
            acc_id = best_id;
            acc_inst = ii;
        }
    }
    if (alive) write_out(W, i, acc_t, acc_id, acc_inst, ANY);
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

// Shared memory of a mesh_sweep block: the box hierarchy and each warp's
// scratch.
size_t sweep_smem(int n_coarse) {
    return ((size_t)sweep_box_floats(n_coarse) + (size_t)SWEEP_WARPS * SWEEP_WARP_FLOATS) *
           sizeof(float);
}

template <bool ANY>
int sweep_attributes(size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(mesh_sweep_kernel<ANY>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool ANY>
int launch_sweep(SweepMesh M, Rays R, float t_min, Out W, cudaStream_t stream) {
    unsigned int blocks = 1;
    int err = grid_size(R.n, &blocks);
    if (err != 0) return err;
    const size_t smem = sweep_smem(M.n_coarse);
    err = sweep_attributes<ANY>(smem);
    if (err != 0) return err;
    mesh_sweep_kernel<ANY><<<blocks, THREADS, smem, stream>>>(M, R, t_min, W);
    return (int)cudaGetLastError();
}

// STREAM_MIN_BLOCKS blocks of STREAM_SMEM bytes fit an SM only when its
// carve-out favours shared memory: ask for that (and allow a block all of
// STREAM_SMEM, which the 48 KB a block gets unasked would cap).
template <bool ANY>
int stream_attributes() {
    const int err = (int)cudaFuncSetAttribute(mesh_stream_kernel<ANY>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)STREAM_SMEM);
    if (err != 0) return err;
    return (int)cudaFuncSetAttribute(mesh_stream_kernel<ANY>,
                                     cudaFuncAttributePreferredSharedMemoryCarveout,
                                     (int)cudaSharedmemCarveoutMaxShared);
}

template <bool ANY>
int launch_stream(StreamMesh M, Rays R, float t_min, Out W, cudaStream_t stream) {
    // one warp a run of 32 rays and no grid-stride loop: the hardware hands
    // blocks to the SMs as they free up, which evens out the rays' unequal
    // work (sorted rays put the statue's hits and the misses in runs)
    const long long blocks = (R.n + STREAM_THREADS - 1) / STREAM_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int err = stream_attributes<ANY>();
    if (err != 0) return err;
    mesh_stream_kernel<ANY><<<(unsigned int)blocks, STREAM_THREADS, STREAM_SMEM, stream>>>(
        M, R, t_min, W);
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
    if (n_seg < 1 || n_seg > MAX_SEGMENTS || tps < 1) return (int)cudaErrorInvalidValue;
    const StreamMesh M{w2l, n_inst, root, segbox, slotbox, n_seg, tps, tri, n_tris};
    const Rays R{ox, oy, oz, dx, dy, dz, t_max, n_rays};
    const Out W{t_out, tri_out, inst_out, hit_out};
    const cudaStream_t s = (cudaStream_t)cuda_stream;
    return any_hit ? launch_stream<true>(M, R, t_min, W, s)
                   : launch_stream<false>(M, R, t_min, W, s);
}

// Blocks of mesh_stream (closest hit, or any hit) that an SM holds at once,
// from its registers and shared memory; and its threads and shared memory a
// block.  Returns a CUDA error code (0 on success).
extern "C" int mesh_stream_occupancy(int any_hit, int* blocks_per_sm, int* threads,
                                     int* smem_bytes) {
    *threads = STREAM_THREADS;
    *smem_bytes = (int)STREAM_SMEM;
    const int err = any_hit ? stream_attributes<true>() : stream_attributes<false>();
    if (err != 0) return err;
    const void* fn = any_hit ? (const void*)mesh_stream_kernel<true>
                             : (const void*)mesh_stream_kernel<false>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                              STREAM_THREADS, STREAM_SMEM);
}

// Blocks of mesh_sweep (closest hit, or any hit) that an SM holds at once
// for a prototype of n_coarse coarse segments, from its registers and
// shared memory; and its threads and shared memory a block.  Returns a CUDA
// error code (0 on success).
extern "C" int mesh_sweep_occupancy(int any_hit, int n_coarse, int* blocks_per_sm,
                                    int* threads, int* smem_bytes) {
    if (n_coarse < 1 || n_coarse > 8) return (int)cudaErrorInvalidValue;
    const size_t smem = sweep_smem(n_coarse);
    *threads = THREADS;
    *smem_bytes = (int)smem;
    const int err = any_hit ? sweep_attributes<true>(smem) : sweep_attributes<false>(smem);
    if (err != 0) return err;
    const void* fn = any_hit ? (const void*)mesh_sweep_kernel<true>
                             : (const void*)mesh_sweep_kernel<false>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                              THREADS, smem);
}
