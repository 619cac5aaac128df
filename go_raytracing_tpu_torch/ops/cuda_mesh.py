"""Closest-hit and any-hit kernels over an instanced triangle mesh.

Counterparts of the JAX package's two mesh kernels, one per size class of
the prototype (``geometry/mesh_bvh.build_proto`` builds the tables of one):

* ``intersect_mesh_kernel`` (CUDA ``mesh_sweep``; replaces
  ``ops/pallas_mesh.py``'s segment sweep) for prototypes of at most
  ``MAX_KERNEL_TRIS`` triangles.  Per instance the ray walks a slab-test
  ladder of root, coarse (2,048 triangles), tile (128), subtile (32) and
  leaf (8) boxes in leaf order, each test clipped by the running best, and
  tests the triangles of every leaf it enters by Moller-Trumbore.
* ``intersect_mesh_stream`` (CUDA ``mesh_stream``; replaces
  ``ops/pallas_mesh_stream.py``'s tile stream) above that.  Per instance
  the ray's root-box interval, clipped by the best hit of the instances
  before, gates each 2,048-triangle segment and then each cull slot (one
  or more 128-triangle tiles of a tile-aligned median-split order); the
  triangles of every slot it enters are tested by Baldwin-Weber on rows
  precomputed in float64.  Winners are reported by their leaf-order id.

Both return ``(t, tri, inst, hit, overflow)`` as the JAX package's do: ``t``
is BIG, ``tri`` and ``inst`` are 0 on a miss, and ``overflow`` is always 0
(the kernels have no slot cap).  With ``any_hit=True`` only ``hit`` means
anything (shadow rays).  ``t_max >= BIG`` counts as BIG; a ray with
``t_max`` below ``t_min`` (dead lanes come in with -1) hits nothing.

Ties: the sweep keeps the first triangle in leaf order and, across
instances, the earlier instance (strict ``<``).  The stream keeps, within
an instance, the lowest leaf-order id among the triangles at the least
``t`` and, across instances, the earlier instance.

The TPU kernels cull per block of rays (a box is entered if any ray of the
block hits it, the triangles then tested for all of them); these cull per
ray.  The two can differ only where a ray hits a triangle of a box whose
own slab test it fails, at the box's edge in the last bit.  The padding
boxes (+-3e38, min above max) pass a min/max slab test, so the TPU kernels
enter them and test their zero triangles; these skip every box that holds
only padding, by the triangle count, which changes no result.

Each wrapper launches its CUDA kernel (``csrc/mesh.cu``, built at first use
by ``ops/_build.py``) when the rays lie on a GPU, or raises; for rays on
the CPU it runs the plain PyTorch version beside it, and only because they
lie there.  The plain versions repeat the kernels' culling rules and
arithmetic, operation for operation, on ``[R]`` and ``[pairs, 128]``
tensors (never an ``[R, T]`` buffer), so on one GPU the two agree on every
ray.  The kernels see numbers, not graphs: inputs are detached.

The host-side table builds (``build_kernel_tables``,
``aligned_stream_order``, ``build_stream_tables``) repeat the JAX
package's in NumPy, so both packages test the same numbers: the triangle
order, the padded boxes and the Baldwin-Weber rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.vec3 import V3

BIG = np.float32(3.0e38)

# Small-mesh ladder (mesh_sweep)
TILE = 128               # triangles per tile
SUB = 32                 # triangles per subtile
LEAF = 8                 # triangles per leaf (the BVH leaf)
COARSE = 16              # tiles per coarse segment (2,048 triangles)
MAX_KERNEL_TRIS = 16384  # above: the tile stream

# Tile stream (mesh_stream)
SEG_TILES = 16           # cull slots per segment
ROWS = 16                # rows per triangle (13 used: n, U, V, id, d_p, Uo, Vo)
MAXT_INST = 896          # slots that cover a mesh; a slot is tps tiles
# Row 9 carries the leaf-order id as float32, exact up to 2^24: the only
# size limit the stream has.
MAX_STREAM_TRIS = 1 << 24

# Kernel launches made by the wrappers (CUDA tensors only).
LAUNCHES_SWEEP = 0    # intersect_mesh_kernel
LAUNCHES_STREAM = 0   # intersect_mesh_stream

# Pairs of (ray, slot) swept at a time by the stream's plain version.
_PAIR_BATCH = 1 << 14


# -----------------------------------------------------------------------------
# Host-side table builds (NumPy)
# -----------------------------------------------------------------------------

def build_kernel_tables(v0, e1, e2):
    """Subtile, tile and coarse segment boxes and padded triangle rows.

    Returns (ktri [9, Tpad] f32, leafbox [n_leaf,2,3], subtilebox
    [n_sub,2,3], tilebox [n_tiles,2,3], coarsebox [n_coarse,2,3], n_tiles,
    n_coarse).
    """
    v1 = v0 + e1
    v2 = v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)

    def seg_boxes(seg):
        t = lo.shape[0]
        n_seg = -(-t // seg)
        pad = n_seg * seg - t
        lo_p = np.pad(lo, ((0, pad), (0, 0)), constant_values=np.inf)
        hi_p = np.pad(hi, ((0, pad), (0, 0)), constant_values=-np.inf)
        mn = lo_p.reshape(n_seg, seg, 3).min(axis=1)
        mx = hi_p.reshape(n_seg, seg, 3).max(axis=1)
        thin = (mx - mn) < 1e-4
        mn = np.where(thin, mn - 1e-4, mn)
        mx = np.where(thin, mx + 1e-4, mx)
        # empty (all-padding) segments: +-3e38 never passes the slab test
        mn = np.where(np.isfinite(mn), mn, 3e38)
        mx = np.where(np.isfinite(mx), mx, -3e38)
        return np.stack([mn, mx], axis=1)

    def pad_segs(boxes, want):
        if boxes.shape[0] < want:
            empty = np.zeros((want - boxes.shape[0], 2, 3), np.float32)
            empty[:, 0] = np.float32(3e38)
            empty[:, 1] = np.float32(-3e38)
            boxes = np.concatenate([boxes, empty], axis=0)
        return boxes

    leafbox = seg_boxes(LEAF)
    subtilebox = seg_boxes(SUB)
    tilebox = seg_boxes(TILE)
    coarsebox = seg_boxes(TILE * COARSE)
    n_coarse = coarsebox.shape[0]
    tilebox = pad_segs(tilebox, n_coarse * COARSE)
    n_tiles = tilebox.shape[0]
    subtilebox = pad_segs(subtilebox, n_tiles * (TILE // SUB))
    leafbox = pad_segs(leafbox, n_tiles * (TILE // LEAF))

    t_pad = n_tiles * TILE
    ktri = np.zeros((9, t_pad), np.float32)
    n = v0.shape[0]
    for c in range(3):
        ktri[c, :n] = v0[:, c]
        ktri[3 + c, :n] = e1[:, c]
        ktri[6 + c, :n] = e2[:, c]
    # zero-padded triangles are degenerate and never pass the tests
    return (
        ktri.astype(np.float32),
        leafbox.astype(np.float32),
        subtilebox.astype(np.float32),
        tilebox.astype(np.float32),
        coarsebox.astype(np.float32),
        n_tiles,
        n_coarse,
    )


def aligned_stream_order(lo, hi, tile=TILE):
    """Tile-aligned recursive median split: every 128-triangle tile is one
    exact subtree, so the tile boxes are the smallest the topology allows
    (the implicit BVH's leaves vary in size, and 128 consecutive triangles
    of its order straddle subtrees)."""
    n = lo.shape[0]
    centroid = (lo + hi) * 0.5
    order = np.arange(n)
    segs = [(0, n)]
    while segs:
        s, e = segs.pop()
        cnt = e - s
        if cnt <= tile:
            continue
        c = centroid[order[s:e]]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        k = c[:, axis].argsort(kind="stable")
        order[s:e] = order[s:e][k]
        mid = s + (-(-cnt // tile) // 2) * tile
        segs.append((s, mid))
        segs.append((mid, e))
    return order


def build_stream_tables(v0, e1, e2):
    """([NT, ROWS, TILE] tile-major triangle rows, [S, 6, SEG_TILES] slot
    boxes, S).

    Triangles are re-clustered into tile-aligned subtrees
    (``aligned_stream_order``); row 9 carries each triangle's leaf-order id
    as float32, so the winners are reported in the order every other
    consumer uses.  A cull slot is ``tps = ceil(n_tiles / MAXT_INST)``
    adjacent tiles (1 up to 114,688 triangles).  Padding triangles are zero
    (n = 0: rejected as parallel); padding slot boxes are +BIG/-BIG.

    Rows 0-2: the plane normal n = e1 x e2; 3-5: U = (e2 x n)/|n|^2; 6-8:
    V = (n x e1)/|n|^2 (barycentrics as affine functions of the hit point:
    u = U.p + Uo, v = V.p + Vo); 9: the leaf-order id; 10: d_p = n.v0;
    11-12: Uo, Vo.  Precomputed in float64, so that a sliver triangle's U
    and V stay accurate in float32.
    """
    t = v0.shape[0]
    if t:
        lo0 = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
        hi0 = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
        perm = aligned_stream_order(lo0, hi0)
        v0, e1, e2 = v0[perm], e1[perm], e2[perm]
    else:
        perm = np.zeros((0,), np.int64)
    nt_raw = -(-t // TILE)
    tps = max(1, -(-nt_raw // MAXT_INST))   # tiles per cull slot
    slot_tris = TILE * tps
    s = -(-(-(-t // slot_tris)) // SEG_TILES)  # segments of 16 slots
    nslot = s * SEG_TILES
    tpad = nslot * slot_tris
    nt = tpad // TILE

    v064 = v0.astype(np.float64)
    e164 = e1.astype(np.float64)
    e264 = e2.astype(np.float64)
    n64 = np.cross(e164, e264)
    n2 = np.maximum((n64 * n64).sum(axis=1, keepdims=True), 1e-300)
    U = np.cross(e264, n64) / n2
    V = np.cross(n64, e164) / n2
    rows = np.zeros((ROWS, tpad), np.float32)
    rows[0:3, :t] = n64.T
    rows[3:6, :t] = U.T
    rows[6:9, :t] = V.T
    rows[9, :t] = perm.astype(np.float32)          # leaf-order ids
    rows[10, :t] = (n64 * v064).sum(axis=1)        # d_p
    rows[11, :t] = -(U * v064).sum(axis=1)         # Uo
    rows[12, :t] = -(V * v064).sum(axis=1)         # Vo
    # [ROWS, NT, TILE] -> [NT, ROWS, TILE]
    tri = np.ascontiguousarray(rows.reshape(ROWS, nt, TILE).transpose(1, 0, 2))

    v1 = v0 + e1
    v2 = v0 + e2
    lo_t = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi_t = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    lo_p = np.full((tpad, 3), np.inf, np.float32)
    hi_p = np.full((tpad, 3), -np.inf, np.float32)
    lo_p[:t] = lo_t
    hi_p[:t] = hi_t
    mn = lo_p.reshape(nslot, slot_tris, 3).min(axis=1)
    mx = hi_p.reshape(nslot, slot_tris, 3).max(axis=1)
    thin = (mx - mn) < 1e-4
    mn = np.where(thin, mn - 1e-4, mn)
    mx = np.where(thin, mx + 1e-4, mx)
    mn = np.where(np.isfinite(mn), mn, BIG)
    mx = np.where(np.isfinite(mx), mx, -BIG)
    tilebox = np.concatenate(
        [mn.reshape(s, SEG_TILES, 3), mx.reshape(s, SEG_TILES, 3)], axis=2
    ).transpose(0, 2, 1)  # [S, 6, SEG_TILES]
    return tri, np.ascontiguousarray(tilebox), s


def kernel_ok(proto) -> bool:
    """Does the prototype carry the small-mesh ladder's tables?"""
    return proto.k_n_coarse > 0 and proto.n_tris <= MAX_KERNEL_TRIS


def stream_ok(proto) -> bool:
    """Does the prototype carry the tile stream's tables?"""
    return proto.s_n_seg > 0


# -----------------------------------------------------------------------------
# Plain PyTorch versions
# -----------------------------------------------------------------------------

def _local_rays(w2l, o, d):
    """World rays -> one instance's local origin, direction and safe 1/d
    (3 lists of [R]); ``w2l`` is the instance's 3x4 matrix as floats."""
    ol, dl, inv = [], [], []
    for i in range(3):
        m0, m1, m2, m3 = w2l[i]
        oli = m0 * o[0] + m1 * o[1] + m2 * o[2] + m3
        dli = m0 * d[0] + m1 * d[1] + m2 * d[2]
        safe = torch.where(torch.abs(dli) < 1e-12,
                           torch.where(dli < 0, -1e-12, 1e-12), dli)
        ol.append(oli)
        dl.append(dli)
        inv.append(1.0 / safe)
    return ol, dl, inv


def _slab(box, ol, inv, near, far):
    """Slab test of one box (6 floats: min xyz, max xyz) or of boxes
    broadcast against the rays; returns (near, far)."""
    for i in range(3):
        ta = (box[i] - ol[i]) * inv[i]
        tb = (box[3 + i] - ol[i]) * inv[i]
        near = torch.maximum(near, torch.minimum(ta, tb))
        far = torch.minimum(far, torch.maximum(ta, tb))
    return near, far


def _count(counts, key, n):
    if counts is not None:
        counts[key] = counts.get(key, 0) + int(n)


def _sweep_plain(proto, o, d, t_cap, t_min, any_hit, counts=None):
    """The ladder of ``mesh_sweep``: for each ray, instance by instance, the
    root, coarse, tile, subtile and leaf boxes in leaf order, each slab test
    clipped by the ray's running best (``far > near``), and Moller-Trumbore
    on the 8 triangles of each leaf entered.  Vectorized over the rays that
    entered the parent box, one 128-triangle tile at a time; the boxes are
    taken in the kernel's order, so that each test sees the running best the
    kernel's does.  A ray whose ``t_cap`` is not above ``t_min`` hits
    nothing and is left out from the start, as the kernel writes its miss
    before the instance loop.  Returns (t_best, tri_best, inst_best) with
    -1 ids on a miss."""
    r, dev = t_cap.shape[0], t_cap.device
    t_best = t_cap.clone()
    tri_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    inst_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    w2l = proto.w2l_host
    root = proto.root_box.tolist()
    coarse, tiles = (b.detach().reshape(-1, 6).cpu().numpy().astype(np.float64).tolist()
                     for b in (proto.k_coarsebox, proto.k_tilebox))
    subs = proto.k_subtilebox.reshape(-1, TILE // SUB, 6)     # per tile
    leaves = proto.k_leafbox.reshape(-1, TILE // LEAF, 6)
    live = torch.nonzero(t_cap > t_min).squeeze(1)

    for ii in range(proto.n_instances):
        if any_hit:
            live = live[tri_best[live] < 0]   # the kernel stops at a hit
        _count(counts, "local_rays", live.numel())
        ol, dl, inv = _local_rays(w2l[ii], o, d)

        def enter(idx, box):
            """Rays of ``idx`` whose slab test of ``box`` passes."""
            _count(counts, "box_tests", idx.numel())
            near, far = _slab(box, [c[idx] for c in ol], [c[idx] for c in inv],
                              torch.full((idx.numel(),), t_min, device=dev),
                              t_best[idx])
            return idx[far > near]

        idx0 = enter(live, root)
        for ci in range(proto.k_n_coarse if idx0.numel() else 0):
            idx1 = enter(idx0, coarse[ci])
            for k in range(COARSE if idx1.numel() else 0):
                ti = ci * COARSE + k
                if ti * TILE >= proto.n_tris:
                    break                        # padding from here on
                idx2 = enter(idx1, tiles[ti])
                if idx2.numel():
                    _tile_sweep(proto.k_tri, ti, subs[ti], leaves[ti], idx2, ol,
                                dl, inv, t_min, t_best, tri_best, inst_best, ii,
                                any_hit, counts, proto.n_tris)
    return t_best, tri_best, inst_best


def _tile_sweep(ktri, ti, subs, leaves, idx, ol, dl, inv, t_min, t_best,
                tri_best, inst_best, ii, any_hit, counts, n_tris):
    """The subtiles, leaves and triangles of tile ``ti`` for the rays
    ``idx`` that entered it, updating the running bests in place.

    What does not depend on the running best is computed for the whole tile
    at once: Moller-Trumbore on its 128 triangles ([n, 128]), and each
    subtile's and leaf's slab interval with the far end unclipped.  Then the
    4 subtiles and 16 leaves are taken in the kernel's order, each test
    clipping its far end by the running best (min is exact, so this equals
    the kernel's clip inside the slab).  Within a leaf the kernel tests the
    triangles one after another with strict ``tc < t_best``, so it keeps
    the first triangle at the least t; in any-hit mode the first hit, its t
    collapsing to 0.  Subtiles and leaves of padding alone are skipped."""
    n, dev = idx.numel(), idx.device
    o_ = [c[idx][:, None] for c in ol]
    inv_ = [c[idx][:, None] for c in inv]
    d_ = [c[idx][:, None] for c in dl]
    near0 = torch.full((n, 1), t_min, device=dev)
    far0 = torch.full((n, 1), torch.inf, device=dev)
    s_near, s_far = _slab(subs.t(), o_, inv_, near0, far0)       # [n, 4]
    l_near, l_far = _slab(leaves.t(), o_, inv_, near0, far0)     # [n, 16]

    k = ktri[:, ti * TILE:(ti + 1) * TILE]                       # [9, 128]
    v0, e1, e2 = k[0:3, None], k[3:6, None], k[6:9, None]        # [3, 1, 128]
    hx = d_[1] * e2[2] - d_[2] * e2[1]
    hy = d_[2] * e2[0] - d_[0] * e2[2]
    hz = d_[0] * e2[1] - d_[1] * e2[0]
    a = e1[0] * hx + e1[1] * hy + e1[2] * hz
    parallel = torch.abs(a) < 1e-8
    f = 1.0 / torch.where(parallel, 1.0, a)
    sx = o_[0] - v0[0]
    sy = o_[1] - v0[1]
    sz = o_[2] - v0[2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = f * (d_[0] * qx + d_[1] * qy + d_[2] * qz)
    tc = f * (e2[0] * qx + e2[1] * qy + e2[2] * qz)
    ok = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (tc >= t_min)).reshape(n, TILE // LEAF, LEAF)
    tc = tc.reshape(n, TILE // LEAF, LEAF)

    tb = t_best[idx]
    if any_hit:
        # before its first hit a ray's running best is its t_max
        ok = ok & (tc < tb[:, None, None])
        leaf_any = ok.any(dim=2)
        leaf_pick = torch.argmax(ok.to(torch.int8), dim=2)       # first hit
    else:
        leaf_t, leaf_pick = torch.where(ok, tc, torch.inf).min(dim=2)
    tri, inst = tri_best[idx], inst_best[idx]
    for kk in range(TILE // SUB):
        if ti * TILE + kk * SUB >= n_tris:
            break
        sub_in = torch.minimum(s_far[:, kk], tb) > s_near[:, kk]
        _count(counts, "box_tests", n)
        for ll in range(SUB // LEAF):
            li = kk * (SUB // LEAF) + ll
            if ti * TILE + li * LEAF >= n_tris:
                break
            leaf_in = sub_in & (torch.minimum(l_far[:, li], tb) > l_near[:, li])
            if counts is not None:
                _count(counts, "box_tests", sub_in.sum())
                _count(counts, "tri_tests", leaf_in.sum() * LEAF)
            if any_hit:
                upd = leaf_in & leaf_any[:, li]
                tb = torch.where(upd, 0.0, tb)
            else:
                upd = leaf_in & (leaf_t[:, li] < tb)
                tb = torch.where(upd, leaf_t[:, li], tb)
            tri = torch.where(upd, (ti * TILE + li * LEAF + leaf_pick[:, li]).to(torch.int32), tri)
            inst = torch.where(upd, ii, inst)
    t_best[idx] = tb
    tri_best[idx] = tri
    inst_best[idx] = inst


def _stream_plain(proto, o, d, t_cap, t_min, any_hit, counts=None):
    """The cull and sweep of ``mesh_stream``: for each ray, instance by
    instance, the root-box interval [t_en, t_ex] clipped by the best hit of
    the instances before (``far0``); each segment whose box the ray meets
    within it (``far >= near``), each slot of such a segment likewise, and
    Baldwin-Weber on the triangles of each slot entered, accepting
    ``t_min <= tc < t_cap`` (a ray whose ``t_cap`` is not above ``t_min``
    is left out from the start, as in the kernel).  The culls of one instance do not depend on
    its own hits, so the (ray, slot) pairs are found first and swept in
    batches of ``[pairs, 128 * tps]``; within an instance the least t wins
    and, at equal t, the lowest leaf-order id, which makes the order of the
    sweep immaterial.  Returns (t_best, tri_best, inst_best), -1 ids on a
    miss."""
    r, dev = t_cap.shape[0], t_cap.device
    big = float(BIG)
    int_max = torch.iinfo(torch.int32).max
    acc_t = torch.full((r,), big, device=dev)
    acc_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
    acc_inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    w2l = proto.w2l_host
    root = proto.root_box.tolist()
    tilebox = proto.s_tilebox
    n_seg = tilebox.shape[0]
    segbox = proto.s_segbox.t()                                    # [6, S]
    slotbox = tilebox.permute(1, 0, 2).reshape(6, n_seg * SEG_TILES)  # [6, NSLOT]
    tps = proto.s_tri.shape[0] // (n_seg * SEG_TILES)
    s_tri = proto.s_tri

    live = t_cap > t_min
    for ii in range(proto.n_instances):
        if any_hit:
            live = live & (acc_id < 0)        # the kernel stops at a hit
        if counts is not None:
            _count(counts, "local_rays", live.sum())
            _count(counts, "box_tests", live.sum())
        ol, dl, inv = _local_rays(w2l[ii], o, d)
        near0, t_ex = _slab(root, ol, inv, torch.full((r,), t_min, device=dev),
                            t_cap)
        far0 = torch.minimum(t_ex, acc_t)
        # every later slab test lies inside [near0, far0]
        idx = torch.nonzero(live & (far0 >= near0)).squeeze(1)
        if idx.numel() == 0:
            continue
        ol_i = [c[idx] for c in ol]
        dl_i = [c[idx] for c in dl]
        inv_i = [c[idx] for c in inv]
        near_i, far_i = near0[idx], far0[idx]

        # segment gate: [n, S]
        _count(counts, "box_tests", idx.numel() * n_seg)
        s_near, s_far = _slab(segbox[:, None, :], [c[:, None] for c in ol_i],
                              [c[:, None] for c in inv_i], near_i[:, None],
                              far_i[:, None])
        pr, ps = torch.nonzero(s_far >= s_near, as_tuple=True)
        # slot tests of the segments entered (slots of padding alone
        # skipped): [P, 16]
        slots = ps[:, None] * SEG_TILES + torch.arange(SEG_TILES, device=dev)
        real = slots * (tps * TILE) < proto.n_tris
        if counts is not None:
            _count(counts, "box_tests", real.sum())
        b = slotbox[:, slots]                                        # [6, P, 16]
        t_near, t_far = _slab(b, [c[pr][:, None] for c in ol_i],
                              [c[pr][:, None] for c in inv_i],
                              near_i[pr][:, None], far_i[pr][:, None])
        hit_p, hit_k = torch.nonzero((t_far >= t_near) & real, as_tuple=True)
        pair_ray = pr[hit_p]                       # into idx
        pair_slot = slots[hit_p, hit_k]
        _count(counts, "tri_tests", pair_ray.numel() * TILE * tps)

        best_t = torch.full((idx.numel(),), big, device=dev)
        best_id = torch.full((idx.numel(),), int_max, dtype=torch.int32, device=dev)
        cap = t_cap[idx]
        lanes = torch.arange(tps, device=dev)
        for p0 in range(0, pair_ray.numel(), _PAIR_BATCH):
            pray = pair_ray[p0:p0 + _PAIR_BATCH]
            tiles = pair_slot[p0:p0 + _PAIR_BATCH, None] * tps + lanes  # [B, tps]
            rows = s_tri[tiles].permute(2, 0, 1, 3).reshape(ROWS, tiles.shape[0], -1)
            t_p, id_p = _bw_pairs(rows, [c[pray][:, None] for c in ol_i],
                                  [c[pray][:, None] for c in dl_i],
                                  cap[pray][:, None], t_min, int_max, counts)
            # lexicographic (t, id) minimum per ray over the batch's pairs
            bt = torch.full_like(best_t, big).scatter_reduce(
                0, pray, t_p, "amin")
            cand = t_p == bt[pray]
            bid = torch.full_like(best_id, int_max).scatter_reduce(
                0, pray, torch.where(cand, id_p, int_max), "amin")
            take = (bt < best_t) | ((bt == best_t) & (bid < best_id))
            best_t = torch.where(take, bt, best_t)
            best_id = torch.where(take, bid, best_id)

        found = best_t < big
        if any_hit:
            best_t = torch.where(found, 0.0, best_t)
        upd = best_t < acc_t[idx]
        acc_t[idx] = torch.where(upd, best_t, acc_t[idx])
        acc_id[idx] = torch.where(upd, best_id, acc_id[idx])
        acc_inst[idx] = torch.where(upd, ii, acc_inst[idx])
    return acc_t, acc_id, acc_inst


def _bw_pairs(rows, o_, d_, cap, t_min, int_max, counts=None):
    """Baldwin-Weber of each pair's ray ([B, 1] components) against its
    triangles (``rows`` [ROWS, B, L]).  Returns the pair's least accepted
    t (BIG if none) and the lowest leaf-order id at that t.  Counts the
    triangles whose plane t passes (``tri_t_pass``): only those go on to
    the barycentrics in the kernel."""
    nr, U, V = rows[0:3], rows[3:6], rows[6:9]
    d_p, Uo, Vo = rows[10], rows[11], rows[12]
    den = nr[0] * d_[0] + nr[1] * d_[1] + nr[2] * d_[2]
    num = d_p - (nr[0] * o_[0] + nr[1] * o_[1] + nr[2] * o_[2])
    parallel = torch.abs(den) < 1e-12
    tc = num / torch.where(parallel, 1.0, den)
    if counts is not None:
        _count(counts, "tri_t_pass", (~parallel & (tc >= t_min) & (tc < cap)).sum())
    px = o_[0] + tc * d_[0]
    py = o_[1] + tc * d_[1]
    pz = o_[2] + tc * d_[2]
    u = U[0] * px + U[1] * py + U[2] * pz + Uo
    v = V[0] * px + V[1] * py + V[2] * pz + Vo
    ok = (~parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (tc >= t_min) & (tc < cap))
    tcm = torch.where(ok, tc, float(BIG))
    t_p = tcm.amin(dim=1)
    oid = rows[9].to(torch.int32)
    id_p = torch.where(ok & (tcm == t_p[:, None]), oid, int_max).amin(dim=1)
    return t_p, id_p


def _finish(t_best, tri_best, inst_best, any_hit):
    hit = tri_best >= 0
    t = torch.where(hit, torch.zeros_like(t_best) if any_hit else t_best,
                    float(BIG))
    return (t, torch.clamp_min(tri_best, 0), torch.clamp_min(inst_best, 0), hit)


# -----------------------------------------------------------------------------
# Kernel wrappers
# -----------------------------------------------------------------------------

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# w2l n_inst root | coarse tile sub leaf n_coarse | ktri t_pad n_tris | rays(7) n t_min any | outs(4) stream
_SWEEP_ARGTYPES = ([_P, _I, _P] + [_P] * 4 + [_I] + [_P, _I, _I] + [_P] * 7
                   + [_L, _F, _I] + [_P] * 4 + [_P])
# w2l n_inst root | segbox tilebox n_seg tps | s_tri n_tris | rays(7) n t_min any | outs(4) stream
_STREAM_ARGTYPES = ([_P, _I, _P] + [_P, _P, _I, _I] + [_P, _I] + [_P] * 7
                    + [_L, _F, _I] + [_P] * 4 + [_P])


def _kernel(function: str, argtypes):
    from . import _build

    fn = getattr(_build.load("mesh").lib, function)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(function, argtypes, dev, args):
    fn = _kernel(function, argtypes)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{function} failed: CUDA error {err}")


def _check(proto, names, rays, r):
    """Raise on what the kernels do not take."""
    dev = rays[0].device
    for a in rays:
        if a.device != dev or a.dtype != torch.float32 or a.shape != (r,) \
                or not a.is_contiguous():
            raise ValueError(
                "rays must be contiguous float32 [R] tensors on one CUDA "
                f"device, got {a.dtype} {tuple(a.shape)} on {a.device}")
    for name in names:
        tab = getattr(proto, name)
        if tab.device != dev or tab.dtype != torch.float32 \
                or not tab.is_contiguous():
            raise ValueError(f"mesh table {name} must be a contiguous float32 "
                             f"tensor on {dev}, got {tab.dtype} on {tab.device}")


def _outputs(r, dev):
    return (torch.empty((r,), dtype=torch.float32, device=dev),
            torch.empty((r,), dtype=torch.int32, device=dev),
            torch.empty((r,), dtype=torch.int32, device=dev),
            torch.empty((r,), dtype=torch.uint8, device=dev))


def _sweep_cuda(proto, o, d, t_max, t_min, any_hit):
    """Launch on PyTorch's current stream; does not synchronize."""
    global LAUNCHES_SWEEP
    r = t_max.shape[0]
    _check(proto, ("inst_w2l", "root_box", "k_coarsebox",
                   "k_tilebox", "k_subtilebox", "k_leafbox", "k_tri"),
           [*o, *d, t_max], r)
    t, tri, inst, hit = _outputs(r, t_max.device)
    if r:
        _launch("mesh_sweep_launch", _SWEEP_ARGTYPES, t_max.device,
                [proto.inst_w2l.data_ptr(), proto.n_instances, proto.root_box.data_ptr(),
                 proto.k_coarsebox.data_ptr(), proto.k_tilebox.data_ptr(),
                 proto.k_subtilebox.data_ptr(), proto.k_leafbox.data_ptr(),
                 proto.k_n_coarse, proto.k_tri.data_ptr(),
                 int(proto.k_tri.shape[1]), proto.n_tris,
                 *[a.data_ptr() for a in (*o, *d, t_max)], r, float(t_min),
                 int(any_hit), t.data_ptr(), tri.data_ptr(), inst.data_ptr(),
                 hit.data_ptr()])
        LAUNCHES_SWEEP += 1
    return t, tri, inst, hit.view(torch.bool)


def _stream_cuda(proto, o, d, t_max, t_min, any_hit):
    """Launch on PyTorch's current stream; does not synchronize."""
    global LAUNCHES_STREAM
    r = t_max.shape[0]
    _check(proto, ("inst_w2l", "root_box", "s_segbox", "s_tilebox", "s_tri"),
           [*o, *d, t_max], r)
    t, tri, inst, hit = _outputs(r, t_max.device)
    if r:
        n_seg = int(proto.s_tilebox.shape[0])
        tps = int(proto.s_tri.shape[0]) // (n_seg * SEG_TILES)
        _launch("mesh_stream_launch", _STREAM_ARGTYPES, t_max.device,
                [proto.inst_w2l.data_ptr(), proto.n_instances, proto.root_box.data_ptr(),
                 proto.s_segbox.data_ptr(), proto.s_tilebox.data_ptr(), n_seg, tps,
                 proto.s_tri.data_ptr(), proto.n_tris,
                 *[a.data_ptr() for a in (*o, *d, t_max)], r, float(t_min),
                 int(any_hit), t.data_ptr(), tri.data_ptr(), inst.data_ptr(),
                 hit.data_ptr()])
        LAUNCHES_STREAM += 1
    return t, tri, inst, hit.view(torch.bool)


def _rays(o, d, t_max):
    """V3s (or [R, 3] tensors) and [R] -> detached contiguous float32
    components, and t_max with ``>= BIG`` counted as BIG."""
    def comps(v):
        v = v if isinstance(v, V3) else V3.from_rows(v)
        return [c.detach().to(torch.float32).contiguous() for c in v]

    t_max = t_max.detach().to(torch.float32)
    big = float(BIG)
    return comps(o), comps(d), torch.where(t_max >= big, big, t_max).contiguous()


def intersect_mesh_kernel(proto, o, d, t_min, t_max, any_hit=False):
    """Closest (or, with ``any_hit``, any) triangle hit over every instance
    of a prototype of at most ``MAX_KERNEL_TRIS`` triangles.  Returns (t,
    tri, inst, hit, overflow = 0).  CUDA rays launch ``mesh_sweep`` (or
    raise); CPU rays run the plain version."""
    if not kernel_ok(proto):
        raise ValueError("the prototype has no small-mesh tables "
                         f"({proto.n_tris} triangles; at most {MAX_KERNEL_TRIS})")
    o_, d_, t_max_ = _rays(o, d, t_max)
    t_min = float(np.float32(t_min))
    if t_max_.is_cuda:
        t, tri, inst, hit = _sweep_cuda(proto, o_, d_, t_max_, t_min, any_hit)
        return t, tri, inst, hit, 0
    return (*_finish(*_sweep_plain(proto, o_, d_, t_max_, t_min, any_hit),
                     any_hit), 0)


def intersect_mesh_stream(proto, o, d, t_min, t_max, any_hit=False):
    """Closest (or any) triangle hit over every instance of a prototype
    built with the stream tables (more than ``MAX_KERNEL_TRIS``
    triangles).  Returns (t, tri, inst, hit, overflow = 0).  CUDA rays
    launch ``mesh_stream`` (or raise); CPU rays run the plain version."""
    if not stream_ok(proto):
        raise ValueError("the prototype has no tile-stream tables "
                         f"({proto.n_tris} triangles)")
    o_, d_, t_max_ = _rays(o, d, t_max)
    t_min = float(np.float32(t_min))
    if t_max_.is_cuda:
        t, tri, inst, hit = _stream_cuda(proto, o_, d_, t_max_, t_min, any_hit)
        return t, tri, inst, hit, 0
    return (*_finish(*_stream_plain(proto, o_, d_, t_max_, t_min, any_hit),
                     any_hit), 0)


def plain(kind: str, proto, o, d, t_min, t_max, any_hit=False, counts=None):
    """The plain version of ``kind`` ("sweep" or "stream") on tensors of any
    device: what the GPU check holds the kernel against.  Adds the work it
    does that the kernel does too to ``counts``, a dict, when one is given:
    ``local_rays`` (ray, instance) pairs transformed, ``box_tests``,
    ``tri_tests`` and, for the stream, ``tri_t_pass`` (triangles whose
    plane t passes, so that the barycentrics follow)."""
    o_, d_, t_max_ = _rays(o, d, t_max)
    fn = _sweep_plain if kind == "sweep" else _stream_plain
    return (*_finish(*fn(proto, o_, d_, t_max_, float(np.float32(t_min)),
                         any_hit, counts), any_hit), 0)
