"""Instanced triangle meshes: the implicit wide BVH of one prototype.

The reference builds a pointer-based binary BVH with median splits on the
longest centroid axis.  A median split (``mid = n/2``) makes the tree
exactly balanced, so the hierarchy is kept *implicit*: the triangles are
reordered by level-by-level segment sorts (the same topology as the
reference's build), and node (k, i) covers a contiguous triangle segment
whose 8 children at level k+1 are its arithmetic sub-segments.  No pointers
anywhere: the boxes of any segment are the boxes of a BVH node.

The build runs on the host in NumPy and repeats the JAX package's
``geometry/mesh_bvh.build_proto`` operation for operation, so both packages
hold the same triangle order and the same boxes.  Of the two kernels' table
sets (``ops/cuda_mesh``) it builds one by the prototype's size: the
small-mesh ladder's tables up to ``cuda_mesh.MAX_KERNEL_TRIS`` triangles,
the tile stream's above.  Which set exists decides which kernel runs.

Instancing: instances share one prototype and carry world->local affines;
rays are transformed into local space (an affine map keeps ``t``), and hit
normals are mapped back by the inverse transpose.

The JAX package's frontier traversal (``intersect_mesh``), its fallback
where no Pallas kernel applies, has no counterpart here: the two kernels of
``ops/cuda_mesh`` take a prototype of any size up to 2^24 triangles (the
stream carries triangle ids as float32), with any number of instances.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

BRANCH = 8          # children per wide node (3 binary median splits)
LEAF_SIZE = 8       # most triangles in a leaf segment


@dataclass(frozen=True)
class MeshProto:
    """One triangle prototype (BLAS) with its implicit wide BVH, the
    instances that reference it and the tables of its kernel."""

    # Leaf-ordered triangles (local space)
    tri_v0: torch.Tensor       # [T, 3]
    tri_e1: torch.Tensor       # [T, 3]
    tri_e2: torch.Tensor       # [T, 3]
    # Per-level child boxes: level k has 8^k parent nodes x BRANCH children
    level_bbox_min: Tuple[torch.Tensor, ...]  # each [8^k, BRANCH, 3]
    level_bbox_max: Tuple[torch.Tensor, ...]
    leaf_start: torch.Tensor   # [n_leaves] i32 (leaves = segments of the last level)
    leaf_count: torch.Tensor   # [n_leaves] i32 (<= LEAF_SIZE)
    root_bbox_min: torch.Tensor  # [3]
    root_bbox_max: torch.Tensor  # [3]
    # Instances
    inst_w2l: torch.Tensor     # [I, 3, 4] world -> local affine
    inst_nmat: torch.Tensor    # [I, 3, 3] normal transform (inverse transpose)
    inst_mat: torch.Tensor     # [I] i32 material id
    # World-space box of all instances
    world_bbox_min: torch.Tensor  # [3]
    world_bbox_max: torch.Tensor  # [3]
    # Small-mesh ladder tables (ops/cuda_mesh.mesh_sweep; empty above
    # MAX_KERNEL_TRIS triangles)
    k_tri: torch.Tensor        # [9, Tpad] padded v0/e1/e2 component rows
    k_leafbox: torch.Tensor    # [n_leaf, 2, 3]
    k_subtilebox: torch.Tensor  # [n_sub, 2, 3]
    k_tilebox: torch.Tensor    # [n_tiles, 2, 3]
    k_coarsebox: torch.Tensor  # [n_coarse, 2, 3]
    # Tile-stream tables (ops/cuda_mesh.mesh_stream; empty up to
    # MAX_KERNEL_TRIS triangles)
    s_tri: torch.Tensor        # [NT, ROWS, TILE] tile-major Baldwin-Weber rows
    s_tilebox: torch.Tensor    # [S, 6, SEG_TILES] slot boxes
    depth: int = 0
    k_n_tiles: int = 0
    k_n_coarse: int = 0
    s_n_seg: int = 0
    # Derived once from the fields above, for the kernels' wrappers and
    # plain versions: the root box [6] (min xyz, max xyz), the stream's
    # segment boxes [S, 6] (each the union of its slots; padding slots are
    # +BIG/-BIG and vanish), and the world->local affines as host floats.
    root_box: torch.Tensor = field(init=False, repr=False, compare=False)
    s_segbox: torch.Tensor = field(init=False, repr=False, compare=False)
    w2l_host: tuple = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        tb = self.s_tilebox
        for name, value in (
                ("root_box", torch.cat([self.root_bbox_min, self.root_bbox_max])),
                ("s_segbox", torch.cat([tb[:, 0:3, :].amin(dim=2),
                                        tb[:, 3:6, :].amax(dim=2)], dim=1).contiguous()),
                ("w2l_host", tuple(tuple(map(tuple, m)) for m in self.inst_w2l.tolist()))):
            object.__setattr__(self, name, value)

    @property
    def n_instances(self) -> int:
        return int(self.inst_mat.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_start.shape[0])

    @property
    def n_tris(self) -> int:
        return int(self.tri_v0.shape[0])


TENSOR_FIELDS = (
    "tri_v0", "tri_e1", "tri_e2", "leaf_start", "leaf_count",
    "root_bbox_min", "root_bbox_max", "inst_w2l", "inst_nmat", "inst_mat",
    "world_bbox_min", "world_bbox_max", "k_tri", "k_leafbox", "k_subtilebox",
    "k_tilebox", "k_coarsebox", "s_tri", "s_tilebox",
)
STATIC_FIELDS = ("depth", "k_n_tiles", "k_n_coarse", "s_n_seg")


def proto_from_numpy(fields: dict, device) -> MeshProto:
    """Dict of the ``MeshProto`` field names (numpy arrays, tuples of them
    for the level boxes, ints) -> ``MeshProto`` on ``device``.  Integer
    arrays become int32, the others float32."""
    def tensor(a):
        a = np.asarray(a)
        dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        return torch.from_numpy(np.array(a, dtype)).to(device)

    vals = {k: tensor(fields[k]) for k in TENSOR_FIELDS}
    for k in ("level_bbox_min", "level_bbox_max"):
        vals[k] = tuple(tensor(a) for a in fields[k])
    vals.update({k: int(fields[k]) for k in STATIC_FIELDS})
    return MeshProto(**vals)


def build_proto(verts: np.ndarray, tris: np.ndarray, instances, device) -> MeshProto:
    """Build the implicit wide BVH and the kernel's tables.

    verts [V,3] f64, tris [T,3] int, instances: list of (affine_4x4, mat_id)
    where the affine maps local -> world.  ``device`` is a torch device.
    """
    from ..ops import cuda_mesh

    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    n_tris = len(tris)
    if not 0 < n_tris <= cuda_mesh.MAX_STREAM_TRIS:
        raise ValueError(f"a mesh prototype takes 1 to {cuda_mesh.MAX_STREAM_TRIS} "
                         f"triangles, got {n_tris}")

    # Max leaf size after 3*depth median splits is ceil(n / 2^(3*depth))
    # (repeated halving: ceil(ceil(n/2)/2) == ceil(n/4)).
    depth = 0
    while -(-n_tris // (1 << (3 * depth))) > LEAF_SIZE:
        depth += 1

    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    centroid = (lo + hi) * 0.5

    # Level-by-level segment sorts on the longest centroid axis: the
    # vectorized equivalent of the reference's recursive sort and split.
    # Median splits keep segments arithmetic, so the tree never needs nodes.
    order = np.arange(n_tris)
    seg_starts = np.array([0, n_tris], np.int64)
    for _level in range(3 * depth):
        starts, ends = seg_starts[:-1], seg_starts[1:]
        counts = ends - starts
        seg_id = np.repeat(np.arange(len(starts)), counts)
        c = centroid[order]
        # per-segment centroid extents via reduceat (empty segments masked)
        nonempty = counts > 0
        red_idx = np.minimum(starts, n_tris - 1)
        cmin = np.minimum.reduceat(c, red_idx, axis=0)
        cmax = np.maximum.reduceat(c, red_idx, axis=0)
        ext = np.where(nonempty[:, None], cmax - cmin, 0.0)
        # the reference's longest-axis tie-break: x strictly greatest, else
        # y against z
        axis = np.where(
            (ext[:, 0] > ext[:, 1]) & (ext[:, 0] > ext[:, 2]),
            0,
            np.where(ext[:, 1] > ext[:, 2], 1, 2),
        )
        key = c[np.arange(n_tris), axis[seg_id]]
        perm = np.lexsort((key, seg_id))
        order = order[perm]
        mids = starts + counts // 2
        nxt = np.empty(2 * len(starts) + 1, np.int64)
        nxt[0::2] = seg_starts
        nxt[1::2] = mids
        seg_starts = nxt

    v0, v1, v2 = v0[order], v1[order], v2[order]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)

    def seg_boxes(bounds):
        """Boxes of the segments delimited by ``bounds`` (empty -> inf/-inf)."""
        starts, ends = bounds[:-1], bounds[1:]
        nonempty = ends > starts
        red_idx = np.minimum(starts, max(n_tris - 1, 0))
        mn = np.minimum.reduceat(lo, red_idx, axis=0)
        mx = np.maximum.reduceat(hi, red_idx, axis=0)
        # reduceat reduces to the next boundary in red_idx order, which for
        # monotone starts is the segment; empties are set explicitly.
        mn = np.where(nonempty[:, None], mn, np.inf)
        mx = np.where(nonempty[:, None], mx, -np.inf)
        # Degenerate axes are padded, so that flat (axis-aligned) geometry
        # still passes the slab test.
        thin = (mx - mn) < 1e-4
        mn = np.where(thin & nonempty[:, None], mn - 1e-4, mn)
        mx = np.where(thin & nonempty[:, None], mx + 1e-4, mx)
        return mn, mx

    level_bbox_min, level_bbox_max = [], []
    for k in range(depth):
        mn, mx = seg_boxes(_wide_bounds(n_tris, k + 1))
        parents = 8 ** k
        level_bbox_min.append(mn.reshape(parents, BRANCH, 3))
        level_bbox_max.append(mx.reshape(parents, BRANCH, 3))

    leaf_bounds = _wide_bounds(n_tris, depth)
    leaf_start = leaf_bounds[:-1].astype(np.int32)
    leaf_count = (leaf_bounds[1:] - leaf_bounds[:-1]).astype(np.int32)
    assert leaf_count.max(initial=0) <= LEAF_SIZE

    root_min = lo.min(axis=0)
    root_max = hi.max(axis=0)
    thin = (root_max - root_min) < 1e-4
    root_min = np.where(thin, root_min - 1e-4, root_min)
    root_max = np.where(thin, root_max + 1e-4, root_max)

    w2l = np.zeros((len(instances), 3, 4))
    nmat = np.zeros((len(instances), 3, 3))
    mats = np.zeros(len(instances), np.int32)
    corners = np.stack(np.meshgrid(
        [root_min[0], root_max[0]], [root_min[1], root_max[1]],
        [root_min[2], root_max[2]], indexing="ij",
    ), axis=-1).reshape(8, 3)
    wmin = np.full(3, np.inf)
    wmax = np.full(3, -np.inf)
    for i, (l2w, mat_id) in enumerate(instances):
        inv = np.linalg.inv(l2w)
        w2l[i] = inv[:3, :4]
        nmat[i] = np.linalg.inv(l2w[:3, :3]).T
        mats[i] = mat_id
        wc = corners @ l2w[:3, :3].T + l2w[:3, 3]
        wmin = np.minimum(wmin, wc.min(axis=0))
        wmax = np.maximum(wmax, wc.max(axis=0))
    if not np.all(np.isfinite(wmin)):
        wmin, wmax = np.zeros(3), np.ones(3)

    e1 = v1 - v0
    e2 = v2 - v0
    v0f, e1f, e2f = (a.astype(np.float32) for a in (v0, e1, e2))
    # One table set per size class: building only the one that applies
    # keeps a large mesh from paying for both.
    if n_tris <= cuda_mesh.MAX_KERNEL_TRIS:
        (ktri, leafbox, subtilebox, tilebox, coarsebox, n_tiles,
         n_coarse) = cuda_mesh.build_kernel_tables(v0f, e1f, e2f)
        s_tri = np.zeros((0, cuda_mesh.ROWS, cuda_mesh.TILE), np.float32)
        s_tilebox = np.zeros((0, 6, cuda_mesh.SEG_TILES), np.float32)
        s_n_seg = 0
    else:
        ktri = np.zeros((9, 0), np.float32)
        leafbox = subtilebox = tilebox = coarsebox = np.zeros((0, 2, 3), np.float32)
        n_tiles = n_coarse = 0
        s_tri, s_tilebox, s_n_seg = cuda_mesh.build_stream_tables(v0f, e1f, e2f)
    return proto_from_numpy(dict(
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        level_bbox_min=level_bbox_min, level_bbox_max=level_bbox_max,
        leaf_start=leaf_start, leaf_count=leaf_count,
        root_bbox_min=root_min, root_bbox_max=root_max,
        inst_w2l=w2l, inst_nmat=nmat, inst_mat=mats,
        world_bbox_min=wmin, world_bbox_max=wmax,
        k_tri=ktri, k_leafbox=leafbox, k_subtilebox=subtilebox,
        k_tilebox=tilebox, k_coarsebox=coarsebox,
        s_tri=s_tri, s_tilebox=s_tilebox,
        depth=depth, k_n_tiles=n_tiles, k_n_coarse=n_coarse, s_n_seg=s_n_seg,
    ), device)


def _wide_bounds(n_tris: int, k: int) -> np.ndarray:
    """Segment boundary offsets of the 8^k wide segments at wide level k."""
    b = np.array([0, n_tris], np.int64)
    for _ in range(3 * k):
        starts, ends = b[:-1], b[1:]
        mids = starts + (ends - starts) // 2
        nxt = np.empty(2 * len(starts) + 1, np.int64)
        nxt[0::2] = b
        nxt[1::2] = mids
        b = nxt
    return b
