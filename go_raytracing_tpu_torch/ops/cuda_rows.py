"""Row sums in a fixed order: the backward pass of ``textures.take_rows``,
and the per-key sums of tables too large for it (``core/segsum``).

``row_sums(g, idx, n_rows)`` is ``zeros(n_rows, ...).index_add_(0, idx, g)``
with the same bits on every run.  A CUDA tensor launches the kernel of
``csrc/row_sums.cu`` (built at first use by ``ops/_build.py``) or raises; a
CPU tensor runs the plain version, ``_row_sums_plain`` (float64 sums, one
row after another), and only because it lies on the CPU.

Not a port of a TPU kernel: it gives the port's ``torch.autograd`` route
what the JAX package's gathers have on every backend, gradients that do not
change from run to run (ROADMAP.md C7).

The per-key sums of an environment map's or an atlas's texels take two
steps of the same file, each with its plain version:

* ``segment_keep(ids, test, n_keys)``: the rows that add something (an id
  in range, a tested column not zero), as int32 (id, row) pairs in input
  order (``_segment_keep_plain``);
* ``sorted_segment_sums(sorted_ids, vals, n_keys, perm, rows)``: the sums of
  rows taken in key order, through the sort's permutation and the kept
  rows, one launch a level of spans (``_sorted_segment_sums_plain``, float64
  ``index_add_``, also the card's oracle).
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES_ROW_SUMS = 0   # row_sums kernel launches (CUDA tensors only)
LAUNCHES_SEGMENT_KEEP = 0   # segment_keep's count and write kernel launches
LAUNCHES_SEGMENT_SUMS = 0   # segment_span_sums kernel launches, one a level

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, _P]


def _kernel(function: str, argtypes):
    from . import _build

    fn = getattr(_build.load("row_sums").lib, function)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _row_sums_plain(g, idx, n_rows: int):
    """Plain version: the rows added in float64, in input order."""
    out = torch.zeros((n_rows,) + tuple(g.shape[1:]), dtype=torch.float64,
                      device=g.device)
    return out.index_add_(0, idx.reshape(-1).long(), g.to(torch.float64)).to(g.dtype)


def _row_sums_cuda(g, idx, n_rows: int):
    """Launch the kernel on PyTorch's current stream, one launch for each
    tile of rows that a block's shared memory holds; does not synchronize.
    The blocks' partial rows are added by ``torch.sum``, whose order is
    fixed by the shapes."""
    global LAUNCHES_ROW_SUMS
    dev = g.device
    n = idx.numel()
    shape = (n_rows,) + tuple(g.shape[1:])
    g2 = g.reshape(n, -1).to(torch.float32).contiguous()
    idx = idx.reshape(-1).to(torch.int64).contiguous()
    if idx.device != dev:
        raise ValueError(f"indices on {idx.device}, rows on {dev}")
    cols = g2.shape[1]
    if n == 0 or n_rows == 0 or cols == 0:
        return torch.zeros(shape, dtype=g.dtype, device=dev)
    block_rows = _kernel("row_sums_block_rows", [])()
    max_acc = _kernel("row_sums_max_acc", [])()
    if cols > max_acc:
        raise ValueError(f"a row of {cols} columns does not fit the kernel's "
                         f"accumulator of {max_acc}")
    tile = max_acc // cols
    fn = _kernel("row_sums_launch", _ARGTYPES)
    parts = []
    for key0 in range(0, n_rows, tile):
        n_keys = min(tile, n_rows - key0)
        partial = torch.empty((-(-n // block_rows), n_keys * cols),
                              dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = fn(g2.data_ptr(), idx.data_ptr(), partial.data_ptr(), n, cols,
                     key0, n_keys, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"row_sums kernel launch failed: CUDA error {err}")
        LAUNCHES_ROW_SUMS += 1
        parts.append(partial.sum(dim=0).reshape(n_keys, cols))
    return torch.cat(parts).reshape(shape).to(g.dtype)


def row_sums(g, idx, n_rows: int):
    """Sums of ``g``'s rows ([R, ...]) by ``idx`` ([R] integers in
    [0, n_rows)) -> [n_rows, ...], in an order fixed by the shapes."""
    if g.is_cuda:
        return _row_sums_cuda(g, idx, n_rows)
    return _row_sums_plain(g, idx, n_rows)


_KEEP_COUNT_ARGTYPES = [_P, ctypes.c_int, _P, ctypes.c_int] + [ctypes.c_longlong] * 3 \
    + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P, _P, _P]
_KEEP_WRITE_ARGTYPES = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
_SUMS_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int] + [ctypes.c_longlong] * 4 \
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P, _P]


def _segment_keep_plain(ids, test, n_keys: int):
    """Plain version: the kept rows' ids and flat row indices, int32, in
    input order."""
    flat = ids.reshape(-1)
    keep = (flat >= 0) & (flat < n_keys)
    keep &= (test.reshape(test.shape[0], -1) != 0).any(dim=0)
    rows = torch.nonzero(keep).reshape(-1)
    return flat[rows].to(torch.int32), rows.to(torch.int32)


def _segment_keep_cuda(ids, test, n_keys: int):
    """Launch the count kernel, take the exclusive prefix of the blocks'
    counts (one read of the total to the host: it sizes the outputs), then
    launch the write kernel; on PyTorch's current stream."""
    global LAUNCHES_SEGMENT_KEEP
    dev = ids.device
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    if ids.numel() == 0:
        return empty, empty
    ids2 = ids.reshape(-1, ids.shape[-1])   # [D, R], R the last dimension
    if ids2.dtype not in (torch.int32, torch.int64):
        ids2 = ids2.to(torch.int64)
    ids2 = ids2.contiguous()
    d, r = ids2.shape
    if d * r >= 2 ** 31:
        raise ValueError(f"segment_keep takes fewer than 2^31 rows, got {d * r}")
    t3 = test.reshape(test.shape[0], d, r)   # a view where the strides allow
    if t3.dtype != torch.float32:
        t3 = t3.to(torch.float32)
    if t3.device != dev:
        raise ValueError(f"tested columns on {t3.device}, ids on {dev}")
    span = _kernel("segment_keep_span", [])()
    blocks = -(-r // span) * d
    mask = torch.empty(blocks * (span // 32), dtype=torch.int32, device=dev)
    counts = torch.empty(blocks, dtype=torch.int32, device=dev)
    ids64 = int(ids2.dtype == torch.int64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("segment_keep_count_launch", _KEEP_COUNT_ARGTYPES)(
            ids2.data_ptr(), ids64, t3.data_ptr(), t3.shape[0], *t3.stride(), d, r, n_keys,
            mask.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_keep count kernel launch failed: CUDA error {err}")
    LAUNCHES_SEGMENT_KEEP += 1
    ends = torch.cumsum(counts, 0)
    m = int(ends[-1])
    if m == 0:
        return empty, empty
    offsets = ends - counts
    kept_ids = torch.empty(m, dtype=torch.int32, device=dev)
    kept_rows = torch.empty(m, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel("segment_keep_write_launch", _KEEP_WRITE_ARGTYPES)(
            ids2.data_ptr(), ids64, d, r, mask.data_ptr(), offsets.data_ptr(),
            kept_ids.data_ptr(), kept_rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_keep write kernel launch failed: CUDA error {err}")
    LAUNCHES_SEGMENT_KEEP += 1
    return kept_ids, kept_rows


def segment_keep(ids, test, n_keys: int):
    """The rows of ``ids`` (integers of any shape, taken flat) that add
    something to a per-key sum: id in [0, n_keys) and one of the tested
    columns ``test`` [C', *ids.shape] not zero.  Returns (their ids, their
    flat row indices), int32, in input order."""
    if ids.is_cuda:
        return _segment_keep_cuda(ids, test, n_keys)
    return _segment_keep_plain(ids, test, n_keys)




def _sorted_segment_sums_plain(sorted_ids, vals, n_keys: int, perm=None, rows=None):
    """Plain version: each key's rows added in float64, in sorted order."""
    flat = vals.reshape(vals.shape[0], -1)
    if perm is not None:
        flat = flat[:, rows.long()[perm.long()]]
    keep = (sorted_ids >= 0) & (sorted_ids < n_keys)
    out = torch.zeros((n_keys, vals.shape[0]), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, sorted_ids[keep].long(), flat[:, keep].t().to(torch.float64))
    return out.to(torch.float32)


def _sorted_segment_sums_cuda(sorted_ids, vals, n_keys: int, perm=None, rows=None):
    """Launch the span sums on PyTorch's current stream, a level at a time
    until one span is left; does not synchronize."""
    global LAUNCHES_SEGMENT_SUMS
    dev = vals.device
    cols = vals.shape[0]
    max_cols = _kernel("segment_sums_max_cols", [])()
    if not 0 < cols <= max_cols:
        raise ValueError(f"sorted_segment_sums takes 1 to {max_cols} columns, got {cols}")
    n = sorted_ids.numel()
    if sorted_ids.device != dev or (perm is not None and perm.shape != (n,)):
        raise ValueError("ids (and perm) must be [n] tensors on the values' device")
    if perm is None and vals[0].numel() != n:
        raise ValueError(f"{n} ids for {vals[0].numel()} rows of values")
    out = torch.zeros((n_keys, cols), dtype=torch.float32, device=dev)
    if n == 0 or n_keys == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"sorted_segment_sums takes fewer than 2^31 rows, got {n}")
    keys = sorted_ids.reshape(-1)
    if keys.dtype != torch.int32:   # out-of-range ids stay out of range, in order
        keys = keys.clamp(-1, n_keys).to(torch.int32)
    keys = keys.contiguous()
    v = vals.reshape(cols, -1, vals.shape[-1])
    if v.dtype != torch.float32:
        v = v.to(torch.float32)
    if perm is not None:
        perm, rows = perm.to(torch.int64).contiguous(), rows.to(torch.int32).contiguous()
    span = _kernel("segment_sums_span", [])()
    fn = _kernel("segment_sums_launch", _SUMS_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the carries of every level but the last, in one buffer each
    levels, k = [], n
    while k > span:
        k = 2 * -(-k // span)
        levels.append(k)
    carry_keys = torch.empty(sum(levels), dtype=torch.int32, device=dev)
    carry_vals = torch.empty(cols * sum(levels), dtype=torch.float64, device=dev)
    sc, sb, sr = v.stride()
    r, v64, at = v.shape[2], 0, 0
    for level in range(len(levels) + 1):
        last = level == len(levels)
        ck = None if last else carry_keys[at:at + levels[level]]
        cv = None if last else carry_vals[cols * at:cols * (at + levels[level])]
        with torch.cuda.device(dev):
            err = fn(keys.data_ptr(), None if perm is None else perm.data_ptr(),
                     None if perm is None else rows.data_ptr(), v.data_ptr(), v64,
                     sc, sb, sr, r, cols, n, n_keys, out.data_ptr(),
                     None if last else ck.data_ptr(), None if last else cv.data_ptr(),
                     stream)
        if err != 0:
            raise RuntimeError(f"segment_span_sums kernel launch failed: CUDA error {err}")
        LAUNCHES_SEGMENT_SUMS += 1
        if last:
            return out
        # the next level: the carries, in key order, float64 [cols, n]
        n = r = levels[level]
        keys, v, perm, rows, v64 = ck, cv, None, None, 1
        sc, sb, sr = n, 0, 1
        at += n


def sorted_segment_sums(sorted_ids, vals, n_keys: int, perm=None, rows=None):
    """Per-key sums of rows taken in key order -> [n_keys, C] float32.

    ``sorted_ids`` [n] ascending; ``vals`` [C, ...] float32 columns whose
    rows, taken flat, are the rows to add; sorted row j is flat row
    ``rows[perm[j]]`` (``perm`` the sort's permutation, ``rows`` the kept
    rows' indices, both given or both None: row j).  Ids outside
    [0, n_keys) are dropped.  The sums are float64, in an order fixed by the
    sorted rows' order, so the result has the same bits on every run."""
    if (perm is None) != (rows is None):
        raise ValueError("perm and rows are given together or not at all")
    if vals.is_cuda:
        return _sorted_segment_sums_cuda(sorted_ids, vals, n_keys, perm, rows)
    return _sorted_segment_sums_plain(sorted_ids, vals, n_keys, perm, rows)
