"""Row sums in a fixed order: the backward pass of ``textures.take_rows``.

``row_sums(g, idx, n_rows)`` is ``zeros(n_rows, ...).index_add_(0, idx, g)``
with the same bits on every run.  A CUDA tensor launches the kernel of
``csrc/row_sums.cu`` (built at first use by ``ops/_build.py``) or raises; a
CPU tensor runs the plain version, ``_row_sums_plain`` (float64 sums, one
row after another), and only because it lies on the CPU.

Not a port of a TPU kernel: it gives the port's ``torch.autograd`` route
what the JAX package's gathers have on every backend, gradients that do not
change from run to run (ROADMAP.md C7).

``sorted_segment_sums(sorted_ids, vals, n_keys)`` sums rows that come sorted
by key, for tables too large for ``row_sums``' shared memory (an environment
map's texels, ``core/segsum``): a second kernel of the same file, one warp a
key; its plain version is ``_sorted_segment_sums_plain``.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES_ROW_SUMS = 0   # row_sums kernel launches (CUDA tensors only)
LAUNCHES_SEGMENT_SUMS = 0   # sorted_segment_sums kernel launches

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


_SEG_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, _P]


def _sorted_segment_sums_plain(sorted_ids, vals, n_keys: int):
    """Plain version: each key's rows added in float64, in input order."""
    keep = (sorted_ids >= 0) & (sorted_ids < n_keys)
    out = torch.zeros((n_keys, vals.shape[0]), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, sorted_ids[keep], vals[:, keep].t().to(torch.float64))
    return out.to(torch.float32)


def _sorted_segment_sums_cuda(sorted_ids, vals, n_keys: int):
    """Launch the kernel on PyTorch's current stream; does not synchronize."""
    global LAUNCHES_SEGMENT_SUMS
    dev = vals.device
    cols, n = vals.shape
    max_cols = _kernel("sorted_segment_sums_max_cols", [])()
    if not 0 < cols <= max_cols:
        raise ValueError(f"sorted_segment_sums takes 1 to {max_cols} columns, got {cols}")
    if sorted_ids.device != dev or sorted_ids.shape != (n,):
        raise ValueError("ids must be an [n] tensor on the values' device")
    out = torch.empty((n_keys, cols), dtype=torch.float32, device=dev)
    if n_keys == 0:
        return out
    # the first row of each key's run (ids outside [0, n_keys) fall before
    # the first run or after the last)
    keys = torch.arange(n_keys + 1, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_ids.to(torch.int64).contiguous(), keys)
    vals = vals.to(torch.float32).contiguous()
    fn = _kernel("sorted_segment_sums_launch", _SEG_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(vals.data_ptr(), starts.data_ptr(), out.data_ptr(), n, cols,
                 n_keys, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sorted_segment_sums kernel launch failed: CUDA error {err}")
    LAUNCHES_SEGMENT_SUMS += 1
    return out


def sorted_segment_sums(sorted_ids, vals, n_keys: int):
    """Per-key sums of the columns ``vals`` [C, n] whose rows come sorted by
    ``sorted_ids`` [n] (ascending int64) -> [n_keys, C] float32, in an order
    fixed by the keys' run lengths.  Ids outside [0, n_keys) are dropped."""
    if vals.is_cuda:
        return _sorted_segment_sums_cuda(sorted_ids, vals, n_keys)
    return _sorted_segment_sums_plain(sorted_ids, vals, n_keys)
