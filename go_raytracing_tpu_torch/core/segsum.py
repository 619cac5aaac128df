"""Per-bin row sums with the same bits on every run.

Counterpart of the JAX package's ``core/segsum.py``, which sorts
(id, value) pairs and runs a segmented scan so that duplicate rows (the
texel cotangents of an environment map) are reduced before one placement.
Here: a stable sort of the ids (``torch.sort(stable=True)``), one gather of
the value columns into that order, and the fixed-order per-key sums of
``ops/cuda_rows.sorted_segment_sums``.  Neither step uses atomics, so an
environment's gradient has the same bits from run to run, like every other
gradient of the port.

Ids outside [0, n_bins) are dropped, negative ones included.  (The JAX
package clamps only the high end, so a negative id there corrupts every bin:
ROADMAP.md C2.)
"""

from __future__ import annotations

import torch

from ..ops import cuda_rows


def _sort(ids):
    ids = ids.reshape(-1).to(torch.int64)
    return torch.sort(ids, stable=True)


def rows_segment_sum(ids, rows, n_bins: int):
    """Per-bin sums of ``rows`` [R, C] grouped by integer ``ids`` [R] ->
    [n_bins, C]: ``zeros.index_add_(0, ids, rows)`` for the ids in range,
    in a fixed order."""
    return cols_segment_sum(ids, [rows[:, j] for j in range(rows.shape[1])],
                            n_bins)


def cols_segment_sum(ids, col_list, n_bins: int):
    """Column form of :func:`rows_segment_sum`: per-bin sums of C separate
    [R] value columns, returned as [n_bins, C]."""
    sid, perm = _sort(ids)
    vals = torch.stack([torch.index_select(c.reshape(-1), 0, perm)
                        for c in col_list])
    return cuda_rows.sorted_segment_sums(sid, vals, n_bins)


def cols_segment_sum_factored(ids, carry_cols, expand, n_bins: int):
    """Like :func:`cols_segment_sum`, but gathers only the narrow
    ``carry_cols`` into key order and expands them there:
    ``expand(*sorted_carry)`` -> list of value columns, elementwise."""
    sid, perm = _sort(ids)
    carry = [torch.index_select(c.reshape(-1), 0, perm) for c in carry_cols]
    vals = torch.stack(list(expand(*carry)))
    return cuda_rows.sorted_segment_sums(sid, vals, n_bins)


class _TakeRowsSorted(torch.autograd.Function):
    """``index_select`` whose backward pass is :func:`rows_segment_sum`."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return rows_segment_sum(idx, g, ctx.n_rows).to(g.dtype), None


def take_rows_sorted(table, idx):
    """``table[idx]`` for a large table a gradient may flow into (an
    environment map's texels): the backward pass sums each row's cotangents
    by :func:`rows_segment_sum`, in a fixed order.  (``textures.take_rows``
    keeps a whole table's sums in a block's shared memory, which suits a few
    hundred rows, not half a million.)"""
    if table.requires_grad and torch.is_grad_enabled():
        return _TakeRowsSorted.apply(table, idx)
    return torch.index_select(table, 0, idx)
