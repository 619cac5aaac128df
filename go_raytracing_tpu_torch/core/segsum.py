"""Per-bin row sums with the same bits on every run.

Counterpart of the JAX package's ``core/segsum.py``, which sorts
(id, value) pairs and runs a segmented scan so that duplicate rows (the
texel cotangents of an environment map) are reduced before one placement.
Here, three steps (``ops/cuda_rows``): the rows that add something are kept
(``segment_keep``: an id in range, a column not zero), their int32 ids are
sorted (``torch.sort(stable=True)``), and the per-key sums are taken in that
order through the sort's permutation (``sorted_segment_sums``).  No step
uses atomics, so an environment's or an atlas's gradient has the same bits
from run to run, like every other gradient of the port.

Ids outside [0, n_bins) are dropped, negative ones included.  (The JAX
package clamps only the high end, so a negative id there corrupts every bin:
ROADMAP.md C2.)
"""

from __future__ import annotations

import torch

from ..ops import cuda_rows


# A harness that times the sums on the rows a path gave them sets this to a
# callable; each column sum then passes it its arguments before it runs:
# ("cols", ids, cols, n_bins) or ("factored", ids, carry_cols, expand,
# n_bins, zero_cols), the columns stacked.  None (the default) does nothing.
ON_CALL = None


def _stacked(cols):
    """[C, ...] columns: a tensor as it is, a sequence of C tensors stacked."""
    return cols if isinstance(cols, torch.Tensor) else torch.stack(list(cols))


def _kept_in_key_order(ids, test, n_bins: int):
    """(sorted int32 ids, the sort's permutation, the kept rows' flat
    indices) of the rows of ``ids`` that add something."""
    kept_ids, kept_rows = cuda_rows.segment_keep(ids, test, n_bins)
    keys, perm = torch.sort(kept_ids, stable=True)
    return keys, perm, kept_rows


def rows_segment_sum(ids, rows, n_bins: int):
    """Per-bin sums of ``rows`` [R, C] grouped by integer ``ids`` [R] ->
    [n_bins, C]: ``zeros.index_add_(0, ids, rows)`` for the ids in range,
    in a fixed order."""
    return cols_segment_sum(ids, rows.t(), n_bins)


def cols_segment_sum(ids, cols, n_bins: int):
    """Column form of :func:`rows_segment_sum`: per-bin sums of C value
    columns, each shaped like ``ids`` (a [C, *ids.shape] tensor, a view of
    any strides, or a sequence of C tensors), returned as [n_bins, C].  A
    row whose columns are all zero is skipped: it adds nothing."""
    cols = _stacked(cols)
    if ON_CALL is not None:
        ON_CALL("cols", ids, cols, n_bins)
    keys, perm, kept_rows = _kept_in_key_order(ids, cols, n_bins)
    return cuda_rows.sorted_segment_sums(keys, cols, n_bins, perm=perm, rows=kept_rows)


def cols_segment_sum_factored(ids, carry_cols, expand, n_bins: int, zero_cols=None):
    """Like :func:`cols_segment_sum`, but gathers only the narrow
    ``carry_cols`` into key order and expands them there:
    ``expand(*sorted_carry)`` -> list of value columns, elementwise.
    ``zero_cols`` (the carry columns where not given): columns shaped like
    ``ids`` where a row whose entries are all zero expands to zeros; such a
    row is skipped."""
    test = _stacked(carry_cols if zero_cols is None else zero_cols)
    if ON_CALL is not None:
        ON_CALL("factored", ids, carry_cols, expand, n_bins, test)
    keys, perm, kept_rows = _kept_in_key_order(ids, test, n_bins)
    src = kept_rows.index_select(0, perm)
    carry = [torch.index_select(c.reshape(-1), 0, src) for c in carry_cols]
    vals = torch.stack(list(expand(*carry)))
    return cuda_rows.sorted_segment_sums(keys, vals, n_bins)


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
