"""The per-key sums of large tables (``core/segsum``, ``ops/cuda_rows``) on
their plain versions, against float64 ``index_add_`` over the rows in input
order: the kept rows (``segment_keep``), the sums in key order through the
sort's permutation (``sorted_segment_sums``) and the three entry points that
the environment and image tiers call.  No JAX call: the JAX package's
counterpart is held to the port in ``test_torch_hdri.py``."""

import numpy as np
import pytest
import torch

from go_raytracing_tpu_torch.core import segsum
from go_raytracing_tpu_torch.ops import cuda_rows

N_KEYS = 700
# more rows than three of the CUDA kernel's spans (512 sorted rows a warp)
N_ROWS = 6000


def _case(cols: int, seed: int = 0):
    """(ids [N_ROWS] int64, columns [cols, N_ROWS] f32): one key holds most
    rows in one long run of the sorted order, many keys are empty, some ids
    are negative or past the last key, and some rows are all zero, some all
    -0.0, among rows that are not."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N_KEYS // 4, N_ROWS) * 4          # 3 keys of 4 empty
    ids[rng.random(N_ROWS) < 0.55] = 333                     # the long run
    ids[::13] = -1 - rng.integers(0, 5, ids[::13].size)
    ids[5::17] = N_KEYS + rng.integers(0, 5, ids[5::17].size)
    vals = rng.normal(size=(cols, N_ROWS)).astype(np.float32)
    vals[:, ::3] = 0.0
    vals[:, 1::7] = -0.0
    return torch.from_numpy(ids), torch.from_numpy(vals)


def _reference(ids, vals):
    """float64 sums over the ids in range, in input order, as float32."""
    keep = (ids >= 0) & (ids < N_KEYS)
    out = torch.zeros((N_KEYS, vals.shape[0]), dtype=torch.float64)
    out.index_add_(0, ids[keep], vals[:, keep].t().double())
    return out.float()


def _close(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-6 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("cols", [1, 3, 12])
def test_cols_segment_sum_matches_index_add(cols):
    ids, vals = _case(cols)
    want = _reference(ids, vals)
    _close(segsum.cols_segment_sum(ids, vals, N_KEYS), want)
    # a sequence of columns and the row form give the same sums
    _close(segsum.cols_segment_sum(ids, list(vals), N_KEYS), want)
    _close(segsum.rows_segment_sum(ids, vals.t(), N_KEYS), want)
    # empty keys read 0, the long run's key its sum
    assert float(want[1].abs().max()) == 0.0 and float(want[333].abs().max()) > 0.0


def test_segment_keep_keeps_rows_that_add_something_in_input_order():
    ids, vals = _case(3)
    kid, krow = cuda_rows.segment_keep(ids, vals, N_KEYS)
    assert kid.dtype == torch.int32 and krow.dtype == torch.int32
    keep = (ids >= 0) & (ids < N_KEYS) & (vals != 0).any(dim=0)
    assert torch.equal(krow.long(), torch.nonzero(keep).reshape(-1))
    assert torch.equal(kid.long(), ids[keep])
    # -0.0 rows count as zero; with a column of ones every id in range stays
    assert not bool(keep[1::7][1:].any()) and bool(keep.any())
    kid_all, _ = cuda_rows.segment_keep(ids, torch.ones((1, N_ROWS)), N_KEYS)
    assert kid_all.numel() == int(((ids >= 0) & (ids < N_KEYS)).sum())
    # every row dropped
    none_id, none_row = cuda_rows.segment_keep(ids, torch.zeros_like(vals), N_KEYS)
    assert none_id.numel() == 0 and none_row.numel() == 0
    assert float(segsum.cols_segment_sum(ids, torch.zeros_like(vals), N_KEYS).abs().max()) == 0


def test_sorted_segment_sums_through_the_permutation():
    """The sums of rows taken through (permutation, kept rows), of rows
    already in key order, and of [D, C, R] columns seen as a strided
    [C, D, R] view (the fused tier's eout rows) with [D, R] ids."""
    ids, vals = _case(3, seed=1)
    kid, krow = cuda_rows.segment_keep(ids, vals, N_KEYS)
    keys, perm = torch.sort(kid, stable=True)
    want = _reference(ids, vals)
    _close(cuda_rows.sorted_segment_sums(keys, vals, N_KEYS, perm=perm, rows=krow), want)
    ordered = vals[:, krow.long()[perm]]
    _close(cuda_rows.sorted_segment_sums(keys, ordered, N_KEYS), want)
    layers = vals.reshape(3, 4, N_ROWS // 4).permute(1, 0, 2).contiguous()   # [D, C, R]
    got = segsum.cols_segment_sum(ids.reshape(4, N_ROWS // 4), layers.transpose(0, 1), N_KEYS)
    _close(got, want)


def test_factored_form_skips_rows_whose_cotangent_is_zero():
    rng = np.random.default_rng(2)
    ids, _ = _case(1, seed=2)
    fx = torch.from_numpy(rng.random(N_ROWS).astype(np.float32))
    lam = torch.from_numpy(rng.normal(size=(3, N_ROWS)).astype(np.float32))
    lam[:, rng.random(N_ROWS) < 0.7] = 0.0

    def expand(fx_, *l3):
        return [w * ch for w in (fx_, 1.0 - fx_) for ch in l3]

    want = _reference(ids, torch.stack(expand(fx, *lam)))
    # the cotangent's columns tested, or (not given) every carry column
    for zero_cols in (tuple(lam), None):
        got = segsum.cols_segment_sum_factored(ids, (fx, *lam), expand, N_KEYS,
                                               zero_cols=zero_cols)
        _close(got, want)
