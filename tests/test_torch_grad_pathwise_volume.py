"""PyTorch port vs the JAX package: the pathwise gradient kernels on a fog
box around a fuzzy metal and a glass sphere, under the sky gradient.  One
JAX reverse call (interpret mode, cached) holds both what
tests/test_torch_grad_pathwise.py does not reach: the volume
scatter-distance adjoint (entry slab and free-flight length) and the sky
colour's derivative by the miss direction."""

import dataclasses
import functools

import numpy as np
import torch

from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import (MINI_GLOSSY_CAM, build_mini_volume_glossy,
                                check_pathwise_forward, check_pathwise_reverse,
                                pathwise_case)

torch.set_num_threads(2)

# depth 3: the interpret-mode reverse costs about 15 s a bounce
SKY_CAM = dict(MINI_GLOSSY_CAM, use_sky_gradient=True, max_depth=3)


@functools.lru_cache(maxsize=None)
def _case():
    return pathwise_case(build_mini_volume_glossy, SKY_CAM)


def test_pathwise_volume_fwd_plain_matches_interpret_pallas_kernel():
    t_si = check_pathwise_forward(_case(), cw)
    mk = t_si[:, 2]
    vol = (mk & cw.PW_VOLUME) != 0
    assert vol.mean() > 0.05                       # the fog is met often
    assert ((mk[vol] >> cw.PW_VOL_SHIFT) & 3 == 0).all()   # one volume: index 0
    assert (t_si[:, 1][vol] == cw.MSLOT_NONE).all()        # no fuzz / ior there
    assert (t_si[:, 0][vol] >= 0).all()                    # but a colour
    for bit in (cw.PW_LIT, cw.PW_METAL, cw.PW_DIELECTRIC, cw.PW_BLK_A):
        assert (mk & bit).any(), bit


def test_pathwise_volume_rev_plain_matches_jax_reverse():
    check_pathwise_reverse(_case())


def test_pathwise_sky_direction_term_counts():
    """Under a flat background the same stash gives other fuzz and ior
    sums: the sky's derivative by the miss direction is in them."""
    c = _case()
    o, d, tm, ids = c["rays"]
    flat = dataclasses.replace(c["tcam"], use_sky_gradient=False)
    g = cw.grad_rev_stash(c["ts"], flat, torch.from_numpy(c["g3"]), c["t_carry"],
                          pathwise=True, stream=ids, seed=c["seed"])
    for k in ("fuzz", "ior"):
        diff = np.abs(g[k].numpy() - c["t_grads"][k]).max()
        assert diff > 1e-3 * np.abs(c["t_grads"][k]).max(), k
    # the colours' sums do not read the direction adjoint
    for k in ("even_color", "odd_color"):
        np.testing.assert_allclose(g[k].numpy(), c["t_grads"][k], rtol=1e-6)


def test_volume_entry_matches_the_window():
    """``_volume_entry``'s near is the forward window's, and the axis it
    picks is the one whose slab gives it."""
    c = _case()
    tb = cw.build_tables(c["ts"])
    o, d, _, _ = c["rays"]
    near, ne, inv_e, act_e = cw._volume_entry(tb, list(o), list(d), 0)
    assert torch.isfinite(near).all() and (act_e == 1).all()
    # axis-aligned box: ne is a unit axis, inv_e the reciprocal of d there
    assert ((torch.stack(ne).abs().sum(dim=0) - 1).abs() < 1e-6).all()
    dn = sum(ne[i] * d[i] for i in range(3))
    torch.testing.assert_close(inv_e, 1.0 / dn)
