"""PyTorch port vs the JAX package: the pathwise gradient kernels (metal
fuzz, glass IOR, colours behind a specular chain) on the mini-glossy scene.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode (``INTERPRET = True``,
``BLOCK_ROWS = 8``, restored afterwards; nothing in the JAX package
changes).  One JAX reverse call takes most of a minute here, so the file
makes one and caches it.  The volume adjoint and the sky are in
tests/test_torch_grad_pathwise_volume.py, ``render_grad`` in
tests/test_torch_grad_pathwise_render.py, the CUDA kernels in
tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch

import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import (MINI_GLOSSY_CAM, PATHWISE_KEYS,
                                build_mini_glossy, check_pathwise_forward,
                                check_pathwise_reverse, pathwise_case)

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _case():
    # depth 3: the interpret-mode reverse costs about 15 s a bounce
    return pathwise_case(build_mini_glossy, dict(MINI_GLOSSY_CAM, max_depth=3))


def test_pathwise_fwd_plain_matches_interpret_pallas_kernel():
    t_si = check_pathwise_forward(_case(), cw)
    mk = t_si[:, 2]
    # every kind of row occurs: emission seen, survivors, misses, blocked
    # and open shadow rays, back faces (inside the glass), both speculars
    for bit in (cw.PW_EMIT, cw.PW_ALIVE_NEXT, cw.PW_LIT, cw.PW_BLK_A,
                cw.PW_FRONT, cw.PW_METAL, cw.PW_DIELECTRIC, cw.PW_USE_MIS):
        assert (mk & bit).any(), bit
    hit = (mk & cw.PW_HIT) != 0
    assert (hit & ((mk & cw.PW_FRONT) == 0)).any()
    assert not (mk & (cw.PW_VOLUME | cw.PW_BLK_H | cw.PW_MARBLE)).any()
    # checker variants, and a dielectric winner has no albedo slot
    assert {0, 1, 2} <= set((t_si[:, 0][t_si[:, 0] >= 0] % 3).tolist())
    assert (t_si[:, 0][(mk & cw.PW_DIELECTRIC) != 0] == cw.SLOT_NONE).all()
    mats = set(t_si[:, 1][hit].tolist())
    assert mats == set(range(int(_case()["ts"].materials.kind.shape[0])))


def test_pathwise_fwd_radiance_is_the_forward_kernels():
    """The stash changes nothing of the bounce loop: bit-equal radiance."""
    c = _case()
    ts, tcam = c["ts"], c["tcam"]
    o, d, tm, ids = c["rays"]
    out, flags = cw.wavefront_fwd(cw.build_tables(ts), o, d, tm, ids, c["seed"],
                                  tcam.max_depth)
    mc = cw._miss_colour_rows(out, flags, cw.miss_config(tcam))
    want = torch.stack([out[ch] + out[6 + ch] * mc[ch] for ch in range(3)])
    np.testing.assert_array_equal(c["t_rad"], want.numpy())
    assert torch.equal(c["t_carry"][0], mc)


def test_pathwise_rev_plain_matches_jax_reverse():
    c = _case()
    check_pathwise_reverse(c)
    kinds = c["ts"].materials.kind.numpy()
    # fuzz only on metals (the mirror's too: d/dfuzz at fuzz = 0), ior only
    # on the glass
    assert (c["t_grads"]["fuzz"][kinds != 1] == 0).all()
    assert (c["t_grads"]["fuzz"][kinds == 1] != 0).all()
    assert (c["t_grads"]["ior"][kinds != 2] == 0).all()
    assert (c["t_grads"]["ior"][kinds == 2] != 0).all()


def test_pathwise_trace_backward():
    """A caller's own loss on a chunk's radiance: ``.backward()`` through
    ``PathwiseTrace`` gives the reverse sweep's gradients."""
    c = _case()
    ts, tcam = c["ts"], c["tcam"]
    o, d, tm, ids = c["rays"]
    params = grtt.trainable_params(ts)
    leaves = [params[k].clone().requires_grad_(True)
              for k in ("fuzz", "ior", "color", "even_color", "odd_color")]
    rad = cw.PathwiseTrace.apply(*leaves, ts, tcam, o, d, tm, ids, c["seed"])
    assert rad.shape == (3, ids.shape[0]) and rad.requires_grad
    np.testing.assert_array_equal(rad.detach().numpy(), c["t_rad"])
    (rad * torch.from_numpy(c["g3"])).sum().backward()
    for leaf, k in zip(leaves, ("fuzz", "ior", "color", "even_color", "odd_color")):
        np.testing.assert_array_equal(leaf.grad.numpy(), c["t_grads"][k], err_msg=k)


@pytest.mark.parametrize("key", PATHWISE_KEYS)
def test_pathwise_rev_is_linear_in_the_cotangent(key):
    """The sweep is linear in g: twice the cotangent, twice every sum (a
    power of two, so exactly)."""
    c = _case()
    o, d, tm, ids = c["rays"]
    twice = cw.grad_rev_stash(c["ts"], c["tcam"], torch.from_numpy(c["g3"]) * 2.0,
                              c["t_carry"], pathwise=True, stream=ids,
                              seed=c["seed"])
    np.testing.assert_array_equal(twice[key].numpy(), 2.0 * c["t_grads"][key])
