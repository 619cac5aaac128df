"""PyTorch port vs the JAX package, and the port's tiers against each other:
marble behind metal and glass on the pathwise and fused tiers.

* B5a's plain version (the pathwise gradient forward) on the noise + glossy
  scene of tests/test_grad_pathwise.py (``_mini_noise_glossy``, 10x10,
  4 spp, depth 3) against the JAX kernel (``_call_grad_fwd``) in Pallas
  interpret mode: radiance and every stash row, row 19 (the marble's scale)
  and mask bit 8192 among them (``check_pathwise_forward``); and B5b's plain
  version on the JAX stash against itself on the port's stash.  The JAX
  reverse kernel is not run here (in interpret mode it takes minutes with
  marble): tests/test_torch_marble_grad.py holds the port's reverse to
  ``jax.grad``.
* ``render_grad`` of the same scene on the pathwise tier against the replay
  tier (``_render_grad_replay``: record, then ``torch.autograd`` through the
  standard integrator), 16x16, 4 spp: within 2e-3 of each key's largest
  entry.
* The same scene under an environment with its quad light (HDRI NEE), on
  the fused tier (B4's plain version), against the replay tier, 16x16,
  4 spp, depth 4: within 1e-4 of each key's largest entry.
* The scene's trainable parameters (fuzz, IOR, colours) from the JAX package
  through ``convert.params_from_numpy`` / ``params_to_numpy``."""

import functools

import numpy as np
import torch

import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as tgrad
from test_torch_helpers import (NOISE_GLOSSY_CAM, build_noise_glossy,
                                check_pathwise_forward, mini_env, pathwise_case)

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _case():
    return pathwise_case(build_noise_glossy, NOISE_GLOSSY_CAM, jax_reverse=False)


def test_pathwise_fwd_plain_with_marble_matches_interpret_pallas_kernel():
    c = _case()
    t_si = check_pathwise_forward(c, cw, min_live=800)
    mk = t_si[:, 2]
    marble = (mk & cw.PW_MARBLE) != 0
    assert marble.any()
    # a marble winner is a hit that is not glass; its row 19 is the scale
    assert ((mk[marble] & cw.PW_HIT) != 0).all()
    assert ((mk[marble] & cw.PW_DIELECTRIC) == 0).all()
    t_sf = c["t_carry"][1].numpy()
    np.testing.assert_array_equal(t_sf[:, 19][marble], np.float32(0.4))
    assert (t_sf[:, 19][~marble & ((mk & cw.PW_HIT) == 0)] == 0).all()


def test_pathwise_rev_plain_reads_the_jax_stash():
    """The port's reverse sweep on the JAX kernel's stash (its 20 rows) and
    on its own give the same gradients within rtol 2e-3 / atol 3e-6, each
    key with a signal, with the cotangent of the rays whose path differs
    between the two forwards (mask words, or radiance beyond rtol 1e-4 /
    atol 1e-5) set to 0; a cotangent of zeros gives zeros."""
    c = _case()
    ts, tcam = c["ts"], c["tcam"]
    j_mc, j_sf, j_si = (torch.from_numpy(np.array(x)) for x in c["j_stash"])
    t_mc, t_sf, t_si = c["t_carry"]
    entered = (t_si[:, 2] & (cw.PW_HIT | cw.PW_LIT)) != 0
    same = ((t_si[:, 2] == j_si[:, 2]) | ~entered).all(dim=0) & torch.from_numpy(
        np.isclose(c["t_rad"], c["j_rad"], rtol=1e-4, atol=1e-5).all(axis=0))
    assert float(same.float().mean()) > 0.98
    g3 = torch.from_numpy(c["g3"]) * same
    tb = cw.build_tables(ts)
    n_tex, n_mat = int(ts.textures.color.shape[0]), int(ts.materials.kind.shape[0])
    ids = c["rays"][3]

    def rev(mc, sf, si):
        return cw.wavefront_grad_rev_pathwise(tb, sf, si, g3, mc, ids, c["seed"],
                                              bool(tcam.use_sky_gradient), n_tex, n_mat)

    on_jax, own = rev(j_mc, j_sf, j_si), rev(t_mc, t_sf, t_si)
    for name, a, b in zip(("color", "fuzz", "ior"), on_jax, own):
        assert float(b.abs().max()) > 1e-6, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=3e-6,
                                   err_msg=name)
    for k in ("color", "fuzz", "ior"):
        assert (c["zero_grads"][k] == 0).all(), k


def test_marble_glossy_params_round_trip():
    """The JAX package's trainable parameters of the noise + glossy scene
    (fuzz, IOR, colours) reach the port through ``convert.params_from_numpy``
    and ``apply_params`` and come back through ``params_to_numpy`` with the
    same bits; the port's pathwise render of the moved scene is the
    converted scene's."""
    import go_raytracing_tpu as grt
    from go_raytracing_tpu.parallel.sharding import trainable_params as jparams
    from go_raytracing_tpu_torch import convert
    from test_torch_helpers import scene_tree

    js = build_noise_glossy(grt)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    j_params = {k: np.asarray(v) for k, v in jparams(js).items()}
    moved = grtt.apply_params(ts, convert.params_from_numpy(j_params, "cpu"))
    back = convert.params_to_numpy(grtt.trainable_params(moved))
    assert set(back) == set(j_params)
    for k in ("fuzz", "ior", "color"):
        assert np.abs(j_params[k]).max() > 0, k
    for k, v in j_params.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    cam = grtt.Camera(**NOISE_GLOSSY_CAM)
    np.testing.assert_array_equal(grtt.render(moved, cam, seed=0, device="cpu").numpy(),
                                  grtt.render(ts, cam, seed=0, device="cpu").numpy())


def _tiers(scene, cam, spp):
    target = torch.from_numpy(np.random.default_rng(5).uniform(
        0.05, 0.5, (cam.image_height, cam.image_width, 3)).astype(np.float32))
    loss, g = grtt.render_grad(scene, cam, target, seed=1, device="cpu")
    ref_loss, ref = tgrad._render_grad_replay(
        scene, cam, target, spp=spp, max_depth=cam.max_depth, seed=1, chunk=None,
        stats=None, dec_budget=None)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    return g, ref


def test_pathwise_render_grad_with_marble_matches_replay():
    scene = build_noise_glossy(grtt, device="cpu")
    cam = grtt.Camera(**{**NOISE_GLOSSY_CAM, "image_width": 16})
    assert tgrad.grad_tier(scene, cam.max_depth) == "pathwise"
    g, ref = _tiers(scene, cam, 4)
    for k in ("color", "fuzz", "ior"):
        big = float(ref[k].abs().max())
        assert big > 0, k
        np.testing.assert_allclose(g[k].numpy(), ref[k].numpy(), atol=2e-3 * big,
                                   err_msg=k)


def test_fused_render_grad_with_marble_matches_replay():
    scene = build_noise_glossy(grtt, env=mini_env(), device="cpu")
    cam = grtt.Camera(**{**NOISE_GLOSSY_CAM, "image_width": 16, "max_depth": 4})
    assert cw.uses_hdri_nee(scene) and tgrad.grad_tier(scene, 4) == "fused"
    g, ref = _tiers(scene, cam, 4)
    for k in ("color", "fuzz", "ior", "env_data"):
        big = float(ref[k].abs().max())
        assert big > 0, k
        np.testing.assert_allclose(g[k].numpy(), ref[k].numpy(), atol=1e-4 * big,
                                   err_msg=k)
