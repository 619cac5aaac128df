"""PyTorch port vs the JAX package: gradients of scenes with marble noise
textures (ROADMAP.md A13).

* The noise + solid scene (a marble floor and sphere, a solid sphere, a quad
  light) on the product-chain tier, as in the JAX package: ``render_grad``
  held against one JAX ``render_grad`` (its product kernels in Pallas
  interpret mode), 16 px, 2 spp, depth 3.  A marble has no trainable
  parameter and, with the hit points fixed, is a constant of each path, so
  the tier's gradients are exact; the marble's winners route to the null
  slot.  Loss rtol 1e-4, every key within 2e-3 of its largest entry.  (The
  marble's derivative in the hit point is about 140 at scale 4: where XLA's
  fused multiply-adds put a hit point an ulp away, the marble moves by up
  to 1e-3, and the residual against a target of 0.8 x render magnifies
  that in the loss to 3e-5 here.)
* Behind metal or glass a marble moves with the hit point: such a scene
  takes the pathwise tier, whose reverse sweep carries dmarble/dp, as the
  JAX package's does (whose interpret-mode test costs 772 s; the port's
  tier is held to ``jax.grad`` in tests/test_torch_marble_grad.py).  Here,
  at scale 4, held against ``torch.autograd`` through the megakernel's
  plain forward and, for the colours, through ``render(differentiable=True)``
  and the replay tier.
* The gates, pure Python.
"""

import dataclasses

import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu.render.grad import render_grad as jrender_grad
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as tgrad
from go_raytracing_tpu_torch.render import renderer
from test_torch_helpers import (MARBLE_CAM, build_marble, grads_to_numpy,
                                mini_env, scene_tree)

torch.set_num_threads(2)

COLOUR_KEYS = ("color", "even_color", "odd_color")


def test_render_grad_of_marble_matches_jax():
    """The product-chain tier on both sides (module docstring)."""
    js = build_marble(grt)
    jcam = jcamera.Camera(**{**MARBLE_CAM, "max_depth": 3})
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    assert ts.has_noise and tgrad.grad_tier(ts, 3) == "product"
    target = (grtt.render(ts, tcam, seed=9, device="cpu") / 2 * 0.8).numpy()

    old = jmega.INTERPRET, jmega.BLOCK_ROWS
    jmega.INTERPRET, jmega.BLOCK_ROWS = True, 8
    try:
        assert jmega.grad_applicable(js, 3)
        j_loss, j_grads = jrender_grad(js, jcam, target, seed=0)
        j_loss, j_grads = float(j_loss), grads_to_numpy(j_grads)
    finally:
        jmega.INTERPRET, jmega.BLOCK_ROWS = old

    loss, grads = grtt.render_grad(ts, tcam, target, seed=0, device="cpu")
    grads = grads_to_numpy(grads)
    assert set(grads) == set(j_grads)
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-4)
    # the solid sphere's colour and the light's emission move the loss;
    # the marble's white colour row gets nothing
    assert np.abs(grads["color"][1]).max() > 1e-6
    assert np.abs(grads["color"][0]).max() == 0.0
    for k in grads:
        big = max(float(np.abs(j_grads[k]).max()), 1e-12)
        np.testing.assert_allclose(grads[k], j_grads[k], rtol=0.0, atol=2e-3 * big,
                                   err_msg=k)


def test_marble_behind_metal_takes_the_replay_tier():
    """Marble (scale 4) and a fuzzy metal now take the pathwise tier.  Its
    gradients are held to ``torch.autograd`` through the plain forward of
    the megakernel on one chunk (the exact derivative of what the kernels
    compute, dmarble/dp and the hit distance included: every key within
    1e-4 of its largest entry), and ``render_grad``'s colour gradients to
    autograd through ``render(differentiable=True)`` and to the replay tier
    within 2e-3 of each key's largest entry.  (Their fuzz gradients differ
    more: the standard integrator's hit points round apart from the
    megakernel's, and at scale 4 the marble moves 140 times as much as the
    hit point.)"""
    ts = build_marble(grtt, metal=True, device="cpu")
    cam = grtt.Camera(**{**MARBLE_CAM, "max_depth": 3})
    assert tgrad.grad_tier(ts, 3) == "pathwise"

    # one chunk: the reverse sweep against autograd of the plain forward
    n = cam.image_width * cam.image_height * cam.samples_per_pixel
    _, o, d, tm, ids, _, _ = renderer._chunk_rays(ts, cam, 0, 0, spp=2, chunk=n,
                                                  max_depth=3, device="cpu")
    g3 = torch.from_numpy((np.random.default_rng(3).uniform(size=(3, n))
                           * 1e-3).astype(np.float32))
    _, carry = cw.grad_fwd_stash(ts, cam, o, d, tm, ids, 0, pathwise=True)
    kern = cw.grad_rev_stash(ts, cam, g3, carry, pathwise=True, stream=ids, seed=0)
    leaves = {k: v.clone().requires_grad_() for k, v in grtt.trainable_params(ts).items()}
    with torch.enable_grad():
        tb = cw.build_tables(grtt.apply_params(ts, leaves))
        out, flags = cw._wavefront_fwd_plain(tb, list(o), list(d), tm,
                                             cw.stream_to_i32(ids), 0, 3)
        mc = cw._miss_colour_rows(out.detach(), flags, cw.miss_config(cam))
        rad = torch.stack([out[c] + out[6 + c] * mc[c] for c in range(3)])
        (rad * g3).sum().backward()
    for k in ("color", "fuzz"):
        big = float(leaves[k].grad.abs().max())
        assert big > 0, k
        np.testing.assert_allclose(kern[k].numpy(), leaves[k].grad.numpy(), rtol=0.0,
                                   atol=1e-4 * big, err_msg=k)

    target = grtt.render(ts, cam, seed=9, device="cpu") / 2 * 0.8
    loss, grads = grtt.render_grad(ts, cam, target, seed=0, device="cpu")
    params = {k: v.clone().requires_grad_()
              for k, v in grtt.trainable_params(ts).items()}
    fb = grtt.render(grtt.apply_params(ts, params), cam, seed=0, device="cpu",
                     differentiable=True)
    auto_loss = torch.mean((fb / 2 - target) ** 2)
    auto_loss.backward()
    np.testing.assert_allclose(float(loss), float(auto_loss.detach()), rtol=1e-5)
    _, replay = tgrad._render_grad_replay(ts, cam, target, spp=2, max_depth=3, seed=0,
                                          chunk=None, stats=None, dec_budget=None)
    for k in COLOUR_KEYS:
        big = max(float(params[k].grad.abs().max()), 1e-12)
        np.testing.assert_allclose(grads[k].numpy(), params[k].grad.numpy(),
                                   rtol=0.0, atol=2e-3 * big, err_msg=k)
        np.testing.assert_allclose(grads[k].numpy(), replay[k].numpy(),
                                   rtol=0.0, atol=2e-3 * big, err_msg=k)
    assert torch.isfinite(grads["fuzz"]).all() and float(grads["fuzz"].abs().max()) > 0


@pytest.mark.parametrize("case, tier", [
    ("marble", "product"), ("marble-metal", "pathwise"),
    ("marble-metal-env-light", "fused"),
])
def test_marble_gates(case, tier):
    """Marble rides the megakernel and every kernel tier, as in the JAX
    package: the product tier with lambertian materials, the pathwise tier
    with metal or glass, the fused tier with an environment and quad
    lights; without the marble each scene takes the same tier."""
    ts = build_marble(grtt, metal=case != "marble", device="cpu")
    if case.endswith("env-light"):
        b = grtt.SceneBuilder()
        perl = b.lambertian(b.noise(4.0))
        b.plane((0, 0, 0), (0, 1, 0), perl)
        b.sphere((-2.1, 0.8, 0.4), 0.8, b.metal((0.8, 0.8, 0.9), 0.3))
        b.add_light(b.quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3),
                           b.diffuse_light((6, 6, 6))))
        b.set_environment(mini_env())
        ts = b.build(device="cpu")
        assert cw.uses_hdri_nee(ts)
    assert ts.has_noise and cw.applicable(ts)
    assert cw.grad_applicable(ts, 3) == (tier == "product")
    # both kernel gates admit marble (the product tier wins where it applies)
    assert cw.grad_pathwise_applicable(ts, 3) and cw.grad_fused_applicable(ts, 3)
    assert tgrad.grad_tier(ts, 3) == tier
    assert cw.pathwise_stash_rows(cw.build_tables(ts)) == cw.PW_STASH_F_ROWS_MARBLE
    assert tgrad.stash_bytes_per_ray(3, pathwise=True, noise=True) == (3 * 23 + 3) * 4
    plain = dataclasses.replace(ts, has_noise=False)
    assert tgrad.grad_tier(plain, 3) == tier
