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
* Behind metal or glass a marble moves with the hit point.  The port's
  pathwise and fused kernels lack dmarble/dp (ROADMAP.md A13b), so such a
  scene takes the replay tier (the JAX package takes its pathwise kernels,
  whose interpret-mode test costs 772 s): held against ``torch.autograd``
  through ``render(differentiable=True)`` (colour keys within 2e-3 of the
  largest entry; fuzz there lacks the terms through the hit distance, which
  the replay has).
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
    """Marble and a fuzzy metal: the replay tier's colour gradients are
    autograd's through the standard integrator, its fuzz gradient finite and
    not zero."""
    ts = build_marble(grtt, metal=True, device="cpu")
    cam = grtt.Camera(**{**MARBLE_CAM, "max_depth": 3})
    assert tgrad.grad_tier(ts, 3) == "replay"
    target = grtt.render(ts, cam, seed=9, device="cpu") / 2 * 0.8
    loss, grads = grtt.render_grad(ts, cam, target, seed=0, device="cpu")

    params = {k: v.clone().requires_grad_()
              for k, v in grtt.trainable_params(ts).items()}
    fb = grtt.render(grtt.apply_params(ts, params), cam, seed=0, device="cpu",
                     differentiable=True)
    auto_loss = torch.mean((fb / 2 - target) ** 2)
    auto_loss.backward()
    np.testing.assert_allclose(float(loss), float(auto_loss.detach()), rtol=1e-5)
    for k in COLOUR_KEYS:
        big = max(float(params[k].grad.abs().max()), 1e-12)
        np.testing.assert_allclose(grads[k].numpy(), params[k].grad.numpy(),
                                   rtol=0.0, atol=2e-3 * big, err_msg=k)
    assert torch.isfinite(grads["fuzz"]).all() and float(grads["fuzz"].abs().max()) > 0


@pytest.mark.parametrize("case, tier", [
    ("marble", "product"), ("marble-metal", "replay"),
    ("marble-metal-env-light", "replay"),
])
def test_marble_gates(case, tier):
    """Marble rides the megakernel and the product tier; with metal or glass
    it leaves the pathwise and fused tiers, each gate saying so itself."""
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
    assert not cw.grad_pathwise_applicable(ts, 3)
    assert not cw.grad_fused_applicable(ts, 3)
    assert tgrad.grad_tier(ts, 3) == tier
    # without the marble the same scene is a kernel tier's
    plain = dataclasses.replace(ts, has_noise=False)
    assert tgrad.grad_tier(plain, 3) == {"marble": "product",
                                         "marble-metal": "pathwise",
                                         "marble-metal-env-light": "fused"}[case]
