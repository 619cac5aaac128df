"""PyTorch port vs the JAX package: the gradient slice as a whole,
``render_grad`` on the product-chain tier (CPU, small images).

The JAX side runs its gradient kernels in Pallas interpret mode
(``INTERPRET = True``, ``BLOCK_ROWS = 8``, restored afterwards); the port
runs its kernels' plain versions.  The kernels themselves are compared in
tests/test_torch_grad.py."""

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
from go_raytracing_tpu_torch.render import grad as tgrad
from go_raytracing_tpu_torch.render import renderer as trender
from test_torch_helpers import (SKY_CAM, SPHERE_FIELD_CAM, build_mixed,
                                build_sky_diffuse, build_sphere_field,
                                grads_to_numpy, scene_tree)

torch.set_num_threads(2)

KEYS = {"fuzz", "ior", "color", "even_color", "odd_color", "atlas"}


def _sky(spp=8):
    scene = build_sky_diffuse(grtt, device="cpu")
    return scene, grtt.Camera(**{**SKY_CAM, "samples_per_pixel": spp})


@pytest.mark.parametrize("layout", ["untiled-two-chunks", "tiled"])
def test_render_grad_matches_jax(layout):
    """Same scene (through ``convert``), same seed, same target in both
    packages.  Gradients to 2e-3 of each table's largest entry (the two
    packages round a ray's terms differently and add them in another order;
    a table's small entries are sums of few rays).
    ``untiled-two-chunks``: 16x16, 8 spp in two chunks of 1024 rays under
    the sky gradient; loss to rtol 1e-5.  ``tiled``: 64 spheres switch both
    packages to the 32x32-bucket ray layout, whose padding lanes must get
    no cotangent; loss to rtol 1e-4, because one of its 288 rays grazes a
    sphere and lands 3e-4 apart in the two packages' forward renders, which
    the residual against a target of 0.8 x render magnifies to 2e-5."""
    if layout == "tiled":
        js, cam_fields, kw = build_sphere_field(grt), SPHERE_FIELD_CAM, {}
    else:
        js, cam_fields = build_sky_diffuse(grt), {**SKY_CAM, "samples_per_pixel": 8}
        kw = dict(chunk=1024)
    jcam = jcamera.Camera(**cam_fields)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    assert trender.scene_tiled(ts) == (layout == "tiled")
    spp = tcam.samples_per_pixel
    target = (grtt.render(ts, tcam, seed=9, device="cpu") / spp * 0.8).numpy()

    old = jmega.INTERPRET, jmega.BLOCK_ROWS
    jmega.INTERPRET, jmega.BLOCK_ROWS = True, 8
    try:
        assert jmega.grad_two_phase_ok(js, jcam.max_depth)
        j_loss, j_grads = jrender_grad(js, jcam, target, seed=0, **kw)
        j_loss, j_grads = float(j_loss), grads_to_numpy(j_grads)
    finally:
        jmega.INTERPRET, jmega.BLOCK_ROWS = old

    stats = grtt.RenderStats()
    loss, grads = grtt.render_grad(ts, tcam, target, seed=0, device="cpu",
                                   stats=stats, **kw)
    assert stats.chunks == (2 if kw else 1)
    assert stats.rays_traced == trender.ray_layout(
        tcam.image_width, tcam.image_height, layout == "tiled")[2] * spp
    assert set(grads) == set(j_grads) == KEYS
    np.testing.assert_allclose(float(loss), j_loss,
                               rtol=1e-4 if layout == "tiled" else 1e-5)
    grads = grads_to_numpy(grads)
    for k in KEYS:
        assert grads[k].shape == j_grads[k].shape, k
        big = np.abs(j_grads[k]).max()
        np.testing.assert_allclose(grads[k], j_grads[k], rtol=0, atol=2e-3 * big,
                                   err_msg=k)
    assert np.abs(j_grads["color"]).max() > 1e-4
    for k in ("fuzz", "ior", "atlas"):
        assert not grads[k].any(), k


def test_render_grad_over_budget_route_equals_in_budget():
    """A stash budget of one chunk: the second chunk is traced by the plain
    forward in pass A and traced again, with its stash, in pass B.  Same
    framebuffer, same stash, so the same loss and gradients (rtol 1e-5)."""
    scene, cam = _sky()
    target = grtt.render(scene, cam, seed=9, device="cpu") / 8 * 0.8
    kw = dict(seed=0, chunk=1024, device="cpu")
    loss_in, g_in = grtt.render_grad(scene, cam, target, **kw)
    one_chunk = 1024 * tgrad.stash_bytes_per_ray(cam.max_depth)
    assert tgrad.stash_bytes_per_ray(5) == 312
    for budget in (one_chunk + 1, 0):
        stats = grtt.RenderStats()
        loss, g = grtt.render_grad(scene, cam, target, stash_budget=budget,
                                   stats=stats, **kw)
        assert stats.chunks == 2     # ray chunks, once, on every route
        np.testing.assert_allclose(float(loss), float(loss_in), rtol=1e-5)
        for k in KEYS:
            np.testing.assert_allclose(g[k].numpy(), g_in[k].numpy(),
                                       rtol=1e-5, atol=1e-9, err_msg=k)


def test_render_grad_chunking_does_not_change_the_result():
    """32x32, 3 spp: chunks of two samples leave a last chunk that reaches
    past the job's end; its overhanging lanes get no radiance and no
    cotangent.  Equal to the single-chunk result up to the order of sums."""
    scene, cam = _sky(spp=3)
    cam = dataclasses.replace(cam, image_width=32)
    target = torch.zeros((32, 32, 3))
    loss1, g1 = grtt.render_grad(scene, cam, target, seed=2, device="cpu")
    stats = grtt.RenderStats()
    loss2, g2 = grtt.render_grad(scene, cam, target, seed=2, device="cpu",
                                 chunk=2048, stats=stats)
    assert stats.chunks == 2
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-6)
    for k in KEYS:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-4,
                                   atol=1e-8, err_msg=k)
    # the loss is the one of render()'s picture
    fb = grtt.render(scene, cam, seed=2, device="cpu")
    np.testing.assert_allclose(float(loss1), float(torch.mean((fb / 3) ** 2)),
                               rtol=1e-5)


def test_render_grad_descends():
    """A few gradient-descent steps on the checker colours reduce the
    fitting loss (target: the same scene with a greener checker)."""
    scene, cam = _sky(spp=4)
    tex = scene.textures
    greener = tex.even_color.clone()
    greener[:, 1] += 0.2
    target_scene = dataclasses.replace(
        scene, textures=dataclasses.replace(tex, even_color=greener))
    target = grtt.render(target_scene, cam, seed=0, device="cpu") / 4
    losses = []
    for _ in range(4):
        loss, grads = grtt.render_grad(scene, cam, target, seed=0, device="cpu")
        losses.append(float(loss))
        params = dict(grtt.trainable_params(scene))
        for k in ("even_color", "odd_color"):
            params[k] = torch.clamp(params[k] - 5.0 * grads[k], 0.0, 1.0)
        scene = grtt.apply_params(scene, params)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_render_grad_raises_outside_the_ported_tier():
    # metal and dielectric are inside the pathwise tier, marble textures in
    # the product and replay tiers (tests/test_torch_noise_grad.py); image
    # textures in the image and replay tiers (tests/test_torch_image_*.py):
    # a scene that claims one takes the replay tier, and holding none, has
    # no atlas gradient
    imaged = dataclasses.replace(build_mixed(grtt, device="cpu"), has_image=True)
    scene, cam = _sky(spp=1)
    target = torch.zeros((16, 16, 3))
    assert tgrad.grad_tier(imaged, cam.max_depth) == "replay"
    loss, grads = grtt.render_grad(imaged, cam, target, device="cpu")
    assert np.isfinite(float(loss)) and not grads["atlas"].any()
    with pytest.raises(NotImplementedError, match="A19"):
        grtt.render_grad(scene, cam, target, device="cpu", mesh=object())
    if not torch.cuda.is_available():
        # no device given means the GPU; the port never falls back by itself
        with pytest.raises(RuntimeError, match="CUDA"):
            grtt.render_grad(scene, cam, target)
