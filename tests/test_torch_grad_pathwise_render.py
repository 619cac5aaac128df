"""PyTorch port vs the JAX package: ``render_grad`` on the pathwise tier
(metal and glass; CPU, small images), and the port's own routing, budget
and gates around it.

The JAX side runs its gradient kernels in Pallas interpret mode
(``INTERPRET = True``, ``BLOCK_ROWS = 8``, restored afterwards); the port
runs its kernels' plain versions.  The kernels themselves are compared in
tests/test_torch_grad_pathwise.py and tests/test_torch_grad_pathwise_volume.py."""

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
from test_torch_helpers import (MINI_GLOSSY_CAM, SKY_CAM, build_mini_glossy,
                                build_sky_diffuse, grads_to_numpy, scene_tree)

torch.set_num_threads(2)

KEYS = {"fuzz", "ior", "color", "even_color", "odd_color", "atlas"}


def _glossy(spp=2, depth=3):
    scene = build_mini_glossy(grtt, device="cpu")
    return scene, grtt.Camera(**{**MINI_GLOSSY_CAM, "samples_per_pixel": spp,
                                 "max_depth": depth})


def _counters():
    return (cw.LAUNCHES, cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV,
            cw.LAUNCHES_GRAD_FWD_PATHWISE, cw.LAUNCHES_GRAD_REV_PATHWISE)


def test_pathwise_render_grad_matches_jax():
    """Same scene (through ``convert``), same seed, same target in both
    packages: mini-glossy at 16x16, 2 spp, depth 3.  Loss to rtol 1e-5;
    every gradient key to rtol 5e-3 with an atol of 1e-8 scaled to the key's
    largest entry (the two packages round a ray's terms differently and add
    them in another order)."""
    js = build_mini_glossy(grt)
    jcam = jcamera.Camera(**{**MINI_GLOSSY_CAM, "samples_per_pixel": 2,
                             "max_depth": 3})
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    target = (grtt.render(ts, tcam, seed=9, device="cpu") / 2 * 0.8).numpy()

    old = jmega.INTERPRET, jmega.BLOCK_ROWS
    jmega.INTERPRET, jmega.BLOCK_ROWS = True, 8
    try:
        assert not jmega.grad_applicable(js, jcam.max_depth)
        assert jmega.grad_pathwise_applicable(js, jcam.max_depth)
        j_loss, j_grads = jrender_grad(js, jcam, target, seed=0)
        j_loss, j_grads = float(j_loss), grads_to_numpy(j_grads)
    finally:
        jmega.INTERPRET, jmega.BLOCK_ROWS = old

    before = _counters()
    stats = grtt.RenderStats()
    loss, grads = grtt.render_grad(ts, tcam, target, seed=0, device="cpu",
                                   stats=stats)
    assert _counters() == before          # CPU: plain versions, no launch
    assert stats.chunks == 1 and stats.rays_traced == 16 * 16 * 2
    assert set(grads) == set(j_grads) == KEYS
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    grads = grads_to_numpy(grads)
    for k in KEYS:
        assert grads[k].shape == j_grads[k].shape, k
        big = np.abs(j_grads[k]).max()
        np.testing.assert_allclose(grads[k], j_grads[k], rtol=5e-3,
                                   atol=1e-8 * max(big / 1e-4, 1.0), err_msg=k)
    for k in ("fuzz", "ior", "color", "even_color", "odd_color"):
        assert np.abs(j_grads[k]).max() > 1e-7, k
    assert not grads["atlas"].any()


def test_render_grad_routes_by_tier(monkeypatch):
    """A scene without metal and glass goes through the product-chain
    wrappers, one with them through the pathwise wrappers."""
    calls = []
    fwd, rev = cw.grad_fwd_stash, cw.grad_rev_stash

    def spy_fwd(*a, pathwise=False, **k):
        calls.append(("fwd", pathwise))
        return fwd(*a, pathwise=pathwise, **k)

    def spy_rev(*a, pathwise=False, **k):
        calls.append(("rev", pathwise, k.get("stream") is not None))
        return rev(*a, pathwise=pathwise, **k)

    monkeypatch.setattr(cw, "grad_fwd_stash", spy_fwd)
    monkeypatch.setattr(cw, "grad_rev_stash", spy_rev)
    target = torch.zeros((16, 16, 3))
    sky = build_sky_diffuse(grtt, device="cpu")
    sky_cam = grtt.Camera(**{**SKY_CAM, "samples_per_pixel": 1})
    assert cw.grad_applicable(sky, 3) and cw.grad_pathwise_applicable(sky, 3)
    _, g = grtt.render_grad(sky, sky_cam, target, device="cpu")
    assert calls == [("fwd", False), ("rev", False, False)]   # product wins
    assert not g["fuzz"].any() and not g["ior"].any()
    calls.clear()
    scene, cam = _glossy(spp=1)
    _, g = grtt.render_grad(scene, cam, target, device="cpu")
    assert calls == [("fwd", True), ("rev", True, True)]
    assert g["fuzz"].any() and g["ior"].any()


def test_pathwise_render_grad_budget_and_chunks():
    """A stash budget of one chunk or of nothing (chunks traced by the plain
    forward in pass A and again, with stash, in pass B) gives the loss and
    gradients of the all-stashed run, and two chunks give one chunk's;
    ``stats.chunks`` counts ray chunks once on every route."""
    scene, cam = _glossy(spp=8)
    target = grtt.render(scene, cam, seed=9, device="cpu") / 8 * 0.8
    loss1, g1 = grtt.render_grad(scene, cam, target, seed=0, device="cpu")
    kw = dict(seed=0, chunk=1024, device="cpu")
    assert tgrad.stash_bytes_per_ray(5, pathwise=True) == 452
    assert tgrad.stash_bytes_per_ray(5) == 312
    one_chunk = 1024 * tgrad.stash_bytes_per_ray(cam.max_depth, pathwise=True)
    for budget in (None, one_chunk + 1, 0):
        stats = grtt.RenderStats()
        loss, g = grtt.render_grad(scene, cam, target, stash_budget=budget,
                                   stats=stats, **kw)
        assert stats.chunks == 2
        np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-6)
        for k in KEYS:
            np.testing.assert_allclose(g[k].numpy(), g1[k].numpy(), rtol=1e-4,
                                       atol=1e-9, err_msg=f"{k} budget {budget}")
    # the loss is the one of render()'s picture
    fb = grtt.render(scene, cam, seed=0, device="cpu")
    np.testing.assert_allclose(float(loss1),
                               float(torch.mean((fb / 8 - target) ** 2)), rtol=1e-5)


def test_pathwise_gates():
    """The pathwise gate: the reverse kernel's accumulator (9 a texture and
    2 a material in 1,536 floats), no environment, no noise.  Outside both
    gates ``render_grad`` raises and names the ROADMAP items."""
    scene, cam = _glossy(spp=1)
    target = torch.zeros((16, 16, 3))
    assert cw.grad_pathwise_applicable(scene, 3) and not cw.grad_applicable(scene, 3)
    assert not cw.grad_pathwise_applicable(scene, 0)
    assert cw.grad_pathwise_applicable(scene, 50)     # depth is bounded by memory alone
    n_mat = int(scene.materials.kind.shape[0])
    fits = (cw.GRAD_PATHWISE_MAX_ACC - 2 * n_mat) // 9
    for n_tex, ok in ((fits, True), (fits + 1, False)):
        many = dataclasses.replace(scene, textures=dataclasses.replace(
            scene.textures, color=torch.zeros((n_tex, 3))))
        assert cw.grad_pathwise_applicable(many, 3) == ok
    with pytest.raises(NotImplementedError, match="A18"):
        grtt.render_grad(many, cam, target, device="cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        grtt.render_grad(dataclasses.replace(scene, env=object()), cam, target,
                         device="cpu")
    for outside in (dataclasses.replace(scene, has_noise=True),
                    dataclasses.replace(scene, has_image=True)):
        assert not cw.grad_pathwise_applicable(outside, 3)
    # the wrappers hold the gate of the tier they are asked for
    ids = torch.arange(64)
    o, d, tm = grtt.camera.generate_rays(cam, ids % 16, ids // 16, ids, 0)
    with pytest.raises(NotImplementedError, match="pathwise=True"):
        cw.grad_fwd_stash(scene, cam, o, d, tm, ids, 0)
    with pytest.raises(NotImplementedError, match="A18"):
        cw.grad_fwd_stash(many, cam, o, d, tm, ids, 0, pathwise=True)
    _, carry = cw.grad_fwd_stash(scene, cam, o, d, tm, ids, 0, pathwise=True)
    with pytest.raises(ValueError, match="stream"):
        cw.grad_rev_stash(scene, cam, torch.zeros(3, 64), carry, pathwise=True)


def test_apply_params_reaches_fuzz_and_ior():
    """``fuzz`` and ``ior`` travel through ``params_from_numpy`` /
    ``apply_params`` into rows 17 and 18 of the kernel's material block, and
    a changed fuzz changes the render."""
    scene, cam = _glossy(spp=2)
    params = convert.params_to_numpy(grtt.trainable_params(scene))
    kinds = scene.materials.kind.numpy()
    params["fuzz"] = np.where(kinds == 1, params["fuzz"] + 0.3, params["fuzz"]).astype(np.float32)
    params["ior"] = np.where(kinds == 2, 1.33, params["ior"]).astype(np.float32)
    moved = grtt.apply_params(scene, convert.params_from_numpy(params, "cpu"))
    np.testing.assert_array_equal(moved.materials.fuzz.numpy(), params["fuzz"])
    tb, tb0 = cw.build_tables(moved), cw.build_tables(scene)
    assert not torch.equal(tb.st[9], tb0.st[9]) and not torch.equal(tb.st[10], tb0.st[10])
    assert torch.equal(tb.st[:9], tb0.st[:9]) and torch.equal(tb.st[11:], tb0.st[11:])
    assert torch.equal(tb.pt, tb0.pt)
    a = grtt.render(scene, cam, seed=0, device="cpu")
    b = grtt.render(moved, cam, seed=0, device="cpu")
    assert float((a - b).abs().max()) > 1e-3


def test_pathwise_render_grad_descends():
    """A few gradient-descent steps on the gold sphere's fuzz reduce the
    fitting loss (target: the same scene with a rougher gold)."""
    scene, cam = _glossy(spp=4)
    fuzz = scene.materials.fuzz
    gold = int(torch.argmax(fuzz))
    rougher = fuzz.clone()
    rougher[gold] += 0.3
    params = dict(grtt.trainable_params(scene))
    target_scene = grtt.apply_params(scene, {**params, "fuzz": rougher})
    target = grtt.render(target_scene, cam, seed=0, device="cpu") / 4
    losses = []
    for _ in range(4):
        loss, grads = grtt.render_grad(scene, cam, target, seed=0, device="cpu")
        losses.append(float(loss))
        params = dict(grtt.trainable_params(scene))
        step = torch.zeros_like(fuzz)
        step[gold] = 0.1 * torch.sign(grads["fuzz"][gold])
        params["fuzz"] = torch.clamp(params["fuzz"] - step, 0.0, 1.0)
        scene = grtt.apply_params(scene, params)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
