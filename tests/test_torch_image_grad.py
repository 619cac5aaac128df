"""PyTorch port vs the JAX package: ``render_grad`` on the image tier (CPU,
small images).

The scene of tests/test_grad_render.py's image-tier test (one sphere of
radius 2 with an 8x16 image texture under the sky gradient, 12x12, 4 spp,
depth 3).  The JAX package runs its product-chain gradient kernels in Pallas
interpret mode (``INTERPRET = True``, ``BLOCK_ROWS = 8``, restored
afterwards); the port runs its kernels' plain versions on the white scene
and sums the atlas cotangents per texel.  One JAX gradient in this file."""

import dataclasses

import numpy as np
import pytest
import torch

import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu.render.grad import render_grad as jrender_grad
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as tgrad
from test_torch_helpers import (IMAGE_SPHERE_CAM, build_image_sphere, grads_to_numpy,
                                port_and_jax, seeded_atlas)

torch.set_num_threads(2)

KEYS = {"fuzz", "ior", "color", "even_color", "odd_color", "atlas"}


@pytest.fixture(scope="module")
def image_tier():
    """Loss and gradients of the same target in both packages; the target
    is 0.8 x the port's picture of another seed."""
    js, jcam, ts, tcam = port_and_jax(
        lambda pkg: build_image_sphere(pkg, seeded_atlas(8, 16, seed=5)), IMAGE_SPHERE_CAM)
    spp = tcam.samples_per_pixel
    target = (grtt.render(ts, tcam, seed=9, device="cpu") / spp * 0.8).numpy()
    old = jmega.INTERPRET, jmega.BLOCK_ROWS
    jmega.INTERPRET, jmega.BLOCK_ROWS = True, 8
    try:
        assert jwf.image_prefactor_ok(js)
        assert jmega.grad_applicable(jwf._strip_image(js), jcam.max_depth)
        j_loss, j_grads = jrender_grad(js, jcam, target, seed=0)
        j_loss, j_grads = float(j_loss), grads_to_numpy(j_grads)
    finally:
        jmega.INTERPRET, jmega.BLOCK_ROWS = old
    return dict(ts=ts, tcam=tcam, target=target, j_loss=j_loss, j_grads=j_grads)


def test_image_tier_matches_the_jax_packages(image_tier):
    """Loss to rtol 1e-5, every gradient, ``atlas`` included, within 2e-3 of
    the key's largest entry.  The atlas gradient has texels on both sides
    of zero and none where no ray's first hit fell."""
    c = image_tier
    ts, tcam = c["ts"], c["tcam"]
    assert tgrad.grad_tier(ts, tcam.max_depth) == "image"
    stats = grtt.RenderStats()
    loss, grads = grtt.render_grad(ts, tcam, c["target"], seed=0, device="cpu",
                                   stats=stats)
    assert stats.chunks == 1
    assert set(grads) == set(c["j_grads"]) == KEYS
    np.testing.assert_allclose(float(loss), c["j_loss"], rtol=1e-5)
    grads = grads_to_numpy(grads)
    for k in KEYS:
        ref = c["j_grads"][k]
        assert grads[k].shape == ref.shape, k
        big = np.abs(ref).max()
        np.testing.assert_allclose(grads[k], ref, rtol=0, atol=2e-3 * big, err_msg=k)
    atlas = grads["atlas"]
    assert (atlas > 0).any() and (atlas < 0).any() and (atlas == 0).any()
    for k in KEYS - {"atlas"}:
        assert not grads[k].any(), k    # the image's white slot is dropped


def test_image_tier_over_budget_route_and_chunks(image_tier):
    """At 24x24 (2,304 rays): chunks of one sample split the job in four;
    a stash budget of one chunk keeps the first chunk's carry and traces
    the others again in pass B, a budget of 0 traces every chunk again.
    The same loss and gradients as one chunk kept whole (rtol 1e-5)."""
    ts = image_tier["ts"]
    cam = dataclasses.replace(image_tier["tcam"], image_width=24)
    target = torch.full((24, 24, 3), 0.2)
    loss_in, g_in = grtt.render_grad(ts, cam, target, seed=0, device="cpu")
    one_chunk = 576 * tgrad.stash_bytes_per_ray(cam.max_depth, image=True)
    for budget in (None, one_chunk, 0):
        stats = grtt.RenderStats()
        loss, g = grtt.render_grad(ts, cam, target, seed=0, device="cpu", stats=stats,
                                   chunk=1024, stash_budget=budget)
        assert stats.chunks == 4
        np.testing.assert_allclose(float(loss), float(loss_in), rtol=1e-5)
        assert float(g["atlas"].abs().max()) > 0
        for k in KEYS:
            np.testing.assert_allclose(g[k].numpy(), g_in[k].numpy(), rtol=1e-5,
                                       atol=1e-9, err_msg=f"{k} {budget}")


def test_image_tier_against_the_replay_tier_and_autograd(image_tier):
    """The same job through the replay tier and through ``torch.autograd``
    of ``render(differentiable=True)`` (the standard integrator reading the
    atlas at every hit): the same loss and atlas gradient, to 2e-3 of its
    largest entry."""
    c = image_tier
    ts, tcam, target = c["ts"], c["tcam"], c["target"]
    spp, depth = tcam.samples_per_pixel, tcam.max_depth
    loss, g = grtt.render_grad(ts, tcam, target, seed=0, device="cpu")
    loss_r, g_r = tgrad._render_grad_replay(ts, tcam, target, spp=spp, max_depth=depth,
                                            seed=0, chunk=None, stats=None, dec_budget=None)
    params = {k: v.clone().requires_grad_() for k, v in grtt.trainable_params(ts).items()}
    fb = grtt.render(grtt.apply_params(ts, params), tcam, seed=0, device="cpu",
                     differentiable=True)
    loss_a = torch.mean((fb / spp - torch.from_numpy(target)) ** 2)
    loss_a.backward()
    loss_a = loss_a.detach()
    big = float(g["atlas"].abs().max())
    for other_loss, other in ((loss_r, g_r["atlas"]), (loss_a, params["atlas"].grad)):
        np.testing.assert_allclose(float(other_loss), float(loss), rtol=1e-5)
        assert float((other - g["atlas"]).abs().max()) <= 2e-3 * big


def test_image_tier_gate_and_stash_bytes(image_tier):
    """'image' needs the white scene inside the product-chain gate: a
    metal sphere, or a light, sends the scene to the replay tier.  The
    image carry is 7 rows a ray beside the product stash and the miss
    colour."""
    ts, tcam = image_tier["ts"], image_tier["tcam"]
    assert tgrad.grad_tier(ts, 5) == "image"
    assert tgrad.stash_bytes_per_ray(5, image=True) == (5 * 15 + 10) * 4
    assert tgrad.stash_bytes_per_ray(5) == (5 * 15 + 3) * 4
    atlas = seeded_atlas(4, 4)
    b = grtt.SceneBuilder()
    b.sphere((0, 0, 0), 2.0, b.metal(b.image(atlas), 0.1))
    assert tgrad.grad_tier(b.build(device="cpu"), 3) == "replay"
    b = grtt.SceneBuilder()
    b.sphere((0, 0, 0), 2.0, b.lambertian(b.image(atlas)))
    b.add_light(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((4, 4, 4))))
    lit = b.build(device="cpu")
    assert not twf.image_prefactor_ok(lit) and tgrad.grad_tier(lit, 3) == "replay"
    small = dataclasses.replace(tcam, image_width=8, samples_per_pixel=1)
    loss, g = grtt.render_grad(lit, small, torch.zeros((8, 8, 3)), seed=0, device="cpu")
    assert np.isfinite(float(loss)) and float(g["atlas"].abs().max()) > 0
    assert cw.LAUNCHES_GRAD_FWD == 0    # plain versions on the CPU
