"""PyTorch port vs the JAX package: an image texture outside the image
tier, the Cornell box with a picture on its back wall (CPU, small images).

The standard integrator reads the atlas at every hit.  ``render_grad``'s
replay tier (records by the standard integrator, the replay under
``torch.autograd``) and ``torch.autograd`` through
``render(differentiable=True)`` are held against ``jax.grad`` through the
JAX package's differentiable render at depth 3.  The scene holds only
lambertian and light materials, so no gradient flows through a hit
distance and both JAX routes agree; the JAX package renders with its
default (non-Pallas) sweeps here.  One compiled JAX program gives the
picture and the gradients, cached in a module fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.parallel import sharding as jsharding
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.render import grad as tgrad
from test_torch_helpers import (CORNELL_IMAGE_CAM, build_cornell_image, grads_to_numpy,
                                port_and_jax, seeded_atlas)

torch.set_num_threads(2)

SEED = 4
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)


@pytest.fixture(scope="module")
def cornell_image():
    atlas = seeded_atlas(6, 10, seed=8)
    js, jcam, ts, tcam = port_and_jax(lambda pkg: build_cornell_image(pkg, atlas),
                                      CORNELL_IMAGE_CAM)
    spp = tcam.samples_per_pixel
    target = (grtt.render(ts, tcam, seed=SEED + 1, device="cpu") / spp * 0.8).numpy()

    def j_loss(params):
        fb = grt.render(jsharding.apply_params(js, params), jcam, seed=SEED,
                        differentiable=True)
        return jnp.mean((fb / spp - jnp.asarray(target)) ** 2), fb

    (j_l, j_fb), j_g = jax.value_and_grad(j_loss, has_aux=True)(
        jsharding.trainable_params(js))
    return dict(ts=ts, tcam=tcam, target=target, j_img=np.asarray(j_fb) / spp,
                j_loss=float(j_l), j_grads=grads_to_numpy(j_g))


def _close(got, ref, key):
    big = np.abs(ref).max()
    assert big > 1e-6, key
    assert got.shape == ref.shape, key
    assert np.abs(got - ref).max() <= 2e-3 * big, key


def test_standard_integrator_picture_matches_jax(cornell_image):
    """The port picks the standard integrator (no megakernel takes an image
    texture, and the scene is outside ``image_prefactor_ok``); its picture
    against the JAX package's differentiable render: under 0.5 % of pixels
    outside rtol 1e-3 / atol 2e-3."""
    c = cornell_image
    ts, tcam = c["ts"], c["tcam"]
    assert ts.has_image and not twf.image_prefactor_ok(ts)
    assert twf.choose_mega_mode(ts, tcam, 1024, False) == "off"
    got = grtt.render(ts, tcam, seed=SEED, device="cpu").numpy() / tcam.samples_per_pixel
    assert c["j_img"].mean() > 0.01
    bad = ~np.isclose(got, c["j_img"], **IMAGE_TOL).all(axis=-1)
    assert bad.mean() < 0.005, bad.mean()


@pytest.mark.parametrize("route", ["replay", "replay-over-budget", "autograd"])
def test_atlas_and_colour_gradients_match_jax_grad(cornell_image, route):
    """``render_grad`` on the replay tier (its records kept, and recorded
    again in pass B with ``dec_budget=0``) and ``loss.backward()`` through
    ``render(differentiable=True)``: loss to rtol 1e-4, ``atlas`` and
    ``color`` within 2e-3 of their largest entry of ``jax.grad``, the other
    keys zero in both packages."""
    c = cornell_image
    ts, tcam, target = c["ts"], c["tcam"], c["target"]
    spp = tcam.samples_per_pixel
    if route == "autograd":
        params = {k: v.clone().requires_grad_()
                  for k, v in grtt.trainable_params(ts).items()}
        fb = grtt.render(grtt.apply_params(ts, params), tcam, seed=SEED, device="cpu",
                         differentiable=True)
        loss = torch.mean((fb / spp - torch.from_numpy(target)) ** 2)
        loss.backward()
        grads = {k: torch.zeros_like(v) if v.grad is None else v.grad
                 for k, v in params.items()}
        loss = loss.detach()
    else:
        assert tgrad.grad_tier(ts, tcam.max_depth) == "replay"
        kw = dict(dec_budget=0) if route == "replay-over-budget" else {}
        loss, grads = grtt.render_grad(ts, tcam, target, seed=SEED, device="cpu", **kw)
    np.testing.assert_allclose(float(loss), c["j_loss"], rtol=1e-4)
    grads = grads_to_numpy(grads)
    assert set(grads) == set(c["j_grads"])
    for k in ("atlas", "color"):
        _close(grads[k], c["j_grads"][k], k)
    for k in ("fuzz", "ior", "even_color", "odd_color"):
        assert not grads[k].any() and not c["j_grads"][k].any(), k
    assert (grads["atlas"] != 0).sum() > grads["atlas"].size // 6


def test_replay_atlas_gradient_has_the_same_bits_twice(cornell_image):
    """The atlas gradient's per-texel sums run in a fixed order
    (``core/segsum.take_rows_sorted``): two calls, the same bits."""
    c = cornell_image
    _, g1 = grtt.render_grad(c["ts"], c["tcam"], c["target"], seed=SEED, device="cpu")
    _, g2 = grtt.render_grad(c["ts"], c["tcam"], c["target"], seed=SEED, device="cpu")
    assert torch.equal(g1["atlas"], g2["atlas"])
