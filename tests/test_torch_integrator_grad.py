"""PyTorch port vs the JAX package: gradients through the standard
integrator, ``torch.autograd`` through ``render(differentiable=True)``
against ``jax.grad`` through the JAX render.

The JAX package renders with its Pallas closest-hit kernels in interpret
mode (``pallas_intersect.INTERPRET``, restored afterwards): that is its
accelerator route, in which the hit distance carries no gradient, and the
route the port follows.  (With the kernels off the JAX package
differentiates the hit distance too; fuzz and IOR gradients then differ.)
One compiled JAX program gives the image and the gradients, cached in a
module fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.ops import pallas_intersect as pk
from go_raytracing_tpu.parallel import sharding as jsharding
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import MIXED_CAM, build_mixed, grads_to_numpy, port_and_jax

torch.set_num_threads(2)

SEED = 3
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)


def _linear(ts, tcam, **kw):
    fb = grtt.render(ts, tcam, seed=SEED, device="cpu", **kw)
    return fb.detach().numpy() / tcam.samples_per_pixel


@pytest.fixture(scope="module")
def mixed():
    """The mixed scene (checker plane, metal, glass, a moving sphere, a fog
    box, a quad light) at depth 3 in both packages; the JAX package's linear
    image of it through the gather route, and loss and gradients of a pixel
    MSE through ``render(differentiable=True)`` in both: ``jax.grad`` there,
    ``torch.autograd`` here.  One compiled JAX program gives image and
    gradients."""
    js, jcam, ts, tcam = port_and_jax(
        build_mixed, dict(MIXED_CAM, samples_per_pixel=2, max_depth=3))
    spp = jcam.samples_per_pixel
    target = (_linear(ts, tcam, mega_mode="off") * 0.8).astype(np.float32)

    def j_loss(params):
        fb = grt.render(jsharding.apply_params(js, params), jcam, seed=SEED,
                        differentiable=True)
        return jnp.mean((fb / spp - jnp.asarray(target)) ** 2), fb

    old = pk.INTERPRET
    pk.INTERPRET = True
    try:
        (j_l, j_fb), j_g = jax.value_and_grad(j_loss, has_aux=True)(
            jsharding.trainable_params(js))
    finally:
        pk.INTERPRET = old

    params = {k: v.clone().requires_grad_()
              for k, v in grtt.trainable_params(ts).items()}
    fb = grtt.render(grtt.apply_params(ts, params), tcam, seed=SEED, device="cpu",
                     differentiable=True)
    assert fb.requires_grad
    t_l = torch.mean((fb / spp - torch.from_numpy(target)) ** 2)
    t_l.backward()
    t_g = {k: (torch.zeros_like(v) if v.grad is None else v.grad)
           for k, v in params.items()}
    return dict(ts=ts, tcam=tcam, j_img=np.asarray(j_fb) / spp,
                t_img=fb.detach().numpy() / spp,
                j_loss=float(j_l), t_loss=float(t_l.detach()),
                j_grads=grads_to_numpy(j_g), t_grads=grads_to_numpy(t_g))


def test_both_routes_match_jax_inside_the_gate(mixed):
    c = mixed
    assert cw.applicable(c["ts"])
    assert twf.choose_mega_mode(c["ts"], c["tcam"], 512, False) == "single"
    assert twf.choose_mega_mode(c["ts"], c["tcam"], 512, True) == "off"
    assert c["j_img"].mean() > 0.01
    np.testing.assert_allclose(c["t_img"], c["j_img"], **IMAGE_TOL)
    fast = _linear(c["ts"], c["tcam"], mega_mode="off")
    np.testing.assert_allclose(fast, c["j_img"], **IMAGE_TOL)
    np.testing.assert_allclose(_linear(c["ts"], c["tcam"]), c["j_img"], **IMAGE_TOL)


@pytest.mark.parametrize("key", ["color", "even_color", "odd_color"])
def test_colour_gradients_match_jax_grad(mixed, key):
    """Colour gradients flow through hit records, materials and textures,
    not through the detached hit distance: within 2e-3 of the key's largest
    entry of ``jax.grad`` through the JAX render."""
    c = mixed
    np.testing.assert_allclose(c["t_loss"], c["j_loss"], rtol=1e-4)
    ref = c["j_grads"][key]
    big = np.abs(ref).max()
    assert big > 1e-6, key
    assert c["t_grads"][key].shape == ref.shape
    assert np.abs(c["t_grads"][key] - ref).max() <= 2e-3 * big


def test_no_gradient_is_nan(mixed):
    """fuzz and ior included: every masked lane's guard holds (sqrt of a
    masked discriminant, arccos and arctan2 at a sphere's poles, a grazing
    light sample, t = 1 on a miss)."""
    c = mixed
    assert set(c["t_grads"]) == set(c["j_grads"])
    for k, g in c["t_grads"].items():
        assert np.isfinite(g).all(), k
    # the kernel route gives fuzz and ior a (partial) gradient, in both packages
    for k in ("fuzz", "ior"):
        assert np.abs(c["t_grads"][k]).max() > 0 and np.abs(c["j_grads"][k]).max() > 0
    assert (c["t_grads"]["atlas"] == 0).all()
