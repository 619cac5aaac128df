"""PyTorch port vs the JAX package: the marble's derivative by the hit point
(dmarble/dp), alone and in the pathwise tier's gradients.

* ``textures.perlin_noise_soa(with_grad=True)`` and ``textures.marble_grad`` against
  ``jax.grad`` of the JAX package's ``perlin_noise`` and of the marble of its
  ``evaluate`` (``perlin_turb``), and against ``torch.autograd`` of the
  port's own ``perlin_noise_soa`` and ``marble``, on 4,096 points, a quarter
  of them within 1e-4 of a lattice cell's face at some octave.
* The noise + glossy scene of tests/test_grad_pathwise.py
  (``_mini_noise_glossy``: a marble floor at scale 0.4 seen directly and
  through metal and glass), 10x10, 4 spp, depth 3: the port's pathwise tier
  (the plain versions of B5a and B5b) against ``jax.grad`` of the JAX
  package's differentiable trace, as that file's ``_kernel_and_autodiff``
  builds it, at its tolerance (rtol 5e-3, atol 3e-6) for color, fuzz and
  ior, each with a signal; once with a seeded cotangent of the rays'
  radiance, once through ``render_grad`` with the loss's own cotangent.

The JAX gradient is one ``jax.vjp`` of the trace, cached, run with
``jax.disable_jit()``: compiled whole, the trace with its 7 octaves of
noise takes over a minute to compile on a CPU; op by op it takes half of
that.  Op by op XLA also fuses no multiply-add, so the JAX radiance is the
port's within rtol 1e-4 / atol 1e-5 on every ray of the chunk (asserted:
``render_grad``'s cotangent cannot be masked); the seeded cotangent is
still set to 0 on any ray that differs, as in tests/test_torch_env_nee.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.materials import textures as jtex
from go_raytracing_tpu.parallel.sharding import (apply_params as japply,
                                                 trainable_params as jparams)
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.materials import textures as ttex
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as tgrad
from go_raytracing_tpu_torch.render import renderer
from test_torch_helpers import (NOISE_GLOSSY_CAM, build_noise_glossy,
                                grads_to_numpy, scene_tree)

torch.set_num_threads(2)

KEYS = ("color", "fuzz", "ior")


def _points(scale):
    """4,096 points in [-6, 6]^3; a quarter moved to within 1e-4 of a cell
    face of p * scale * 2^o for an octave o (the noise's gradient is
    one-sided there)."""
    rng = np.random.default_rng(11)
    p = rng.uniform(-6.0, 6.0, (4096, 3))
    edge = rng.random(4096) < 0.25
    octave = rng.integers(0, 7, 4096)
    axis = rng.integers(0, 3, 4096)
    f = scale * 2.0 ** octave
    snapped = (np.round(p[np.arange(4096), axis] * f)
               + rng.uniform(-1e-4, 1e-4, 4096)) / f
    p[edge, axis[edge]] = snapped[edge]
    return p.astype(np.float32), edge


def _jax_marble(p, scale):
    import jax.numpy as jnp
    s = scale * p[:, 2] + 10.0 * jtex.perlin_turb(p * scale, 7)
    return 0.5 * (1.0 + jnp.sin(s))


def test_noise_gradient_matches_jax_and_autograd():
    import jax
    import jax.numpy as jnp

    p, _ = _points(1.0)
    val, grad = ttex.perlin_noise_soa(V3(*torch.from_numpy(p.T.copy())), with_grad=True)
    grad = torch.stack(list(grad)).numpy().T
    np.testing.assert_array_equal(val.numpy(), ttex.perlin_noise(torch.from_numpy(p)).numpy())
    j_grad = np.asarray(jax.grad(lambda q: jtex.perlin_noise(q).sum())(jnp.asarray(p)))
    big = np.abs(j_grad).max()
    assert big > 0.5
    np.testing.assert_allclose(grad, j_grad, rtol=1e-4, atol=1e-5 * big)
    tp = torch.from_numpy(p).requires_grad_()
    ttex.perlin_noise(tp).sum().backward()
    np.testing.assert_allclose(grad, tp.grad.numpy(), rtol=1e-5, atol=1e-6 * big)


@pytest.mark.parametrize("scale", [0.4, 4.0])
def test_marble_gradient_matches_jax_and_autograd(scale):
    """The value is ``marble``'s bit for bit; the gradient is ``jax.grad``'s
    within rtol 1e-4 / 1e-5 of the largest entry, also within 1e-4 of a
    cell face, and ``torch.autograd``'s of ``marble`` within 1e-5.  At a
    zero of the turbulence both take sign(0) = 0."""
    import jax
    import jax.numpy as jnp

    p, edge = _points(scale)
    s = torch.full((4096,), scale)
    val, grad = ttex.marble_grad(V3(*torch.from_numpy(p.T.copy())), s)
    grad = torch.stack(list(grad)).numpy().T
    tp = torch.from_numpy(p.T.copy()).requires_grad_()
    ref = ttex.marble(V3(tp[0], tp[1], tp[2]), s)
    np.testing.assert_array_equal(val.numpy(), ref.detach().numpy())
    ref.sum().backward()
    big = np.abs(grad).max()
    assert big > 1.0 * scale
    np.testing.assert_allclose(grad, tp.grad.numpy().T, rtol=1e-5, atol=1e-6 * big)
    j_grad = np.asarray(jax.grad(
        lambda q: _jax_marble(q, jnp.float32(scale)).sum())(jnp.asarray(p)))
    np.testing.assert_allclose(grad, j_grad, rtol=1e-4, atol=1e-5 * big)
    np.testing.assert_allclose(grad[edge], j_grad[edge], rtol=1e-4, atol=1e-5 * big)


@functools.lru_cache(maxsize=None)
def _case():
    """The noise + glossy chunk through both packages (module docstring)."""
    import jax
    import jax.numpy as jnp

    js = build_noise_glossy(grt)
    jcam = jcamera.Camera(**NOISE_GLOSSY_CAM)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    w, h, spp = tcam.image_width, tcam.image_height, tcam.samples_per_pixel
    n, seed = w * h * spp, 0
    # render_grad's own rays: one chunk of every (pixel, sample)
    _, o, d, tm, ids, pixel, _ = renderer._chunk_rays(
        ts, tcam, 0, seed, spp=spp, chunk=n, max_depth=tcam.max_depth, device="cpu")

    def to_j(v):
        return grt.core.vec3.V3(*(jnp.asarray(c.numpy()) for c in v))

    jo, jd, jtm = to_j(o), to_j(d), jnp.asarray(tm.numpy())
    jids = jnp.asarray(ids.numpy().astype(np.uint32))

    def rows(params):
        return jwf.trace(japply(js, params), jcam, jo, jd, jtm, jids, seed,
                         differentiable=True).rows()

    with jax.disable_jit():
        j_rad, vjp = jax.vjp(rows, jparams(js))
        j_rad = np.asarray(j_rad).T
        t_rad, carry = cw.grad_fwd_stash(ts, tcam, o, d, tm, ids, seed, pathwise=True)
        t_rad = torch.stack(list(t_rad)).numpy()
        same = np.isclose(t_rad, j_rad, rtol=1e-4, atol=1e-5).all(axis=0)
        g3 = (np.random.default_rng(3).uniform(size=(3, n)) * 1e-3).astype(np.float32)
        g3 = g3 * same
        j_grads = grads_to_numpy(vjp(jnp.asarray(g3.T))[0])
        # render_grad's loss: mean((fb / spp - target)^2) over the image
        target = np.random.default_rng(5).uniform(0.05, 0.5, (h, w, 3)).astype(np.float32)
        fb = np.zeros((w * h, 3), np.float64)
        np.add.at(fb, pixel.numpy(), j_rad.T)
        g_pix = 2.0 * (fb / spp - target.reshape(-1, 3)) / (w * h * 3 * spp)
        g_loss = g_pix[pixel.numpy()].astype(np.float32)
        j_loss = float(np.mean((fb / spp - target.reshape(-1, 3)) ** 2))
        j_loss_grads = grads_to_numpy(vjp(jnp.asarray(g_loss))[0])
    t_grads = grads_to_numpy(cw.grad_rev_stash(
        ts, tcam, torch.from_numpy(g3), carry, pathwise=True, stream=ids, seed=seed))
    return dict(ts=ts, tcam=tcam, carry=carry, same=same, j_grads=j_grads,
                t_grads=t_grads, target=target, j_loss=j_loss,
                j_loss_grads=j_loss_grads)


def _check_keys(got, ref):
    for k in KEYS:
        assert np.abs(ref[k]).max() > 1e-6, f"no {k} signal: the scene is too weak"
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-3, atol=3e-6, err_msg=k)


def test_pathwise_plain_matches_jax_grad():
    """B5a's and B5b's plain versions against ``jax.grad`` with a seeded
    cotangent; the stash carries the marble's scale and its winners' bit."""
    c = _case()
    assert (~c["same"]).mean() < 0.01
    assert tgrad.grad_tier(c["ts"], c["tcam"].max_depth) == "pathwise"
    stash_f, stash_i = c["carry"][1], c["carry"][2]
    assert stash_f.shape[1] == cw.PW_STASH_F_ROWS_MARBLE
    marble = (stash_i[:, 2] & cw.PW_MARBLE) != 0
    assert bool(marble.any())
    assert bool((stash_f[:, 19][marble] == np.float32(0.4)).all())
    _check_keys(c["t_grads"], c["j_grads"])


def test_render_grad_matches_jax_grad():
    """``render_grad`` on the pathwise tier: the loss of the JAX trace's
    picture and ``jax.grad`` of it."""
    c = _case()
    # the loss's cotangent cannot be masked: every ray must agree (op by op,
    # XLA rounds as PyTorch does)
    assert c["same"].all()
    stats = grtt.RenderStats()
    loss, grads = grtt.render_grad(c["ts"], c["tcam"], torch.from_numpy(c["target"]),
                                   seed=0, device="cpu", stats=stats)
    assert stats.chunks == 1
    np.testing.assert_allclose(float(loss), c["j_loss"], rtol=1e-5)
    _check_keys(grads_to_numpy(grads), c["j_loss_grads"])
