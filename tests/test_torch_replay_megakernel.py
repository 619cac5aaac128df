"""``render_grad`` on the replay tier for scenes inside the megakernel's
gate but outside both of the port's gradient kernel tiers: the port records
them with the megakernel's record kernel (B6; here its plain version, since
the tensors lie on the CPU) and replays on the standard integrator.

* The combined scene of tests/test_replay.py without its environment (a
  checker floor, a glass, a fuzzy metal and a lambertian sphere, a quad
  light, a fog box) with a mosaic wall of 144 tiles of 144 colours of their
  own behind it (151 textures and materials: 9 x 151 + 2 x 151
  accumulators, over the pathwise kernel's 1,536), 16 px, 2 spp, depth 3,
  held against the JAX package.  The JAX package routes it to its replay
  tier too (its kernel tiers' gates are read with its megakernel enabled,
  as on a TPU) and, on the CPU, records on its standard integrator.
  ``render_grad``: loss rtol 1e-5, every gradient key rtol 2e-3 and atol
  2e-4 of its largest entry.  The replay alone: the port's record of the
  JAX package's first chunk, replayed by ``torch.autograd.grad`` and by the
  JAX package's chunk gradient (the program its ``render_grad`` compiled,
  so that this file compiles one JAX gradient) with one cotangent: every
  key rtol 2e-3 and atol 2e-4 of its largest entry.  Colours, fuzz and IOR,
  the terms through the hit distance included.  (Many small spheres in
  place of the tiles would do too, but a ray grazing a small sphere far
  away finds its distance through a square root of a difference of nearly
  equal squares, and float32 then gives the two packages hit points apart
  in the fifth digit: XLA fuses multiply-adds on the CPU, PyTorch does not.)
* ``random`` on a reduced grid (176 spheres and a checker plane), held
  against the port's own forward and ``torch.autograd``.  Against the JAX
  package it agrees but on one ray at this size, where the JAX package's
  replay differs from its own record: its replay's plane distance differs
  in the last bits from its sweep's (XLA fuses multiply-adds on the CPU),
  which moves the hit point across a checker square's edge.  The port's
  replay repeats the sweep's arithmetic and gives the recorded radiance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.render import grad as jgrad
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as tgrad
from go_raytracing_tpu_torch.render import renderer as trenderer
from test_torch_helpers import grads_to_numpy, port_and_jax
from test_torch_replay_render import (check_against_jax, jax_first_chunk,
                                      jax_route_is_replay)

torch.set_num_threads(2)

SEED = 4
KEYS = ("color", "even_color", "odd_color", "fuzz", "ior")


def build_combined_mosaic(pkg, **build_kwargs):
    b = pkg.SceneBuilder()
    floor = b.lambertian(b.checker(0.7, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
    b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), floor)
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-2.2, 1, 0), 1.0, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((2.2, 1, 0), 1.0, b.lambertian((0.1, 0.2, 0.5)))
    q = b.quad((-1, 5, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((6, 6, 6)))
    b.add_light(q)
    b.volume_box((-4, 0, 2), (-2.5, 1.5, 3.5), 0.4, (0.7, 0.7, 0.7))
    colours = np.random.default_rng(11).uniform(0.1, 0.9, size=(144, 3))
    for k, c in enumerate(colours):
        x, y = k % 12, k // 12
        b.quad((x * 0.6 - 3.6, y * 0.6, -3), (0.6, 0, 0), (0, 0.6, 0),
               b.lambertian(tuple(float(v) for v in c)))
    return b.build(**build_kwargs)


CAM = dict(
    image_width=16, aspect_ratio=1.0, samples_per_pixel=2, max_depth=3,
    look_from=(0, 2.5, 7), look_at=(0, 1, 0), background=(0, 0, 0), vfov=45.0,
)


@pytest.fixture
def record_calls(monkeypatch):
    """Calls of the record kernel's plain version."""
    calls = []
    real = cw._wavefront_record_plain

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(cw, "_wavefront_record_plain", counting)
    return calls


def _target(h, w):
    return (np.random.default_rng(SEED).random((h, w, 3)) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def combined():
    """The JAX package's ``render_grad`` of the scene, and its chunk
    gradient of the port's record of its first chunk."""
    js, jcam, ts, tcam = port_and_jax(build_combined_mosaic, CAM)
    target = _target(jcam.image_height, jcam.image_width)
    j_loss, j_g = jgrad.render_grad(js, jcam, target, seed=SEED)
    chunk, _, rays = jax_first_chunk(js, jcam, SEED)
    o, d, tm, ids, pixel, valid = rays
    _, dec = twf.trace(ts, tcam, o, d, tm, ids, SEED, mega_mode="single", record=True)
    g_fb = np.random.default_rng(SEED + 1).normal(
        size=(jcam.image_width * jcam.image_height, 3)).astype(np.float32)
    # the JAX package's record holds int32 and bool fields
    j_dec = jwf.Decisions(*(jnp.asarray(a if a.dtype == bool else a.astype(np.int32))
                            for a in (getattr(dec, f).numpy() for f in dec._fields)))
    j_vjp = jgrad._chunk_vjp(js, jcam, jnp.asarray(g_fb), jnp.uint32(0), SEED,
                             spp=jcam.samples_per_pixel, chunk=chunk,
                             max_depth=jcam.max_depth, dec=j_dec)
    cot = torch.where(valid[:, None], torch.from_numpy(g_fb)[pixel], 0.0)
    return (js, ts, tcam, target, (float(j_loss), j_g),
            ((o, d, tm, ids), dec, cot, grads_to_numpy(j_vjp)))


def test_replay_gradients_match_the_jax_package(combined):
    """The replay of one record (B6's plain version) in both packages:
    ``torch.autograd.grad`` against the JAX package's chunk gradient."""
    _, ts, tcam, _, _, (rays, dec, cot, j_g) = combined
    params = {k: v.clone().requires_grad_() for k, v in grtt.trainable_params(ts).items()}
    rad = twf.trace(grtt.apply_params(ts, params), tcam, *rays, SEED, decisions=dec)
    inner = (rad.rows() * cot).sum()
    got = torch.autograd.grad(inner, list(params.values()), allow_unused=True)
    t_g = {k: (torch.zeros_like(v) if g is None else g).numpy()
           for (k, v), g in zip(params.items(), got)}
    for k, ref in j_g.items():
        assert np.isfinite(t_g[k]).all(), k
        scale = max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(t_g[k], ref, rtol=2e-3, atol=2e-4 * scale, err_msg=k)
    for k in KEYS:
        assert np.abs(j_g[k]).max() > 0, k
    # the replay's radiance is the record's
    rec = twf.trace(ts, tcam, *rays, SEED, mega_mode="single")
    torch.testing.assert_close(rad.rows().detach(), rec.rows(), rtol=1e-4, atol=1e-5)


def test_render_grad_replay_through_the_record_kernel(combined, record_calls):
    js, ts, tcam, target, (j_loss, j_g), _ = combined
    n_tex = int(ts.textures.color.shape[0])
    n_mat = int(ts.materials.kind.shape[0])
    assert 9 * n_tex + 2 * n_mat > cw.GRAD_PATHWISE_MAX_ACC
    assert cw.applicable(ts)
    assert tgrad.grad_tier(ts, tcam.max_depth) == "replay"
    assert jax_route_is_replay(js, tcam.max_depth)
    stats = grtt.RenderStats()
    loss, g = grtt.render_grad(ts, tcam, torch.from_numpy(target), seed=SEED,
                               device="cpu", stats=stats)
    assert len(record_calls) == stats.chunks == 1   # recorded once, by B6's plain version
    check_against_jax(loss, g, j_loss, j_g)
    for k in KEYS:
        assert float(g[k].abs().max()) > 0.0, k


def test_render_grad_replay_of_random(record_calls):
    """Reduced ``random``: the loss is that of ``render``'s picture, colour
    gradients are those of ``torch.autograd`` through
    ``render(differentiable=True)``, fuzz and IOR are finite, and over the
    record budget (records made again in pass B) nothing changes."""
    ts, tcam = grtt.load_scene("random", grid=(-7, 7, -7, 7), device="cpu")
    tcam = dataclasses.replace(tcam, image_width=16, aspect_ratio=1.0,
                               samples_per_pixel=2, max_depth=3)
    assert tgrad.grad_tier(ts, 3) == "replay" and cw.applicable(ts)
    assert trenderer.scene_tiled(ts)
    target = torch.from_numpy(_target(16, 16))
    loss, g = grtt.render_grad(ts, tcam, target, seed=SEED, device="cpu")
    assert len(record_calls) == 1
    fb = grtt.render(ts, tcam, seed=SEED, device="cpu")
    np.testing.assert_allclose(float(loss), float(torch.mean((fb / 2 - target) ** 2)),
                               rtol=1e-5)
    params = {k: v.clone().requires_grad_() for k, v in grtt.trainable_params(ts).items()}
    fb = grtt.render(grtt.apply_params(ts, params), tcam, seed=SEED, device="cpu",
                     differentiable=True)
    torch.mean((fb / 2 - target) ** 2).backward()
    for k in ("color", "even_color", "odd_color"):
        big = max(float(g[k].abs().max()), 1e-12)
        assert float((params[k].grad - g[k]).abs().max()) <= 2e-3 * big, k
    for k in ("fuzz", "ior"):
        assert torch.isfinite(g[k]).all() and float(g[k].abs().max()) > 0.0, k

    record_calls.clear()
    loss0, g0 = grtt.render_grad(ts, tcam, target, seed=SEED, device="cpu",
                                 dec_budget=0)
    assert len(record_calls) == 1
    np.testing.assert_allclose(float(loss0), float(loss), rtol=1e-6)
    for k, v in g.items():
        np.testing.assert_allclose(g0[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6 * max(float(v.abs().max()), 1e-8),
                                   err_msg=k)
