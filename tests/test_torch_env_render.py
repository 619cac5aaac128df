"""PyTorch port vs the JAX package: renders and ``render_grad`` of a scene
under an HDRI environment without quad lights (hdri-test in miniature: the
environment is seen through the miss shader only), and the forward of one
with a quad light too (HDRI NEE), also against the JAX megakernel's HDRI
rows in interpret mode.

On the CPU the JAX package renders through its standard integrator; the port
renders through the megakernel's plain version and through its own standard
integrator.  Gradients: the port's pathwise two-phase tier (the plain
versions of the stash-writing forward and of the reverse sweep with the
environment's miss rows) against the JAX package's ``render_grad`` (its
replay tier on the CPU, ``jax.grad`` of its differentiable trace), one call,
cached.  The phantom rule's other value is in tests/test_torch_hdri.py."""

import dataclasses
import functools

import numpy as np
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as tgrad
from test_torch_helpers import (ENV_NEE_CAM, MINI_HDRI_CAM, build_env_nee,
                                build_mini_hdri, grads_to_numpy, scene_tree)

torch.set_num_threads(2)

SMALL = dict(image_width=24, samples_per_pixel=2, max_depth=4)


def _both(build, fields):
    js = build(grt)
    jcam = jcamera.Camera(**fields)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    return js, jcam, ts, convert.camera_from_dict(dataclasses.asdict(jcam))


@functools.lru_cache(maxsize=None)
def _renders():
    js, jcam, ts, tcam = _both(build_mini_hdri, dict(MINI_HDRI_CAM, **SMALL))
    ref = np.asarray(grt.render(js, jcam, seed=4))
    before = (cw.LAUNCHES, cw.LAUNCHES_RECORD)
    mega = grtt.render(ts, tcam, seed=4, device="cpu").numpy()
    std = grtt.render(ts, tcam, seed=4, device="cpu", mega_mode="off").numpy()
    assert (cw.LAUNCHES, cw.LAUNCHES_RECORD) == before   # plain versions here
    return ts, tcam, ref, mega, std


def _close_images(got, ref):
    """Mean absolute difference under 1 % of the mean, fewer than 1 % of
    pixels outside rtol 1e-3 / atol 2e-3 (the tolerance of the JAX
    package's own megakernel-vs-integrator test): an ulp can flip a
    discrete decision of a ray, which then differs wholly."""
    assert got.shape == ref.shape and np.isfinite(got).all() and ref.mean() > 0.05
    assert np.abs(got - ref).mean() < 0.01 * ref.mean()
    bad = ~np.isclose(got, ref, rtol=1e-3, atol=2e-3).all(axis=-1)
    assert bad.mean() < 0.01, bad.mean()


def test_env_render_by_the_megakernel_matches_jax():
    """24x24, 2 spp, depth 4: the megakernel's plain version (the miss
    shader in torch, once per ray) against the JAX package's render."""
    ts, tcam, ref, mega, _ = _renders()
    assert cw.applicable(ts)
    _close_images(mega, ref)


def test_env_render_by_the_standard_integrator_matches_jax():
    _, _, ref, mega, std = _renders()
    _close_images(std, ref)
    _close_images(std, mega)


def test_env_nee_renders_match_jax():
    """With a quad light a lambertian hit also samples the environment (HDRI
    NEE): the megakernel's plain version with the HDRI rows, and the
    standard integrator's ``sample_hdri_light``, against the JAX package."""
    fields = dict(MINI_HDRI_CAM, **SMALL)
    js, jcam, ts, tcam = _both(build_env_nee, fields)
    ref = np.asarray(grt.render(js, jcam, seed=4))
    mega = grtt.render(ts, tcam, seed=4, device="cpu").numpy()
    std = grtt.render(ts, tcam, seed=4, device="cpu", mega_mode="off").numpy()
    _close_images(mega, ref)
    _close_images(std, ref)
    # the environment's samples add light: without importance sampling the
    # picture is darker
    dark = grtt.render(dataclasses.replace(ts, env_importance=False), tcam, seed=4,
                       device="cpu").numpy()
    assert dark.mean() < 0.99 * mega.mean()


def test_hdri_rows_match_the_jax_megakernel():
    """The megakernel's plain version with the HDRI NEE rows against the
    JAX megakernel in interpret mode (its ``use_hdri`` rows), on the
    environment + light scene's 1,024 camera rays: radiance before the miss
    shader, miss throughput and, on rays that missed, miss direction, each
    within rtol 1e-4 / atol 1e-5 on all but 1 % of the rays and within rtol
    1e-3 / atol 1e-4 on every ray (the last bits of the transcendental
    functions and of XLA's multiply-add contraction differ along a path),
    and the same rays missing."""
    import jax.numpy as jnp

    js, jcam, ts, tcam = _both(build_env_nee, ENV_NEE_CAM)
    w, n, seed = tcam.image_width, 16 * 16 * 4, 0
    ids = torch.arange(n, dtype=torch.int64)
    o, d, tm = tcamera.generate_rays(tcam, ids % w, (ids // w) % w, ids, seed)
    t_rad, t_dir, t_tp, t_flags = cw.trace_megakernel(ts, tcam, o, d, tm, ids, seed)

    def to_j(v):
        return grt.core.vec3.V3(*(jnp.asarray(c.numpy()) for c in v))

    old = jmega.INTERPRET, jmega.BLOCK_ROWS
    jmega.INTERPRET, jmega.BLOCK_ROWS = True, 8
    try:
        j_rad, j_dir, j_tp, j_missed, _ = jmega.trace_megakernel(
            js, jcam, to_j(o), to_j(d), jnp.asarray(tm.numpy()),
            jnp.asarray(ids.numpy().astype(np.uint32)), seed)
    finally:
        jmega.INTERPRET, jmega.BLOCK_ROWS = old
    missed = ((t_flags & cw.FLAG_MISSED) != 0).numpy()
    np.testing.assert_array_equal(missed, np.asarray(j_missed))
    for t, j, keep in ((t_rad, j_rad, slice(None)), (t_tp, j_tp, slice(None)),
                       (t_dir, j_dir, missed)):
        a = torch.stack(list(t)).numpy()[:, keep]
        b = np.stack([np.asarray(x) for x in j])[:, keep]
        outside = ~np.isclose(a, b, rtol=1e-4, atol=1e-5).all(axis=0)
        assert outside.mean() < 0.01, outside.mean()
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    # the samples count: without the rows the radiance is lower
    no_rows, _ = cw.wavefront_fwd(cw.build_tables(ts), o, d, tm, ids, seed,
                                  tcam.max_depth)
    assert float(no_rows[:3].sum()) < 0.99 * float(torch.stack(list(t_rad)).sum())


@functools.lru_cache(maxsize=None)
def _grads():
    import jax.numpy as jnp
    from go_raytracing_tpu.render.grad import render_grad as jrender_grad

    js, jcam, ts, tcam = _both(build_mini_hdri, MINI_HDRI_CAM)
    target = np.random.default_rng(6).uniform(0.1, 0.6, (16, 16, 3)).astype(np.float32)
    j_loss, j_g = jrender_grad(js, jcam, jnp.asarray(target), seed=0)
    t_loss, t_g = grtt.render_grad(ts, tcam, torch.from_numpy(target), seed=0,
                                   device="cpu")
    return (float(j_loss), grads_to_numpy(j_g), float(t_loss), grads_to_numpy(t_g),
            ts, tcam, target)


def test_env_render_grad_matches_jax():
    """``render_grad`` of the mini-HDRI scene (16x16, 4 spp, depth 5, the
    phantom rule off) on the pathwise two-phase tier against the JAX
    package's: the loss at rtol 1e-5, every gradient at rtol 5e-3 / atol
    1e-4 of its largest entry (the JAX package's own tolerance for its
    environment gradient kernel against ``jax.grad``)."""
    j_loss, j_g, t_loss, t_g, ts, tcam, _ = _grads()
    assert tgrad.grad_tier(ts, tcam.max_depth) == "pathwise"
    assert set(t_g) == set(j_g)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    for k in ("color", "even_color", "odd_color", "fuzz", "ior", "env_data"):
        big = np.abs(j_g[k]).max()
        assert big > 1e-6, k
        np.testing.assert_allclose(t_g[k], j_g[k], rtol=5e-3, atol=1e-4 * big, err_msg=k)


def test_env_render_grad_routes_and_budgets():
    """The stash budget of an environment chunk counts the 19 rows of its
    miss footprint (12 texels and the miss records) and no miss colour;
    chunks grow to the budget; a chunk over budget is traced twice and
    gives the same numbers; the product tier takes an all-diffuse scene
    under an environment and returns its texels' gradient too."""
    _, _, t_loss, t_g, ts, tcam, target = _grads()
    assert tgrad.stash_bytes_per_ray(10, pathwise=True, env=True) == (10 * 22 + 19) * 4
    stats = grtt.RenderStats()
    loss, g = grtt.render_grad(ts, tcam, torch.from_numpy(target), seed=0,
                               device="cpu", stash_budget=0, stats=stats)
    assert stats.chunks == 1
    np.testing.assert_allclose(float(loss), t_loss, rtol=1e-6)
    for k in t_g:
        np.testing.assert_array_equal(g[k].numpy(), t_g[k], err_msg=k)
    # all diffuse: the glass and the metals turned lambertian
    diffuse = dataclasses.replace(ts, materials=dataclasses.replace(
        ts.materials, kind=torch.zeros_like(ts.materials.kind)))
    assert tgrad.grad_tier(diffuse, tcam.max_depth) == "product"
    cam = dataclasses.replace(tcam, max_depth=3)
    loss, g = grtt.render_grad(diffuse, cam, torch.from_numpy(target), seed=0,
                               device="cpu")
    ref_loss, ref = tgrad._render_grad_replay(
        diffuse, cam, torch.from_numpy(target), spp=4, max_depth=3, seed=0,
        chunk=None, stats=None, dec_budget=None)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for k in ("color", "even_color", "odd_color", "env_data"):
        big = float(ref[k].abs().max())
        assert big > 0, k
        np.testing.assert_allclose(g[k].numpy(), ref[k].numpy(), atol=1e-4 * big,
                                   err_msg=k)


def test_autograd_through_the_standard_integrator_reaches_the_texels():
    """``render(differentiable=True)`` + ``backward()``: the texels' and the
    colours' gradients are ``render_grad``'s (neither needs the terms
    through the hit distance that the standard integrator's kernels leave
    out), within 2e-3 of the largest entry."""
    _, _, _, t_g, ts, tcam, target = _grads()
    params = {k: v.clone().requires_grad_() for k, v in grtt.trainable_params(ts).items()}
    fb = grtt.render(grtt.apply_params(ts, params), tcam, seed=0, device="cpu",
                     differentiable=True)
    torch.mean((fb / 4 - torch.from_numpy(target)) ** 2).backward()
    for k in ("color", "even_color", "odd_color", "env_data"):
        big = np.abs(t_g[k]).max()
        np.testing.assert_allclose(params[k].grad.numpy(), t_g[k], atol=2e-3 * big,
                                   err_msg=k)
