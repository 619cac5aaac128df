"""PyTorch port vs the JAX package: a scene with an HDRI environment and a
quad light, whose lambertian hits sample both (HDRI NEE), through the fused
gradient kernel's plain version (B4: ``cuda_wavefront.grad_megakernel``),
the megakernel's HDRI rows, the records and the replay tier.

The scene is the one of ``test_env_nee_grad_kernel_matches_autodiff``
(tests/test_grad_pathwise.py), 16x16, 4 spp, depth 4, inputs from numpy
seeds.  That JAX test holds the JAX fused kernel (``grad_megakernel``) to
``jax.grad`` of the JAX package's differentiable trace at rtol 5e-3 /
atol 1e-4 of the largest entry; the port's fused plain version is held to
the same ``jax.grad`` at the same tolerance (one JAX gradient call, cached):
the JAX fused kernel in interpret mode takes 45 to 124 s on this CPU (depth
3 to 4), over this file's budget.  The HDRI rows of the forward are held to
the JAX megakernel in interpret mode in tests/test_torch_env_render.py.

Same random bits and formulas in both packages, but the transcendental
functions of the two libraries may round differently in their last bit and
XLA contracts a*b+c into fused multiply-adds on the CPU while PyTorch does
not; along a path of four bounces the difference grows, most of all near a
texel edge of the environment or a light's rim: 3.3 % of the rays differ
from the JAX radiance by more than rtol 1e-5 / atol 1e-6, 0.2 % by more than
rtol 1e-4 / atol 1e-5, none by more than 1e-3 (measured).  So at most 1 % of
rays may fall outside rtol 1e-4 / atol 1e-5, and the gradients are compared
with the cotangent of those rays set to 0 on both sides."""

import dataclasses
import functools

import numpy as np
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.integrator import wavefront as jwf
from go_raytracing_tpu.parallel.sharding import (apply_params as japply,
                                                 trainable_params as jparams)
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as tgrad
from test_torch_helpers import ENV_NEE_CAM, build_env_nee, grads_to_numpy, scene_tree

torch.set_num_threads(2)

KEYS = ("color", "even_color", "odd_color", "fuzz", "ior", "env_data")


def _to_j(v):
    import jax.numpy as jnp
    return grt.core.vec3.V3(*(jnp.asarray(c.numpy()) for c in v))


@functools.lru_cache(maxsize=None)
def _case():
    import jax
    import jax.numpy as jnp

    js = build_env_nee(grt)
    jcam = jcamera.Camera(**ENV_NEE_CAM)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    w = tcam.image_width
    n, seed = w * w * tcam.samples_per_pixel, 0
    ids = torch.arange(n, dtype=torch.int64)
    o, d, tm = tcamera.generate_rays(tcam, ids % w, (ids // w) % w, ids, seed)
    jo, jd, jtm = _to_j(o), _to_j(d), jnp.asarray(tm.numpy())
    jids = jnp.asarray(ids.numpy().astype(np.uint32))

    def rows(params):
        return jwf.trace(japply(js, params), jcam, jo, jd, jtm, jids, seed,
                         differentiable=True).rows()

    # one program for both: the radiance first, then the gradient of
    # <radiance, cotangent> for the cotangent chosen by it
    j_rad, vjp = jax.vjp(rows, jparams(js))
    j_rad = np.asarray(j_rad).T
    f_rad = torch.stack(list(twf.trace(ts, tcam, o, d, tm, ids, seed))).numpy()
    same = np.isclose(f_rad, j_rad, rtol=1e-4, atol=1e-5).all(axis=0)
    g3 = (np.random.default_rng(3).uniform(size=(3, n)) * 1e-3).astype(np.float32)
    g3 = g3 * same
    j_grads = grads_to_numpy(vjp(jnp.asarray(g3.T))[0])
    before = (cw.LAUNCHES, cw.LAUNCHES_GRAD_FUSED)
    t_rad, t_grads = cw.grad_megakernel(ts, tcam, o, d, tm, ids, seed,
                                        torch.from_numpy(g3))
    assert (cw.LAUNCHES, cw.LAUNCHES_GRAD_FUSED) == before   # plain versions
    return dict(js=js, jcam=jcam, ts=ts, tcam=tcam, rays=(o, d, tm, ids),
                seed=seed, g3=g3, j_grads=j_grads, j_rad=j_rad, f_rad=f_rad,
                same=same,
                t_rad=torch.stack(list(t_rad)).numpy(),
                t_grads=grads_to_numpy(t_grads))


def test_fused_plain_matches_jax_grad():
    """Every gradient family, the environment's texels among them (the
    miss shader's and the HDRI samples' ``eout`` rows), against ``jax.grad``
    at rtol 5e-3 / atol 1e-4 of the largest entry."""
    c = _case()
    assert (~c["same"]).mean() < 0.01
    assert tgrad.grad_tier(c["ts"], c["tcam"].max_depth) == "fused"
    assert set(c["t_grads"]) == set(KEYS)
    for k in KEYS:
        ref = c["j_grads"][k]
        big = np.abs(ref).max()
        assert big > 1e-6, f"no {k} signal: the scene is too weak"
        assert np.isfinite(c["t_grads"][k]).all(), k
        np.testing.assert_allclose(c["t_grads"][k], ref, rtol=5e-3, atol=1e-4 * big,
                                   err_msg=k)


def test_fused_radiance_is_the_forward_kernels():
    """The fused kernel's radiance is the forward's with the same HDRI rows
    plus the miss term, bit for bit, and the JAX package's within rtol
    1e-4 / atol 1e-5 (the JAX test's tolerance) on all but 1 % of the rays
    and within rtol 1e-3 / atol 1e-4 on every ray."""
    c = _case()
    np.testing.assert_array_equal(c["t_rad"], c["f_rad"])
    assert (~c["same"]).mean() < 0.01
    np.testing.assert_allclose(c["t_rad"], c["j_rad"], rtol=1e-3, atol=1e-4)


def test_records_carry_the_hdri_shadow_bit():
    """``trace(record=True)``: the megakernel's record (B6's plain version,
    code bit 3) and the standard integrator's hold the same outcome of the
    environment's shadow rays (and of the rest) on 99.9 % of ray-bounces or
    more (ties break apart between the two sweeps), both replay to the
    recorded radiance, and the record holds the bytes the budget charges."""
    c = _case()
    ts, tcam = c["ts"], c["tcam"]
    o, d, tm, ids = c["rays"]
    rad_k, dec_k = twf.trace(ts, tcam, o, d, tm, ids, c["seed"], record=True)
    rad_s, dec_s = twf.trace(ts, tcam, o, d, tm, ids, c["seed"], record=True,
                             mega_mode="off")
    assert bool(dec_k.blk_h.any()) and dec_k.blk_h.stride() != (0, 0)
    for a, b in zip(dec_k, dec_s):
        assert float((a == b).float().mean()) >= 0.999
    assert twf.decision_bytes(ts) == 1 + 4 + 1 + 1
    for dec, rad in ((dec_k, rad_k), (dec_s, rad_s)):
        again = twf.trace(ts, tcam, o, d, tm, ids, c["seed"], decisions=dec)
        np.testing.assert_allclose(torch.stack(list(again)).numpy(),
                                   torch.stack(list(rad)).numpy(), rtol=1e-4, atol=1e-5)


def test_replay_tier_matches_the_fused_tier():
    """The replay tier (record, then ``torch.autograd`` through the replay,
    ``sample_hdri_light(blocked=...)`` among it) and the fused tier give the
    same loss and gradients within 1e-4 of each key's largest entry: two
    routes with no code in common but the forward's formulas."""
    c = _case()
    ts, tcam = c["ts"], c["tcam"]
    target = torch.from_numpy(np.random.default_rng(5).uniform(
        0.1, 0.6, (16, 16, 3)).astype(np.float32))
    stats = grtt.RenderStats()
    loss, g = grtt.render_grad(ts, tcam, target, seed=1, device="cpu", stats=stats)
    assert stats.chunks == 1
    ref_loss, ref = tgrad._render_grad_replay(
        ts, tcam, target, spp=4, max_depth=tcam.max_depth, seed=1, chunk=None,
        stats=None, dec_budget=None)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    fb = grtt.render(ts, tcam, seed=1, device="cpu")
    np.testing.assert_allclose(float(loss), float(torch.mean((fb / 4 - target) ** 2)),
                               rtol=1e-5)
    for k in KEYS:
        big = float(ref[k].abs().max())
        assert big > 0, k
        np.testing.assert_allclose(g[k].numpy(), ref[k].numpy(), atol=1e-4 * big,
                                   err_msg=k)
    # chunks: the fused tier's working set is budgeted per ray
    assert tgrad.fused_bytes_per_ray(10, True) > tgrad.fused_bytes_per_ray(10, False)
    stats = grtt.RenderStats()
    loss2, g2 = grtt.render_grad(ts, tcam, target, seed=1, device="cpu", stats=stats,
                                 stash_budget=0)
    assert stats.chunks == 1 and float(loss2) == float(loss)
