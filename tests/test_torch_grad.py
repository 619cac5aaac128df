"""PyTorch port vs the JAX package: the product-chain gradient kernels.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode (``INTERPRET = True``,
``BLOCK_ROWS = 8``, restored afterwards; nothing in the JAX package
changes).  The CUDA kernels can only run on a GPU: their tests are in
tests/test_torch_cuda.py.  The slice as a whole (``render_grad``) is in
tests/test_torch_grad_render.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu.parallel import sharding as jsharding
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from test_torch_helpers import (MINI_CORNELL_CAM, SKY_CAM, build_mini_cornell,
                                build_mixed, build_sky_diffuse, grads_to_numpy,
                                jax_stash_to_numpy, scene_tree)

torch.set_num_threads(2)

SCENES = {"mini-cornell": (build_mini_cornell, MINI_CORNELL_CAM),
          "sky": (build_sky_diffuse, SKY_CAM)}


@functools.lru_cache(maxsize=None)
def _case(name, with_jax_reverse=False):
    """One chunk of the scene's camera rays through the gradient forward of
    both packages (and, on request, through the JAX reverse sweep with a
    seeded cotangent).  Cached: the interpret-mode kernels take seconds."""
    build, cam_fields = SCENES[name]
    js = build(grt)
    jcam = jcamera.Camera(**cam_fields)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    tcam = convert.camera_from_dict(dataclasses.asdict(jcam))
    w, h = tcam.image_width, tcam.image_height
    n, seed = w * h * tcam.samples_per_pixel, 0
    ids = torch.arange(n, dtype=torch.int64)
    o, d, tm = tcamera.generate_rays(tcam, ids % w, (ids // w) % h, ids, seed)
    g3 = (np.random.default_rng(0).uniform(size=(3, n)) * 1e-3).astype(np.float32)

    def to_j(v):
        return grt.core.vec3.V3(*(jnp.asarray(c.numpy()) for c in v))

    jids = jnp.asarray(ids.numpy().astype(np.uint32))
    old = jmega.INTERPRET, jmega.BLOCK_ROWS
    jmega.INTERPRET, jmega.BLOCK_ROWS = True, 8
    try:
        assert jmega.grad_applicable(js, jcam.max_depth)
        j_rad, j_carry = jmega.grad_fwd_stash(
            js, jcam, to_j(o), to_j(d), jnp.asarray(tm.numpy()), jids, seed)
        j_rad = np.stack([np.asarray(c) for c in j_rad])
        j_stash = jax_stash_to_numpy(j_carry, n)  # before the reverse donates it
        j_grads = None
        if with_jax_reverse:
            j_grads = grads_to_numpy(jmega.grad_rev_stash(
                js, jcam, jids, seed, tuple(jnp.asarray(r) for r in g3), j_carry))
    finally:
        jmega.INTERPRET, jmega.BLOCK_ROWS = old

    assert cw.grad_applicable(ts, tcam.max_depth)
    before = cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV
    t_rad, t_carry = cw.grad_fwd_stash(ts, tcam, o, d, tm, ids, seed)
    t_grads = cw.grad_rev_stash(ts, tcam, torch.from_numpy(g3), t_carry)
    # CPU tensors: plain versions, no launch
    assert (cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV) == before
    return dict(ts=ts, tcam=tcam, rays=(o, d, tm, ids), seed=seed, g3=g3,
                j_rad=j_rad, j_stash=j_stash, j_grads=j_grads,
                t_rad=torch.stack(list(t_rad)).numpy(), t_carry=t_carry,
                t_grads=t_grads)


def test_trainable_params_round_trip_and_keys():
    js = build_mixed(grt)
    ts = convert.scene_from_numpy(scene_tree(js), "cpu")
    params = grtt.trainable_params(ts)
    assert set(params) == set(jsharding.trainable_params(js))
    assert params["color"] is ts.textures.color      # views, not copies
    again = grtt.apply_params(ts, params)
    for k, v in grtt.trainable_params(again).items():
        assert v is params[k]
    # a changed set, carried across as numpy, lands in both packages alike
    rng = np.random.default_rng(1)
    tree = {k: (np.asarray(v) + rng.uniform(0, 0.1, np.shape(v))).astype(np.float32)
            for k, v in jsharding.trainable_params(js).items()}
    moved = grtt.apply_params(ts, convert.params_from_numpy(tree, "cpu"))
    jmoved = jsharding.apply_params(js, {k: jnp.asarray(v) for k, v in tree.items()})
    back = convert.params_to_numpy(grtt.trainable_params(moved))
    for k, v in jsharding.trainable_params(jmoved).items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    assert moved.materials.kind is ts.materials.kind  # the rest is untouched
    # the colours reach the kernel's tables
    tb, tb0 = cw.build_tables(moved), cw.build_tables(ts)
    assert not torch.equal(tb.pt[19:28], tb0.pt[19:28])
    assert torch.equal(tb.pt[:15], tb0.pt[:15])


@pytest.mark.parametrize("name", ["mini-cornell", "sky"])
def test_grad_fwd_plain_matches_interpret_pallas_kernel(name):
    """Radiance, miss colour and stash of the gradient forward.  Same RNG
    bits and formulas in both packages, but XLA and PyTorch round sums of
    products differently and an ulp can flip a discrete decision (an edge
    hit, a volume accept): such a ray then differs wholly.  So, per ray:
    fewer than 1 % outside rtol 1e-4 / atol 1e-5 in radiance, and on the
    agreeing rays the stash rows agree wherever the JAX kernel defines them
    (its dead lanes keep arbitrary floats under a zero mask): mask and
    albedo slot equal where the mask is not 0; T, albedo and the two NEE
    rows close there; the light slot equal where its weight alb_su is not 0."""
    c = _case(name, with_jax_reverse=(name == "mini-cornell"))
    j_mc, j_sf, j_si = c["j_stash"]
    t_mc, t_sf, t_si = (x.numpy() for x in c["t_carry"])
    assert t_sf.shape == j_sf.shape and t_si.shape == j_si.shape
    assert np.isfinite(c["t_rad"]).all() and np.isfinite(t_sf).all()
    good = np.isclose(c["t_rad"], c["j_rad"], rtol=1e-4, atol=1e-5).all(axis=0)
    assert (~good).mean() < 0.01, (~good).mean()

    j_mk, t_mk = j_si[:, 2], t_si[:, 2]
    same_path = good & (j_mk == t_mk).all(axis=0)
    assert (good & ~same_path).mean() < 0.002   # radiance equal by accident
    live = (j_mk != 0) & same_path                # [D, R]
    assert live.sum() > 1000
    np.testing.assert_array_equal(t_si[:, 0][live], j_si[:, 0][live])
    for row in range(12):
        # the albedo row of a lane that left the scene is read by nothing
        at = live & (j_mk != cw.MK_LIT) if 3 <= row < 6 else live
        np.testing.assert_allclose(t_sf[:, row][at], j_sf[:, row][at],
                                   rtol=1e-4, atol=1e-6, err_msg=f"row {row}")
    sampled = live & (j_sf[:, 9:12] != 0).any(axis=1)
    assert sampled.sum() > 100
    np.testing.assert_array_equal(t_si[:, 1][sampled], j_si[:, 1][sampled])
    np.testing.assert_allclose(t_mc[:, same_path], j_mc[:, same_path],
                               rtol=1e-5, atol=1e-7)
    # rows of bounces a ray never entered are inert in the port
    entered = np.ones_like(t_mk, dtype=bool)
    entered[1:] = (t_mk[:-1] & cw.MK_ALIVE_NEXT) != 0
    dead = ~entered
    assert dead.any() and (t_mk[dead] == 0).all()
    assert (t_sf[:, :3].transpose(1, 0, 2)[:, dead] == 0).all()
    assert (t_si[:, 0][dead] == cw.SLOT_NONE).all()
    assert (t_si[:, 1][dead] == cw.LSLOT_NONE).all()
    # every kind of row occurs: survivors, misses, checker variants and, in
    # the mini-Cornell, seen emission and clamped NEE terms
    for bit in (cw.MK_ALIVE_NEXT, cw.MK_LIT):
        assert (t_mk & bit).any(), bit
    if name == "mini-cornell":
        assert (t_mk & cw.MK_EMIT).any() and (t_mk & (7 * cw.MK_CLAMPED)).any()
    assert {1, 2} <= set((t_si[:, 0][t_si[:, 0] >= 0] % 3).tolist())


def test_grad_rev_plain_matches_jax_reverse_and_autograd():
    """The reverse sweep on the mini-Cornell.  (1) On the JAX kernel's own
    stash the port's plain version gives the JAX reverse kernel's sums:
    rtol 1e-4 (float64 against blocked float32 sums of 2304 terms).  (2) On
    the port's stash it gives what ``torch.autograd`` gives through the
    plain forward: rtol 2e-3, atol 1e-7, the tolerance of the JAX package's
    own test of its kernel against ``jax.grad``.  Every compared table has
    an entry above 1e-4."""
    c = _case("mini-cornell", with_jax_reverse=True)
    n_tex = int(c["ts"].textures.color.shape[0])
    j_mc, j_sf, j_si = (torch.from_numpy(np.ascontiguousarray(x)) for x in c["j_stash"])
    on_jax_stash = cw.wavefront_grad_rev(j_sf, j_si, torch.from_numpy(c["g3"]),
                                         j_mc, n_tex).numpy()
    for v, k in enumerate(("color", "even_color", "odd_color")):
        assert np.abs(c["j_grads"][k]).max() > 1e-4, k
        np.testing.assert_allclose(on_jax_stash[:, v], c["j_grads"][k],
                                   rtol=1e-4, atol=1e-8, err_msg=k)

    o, d, tm, ids = c["rays"]
    oracle = cw.autograd_colour_grads(c["ts"], c["tcam"], o, d, tm, ids,
                                      c["seed"], torch.from_numpy(c["g3"]))
    for k, ref in oracle.items():
        assert torch.isfinite(ref).all(), k
        assert float(ref.abs().max()) > 1e-4, k
        np.testing.assert_allclose(c["t_grads"][k].numpy(), ref.numpy(),
                                   rtol=2e-3, atol=1e-7, err_msg=k)
        # and the port's gradients are the JAX package's (a flipped ray in
        # 2304 moves a sum by a few parts in a thousand)
        np.testing.assert_allclose(c["t_grads"][k].numpy(), c["j_grads"][k],
                                   rtol=1e-2, atol=1e-6, err_msg=k)


def test_product_chain_trace_backward():
    """A caller's own loss on a chunk's radiance: ``.backward()`` through
    ``ProductChainTrace`` gives the reverse sweep's gradients."""
    c = _case("sky")
    ts, tcam = c["ts"], c["tcam"]
    o, d, tm, ids = c["rays"]
    leaves = [t.clone().requires_grad_(True) for t in
              (ts.textures.color, ts.textures.even_color, ts.textures.odd_color)]
    rad = cw.ProductChainTrace.apply(*leaves, ts, tcam, o, d, tm, ids, c["seed"])
    assert rad.shape == (3, ids.shape[0]) and rad.requires_grad
    np.testing.assert_array_equal(rad.detach().numpy(), c["t_rad"])
    (rad * torch.from_numpy(c["g3"])).sum().backward()
    for leaf, k in zip(leaves, ("color", "even_color", "odd_color")):
        assert torch.equal(leaf.grad, c["t_grads"][k]), k
    assert float(leaves[1].grad.abs().max()) > 0   # the checker floor is seen


def test_grad_gate():
    """Metal or dielectric leaves the product-chain gate, as in the JAX
    package (the pathwise gate takes it); the port states its own texture
    limit.  The product-chain wrappers refuse a pathwise scene."""
    mixed = build_mixed(grtt, device="cpu")          # metal + dielectric
    assert cw.applicable(mixed) and not cw.grad_applicable(mixed, 4)
    assert cw.grad_pathwise_applicable(mixed, 4) and cw.grad_two_phase_ok(mixed, 4)
    assert not jmega.grad_applicable(build_mixed(grt), 4)
    cornell, cam = grtt.load_scene("cornell", device="cpu")
    assert cw.grad_applicable(cornell, 5) and cw.grad_two_phase_ok(cornell, 50)
    assert not cw.grad_applicable(cornell, 0)
    many = dataclasses.replace(cornell, textures=dataclasses.replace(
        cornell.textures, color=torch.zeros((cw.GRAD_MAX_TEX + 1, 3))))
    assert not cw.grad_applicable(many, 5)
    cam = dataclasses.replace(cam, image_width=8)
    ids = torch.arange(64)
    o, d, tm = tcamera.generate_rays(cam, ids % 8, ids // 8, ids, 0)
    with pytest.raises(NotImplementedError, match="pathwise"):
        cw.grad_fwd_stash(mixed, cam, o, d, tm, ids, 0)
    with pytest.raises(NotImplementedError):
        cw.autograd_colour_grads(mixed, cam, o, d, tm, ids, 0, torch.zeros(3, 64))
