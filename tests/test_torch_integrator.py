"""PyTorch port vs the JAX package: the standard integrator
(``trace(mega_mode="off")`` and ``render(differentiable=True)``), forward.

The JAX package renders with its Pallas closest-hit kernels in interpret
mode (``pallas_intersect.INTERPRET``, restored afterwards): that is its
accelerator route.  The port runs the kernels' plain versions, since the
tensors lie on the CPU.  One compiled JAX render, cached in a module
fixture; the gradients are in tests/test_torch_integrator_grad.py."""

import dataclasses

import numpy as np
import pytest
import torch

import go_raytracing_tpu as grt
import go_raytracing_tpu_torch as grtt
from go_raytracing_tpu import camera as jcamera
from go_raytracing_tpu.ops import pallas_intersect as pk
from go_raytracing_tpu_torch import camera as tcamera
from go_raytracing_tpu_torch import convert
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.integrator import wavefront as twf
from go_raytracing_tpu_torch.lights import hdri as hdri_mod
from go_raytracing_tpu_torch.ops import cuda_intersect as ck
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import renderer as trenderer
from test_torch_helpers import (FOG_ROOM_CAM, MIXED_CAM, build_fog_room, build_lucy,
                                build_mixed, mesh_rays, port_and_jax, scene_tree)

torch.set_num_threads(2)

SEED = 3
IMAGE_TOL = dict(rtol=1e-3, atol=2e-3)


def _linear(ts, tcam, seed=SEED, **kw):
    fb = grtt.render(ts, tcam, seed=seed, device="cpu", **kw)
    return fb.detach().numpy() / tcam.samples_per_pixel


@pytest.fixture(scope="module")
def fog_room():
    """A scene outside the megakernel's gate (round fog, pyramid fog) in both
    packages, and the JAX package's linear image of it through the standard
    integrator's fast route (attribute kernels in interpret mode)."""
    js, jcam, ts, tcam = port_and_jax(build_fog_room, FOG_ROOM_CAM)
    old = pk.INTERPRET
    pk.INTERPRET = True
    try:
        j_img = np.asarray(grt.render(js, jcam, seed=SEED, mega_mode="off"))
    finally:
        pk.INTERPRET = old
    return dict(ts=ts, tcam=tcam, j_img=j_img / jcam.samples_per_pixel)


def test_both_routes_match_jax_outside_the_gate(fog_room):
    c = fog_room
    assert not cw.applicable(c["ts"])            # a round fog is outside the gate
    assert twf.attr_path_ok(c["ts"], False) and not twf.attr_path_ok(c["ts"], True)
    fast = _linear(c["ts"], c["tcam"], mega_mode="off")
    gather = _linear(c["ts"], c["tcam"], differentiable=True)
    assert np.isfinite(fast).all() and c["j_img"].mean() > 0.01
    np.testing.assert_allclose(fast, c["j_img"], **IMAGE_TOL)
    np.testing.assert_allclose(gather, c["j_img"], **IMAGE_TOL)
    np.testing.assert_allclose(gather, fast, **IMAGE_TOL)
    # left to itself, render picks the standard integrator
    assert twf.choose_mega_mode(c["ts"], c["tcam"], 512, False) == "off"
    np.testing.assert_allclose(_linear(c["ts"], c["tcam"]), c["j_img"], **IMAGE_TOL)


def _rays(cam, n, seed):
    ids = torch.arange(n, dtype=torch.int64)
    px = ids % cam.image_width
    py = (ids // cam.image_width) % cam.image_height
    o, d, tm = tcamera.generate_rays(cam, px, py, ids, seed)
    return o, d, tm, ids


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke", "simple", "mixed"])
def test_three_routes_one_picture(name):
    """Inside the megakernel's gate the fast route, the gather route and the
    megakernel trace the same rays to the same radiance: every draw has the
    same key, and all three run the same formulas on the CPU."""
    if name == "mixed":
        ts = build_mixed(grtt, device="cpu")
        cam = tcamera.Camera(**MIXED_CAM)
    else:
        ts, cam = grtt.load_scene(name, device="cpu")
        cam = dataclasses.replace(cam, image_width=16, aspect_ratio=1.0, max_depth=4)
    assert cw.applicable(ts)
    o, d, tm, ids = _rays(cam, 512, 5)
    mega = twf.trace(ts, cam, o, d, tm, ids, 5, mega_mode="single").rows()
    fast, stats = twf.trace(ts, cam, o, d, tm, ids, 5, mega_mode="off",
                            with_stats=True)
    gather = twf.trace(ts, cam, o.rows(), d.rows(), tm, ids, 5, differentiable=True)
    assert stats == dict(mesh_overflow=0)
    assert float(mega.mean()) > 0.01
    # per ray: a branch that flips on the last digit changes a ray wholly
    for other in (fast.rows(), gather.rows()):
        bad = ~torch.isclose(other, mega, rtol=1e-4, atol=1e-5).all(dim=1)
        assert float(bad.float().mean()) <= 0.005, float(bad.float().mean())


def test_early_stop_and_launch_counters():
    """The non-differentiable route stops when no ray is alive; on the CPU no
    kernel is launched (the plain versions run, because the rays lie there)."""
    ts, cam = grtt.load_scene("quads", device="cpu")
    cam = dataclasses.replace(cam, image_width=8, max_depth=50)
    o, d, tm, ids = _rays(cam, 64, 0)
    calls = []
    real = twf.bounce_step

    def counting(*a, **kw):
        calls.append(kw["fast"])
        return real(*a, **kw)

    before = (ck.LAUNCHES_PLANAR, ck.LAUNCHES_SPHERE, ck.LAUNCHES_PLANAR_ATTRS,
              ck.LAUNCHES_SPHERE_ATTRS)
    twf.bounce_step = counting
    try:
        a = twf.trace(ts, cam, o, d, tm, ids, 0, mega_mode="off")
        n_fast = len(calls)
        b = twf.trace(ts, cam, o, d, tm, ids, 0, differentiable=True)
    finally:
        twf.bounce_step = real
    assert 1 < n_fast < 50 and all(calls[:n_fast])
    assert len(calls) - n_fast == 50 and not any(calls[n_fast:])
    torch.testing.assert_close(a.rows(), b.rows(), rtol=1e-5, atol=1e-6)
    assert before == (ck.LAUNCHES_PLANAR, ck.LAUNCHES_SPHERE,
                      ck.LAUNCHES_PLANAR_ATTRS, ck.LAUNCHES_SPHERE_ATTRS)


def test_no_grad_render_keeps_no_graph():
    ts, cam = grtt.load_scene("quads", device="cpu")
    cam = dataclasses.replace(cam, image_width=8, samples_per_pixel=1, max_depth=2)
    ts.textures.color.requires_grad_()
    try:
        assert not grtt.render(ts, cam, device="cpu").requires_grad
        assert not grtt.render(ts, cam, device="cpu", mega_mode="off").requires_grad
        with torch.no_grad():
            assert not grtt.render(ts, cam, device="cpu",
                                   differentiable=True).requires_grad
        fb = grtt.render(ts, cam, device="cpu", differentiable=True, chunk=48)
        assert fb.requires_grad      # across chunks that do not align with samples
        fb.sum().backward()
        assert float(ts.textures.color.grad.abs().max()) > 0
    finally:
        ts.textures.color.requires_grad_(False)
        ts.textures.color.grad = None


def test_pick_chunk_size_is_smaller_on_the_differentiable_route():
    ts, _ = grtt.load_scene("cornell", device="cpu")
    assert trenderer.pick_chunk_size(ts) == trenderer.MAX_CHUNK_RAYS
    assert (trenderer.pick_chunk_size(ts, differentiable=True)
            == trenderer.MAX_CHUNK_RAYS_DIFFERENTIABLE < trenderer.MAX_CHUNK_RAYS)


def test_render_image_and_progressive_take_the_routes():
    ts, cam = grtt.load_scene("cornell", device="cpu")
    cam = dataclasses.replace(cam, image_width=8, aspect_ratio=1.0,
                              samples_per_pixel=4, max_depth=3)
    ref = grtt.render_image(ts, cam, seed=1, device="cpu")
    off = grtt.render_image(ts, cam, seed=1, device="cpu", mega_mode="off")
    dif = grtt.render_image(ts, cam, seed=1, device="cpu", differentiable=True)
    torch.testing.assert_close(off, ref, **IMAGE_TOL)
    torch.testing.assert_close(dif, ref, **IMAGE_TOL)
    names = [n for n, _ in grtt.render_progressive(ts, cam, seed=1, device="cpu",
                                                   mega_mode="off")]
    assert names == ["preview", "refining", "final"]


def _recorded(ts, r):
    """The replay tier (ROADMAP.md A18) is ported: a record keeps the
    radiance and holds [depth, rays] decisions."""
    rad, dec = twf.trace(ts, *r, record=True)
    assert torch.equal(rad.rows(), twf.trace(ts, *r).rows())
    assert tuple(dec.which.shape) == (r[0].max_depth, r[1].x.shape[0])


def _replayed(ts, r):
    """... and its replay gives the recorded radiance."""
    rad, dec = twf.trace(ts, *r, record=True)
    rep = twf.trace(ts, *r, decisions=dec)
    torch.testing.assert_close(rep.rows().detach(), rad.rows(), rtol=1e-5, atol=1e-6)


def _mesh_recorded(ts, r):
    """... and the standard integrator records a mesh scene's triangles."""
    lucy = build_lucy(grtt, n_instances=2, device="cpu")
    o, d = (torch.from_numpy(a) for a in mesh_rays(64))
    ids = torch.arange(64)
    _, dec = twf.trace(lucy, r[0], o, d, torch.zeros(64), ids, 0, record=True)
    assert bool((dec.which[0] >= twf.HIT_MESH_BASE).any())


def _env_traced(ts, r):
    """An environment scene traces on both routes: the standard
    integrator's picture is the megakernel's (plain versions here)."""
    cam, o, d, tm, ids, seed = r
    env = hdri_mod.build_environment(np.full((4, 8, 3), 0.5, np.float32))
    lit = dataclasses.replace(ts, env=env)
    a = twf.trace(lit, cam, o, d, tm, ids, seed)
    b = twf.trace(lit, cam, o, d, tm, ids, seed, mega_mode="off")
    np.testing.assert_allclose(torch.stack(list(a)).numpy(),
                               torch.stack(list(b)).numpy(), rtol=1e-4, atol=1e-5)


def _image_mode_traced(ts, r):
    """'image' traces a sphere with an image texture alone to the standard
    integrator's radiance, and refuses a scene outside
    ``image_prefactor_ok`` (quads)."""
    cam, o, d, tm, ids, seed = r
    b = grtt.SceneBuilder()
    b.sphere((0, 0, 0), 2.0, b.lambertian(b.image(np.full((2, 4, 3), 0.5, np.float32))))
    ball = b.build(device="cpu")
    eye = V3(*(torch.full_like(tm, v) for v in (0.0, 0.0, 8.0)))
    at = V3(d.x * 0.2, d.y * 0.2, torch.full_like(tm, -1.0))
    a = twf.trace(ball, cam, eye, at, tm, ids, seed, mega_mode="image")
    b = twf.trace(ball, cam, eye, at, tm, ids, seed, mega_mode="off")
    np.testing.assert_allclose(torch.stack(list(a)).numpy(),
                               torch.stack(list(b)).numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="image_prefactor_ok"):
        twf.trace(ts, *r, mega_mode="image")


def _image_quad_traced(ts, r):
    """A quad with an image texture takes the standard integrator, which
    reads the atlas, and records its decisions for the replay."""
    b = grtt.SceneBuilder()
    b.quad((-50, -50, -1), (100, 0, 0), (0, 100, 0), b.lambertian(b.image(
        np.random.default_rng(0).uniform(0, 1, (3, 5, 3)).astype(np.float32))))
    pic = b.build(device="cpu")
    assert twf.choose_mega_mode(pic, r[0], 16, False) == "off"
    rad, dec = twf.trace(pic, *r, record=True)
    assert torch.equal(rad.rows(), twf.trace(pic, *r).rows())
    assert bool((dec.which[0] == twf.HIT_PLANAR).any())


def _hdri_light_sampled(ts, r):
    """``sample_hdri_light`` returns a contribution, a zero overflow and
    the shadow outcome (given a recorded one, no shadow ray is traced)."""
    cam, o, d, tm, ids, seed = r
    lit = dataclasses.replace(ts, env=hdri_mod.build_environment(
        np.full((4, 8, 3), 0.5, np.float32)))
    n = V3(torch.zeros_like(tm), torch.ones_like(tm), torch.zeros_like(tm))
    att = V3(*(torch.full_like(tm, 0.5) for _ in range(3)))
    mat = torch.zeros_like(ids, dtype=torch.int32)
    contrib, overflow, blocked = twf.sample_hdri_light(
        lit, cam, o, n, d, att, mat, seed, ids, 0)
    assert overflow == 0 and blocked.dtype == torch.bool
    again, _, same = twf.sample_hdri_light(lit, cam, o, n, d, att, mat, seed, ids, 0,
                                           blocked=blocked)
    assert torch.equal(same, blocked)
    assert all(torch.equal(a, b) for a, b in zip(contrib, again))


@pytest.mark.parametrize("call, item", [
    (_recorded, "A18"),
    (_replayed, "A18"),
    # image textures are ported: the 'image' mode, and the standard integrator
    (lambda ts, r: _image_mode_traced(ts, r), "A16"),
    (lambda ts, r: _image_quad_traced(ts, r), "A16"),
    # meshes render, and the standard integrator records their decisions
    (_mesh_recorded, "A18"),
    # environments are ported: the miss shader, and NEE toward the HDRI
    (lambda ts, r: _env_traced(ts, r), "A15"),
    (lambda ts, r: _hdri_light_sampled(ts, r), "A15"),
])
def test_what_remains_names_its_roadmap_item(call, item):
    """Each part still to port raises and names its ROADMAP item; the replay
    tier's calls (A18), environments (A15) and image textures (A16) are
    ported and run their own checks."""
    ts, cam = grtt.load_scene("quads", device="cpu")
    cam = dataclasses.replace(cam, image_width=8, max_depth=2)
    o, d, tm, ids = _rays(cam, 16, 0)
    if item in ("A18", "A15", "A16"):
        call(ts, (cam, o, d, tm, ids, 0))
    else:
        with pytest.raises(NotImplementedError, match=item):
            call(ts, (cam, o, d, tm, ids, 0))
    with pytest.raises(ValueError, match="mega_mode"):
        twf.trace(ts, cam, o, d, tm, ids, 0, mega_mode="sideways")
