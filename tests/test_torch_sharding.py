"""PyTorch port: rendering, gradients and training sharded over
``torch.distributed`` ranks (``parallel/sharding``, ``render_grad(mesh=...)``),
against the JAX package's ``shard_map`` mesh and the port's single device.

The ranks are gloo processes on the CPU, spawned twice for the whole file
(``parallel/launch.run_ranks``): once at world size 2 and once at 4.  Each
spawn makes every call of the file's cases on every rank and hands back
numpy arrays to a module fixture.  The conftest gives JAX 8 virtual CPU
devices.  Scenes: the JAX package's ``tests/test_sharding.py`` floor, light
and metal sphere; one scene per gradient tier (the diffuse and the glossy
box of that file for product and pathwise, a sky with a quad light for
fused, earth under a seeded atlas for image, and two scenes outside every
kernel gate for replay: ``random``'s spheres and three statues).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as jgrt
import go_raytracing_tpu_torch as grt
from go_raytracing_tpu.parallel import sharding as jsharding
from go_raytracing_tpu_torch.parallel import launch, sharding
from go_raytracing_tpu_torch.render import grad
from test_torch_helpers import port_and_jax, seeded_atlas

torch.set_num_threads(2)

SPAWN_TIMEOUT = 240.0
FLOOR_CAM = dict(image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
                 look_from=(0, 2, 6), look_at=(0, 0, 0), background=(0, 0, 0), vfov=40.0)
BOX_CAM = dict(image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
               look_from=(278, 278, -800), look_at=(278, 278, 0), vfov=40.0,
               background=(0.1, 0.1, 0.1))
SMALL = dict(image_width=16, aspect_ratio=1.0)
TIERS = ("product", "pathwise", "fused", "image", "replay", "replay_mesh")
# render_grad against the single device: JAX's own tolerances
# (tests/test_sharding.py::_grad_mesh_case)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-9)


def build_floor_metal(pkg):
    b = pkg.SceneBuilder()
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian((0.8, 0.4, 0.2)))
    b.add_light(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((6, 6, 6))))
    b.sphere((0, 1, 0), 0.8, b.metal((0.9, 0.9, 0.9), 0.1))
    return b.build(**({} if pkg is jgrt else {"device": "cpu"}))


def _diffuse_box():
    b = grt.SceneBuilder()
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), b.lambertian((0.73, 0.72, 0.71)))
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), b.lambertian((0.65, 0.05, 0.05)))
    b.add_light(b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105),
                       b.diffuse_light((15.0, 14.0, 13.0))))
    b.box((150, 0, 150), (350, 200, 350), b.lambertian((0.73, 0.72, 0.71)))
    return b.build(device="cpu"), grt.Camera(**BOX_CAM)


def _glossy_box():
    b = grt.SceneBuilder()
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), b.lambertian((0.73, 0.72, 0.71)))
    b.add_light(b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105),
                       b.diffuse_light((15.0, 14.0, 13.0))))
    b.sphere((278, 100, 278), 90, b.metal((0.8, 0.7, 0.6), 0.2))
    b.sphere((120, 90, 190), 80, b.dielectric(1.5))
    return b.build(device="cpu"), grt.Camera(**BOX_CAM)


def _sky_and_light():
    b = grt.SceneBuilder()
    b.plane((0, 0, 0), (0, 1, 0), b.lambertian(b.checker(0.5, (.1, .1, .1), (.9, .9, .9))))
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((2.5, 1, 0), 1.0, b.metal((1.0, 0.84, 0.0), 0.1))
    b.set_environment(np.random.default_rng(0).uniform(0.2, 1.0, (16, 32, 3))
                      .astype(np.float32))
    b.add_light(b.quad((-1.5, 6, -1.5), (3, 0, 0), (0, 0, 3), b.diffuse_light((9, 9, 9))))
    return b.build(device="cpu"), grt.Camera(
        **SMALL, samples_per_pixel=4, max_depth=4, look_from=(0, 2.5, 8),
        look_at=(0, 1, 0), vfov=40.0)


def _loaded(name, cam_fields, **kwargs):
    scene, cam = grt.load_scene(name, device="cpu", **kwargs)
    return scene, dataclasses.replace(cam, **SMALL, **cam_fields)


def tier_cases():
    """tier -> (scene, camera, target) on the CPU."""
    scenes = {
        "product": _diffuse_box(),
        "pathwise": _glossy_box(),
        "fused": _sky_and_light(),
        "image": _loaded("earth", dict(samples_per_pixel=4, max_depth=4),
                         image=seeded_atlas(16, 32)),
        "replay": _loaded("random", dict(samples_per_pixel=2, max_depth=3),
                          grid=(-7, 7, -7, 7)),
        "replay_mesh": _loaded("cornell-lucy", dict(samples_per_pixel=2, max_depth=3),
                               mesh_detail=(12, 10), n_instances=3),
    }
    out = {}
    for tier, (scene, cam) in scenes.items():
        spp = cam.samples_per_pixel
        target = (grt.render(scene, cam, seed=1, device="cpu") / spp * 0.8).numpy()
        out[tier] = (scene, cam, target)
    return out


@pytest.fixture(scope="module")
def tiers():
    """Every tier's scene, camera and target, with the single-device loss
    and gradients of ``render_grad`` and of ``render_grad`` at spp 1."""
    out = {}
    for tier, (scene, cam, target) in tier_cases().items():
        loss, grads = grad.render_grad(scene, cam, target, seed=0, device="cpu")
        loss1, grads1 = grad.render_grad(scene, cam, target, seed=0, spp=1, device="cpu")
        out[tier] = dict(scene=scene, cam=cam, target=target, loss=loss, grads=grads,
                         loss_spp1=loss1, grads_spp1=grads1)
    return out


@pytest.fixture(scope="module")
def floor():
    js, jcam, ts, tcam = port_and_jax(build_floor_metal, FLOOR_CAM)
    return dict(js=js, jcam=jcam, ts=ts, tcam=tcam)


@pytest.fixture(scope="module")
def world2(tiers, floor):
    ts, tcam = floor["ts"], floor["tcam"]
    target = np.zeros((tcam.image_height, tcam.image_width, 3), np.float32)
    cases = [("render_sharded", ts, tcam, dict(spp=4), 1),
             ("render_sharded", ts, tcam, dict(spp=3), 1),
             ("train_step", ts, tcam, dict(target=target, lr=0.05, spp=4, steps=2), 1),
             ("make_mesh", None, None, dict(n=3), 1)]
    cases += [("render_grad", t["scene"], t["cam"], dict(target=t["target"], seed=0), 2)
              for t in tiers.values()]
    ranks = launch.run_ranks(launch.run_cases, 2, (cases, "cpu"), timeout=SPAWN_TIMEOUT)
    return dict(render=[r[0][0]["out"] for r in ranks],
                render_spp3=[r[1][0]["out"] for r in ranks],
                train=[r[2][0]["out"] for r in ranks],
                make_mesh_3=[r[3] for r in ranks],
                grads={tier: [r[4 + i] for r in ranks] for i, tier in enumerate(tiers)})


@pytest.fixture(scope="module")
def world4(tiers, floor):
    ts, tcam = floor["ts"], floor["tcam"]
    cases = [("render_sharded", ts, tcam, dict(spp=4), 1),
             ("render_sharded", ts, tcam, dict(spp=1), 1)]
    cases += [("render_grad", tiers[t]["scene"], tiers[t]["cam"],
               dict(target=tiers[t]["target"], seed=0, spp=1), 1)
              for t in ("product", "replay")]
    ranks = launch.run_ranks(launch.run_cases, 4, (cases, "cpu"), timeout=SPAWN_TIMEOUT)
    return dict(render=[r[0][0]["out"] for r in ranks],
                render_spp1=[r[1][0]["out"] for r in ranks],
                grads_spp1={t: [r[2 + i][0]["out"] for r in ranks]
                            for i, t in enumerate(("product", "replay"))})


@pytest.fixture(scope="module")
def jax_refs(floor):
    """The JAX package's ``render_sharded`` on 4 devices, and one
    ``train_step`` on 2 devices toward a black target."""
    js, jcam = floor["js"], floor["jcam"]
    fb = jsharding.render_sharded(js, jcam, jsharding.make_mesh(4), jnp.uint32(0), spp=4)
    target = jnp.zeros((jcam.image_height, jcam.image_width, 3), jnp.float32)
    s1, loss = jsharding.train_step(js, jcam, jsharding.make_mesh(2), target,
                                    jnp.uint32(0), jnp.float32(0.05), spp=4)
    params = {k: np.asarray(v) for k, v in jsharding.trainable_params(s1).items()}
    return dict(fb=np.asarray(fb), loss=float(loss), params=params)


def _assert_same_bits(per_rank):
    for other in per_rank[1:]:
        np.testing.assert_array_equal(other, per_rank[0])


def _assert_grads_close(loss, grads, ref_loss, ref_grads):
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    assert set(grads) == set(ref_grads)
    for k, v in ref_grads.items():
        np.testing.assert_allclose(grads[k], v.numpy(), err_msg=k, **GRAD_TOL)


def test_make_mesh_without_a_process_group():
    mesh = sharding.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.member, mesh.group) == (1, 0, True, None)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="need 2 ranks, have 1"):
        sharding.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()
    else:
        assert sharding.make_mesh().device.type == "cuda"


def test_make_mesh_refuses_more_ranks_than_exist(world2):
    for msg in world2["make_mesh_3"]:
        assert msg.startswith("RuntimeError: need 3 ranks, have 2"), msg


def test_sample_windows_cover_every_sample_once():
    for n, size in ((3, 2), (1, 4), (4, 4), (100, 3), (0, 2)):
        wins = [sharding.sample_window(n, size, r) for r in range(size)]
        assert wins[0][0] == 0 and wins[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(wins, wins[1:]))
    assert [sharding.sample_window(1, 4, r) for r in range(4)] == [(0, 0)] * 3 + [(0, 1)]
    assert [sharding.sample_window(3, 2, r) for r in range(2)] == [(0, 1), (1, 3)]


def test_world1_render_sharded_is_render_bits(floor):
    ts, tcam = floor["ts"], floor["tcam"]
    fb = sharding.render_sharded(ts, tcam, sharding.make_mesh(device="cpu"), 0, spp=4)
    assert torch.equal(fb, grt.render(ts, tcam, spp=4, seed=0, device="cpu"))


@pytest.mark.parametrize("tier", TIERS)
def test_world1_render_grad_is_single_device_bits(tiers, tier):
    t = tiers[tier]
    assert grad.grad_tier(t["scene"], t["cam"].max_depth) == tier.split("_")[0]
    loss, grads = grad.render_grad(t["scene"], t["cam"], t["target"], seed=0,
                                   mesh=sharding.make_mesh(device="cpu"))
    assert torch.equal(loss, t["loss"])
    for k, v in t["grads"].items():
        assert torch.equal(grads[k], v), k


@pytest.mark.parametrize("world", [2, 4])
def test_render_sharded_matches_jax_and_the_single_device(world, world2, world4, floor,
                                                          jax_refs):
    per_rank = (world2 if world == 2 else world4)["render"]
    _assert_same_bits(per_rank)
    np.testing.assert_allclose(per_rank[0], jax_refs["fb"], rtol=1e-4, atol=1e-4)
    single = grt.render(floor["ts"], floor["tcam"], spp=4, seed=0, device="cpu").numpy()
    np.testing.assert_allclose(per_rank[0], single, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world, spp", [(2, 3), (4, 1)])
def test_render_sharded_ragged_windows(world, spp, world2, world4, floor):
    """spp 3 on 2 ranks (one sample and two), spp 1 on 4 (three ranks trace
    nothing and still join the all-reduce)."""
    per_rank = world2["render_spp3"] if world == 2 else world4["render_spp1"]
    _assert_same_bits(per_rank)
    single = grt.render(floor["ts"], floor["tcam"], spp=spp, seed=0, device="cpu").numpy()
    np.testing.assert_allclose(per_rank[0], single, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["color", "even_color", "odd_color"])
def test_train_step_matches_jax(world2, jax_refs, floor, key):
    """Loss and the step's colour gradients (old minus new parameters over
    lr) within the tolerances autograd is held to against ``jax.grad``
    (tests/test_torch_integrator_grad.py): the loss to 1e-4, the gradient to
    2e-3 of its largest entry.  The JAX package's ``train_step`` takes the
    XLA closest hit on the CPU, whose hit distance carries a gradient: its
    fuzz and IOR steps have terms the port's standard integrator leaves
    out (``integrator/wavefront.trace``), its colour steps do not."""
    losses, params = world2["train"][0]
    np.testing.assert_allclose(float(losses[0]), jax_refs["loss"], rtol=1e-4)
    old = {k: v.numpy() for k, v in sharding.trainable_params(floor["ts"]).items()}
    for k in [key]:
        ref = jax_refs["params"][k]
        g_port = (old[k] - params[0][k]) / 0.05
        g_jax = (old[k] - ref) / 0.05
        assert np.abs(g_port - g_jax).max() <= 2e-3 * max(np.abs(g_jax).max(), 1e-6), k
    assert np.abs(old["color"] - params[0]["color"]).max() > 0


def test_train_step_lowers_the_loss_on_every_rank(world2):
    (losses, params), (losses1, params1) = world2["train"]
    assert np.isfinite(float(losses[0])) and float(losses[1]) < float(losses[0])
    _assert_same_bits([np.asarray(losses), np.asarray(losses1)])
    for k in params[1]:
        _assert_same_bits([params[1][k], params1[1][k]])


@pytest.mark.parametrize("tier", TIERS)
def test_render_grad_on_two_ranks_matches_the_single_device(tiers, world2, tier):
    """Every tier under a 2-rank mesh: the single-device loss and gradients
    up to the order of the sums, the same bits on both ranks and on a
    second call."""
    t = tiers[tier]
    (first, second), (first1, second1) = world2["grads"][tier]
    loss, grads = first["out"]
    _assert_grads_close(loss, grads, t["loss"], t["grads"])
    assert sum(np.abs(v).sum() for v in grads.values()) > 0
    for other in (second, first1, second1):
        np.testing.assert_array_equal(other["out"][0], loss)
        for k in grads:
            np.testing.assert_array_equal(other["out"][1][k], grads[k], err_msg=k)


@pytest.mark.parametrize("tier", ["product", "replay"])
def test_render_grad_spp1_on_four_ranks(tiers, world4, tier):
    """One sample on four ranks: three trace nothing, every rank gets the
    single-device numbers."""
    t = tiers[tier]
    per_rank = world4["grads_spp1"][tier]
    loss, grads = per_rank[0]
    _assert_grads_close(loss, grads, t["loss_spp1"], t["grads_spp1"])
    for other_loss, other_grads in per_rank[1:]:
        np.testing.assert_array_equal(other_loss, loss)
        for k in grads:
            np.testing.assert_array_equal(other_grads[k], grads[k], err_msg=k)
