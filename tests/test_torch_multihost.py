"""PyTorch port: multi-process start-up and the scaling harness
(``parallel/multihost``), against the JAX package's module of the same name.

Two gloo processes on the CPU join one process group through
``multihost.initialize('127.0.0.1:<port>', 2, i)`` (``parallel/launch``
spawns them, once for the whole file) and make every call of the file's
cases: the render of the JAX package's ``tests/test_multihost.py``, the
scaling report at one and two ranks, and ``render_grad`` of the product
tier, held against the JAX package's ``render_grad(mesh=make_mesh(2))``
(its cheapest tier on the CPU: the gradient kernel in interpret mode).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import go_raytracing_tpu as jgrt
import go_raytracing_tpu_torch as grt
from go_raytracing_tpu.ops import pallas_wavefront as jmega
from go_raytracing_tpu.parallel import multihost as jmultihost
from go_raytracing_tpu.parallel import sharding as jsharding
from go_raytracing_tpu.render.grad import render_grad as j_render_grad
from go_raytracing_tpu_torch.parallel import launch, multihost
from go_raytracing_tpu_torch.render import grad
from test_torch_helpers import build_mini_cornell, port_and_jax

torch.set_num_threads(2)

SIMPLE = dict(image_width=32, samples_per_pixel=2, max_depth=3)
BOX_CAM = dict(image_width=16, aspect_ratio=1.0, samples_per_pixel=8, max_depth=4,
               look_from=(278, 278, -800), look_at=(278, 278, 0), vfov=40.0,
               background=(0, 0, 0))
REPORT_FIELDS = {"devices", "spp", "wall_s", "rays_per_s", "efficiency"}
# explicit rates and links, the same for both packages
RATES = dict(chip_mrays_fwd=310.0, chip_mrays_fwd_bwd=45.0, ici_gbps=450.0, dcn_gbps=50.0)


def _simple():
    scene, cam = grt.load_scene("simple", device="cpu")
    return scene, dataclasses.replace(cam, **SIMPLE)


def _build_box(pkg):
    b = pkg.SceneBuilder()
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), b.lambertian((0.73, 0.72, 0.71)))
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), b.lambertian((0.65, 0.05, 0.05)))
    b.add_light(b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105),
                       b.diffuse_light((15.0, 14.0, 13.0))))
    b.box((150, 0, 150), (350, 200, 350), b.lambertian((0.73, 0.72, 0.71)))
    return b.build(**({} if pkg is jgrt else {"device": "cpu"}))


@pytest.fixture(scope="module")
def box():
    js, jcam, ts, tcam = port_and_jax(_build_box, BOX_CAM)
    target = (grt.render(ts, tcam, seed=7, device="cpu") / 8).numpy()
    return dict(js=js, jcam=jcam, ts=ts, tcam=tcam, target=target)


@pytest.fixture(scope="module")
def two_processes(box):
    scene, cam = _simple()
    cases = [("render_sharded", scene, cam, dict(spp=2), 1),
             ("scaling_report", scene, cam, dict(spp=2, device_counts=[1, 2]), 1),
             ("scaling_report", scene, cam, dict(spp=1, device_counts=[1, 2],
                                                 mode="weak"), 1),
             ("render_grad", box["ts"], box["tcam"], dict(target=box["target"], seed=0), 1)]
    ranks = launch.run_ranks(launch.run_cases, 2, (cases, "cpu"), timeout=240.0)
    return [[case[0]["out"] for case in r] for r in ranks]


def test_two_processes_render_the_single_process_picture(two_processes):
    fb0, fb1 = two_processes[0][0], two_processes[1][0]
    np.testing.assert_array_equal(fb0, fb1)
    scene, cam = _simple()
    ref = grt.render(scene, cam, spp=2, seed=0, device="cpu").numpy()
    np.testing.assert_allclose(fb0, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [1, 2])
def test_scaling_report_at_one_and_two_ranks(two_processes, case):
    strong, weak = two_processes[0][1], two_processes[0][2]
    report = strong if case == 1 else weak
    assert [r["devices"] for r in report] == [1, 2]
    assert [r["spp"] for r in report] == ([2, 2] if case == 1 else [1, 2])
    for r in report:
        assert set(r) == REPORT_FIELDS
        assert r["wall_s"] > 0 and r["rays_per_s"] > 0
        assert 0 < r["efficiency"] <= 2.0
    assert report[0]["efficiency"] == 1.0
    assert two_processes[1][case] == report


def test_scaling_report_without_a_process_group():
    scene, cam = _simple()
    (r,) = multihost.scaling_report(scene, cam, spp=1)
    assert set(r) == REPORT_FIELDS and r["devices"] == 1 and r["efficiency"] == 1.0


def test_render_grad_on_two_processes_matches_jax_mesh(two_processes, box):
    """Product tier under a 2-rank mesh against the JAX package's
    ``render_grad(mesh=make_mesh(2))``: the loss to rtol 1e-5 and each
    gradient to 2e-3 of its largest entry, as the single-device test does
    (tests/test_torch_grad_render.py)."""
    assert grad.grad_tier(box["ts"], box["tcam"].max_depth) == "product"
    old = jmega.INTERPRET, jmega.BLOCK_ROWS
    jmega.INTERPRET, jmega.BLOCK_ROWS = True, 8
    try:
        j_loss, j_grads = j_render_grad(box["js"], box["jcam"], box["target"], seed=0,
                                        mesh=jsharding.make_mesh(2))
        j_loss, j_grads = float(j_loss), {k: np.asarray(v) for k, v in j_grads.items()}
    finally:
        jmega.INTERPRET, jmega.BLOCK_ROWS = old
    loss, grads = two_processes[0][3]
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    assert set(grads) == set(j_grads)
    for k, ref in j_grads.items():
        big = np.abs(ref).max()
        np.testing.assert_allclose(grads[k], ref, rtol=0, atol=2e-3 * big + 1e-12,
                                   err_msg=k)
    assert np.abs(grads["color"]).max() > 0


@pytest.mark.parametrize("n_devices", [2, 4])
def test_comm_analysis_matches_jax(n_devices):
    js, jcam, ts, tcam = port_and_jax(build_mini_cornell, dict(
        image_width=64, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
        look_from=(278, 278, -800), look_at=(278, 278, 0), vfov=40.0))
    got = multihost.comm_analysis(ts, tcam, spp=100, n_devices=n_devices, **RATES)
    ref = jmultihost.comm_analysis(js, jcam, spp=100, n_devices=n_devices, **RATES)
    assert got == ref


def test_comm_analysis_takes_no_default_rates():
    scene, cam = _simple()
    with pytest.raises(TypeError):
        multihost.comm_analysis(scene, cam, spp=100, n_devices=4)


def test_initialize_needs_the_world_with_an_address():
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("127.0.0.1:1", device="cpu")
