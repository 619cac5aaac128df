"""A run of each cell at a tiny size on the CPU (the program's plain route):
the reference agrees with the program, the control fails the cell's limits,
and a run with the timed path broken underneath reads ``correct`` false."""

import dataclasses

import pytest
import torch

import go_raytracing_tpu_torch as grt
from portbench import inputs, program, run
from portbench.reference import jobs
from portbench.reference import scene as ref_scene
from portbench.traffic import closed_loop

CELLS = ["cornell.render", "hdri-test.grad", "cornell.grad", "hdri-test.render"]
SEED = 2**31 + 977


def tiny(name):
    """The cell at 24 pixels across and 2 samples, under a 64x32 sky."""
    cell = run.load_cell(name)
    config = dict(cell["config_data"], width=24, spp=2)
    if config.get("environment"):
        config["environment"] = dict(config["environment"], height=32, width=64)
    cell["config_data"] = config
    return cell


def job_of(cell, seed=SEED):
    config = cell["config_data"]
    sky = inputs.environment(config)
    scene, cam = program.build(config, sky, "cpu")
    job = closed_loop.Job(cell["traffic_data"], program, scene, cam, seed, "cpu")
    job.setup()
    return job, ref_scene.build(config, sky, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_on_the_cpu(name):
    cell = tiny(name)
    job, ref = job_of(cell)
    for k in (0, 1):
        got = job.call(k)
        numbers = closed_loop.compare(job.kind, got, job.reference(jobs, ref, k))
        assert all(v <= 1e-6 for v in numbers.values()), numbers
        assert set(numbers) == set(cell["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    cell = tiny(name)
    job, ref = job_of(cell)
    want = job.reference(jobs, ref, 0)
    ctl = job.reference(jobs, ref, 0, hold=jobs.control)
    numbers = closed_loop.compare(job.kind, ctl, want)
    assert any(v > cell["limits"][k] for k, v in numbers.items()), numbers


def _stale(orig):
    first = []

    def call(*a, **kw):
        out = orig(*a, **kw)
        first.append(out)
        return first[0]
    return call


def _half(orig):
    def call(scene, cam, *a, **kw):
        return orig(scene, dataclasses.replace(cam, samples_per_pixel=cam.samples_per_pixel // 2),
                    *a, **kw)
    return call


def _altered(orig):
    def call(*a, **kw):
        out = orig(*a, **kw)
        if isinstance(out, tuple):
            return out[0] * 1.01, {k: v * 1.01 for k, v in out[1].items()}
        return out * 1.01
    return call


@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_reads_not_correct(name, fault, monkeypatch):
    cell = tiny(name)
    entry = "render_image" if cell["traffic_data"]["call"] == "frame" else "render_grad"
    ok = run.run_cell(cell, SEED, 1.0, False, "cpu", log=lambda m: None)
    assert ok["correct"] and ok["attempted"] >= 2
    monkeypatch.setattr(grt, entry, fault(getattr(grt, entry)))
    bad = run.run_cell(cell, SEED, 1.0, False, "cpu", log=lambda m: None)
    assert not bad["correct"], bad["checks"]
    assert list(bad)[-1] == "checks"


def _dropped(key):
    def fault(orig):
        def call(*a, **kw):
            loss, grads = orig(*a, **kw)
            return loss, {k: v for k, v in grads.items() if k != key}
        return call
    return fault


@pytest.mark.parametrize("name,key", [("cornell.grad", "color"), ("hdri-test.grad", "ior"),
                                      ("hdri-test.grad", "env_data")])
def test_a_step_that_drops_a_gradient_reads_not_correct(name, key, monkeypatch):
    cell = tiny(name)
    monkeypatch.setattr(grt, "render_grad", _dropped(key)(grt.render_grad))
    bad = run.run_cell(cell, SEED, 1.0, False, "cpu", log=lambda m: None)
    assert not bad["correct"] and bad["checks"]["grad_rel"]["value"] >= 1.0, bad["checks"]


def test_compare_counts_a_gradient_either_side_lacks():
    one = torch.ones(3)
    ref = (torch.tensor(1.0), {"a": one, "b": one})
    assert closed_loop.compare("grad_step", (torch.tensor(1.0), {"a": one, "b": one}), ref) == {
        "loss_rel": 0.0, "grad_rel": 0.0}
    assert closed_loop.compare("grad_step", (torch.tensor(1.0), {"a": one}), ref)["grad_rel"] == 1.0
    extra = (torch.tensor(1.0), {"a": one, "b": one, "c": 2 * one})
    assert closed_loop.compare("grad_step", extra, ref)["grad_rel"] == 2.0


def test_a_traced_run_on_the_cpu_reads_its_window():
    cell = tiny("cornell.render")
    res = run.run_cell(cell, SEED, 0.2, True, "cpu", log=lambda m: None)
    assert res["correct"] and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_kernels_on_the_card(name, card):
    cell = tiny(name)
    cell["config_data"] = dict(cell["config_data"], width=96, spp=4)
    config = cell["config_data"]
    sky = inputs.environment(config)
    scene, cam = program.build(config, sky, card)
    job = closed_loop.Job(cell["traffic_data"], program, scene, cam, SEED, card)
    job.setup()
    got = job.call(0)
    numbers = closed_loop.compare(job.kind, got,
                                  job.reference(jobs, ref_scene.build(config, sky, card), 0))
    assert all(v <= cell["limits"][k] for k, v in numbers.items()), numbers
