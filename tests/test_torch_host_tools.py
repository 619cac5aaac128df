"""PyTorch port: the host-side tools, each against the JAX package's module
of the same name where both can be run: render checkpoints (files either
package reads), the live view over HTTP, the profiler and memory report,
the CLI's flags, the micro-benchmarks and the perf probe at a tiny size
(they run; no time is checked on the CPU), the inverse-rendering loop in
each of its modes, and the entry points with their two-rank dry
run (gloo on the CPU).
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

import go_raytracing_tpu as jgrt
import go_raytracing_tpu_torch as grt
from go_raytracing_tpu.render import checkpoint as jcheckpoint
from go_raytracing_tpu_torch.render import checkpoint, display
from go_raytracing_tpu_torch.utils import (cli, entry, inverse_rendering, microbench,
                                           perf_probe, profiler, scaling_report)

torch.set_num_threads(2)


def _simple(spp=8):
    scene, cam = grt.load_scene("simple", device="cpu")
    return scene, dataclasses.replace(cam, image_width=12, aspect_ratio=1.0,
                                      samples_per_pixel=spp, max_depth=4)


def test_checkpoint_round_trip(tmp_path):
    scene, cam = _simple()
    accum = grt.render(scene, cam, spp=2, seed=3, device="cpu")
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, accum, 2, 3, cam)
    back, done, seed = checkpoint.load(path)
    assert torch.equal(back, accum) and (done, seed) == (2, 3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_files_cross_between_the_packages(tmp_path, writer):
    """The same ``.npz`` keys: a file either package writes, the other
    reads, with the same accumulator and progress."""
    scene, cam = _simple()
    accum = grt.render(scene, cam, spp=2, seed=5, device="cpu").numpy()
    path = str(tmp_path / "c.npz")
    if writer == "port":
        checkpoint.save(path, torch.from_numpy(accum), 2, 5, cam)
        back, done, seed = jcheckpoint.load(path)
    else:
        jcam = jgrt.Camera(image_width=cam.image_width, aspect_ratio=1.0)
        jcheckpoint.save(path, accum, 2, 5, jcam)
        back, done, seed = checkpoint.load(path)
    np.testing.assert_array_equal(np.asarray(back), accum)
    assert (done, seed) == (2, 5)
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "meta"]
        assert json.loads(str(z["meta"]))["image_height"] == cam.image_height


def test_resumed_render_equals_the_one_shot_render_bits(tmp_path):
    """Interrupted after 4 of 8 samples in slices of 3, resumed to 8: the
    one-shot render's bits (the renderer adds samples one at a time)."""
    scene, cam = _simple()
    path = str(tmp_path / "ckpt.npz")
    checkpoint.render_with_checkpoints(scene, cam, path, spp=4, seed=7,
                                       spp_per_checkpoint=3, device="cpu")
    assert checkpoint.load(path)[1] == 4
    acc = checkpoint.render_with_checkpoints(scene, cam, path, spp=8, seed=7,
                                             spp_per_checkpoint=3, device="cpu")
    assert torch.equal(acc, grt.render(scene, cam, spp=8, seed=7, device="cpu"))
    with pytest.raises(ValueError, match="seed 7"):
        checkpoint.render_with_checkpoints(scene, cam, path, spp=9, seed=8, device="cpu")


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_live_display_serves_the_frame_and_status():
    disp = display.LiveDisplay(port=0)
    try:
        with pytest.raises(urllib.error.HTTPError):
            _get(disp.url + "frame.png")
        scene, cam = _simple(2)
        img = grt.render_image(scene, cam, device="cpu")
        disp.update(img, pass_name="final", done_spp=2, total_spp=2)
        status, ctype, body = _get(disp.url + "frame.png")
        assert (status, ctype) == (200, "image/png") and body.startswith(b"\x89PNG")
        assert body == grt.film.encode_png(grt.film.to_uint8(img))
        st = json.loads(_get(disp.url + "status")[2])
        assert st["seq"] == 0 and st["pass_name"] == "final" and st["done_spp"] == 2
        assert b"live render" in _get(disp.url)[2]
    finally:
        disp.close()


def test_profiler_trace_timers_and_memory_report(tmp_path):
    scene, cam = _simple(2)
    prof = profiler.Profiler(trace_dir=str(tmp_path / "trace"), device="cpu")
    prof.start()
    for _ in range(2):
        with prof.time("render"):
            grt.render(scene, cam, device="cpu")
    prof.stop()
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    t = prof.timers["render"]
    assert t.count == 2 and 0 < t.min <= t.avg <= t.max
    prof.counters.add_launch(144, 2, 4, 1)
    rep = prof.report(1.0)
    assert "Path segments:     1,440" in rep and "timer render: total=" in rep
    mem = profiler.memory_report("cpu")
    assert "MEMORY REPORT" in mem and "Host peak RSS" in mem
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiler.Profiler()


@pytest.mark.parametrize("flags", [["-interactive", "-interactive-port", "0"],
                                   ["-profile-dir", "PROFILE"], ["-mem-stats"]])
def test_cli_flags(tmp_path, capsys, flags):
    """Each new flag on the CPU; ``-interactive``'s sample slices give the
    one-shot render's bits."""
    flags = [str(tmp_path / "p") if f == "PROFILE" else f for f in flags]
    out = tmp_path / "cli.png"
    img = cli.main(["-scene", "cornell", "-spp", "5", "-width", "16", "-depth", "3",
                    "-device", "cpu", "-out", str(out), *flags])
    assert grt.film.read_png(str(out)).shape == (16, 16, 3)
    printed = capsys.readouterr().out
    assert "RENDER STATS REPORT" in printed
    scene, cam = grt.load_scene("cornell", device="cpu")
    cam = dataclasses.replace(cam, image_width=16, samples_per_pixel=5, max_depth=3)
    assert torch.equal(img, grt.render_image(scene, cam, device="cpu"))
    if "-interactive" in flags:
        assert "Live view: http://127.0.0.1:" in printed
    if "-mem-stats" in flags:
        assert "MEMORY REPORT" in printed
    if "-profile-dir" in flags:
        assert list((tmp_path / "p").glob("*.json"))


def test_microbench_and_perf_probe_run_at_a_tiny_size(capsys):
    microbench.main(["--rays", "256", "--tris", "200", "--device", "cpu"])
    times = perf_probe.main(["--rays", "256", "--device", "cpu"])
    printed = capsys.readouterr().out
    for name in ("vec3/cross", "aabb_slab", "sphere_field", "bvh_build", "mesh_traverse",
                 "quick_cornell", "closest_hit", "area_light NEE", "[R]x3 fma+dot"):
        assert name in printed, name
    assert set(times) >= {"closest_hit", "extract_record", "scatter", "trace depth=5"}
    assert all(t > 0 for t in times.values())


@pytest.mark.parametrize("mode", ["render_grad", "mesh", "train_step"])
def test_inverse_rendering_two_steps(mode):
    losses, final, true = inverse_rendering.run(
        2, 2, 0.05, use_mesh=mode == "mesh", train_step=mode == "train_step",
        device="cpu", width=16, log=lambda *a: None)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not torch.equal(final["color"], true["color"])
    assert float(final["color"].min()) >= 0 and float(final["fuzz"].max()) <= 1
    if mode == "mesh":
        # a one-rank mesh: render_grad's bits
        assert losses == inverse_rendering.run(2, 2, 0.05, device="cpu", width=16,
                                               log=lambda *a: None)[0]


def test_entry_and_the_two_rank_dry_run():
    fn, args = entry.entry(device="cpu")
    rows = fn(*args)
    assert tuple(rows.shape) == (4096, 3) and bool(torch.isfinite(rows).all())
    ranks = entry.dryrun_multichip(2, device="cpu")
    assert ranks[0]["loss"] == ranks[1]["loss"] > 0
    assert ranks[0]["grad_norm"] == ranks[1]["grad_norm"] > 0
    np.testing.assert_array_equal(ranks[0]["fuzz_after_step"], ranks[1]["fuzz_after_step"])


def test_scaling_report_script_prints_json_and_writes_only_out(tmp_path, capsys,
                                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "scaling.json"
    result = scaling_report.main(["--ranks", "2", "--device", "cpu", "--width", "16",
                                  "--spp", "2", "--ici-gbps", "450", "--dcn-gbps", "50",
                                  "--out", str(out)])
    assert json.loads(capsys.readouterr().out) == json.loads(out.read_text())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["scaling.json"]
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "ranks": 2}
    assert [r["devices"] for r in result["strong_scaling"]] == [1, 2]
    assert result["one_rank_mrays"]["forward"] > 0
    ca = result["comm_analysis"]
    assert ca["link_gbps"] == {"ici": 450.0, "dcn": 50.0}
    assert ca["assumed_chip_mrays"]["fwd_bwd"] == result["one_rank_mrays"]["fwd_bwd"]
