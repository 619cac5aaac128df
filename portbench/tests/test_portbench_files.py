"""The benchmark's files: every cell, configuration, traffic mix and metric
is found by name and agrees with ``BENCHMARK.json``; the byte counts of the
roofline metrics on small shapes; the modules the harness and the
reference load."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import roofline, run
from portbench.reference import scene as ref_scene

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_agree_with_the_manifest(name):
    cell = run.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    assert cell["config_data"]["name"] == cell["config"]
    # the end-to-end metrics the cell reports, and its per-layer ones, are
    # those the manifest gives it
    want_e2e = {m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", CELLS)}
    want_pl = {m["name"] for m in BENCH["per_layer"] if name in m.get("workloads", CELLS)}
    assert set(cell["end_to_end"]) == want_e2e
    assert set(cell["per_layer"]) == want_pl
    assert "setup_s" in cell["end_to_end"] and len(cell["end_to_end"]) >= 2
    for m in cell["per_layer"]:
        assert METRICS[m]["moves"] in cell["end_to_end"]
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_readers_are_found_with_their_unit_and_source(name):
    mod = run.metric_module(name)
    assert mod.UNIT == METRICS[name]["unit"]
    assert mod.SOURCE == METRICS[name]["source"]
    for target in getattr(mod, "RANGES", {}).values():
        module, fn = target.split(":")
        assert module.startswith("go_raytracing_tpu_torch.") and fn


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_parse_and_build_on_the_host(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    for key in entry["reduced"]:
        assert key in config and key in config["reduced_from"]
    ref = ref_scene.build(config, None, "cpu")
    assert ref.tables.n_planar + ref.tables.n_sphere > 0
    assert ref.tier in ("product", "pathwise", "fused")


def test_manifest_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_byte_bounds_on_small_shapes():
    cornell = run.load_json("configs", "cornell")
    # 18 quads x 31 rows, 1 volume x 25, 1 light x 17, float32
    assert roofline.table_bytes(cornell, None) == 4 * (18 * 31 + 25 + 17)
    # B1: 11 rows a ray (8 in, radiance 3 out; no miss records), the tables
    # once a launch
    assert roofline.megakernel_bytes(cornell, None, 1000, 2) == 1000 * 44 + 2 * 4 * 600
    # B2 + B3: rays 8, cotangent 3, radiance 3; 5 textures x 9 + 5 materials x 2 out
    assert roofline.grad_kernels_bytes(cornell, None, 1000, 1) == 1000 * 56 + 4 * 600 + 4 * 55
    hdri = run.load_json("configs", "hdri-test")
    sky = np.ones((4, 8, 3), np.float32)
    tables = 4 * (31 + 5 * 23)    # the plane and 5 spheres; no light
    texels = 4 * 3 * 32
    assert roofline.table_bytes(hdri, sky) == tables
    # no NEE rows without a quad light: the texels once a launch
    assert roofline.megakernel_bytes(hdri, sky, 10, 1) == 10 * 44 + tables + texels
    # 4 textures x 9 + 4 materials x 2 out, the texels in and their gradient out
    assert roofline.grad_kernels_bytes(hdri, sky, 10, 1) == (
        10 * 56 + tables + texels + 4 * (9 * 4 + 2 * 4) + texels)
    # a quad light beside the environment: + 7 sample rows a bounce at depth 10
    lit = dict(hdri, scene=hdri["scene"] + [
        {"op": "diffuse_light", "name": "key", "color": [9, 9, 9]},
        {"op": "quad", "q": [-1.5, 6, -1.5], "u": [3, 0, 0], "v": [0, 0, 3],
         "material": "key", "light": True}])
    lit_tables = 4 * (2 * 31 + 5 * 23 + 17)
    assert roofline.megakernel_bytes(lit, sky, 10, 1) == 10 * 4 * (11 + 70) + lit_tables + texels
    assert roofline.share_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.share_pct(1.0, 0.0) is None


def _loaded_modules(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(out.stdout.split())


def test_the_harness_loads_no_jax_and_the_reference_nothing_of_the_port():
    harness = _loaded_modules(
        "import portbench.run, portbench.program, portbench.spans, portbench.calibrate\n"
        "import portbench.traffic.closed_loop\n"
        "from portbench import run\n"
        "[run.metric_module(m) for m in " + repr(sorted(METRICS)) + "]")
    assert not harness & {"jax", "jaxlib", "flax", "go_raytracing_tpu"}
    reference = _loaded_modules("import portbench.reference.jobs, portbench.inputs")
    assert not reference & {"jax", "jaxlib", "flax", "go_raytracing_tpu",
                            "go_raytracing_tpu_torch"}


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "go_raytracing_tpu_torch" in out.stderr
