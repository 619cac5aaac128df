"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Everything a cell needs is found by name:
``workloads/<cell>.json`` (its configuration, traffic, chips, metrics and
the limits of its comparison), ``configs/<config>.json`` (the scene, the
camera and the job's size), ``traffic/<traffic>.json`` (the call and its
parameters, read by the driver ``traffic/<driver>.py``), and
``metrics/<metric>.py`` for each metric (or, for ``<base>.<suffix>``,
``metrics/<base>.py``).

A run: refuse without enough CUDA devices; load the program's kernels
(``go_raytracing_tpu_torch/_build/``, built by nvcc on a checkout's first
run); build the scene and its inputs from the seed; warm up on the cell's
own calls; measure for ``--seconds`` (with ``--trace 1`` under
``torch.profiler``, the program's layer entry functions wrapped in
ranges); read the peak of device memory; free the program's state; compare
answers of the window with the plain reference (``reference/``); print the
numbers compared beside their limits on standard error, and the result as
the last line of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "go_raytracing_tpu"}


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_cell(name: str) -> dict:
    """A cell's file with its configuration and traffic resolved."""
    cell = load_json("workloads", name)
    cell["config_data"] = load_json("configs", cell["config"])
    cell["traffic_data"] = load_json("traffic", cell["traffic"])
    return cell


def metric_module(name: str):
    """``metrics/<name>.py``, else ``metrics/<part before the first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"portbench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for the metric {name!r} under {HERE / 'metrics'}")


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc builds live in its package's ``_build/``)."""
    base = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the timed path launches from one host
    # thread, and idle intra-op threads only contend with it
    os.environ["OMP_NUM_THREADS"] = "1"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             log=print):
    """Run the cell once on ``device``.  Returns the result line's dict."""
    import torch

    from . import inputs, program
    from .reference import jobs as ref_jobs
    from .reference import scene as ref_scene

    cuda = device == "cuda"
    config = cell["config_data"]
    params = cell["traffic_data"]
    stages = {"imports": time.perf_counter() - T_START}

    def stage(name):
        if cuda:
            torch.cuda.synchronize()
        stages[name] = time.perf_counter() - T_START - sum(stages.values())

    if cuda:
        torch.zeros(1, device=device)
        stage("cuda")
        from go_raytracing_tpu_torch.ops import _build
        _build.load_all((lib, False) for lib in cell["libraries"])
        stage("kernels")
    sky = inputs.environment(config)
    scene, cam = program.build(config, sky, device)
    stage("scene")
    driver = importlib.import_module(f"portbench.traffic.{params['driver']}")
    job = driver.Job(params, program, scene, cam, seed, device)
    job.setup()
    stage("job")
    for k in range(int(params["warmup_calls"])):
        job.call(len(job.seeds) - 1 - k)   # seeds the window does not use
    stage("warmup")
    modules = {m: metric_module(m) for m in cell["end_to_end"] + cell["per_layer"]}
    events = None
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    if trace:
        from . import spans
        ranges = {}
        for name in cell["per_layer"]:
            ranges.update(getattr(modules[name], "RANGES", {}))
        events = spans.CallEvents() if cuda else None
        restore = spans.install(ranges, events)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(spans.WINDOW):
                calls, kept, window_s = job.window(seconds, inputs.sampler(seed))
                if cuda:
                    torch.cuda.synchronize()
        restore()
    else:
        calls, kept, window_s = job.window(seconds, inputs.sampler(seed))

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ms = sorted((b - a) * 1e3 for a, b in calls)
    half = len(calls) // 2
    log(f"{len(calls)} calls in {window_s:.3f} s: ms min {ms[0]:.2f} median {ms[len(ms) // 2]:.2f} "
        f"max {ms[-1]:.2f}; first half {calls[half][0]:.3f} s, second {window_s - calls[half][0]:.3f} s")
    run = Run(spans=calls, window_s=window_s, setup_s=setup_s, config=config, sky=sky,
              rays_per_call=job.rays_per_call(), trace=None)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from . import spans
        t0 = time.perf_counter()
        run.trace = spans.Trace(prof)
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        breakdown = run.trace.breakdown()
        log(f"trace read in {time.perf_counter() - t0:.1f} s; {len(run.trace.ops)} device ops, "
            f"{run.trace.by_op} found by their torch op, not their runtime call, "
            f"{run.trace.unlinked} without a launch; device s by range (busy in the trace"
            " / span in the trace / CUDA events around the calls): "
            + ", ".join(f"{r} {run.trace.device_s(in_range=r):.4f} / {run.trace.span_s[r]:.4f}"
                        f" / {s:.4f}" for r, s in (events.seconds() if events else {}).items()))
        del prof
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for name in wanted:
        value = modules[name].read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": modules[name].UNIT}

    # ---- the comparison, after the window, with the program's state freed
    picks = sorted(kept)
    del scene
    job.scene = None
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = ref_scene.build(config, sky, device)
    numbers = driver.worst([driver.compare(job.kind, kept[k], job.reference(ref_jobs, ref, k))
                            for k in picks])
    log(f"reference: {len(picks)} answers (calls {picks}) in {time.perf_counter() - t0:.1f} s")
    checks = {k: {"value": v, "limit": cell["limits"][k]} for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": correct, "attempted": len(calls), "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    cell = load_cell(args.workload)

    import torch

    import go_raytracing_tpu_torch  # noqa: F401  (the system under test, or no run)

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", log)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
