"""The readings the limits of a cell's comparison are set from, in one
process on the chip:

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --control 3 --faults 3 \
        [--first-seed N] [--out FILE]

For each of ``--seeds`` run seeds (``--first-seed``, +1, ...) it makes the
cell's first call of the window as a run would (after the warm-up, at the
cell's own size) and compares it with the plain reference: the program's
readings, whose largest is the lower reading of each number.  On the first
``--control`` seeds it also compares the control (the reference with what a
ray carries from bounce to bounce held in bfloat16) with the reference: the
smallest of those is the upper reading.  On the first ``--faults`` seeds it
plants three faults in the program's answer and reads them too: a stale
answer (the call before's), half of the samples left out with the mean
taken over the rest, and an answer altered where it is produced (every
value times 1.01).  Each reading is printed as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from . import inputs, program, run
    from .reference import jobs, scene as ref_scene

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    config, params = cell["config_data"], cell["traffic_data"]
    from go_raytracing_tpu_torch.ops import _build
    _build.load_all((lib, False) for lib in cell["libraries"])
    driver = importlib.import_module(f"portbench.traffic.{params['driver']}")
    sky = inputs.environment(config)
    scene, cam = program.build(config, sky, "cuda")
    ref = ref_scene.build(config, sky, "cuda")
    out = open(args.out, "a") if args.out else None

    def emit(**kw):
        line = json.dumps(dict(workload=args.workload, **kw))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def scaled(answer, f):
        if isinstance(answer, tuple):
            loss, grads = answer
            return loss * f, {k: v * f for k, v in grads.items()}
        return answer * f

    half_cam = dataclasses.replace(cam, samples_per_pixel=cam.samples_per_pixel // 2)
    for i in range(args.seeds):
        seed = args.first_seed + i
        job = driver.Job(params, program, scene, cam, seed, "cuda")
        job.setup()
        for k in range(int(params["warmup_calls"])):
            job.call(len(job.seeds) - 1 - k)
        t0 = time.perf_counter()
        got = job.call(0)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = job.reference(jobs, ref, 0)
        ref_s = time.perf_counter() - t0
        emit(seed=seed, what="program", **driver.compare(job.kind, got, want),
             call_s=call_s, reference_s=ref_s)
        if i < args.control:
            ctl = job.reference(jobs, ref, 0, hold=jobs.control)
            emit(seed=seed, what="control", **driver.compare(job.kind, ctl, want))
        if i < args.faults:
            emit(seed=seed, what="fault_stale", **driver.compare(job.kind, job.call(1), want))
            job.cam = half_cam
            emit(seed=seed, what="fault_half", **driver.compare(job.kind, job.call(0), want))
            job.cam = cam
            emit(seed=seed, what="fault_altered",
                 **driver.compare(job.kind, scaled(got, 1.01), want))
        del job, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
