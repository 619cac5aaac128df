"""Start the ranks of a sharded run on one machine, and the calls they make.

``run_ranks`` spawns one process a rank (``torch.multiprocessing``'s
``spawn`` context: a forked child cannot use CUDA), joins them into a
process group over ``tcp://127.0.0.1`` on a free port
(``multihost.initialize``), runs a function of this package on every rank
and returns each rank's result.  Every wait has a limit: the process
group's collectives time out, and the parent kills every rank still
running at its deadline.  A rank that fails fails the call.

``run_cases`` is the rank function of the checks of the sharded paths
(the CPU and GPU tests, ``chip_smoke.py``): it makes each call a case
names on every rank and hands back numpy arrays, with the kernel launches
the call counted on that rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import multihost, sharding


def free_port() -> int:
    """A TCP port of 127.0.0.1 that was free a moment ago (bound to 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, backend, timeout_s, args, results):
    try:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, device=device,
                             backend=backend,
                             timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn, world: int, args=(), *, device="cpu", backend=None,
              timeout: float = 300.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one process
    group; returns the ranks' results in rank order.  ``fn`` and ``args``
    are pickled (``fn`` by its import path); what ``fn`` returns must be
    picklable too.  ``device`` and ``backend`` go to
    ``multihost.initialize``.  Raises if a rank fails or the ranks have not
    all finished within ``timeout`` seconds; no rank outlives the call."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, device, backend, timeout, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got = {}
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} did not "
                                   f"finish within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if gone:
                    raise RuntimeError(f"ranks {gone} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in gone]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [got[r] for r in range(world)]


# ---- the calls of the checks ------------------------------------------------------

def launch_counts() -> dict:
    """Every hand-written kernel's launch count (the wrappers' counters)."""
    from ..ops import cuda_intersect, cuda_mesh, cuda_rows, cuda_wavefront

    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": v
            for m in (cuda_wavefront, cuda_intersect, cuda_mesh, cuda_rows)
            for k, v in vars(m).items() if k.startswith("LAUNCHES")}


def _scene_and_camera(spec, cam, device):
    """A case's scene and camera.  ``spec`` is a ``Scene`` sent by the
    parent (CPU tensors), or (builder, keyword arguments): the rank builds
    ``builder(device=device, **kwargs)`` -> (scene, camera), as
    ``scenes.builders.load_scene`` does.  ``cam`` is the camera, or a dict
    of fields to change on the camera the scene function returns."""
    from ..geometry.scene import Scene

    if isinstance(spec, Scene):
        return spec, cam
    builder, kwargs = spec
    scene, built_cam = builder(device=device, **kwargs)
    if isinstance(cam, dict):
        return scene, dataclasses.replace(built_cam, **cam)
    return scene, built_cam if cam is None else cam


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    return x


def _case(op, mesh, scene, cam, kw):
    if op == "render_sharded":
        return sharding.render_sharded(scene, cam, mesh, kw.get("seed", 0), spp=kw["spp"])
    if op == "render_grad":
        from ..render.grad import render_grad

        return render_grad(scene, cam, kw["target"], mesh=mesh,
                           **{k: v for k, v in kw.items() if k != "target"})
    if op == "train_step":
        losses, params = [], []
        for step in range(kw.get("steps", 1)):
            scene, loss = sharding.train_step(scene, cam, mesh, kw["target"],
                                              kw.get("seed", 0), kw["lr"], spp=kw["spp"])
            losses.append(loss)
            params.append(sharding.trainable_params(scene))
        return losses, params
    if op == "scaling_report":
        return multihost.scaling_report(scene, cam, **kw)
    raise ValueError(f"unknown case {op!r}")


def run_cases(rank: int, world: int, cases, device=None) -> list:
    """Rank function of the checks: for each case (op, scene spec, camera,
    keyword arguments, repeats) make the call ``repeats`` times on the mesh
    of all ranks and return, for each, its outputs as numpy arrays, its
    seconds on the host clock (after a device synchronisation) and the
    kernel launches it counted on this rank.  The scene spec and camera
    are those of ``_scene_and_camera``.  ``op`` is 'render_sharded',
    'render_grad', 'train_step' (``steps`` steps) or 'scaling_report';
    'make_mesh' takes its argument as the case's keyword ``n`` and returns
    the error it raised, or None."""
    dev = sharding.mesh_device(rank, device)
    mesh = sharding.make_mesh(device=dev)
    out = []
    for op, spec, cam, kw, repeats in cases:
        if op == "make_mesh":
            try:
                sharding.make_mesh(kw["n"], device=kw.get("device", dev))
                out.append(None)
            except (RuntimeError, ValueError) as e:
                out.append(f"{type(e).__name__}: {e}")
            continue
        scene, cam = _scene_and_camera(spec, cam, dev)
        runs = []
        for _ in range(repeats):
            before = launch_counts()
            t0 = time.perf_counter()
            res = _case(op, mesh, scene, cam, kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            after = launch_counts()
            runs.append(dict(out=_numpy(res), seconds=seconds,
                             launches={k: after[k] - before[k] for k in after
                                       if after[k] != before[k]}))
        out.append(runs)
    return out

