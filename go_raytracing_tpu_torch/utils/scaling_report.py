"""Scaling report of the sharded render, the JAX package's
``scripts/scaling_report.py`` for the port.

    torchrun --nproc-per-node 4 -m go_raytracing_tpu_torch.utils.scaling_report \\
        --ici-gbps G --dcn-gbps G [--scene cornell] [--width 200] [--spp 8] [--out F]
    python -m go_raytracing_tpu_torch.utils.scaling_report --ranks 2 --device cpu \\
        --ici-gbps G --dcn-gbps G

Under torchrun every process is a rank; otherwise the script spawns
``--ranks`` local ranks (``parallel/launch.run_ranks``).  It measures the
strong and weak scaling of ``render_sharded`` over 1, 2, 4, ... ranks
(``multihost.scaling_report``), the one-rank rate of a render and of a
``render_grad``, and gives those measured rates, with the link bandwidths
the caller names (GB/s: ``--ici-gbps`` between the devices of a host,
``--dcn-gbps`` between hosts), to ``multihost.comm_analysis``.  It prints
one JSON object, which names the device, and writes it to ``--out`` only
when that is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from ..parallel import launch, multihost, sharding


def _one_rank_rates(scene, cam, spp, seed) -> tuple:
    """Camera Mrays/s of a render and of a ``render_grad`` on rank 0 alone
    (each after a warm-up call); every rank takes part in the one-rank
    mesh's making and receives rank 0's rates."""
    from ..render.grad import render_grad

    mesh = sharding.make_mesh(1, device=scene.device)
    rates = None
    if mesh.member:
        target = torch.zeros((cam.image_height, cam.image_width, 3), device=scene.device)

        def timed(fn):
            fn()
            if scene.device.type == "cuda":
                torch.cuda.synchronize(scene.device)
            t0 = time.perf_counter()
            fn()
            if scene.device.type == "cuda":
                torch.cuda.synchronize(scene.device)
            return time.perf_counter() - t0

        n = cam.image_width * cam.image_height * spp
        fwd = timed(lambda: sharding.render_sharded(scene, cam, mesh, seed, spp=spp))
        bwd = timed(lambda: render_grad(scene, cam, target, spp=spp, seed=seed, mesh=mesh))
        rates = (n / fwd / 1e6, n / bwd / 1e6)
    if dist.is_initialized():
        shared = [rates]
        dist.broadcast_object_list(shared, src=0)
        rates = shared[0]
    return rates


def report(rank: int, world: int, opts: dict) -> dict:
    """The report on one rank (the same on every rank)."""
    from ..scenes.builders import load_scene

    dev = sharding.mesh_device(rank, opts["device"])
    scene, cam = load_scene(opts["scene"], device=dev)
    cam = dataclasses.replace(cam, image_width=opts["width"],
                              samples_per_pixel=opts["spp"], max_depth=5)
    strong = multihost.scaling_report(scene, cam, spp=opts["spp"], mode="strong")
    weak = multihost.scaling_report(scene, cam, spp=opts["spp"], mode="weak")
    fwd, fwd_bwd = _one_rank_rates(scene, cam, opts["spp"], 0)
    return dict(
        device=dict(platform="gpu" if dev.type == "cuda" else "cpu",
                    kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                    ranks=world),
        scene=opts["scene"], width=opts["width"], spp=opts["spp"],
        strong_scaling=strong, weak_scaling=weak,
        one_rank_mrays=dict(forward=fwd, fwd_bwd=fwd_bwd),
        comm_analysis=multihost.comm_analysis(
            scene, cam, n_devices=4, chip_mrays_fwd=fwd, chip_mrays_fwd_bwd=fwd_bwd,
            ici_gbps=opts["ici_gbps"], dcn_gbps=opts["dcn_gbps"]),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--width", type=int, default=200)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=2,
                    help="local ranks to spawn when not started by torchrun")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    ap.add_argument("--ici-gbps", type=float, required=True,
                    help="GB/s of the link between the devices of a host")
    ap.add_argument("--dcn-gbps", type=float, required=True,
                    help="GB/s of the network between hosts")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    opts = dict(vars(args))
    if "WORLD_SIZE" in os.environ:
        multihost.initialize(device=args.device)
        try:
            result = report(dist.get_rank(), dist.get_world_size(), opts)
        finally:
            dist.destroy_process_group()
        if int(os.environ.get("RANK", "0")) != 0:
            return result
    else:
        result = launch.run_ranks(report, args.ranks, (opts,),
                                  device=args.device or "cuda")[0]
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
