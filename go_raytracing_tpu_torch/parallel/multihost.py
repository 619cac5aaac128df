"""Multi-process (multi-GPU, multi-host) start-up and the scaling harness.

The JAX package starts ``jax.distributed`` and builds one global mesh.
Here every GPU has a process of its own: ``initialize`` joins the process
group (NCCL for CUDA devices, gloo for the CPU), ``sharding.make_mesh``
then spans its ranks, and the collectives of ``render_sharded``,
``train_step`` and ``render_grad(mesh=...)`` run over it.  Start the
processes with ``torchrun --nproc-per-node N`` (``initialize()`` reads its
environment) or give each process the rendezvous address, the world size
and its rank.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..camera import Camera
from ..geometry.scene import Scene
from . import sharding

# How long a collective or the rendezvous may wait for a rank before the
# call fails (a rank that died must not hang the others for ever).
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Join the process group of a multi-process run.

    ``coordinator_address`` ('host:port'): rendezvous over ``tcp://`` with
    ``num_processes`` ranks, this one ``process_id``.  Without it the
    environment names them (``env://``: torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``device`` (default
    ``cuda``) picks the backend: ``nccl`` for CUDA, ``gloo`` for the CPU;
    ``backend`` overrides it (gloo on CUDA tensors runs several ranks on
    one card, which NCCL refuses).  On a CUDA device the rank's card
    (``sharding.mesh_device``) becomes the current one.  Returns the
    rank's device."""
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
        rank = int(process_id)
    else:
        init = dict(init_method="env://")
        rank = int(os.environ.get("RANK", "0"))
    dev = sharding.mesh_device(rank, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=timeout, **init)
    return dev


def _timed_render(scene, cam, mesh, seed, spp):
    """Seconds of one ``render_sharded`` on this rank: CUDA events on a
    GPU, the host clock after the call on the CPU."""
    if mesh.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sharding.render_sharded(scene, cam, mesh, seed, spp=spp)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    sharding.render_sharded(scene, cam, mesh, seed, spp=spp)
    return time.perf_counter() - t0


def scaling_report(scene: Scene, cam: Camera, *, spp: int = 8, seed: int = 0,
                   device_counts=None, mode: str = "strong"):
    """Rays/s of ``render_sharded`` at 1, 2, 4, ... ranks and the scaling
    efficiency, the fields of the JAX package's report (``devices``,
    ``spp``, ``wall_s``, ``rays_per_s``, ``efficiency``).  Every rank of
    the process group calls it; a rank outside a count's first ranks waits
    at a barrier.  Without a process group the only count is 1.

    mode="strong": the same total work (W*H*spp rays) over N ranks;
    efficiency = rays/s / (N * the one-rank rays/s).
    mode="weak": the same work a rank (spp grows with N); efficiency =
    t_1 / t_N.

    ``wall_s`` is rank 0's time of one call after a warm-up call at the
    same spp (the call ends in an all-reduce, which no rank leaves before
    the slowest has reached it); every rank returns rank 0's report."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= world]
    results = []
    for n in device_counts:
        mesh = sharding.make_mesh(n, device=scene.device)
        spp_n = spp * n if mode == "weak" else spp
        dt = None
        if mesh.member:
            sharding.render_sharded(scene, cam, mesh, seed, spp=spp_n)
            if grouped:
                dist.barrier(group=mesh.group)
            dt = _timed_render(scene, cam, mesh, seed + 1, spp_n)
        if grouped:
            dist.barrier()
        n_rays = cam.image_width * cam.image_height * spp_n
        results.append(dict(devices=n, spp=spp_n, wall_s=dt,
                            rays_per_s=None if dt is None else n_rays / dt))
    if grouped:
        # every rank reports rank 0's numbers: it is in every count
        shared = [results]
        dist.broadcast_object_list(shared, src=0)
        results = shared[0]
    if mode == "weak":
        base_t = results[0]["wall_s"]
        for r in results:
            r["efficiency"] = base_t / r["wall_s"]
    else:
        base = results[0]["rays_per_s"]
        for r in results:
            r["efficiency"] = r["rays_per_s"] / (base * r["devices"])
    return results


def comm_analysis(scene: Scene, cam: Camera, *, spp: int = 100,
                  n_devices: int = 4, chip_mrays_fwd: float,
                  chip_mrays_fwd_bwd: float, ici_gbps: float, dcn_gbps: float):
    """Communication-volume model of the sharded render and train step.

    Rays are data-parallel with the scene replicated, so a call's only
    collectives are (a) the all-reduce of the framebuffer [W*H, 3] f32 and
    (b) in a training step, the all-reduce of the gradients (the size of
    the parameter tables).  A ring all-reduce moves 2(N-1)/N times the
    payload a device, so the predicted efficiency is compute / (compute +
    comm).  Every rate is the caller's: ``chip_mrays_fwd`` and
    ``chip_mrays_fwd_bwd`` measured on one device (camera Mrays/s of a
    render and of a gradient), ``ici_gbps`` the link between the devices
    of a host (NVLink on a GPU host) and ``dcn_gbps`` the network between
    hosts, in GB/s.  The keys are the JAX package's (``ici``, ``dcn``)."""
    n_pix = cam.image_width * cam.image_height
    fb_bytes = n_pix * 3 * 4
    grad_bytes = sum(x.numel() * 4 for x in sharding.trainable_params(scene).values())
    n_rays = n_pix * spp
    per_dev_fwd_s = n_rays / n_devices / (chip_mrays_fwd * 1e6)
    per_dev_fb_s = n_rays / n_devices / (chip_mrays_fwd_bwd * 1e6)
    ring = 2 * (n_devices - 1) / n_devices

    def eff(compute_s, payload, gbps):
        comm_s = ring * payload / (gbps * 1e9)
        return dict(
            compute_s=round(compute_s, 6),
            comm_s=round(comm_s, 6),
            predicted_efficiency=round(compute_s / (compute_s + comm_s), 6),
        )

    return dict(
        n_devices=n_devices,
        framebuffer_psum_bytes=fb_bytes,
        grad_psum_bytes=grad_bytes,
        assumed_chip_mrays=dict(forward=chip_mrays_fwd, fwd_bwd=chip_mrays_fwd_bwd),
        link_gbps=dict(ici=ici_gbps, dcn=dcn_gbps),
        render_ici=eff(per_dev_fwd_s, fb_bytes, ici_gbps),
        render_dcn=eff(per_dev_fwd_s, fb_bytes, dcn_gbps),
        train_ici=eff(per_dev_fb_s, fb_bytes + grad_bytes, ici_gbps),
        train_dcn=eff(per_dev_fb_s, fb_bytes + grad_bytes, dcn_gbps),
    )
