"""Entry points: a single-device forward step and a
multi-device dry run (the JAX package's ``__graft_entry__.py``).

    fn, args = entry()            # fn(*args) -> [4096, 3] radiance rows
    dryrun_multichip(2)           # train_step, render_sharded and
                                  # render_grad(mesh=...) on 2 ranks

Both run on the GPU unless ``device="cpu"``; ``dryrun_multichip`` starts
one process a rank (``parallel/launch.run_ranks``: NCCL on GPUs, a GPU a
rank; gloo on the CPU).
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel import launch, sharding
from .device import resolve_device


def _flagship(device):
    """Cornell box (NEE, MIS, volumes) at small launch shapes."""
    from ..scenes.builders import cornell_box_scene

    scene, cam = cornell_box_scene(device=device)
    return scene, dataclasses.replace(cam, image_width=64, samples_per_pixel=4,
                                      max_depth=5)


def entry(device=None):
    """(fn, example_args): one forward step of 4,096 camera rays of the
    flagship scene, ``fn(scene, ray_start, seed)`` -> [4096, 3] rows."""
    from ..camera import generate_rays
    from ..integrator import wavefront

    dev = resolve_device(device)
    scene, cam = _flagship(dev)
    w, h = cam.image_width, cam.image_height
    n = 4096
    spp = cam.samples_per_pixel

    def fn(scene_in, ray_start, seed):
        ids = torch.clamp_max(ray_start + torch.arange(n, dtype=torch.int64, device=dev),
                              w * h * spp - 1)
        pixel = ids % (w * h)
        stream = pixel * spp + ids // (w * h)
        o, d, tm = generate_rays(cam, pixel % w, pixel // w, stream, seed)
        return wavefront.trace(scene_in, cam, o, d, tm, stream, seed).rows()

    return fn, (scene, 0, 0)


def _dryrun_rank(rank: int, world: int, device) -> dict:
    """One rank of ``dryrun_multichip``."""
    from ..ops import cuda_wavefront as mega
    from ..render.grad import render_grad

    dev = sharding.mesh_device(rank, device)
    scene, cam = _flagship(dev)
    cam = dataclasses.replace(cam, image_width=16, samples_per_pixel=2, max_depth=3)
    mesh = sharding.make_mesh(device=dev)
    target = torch.zeros((cam.image_height, cam.image_width, 3), device=dev)
    new_scene, loss = sharding.train_step(scene, cam, mesh, target, 0, 1e-3,
                                          spp=cam.samples_per_pixel)
    fb = sharding.render_sharded(scene, cam, mesh, 0, spp=cam.samples_per_pixel)
    if not mega.grad_applicable(scene, cam.max_depth):
        raise RuntimeError("the flagship scene must ride the gradient kernels")
    loss_g, grads = render_grad(scene, cam, target, spp=cam.samples_per_pixel, seed=0,
                                mesh=mesh)
    gnorm = float(sum(g.abs().sum() for g in grads.values()))
    if not (torch.isfinite(loss) and torch.isfinite(loss_g) and 0 < gnorm < float("inf")):
        raise RuntimeError(f"bad dry run: loss {float(loss)}, grad loss {float(loss_g)}, "
                           f"|g| {gnorm}")
    return dict(loss=float(loss), fb_mean=float(fb.mean()), grad_loss=float(loss_g),
                grad_norm=gnorm,
                fuzz_after_step=new_scene.materials.fuzz.cpu().numpy())


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0) -> list:
    """One ``train_step``, one ``render_sharded`` and one
    ``render_grad(mesh=...)`` of the flagship scene on ``n_devices`` ranks;
    returns each rank's summary (the same numbers on every rank)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip: need {n_devices} GPUs, have "
                           f"{torch.cuda.device_count()}")
    out = launch.run_ranks(_dryrun_rank, n_devices, (device,), device=device,
                           timeout=timeout)
    r = out[0]
    print(f"dryrun_multichip({n_devices}) OK: loss={r['loss']:.6f}, "
          f"fb mean={r['fb_mean']:.4f}, sharded grad loss={r['grad_loss']:.6f} "
          f"|g|={r['grad_norm']:.3e}")
    return out
