"""Inverse rendering: recover material parameters from a target image.

The JAX package's ``examples/inverse_rendering.py`` in PyTorch.  Renders a
target scene, perturbs its albedo / emission / fuzz tables, then fits them
back by projected Adam through ``render_grad`` (the chunked gradient
kernels; ``--mesh`` shards every chunk over the mesh's ranks), or by the
SGD step of ``sharding.train_step`` (``--train-step``: autograd through
the standard integrator).

Run:  python -m go_raytracing_tpu_torch.utils.inverse_rendering
          [--steps 60] [--spp 16] [--lr 0.05] [--mesh] [--train-step]
          [--device cpu]
Under ``torchrun --nproc-per-node N`` the mesh spans the N ranks (call
``multihost.initialize`` first: ``main`` does so when torchrun's
``WORLD_SIZE`` is set); alone it is one rank.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed

from ..camera import Camera
from ..geometry.scene import Scene, SceneBuilder
from ..parallel import multihost, sharding
from ..render.grad import render_grad
from .device import resolve_device

CAMERA = dict(image_width=48, aspect_ratio=1.0, max_depth=4, look_from=(0, 3, 7),
              look_at=(0, 0.5, 0), background=(0, 0, 0), vfov=45.0)


def build_scene(device) -> Scene:
    """A floor, a diffuse and a metal sphere under a quad light."""
    b = SceneBuilder()
    b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), b.lambertian((0.7, 0.5, 0.3)))
    b.sphere((0, 1, 0), 1.0, b.lambertian((0.2, 0.4, 0.8)))
    b.sphere((2.2, 0.7, 1), 0.7, b.metal((0.9, 0.8, 0.6), 0.15))
    b.add_light(b.quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3), b.diffuse_light((8, 8, 8))))
    return b.build(device=device)


def projector(scene: Scene):
    """Projection onto the physically valid set: albedos in [0, 1] (past 1
    multi-bounce energy grows and the loss diverges within a few steps at
    this lr), emission rows only non-negative, fuzz in [0, 1], IOR in
    [1, 2.5]."""
    emissive = torch.zeros(scene.textures.color.shape[0], dtype=torch.bool,
                           device=scene.device)
    emissive[scene.materials.tex[scene.materials.kind == 3].long()] = True
    em = emissive[:, None]

    def project(p: dict) -> dict:
        p = dict(p)
        p["color"] = torch.where(em, torch.clamp_min(p["color"], 0.0),
                                 torch.clamp(p["color"], 0.0, 1.0))
        for k in ("even_color", "odd_color", "fuzz"):
            p[k] = torch.clamp(p[k], 0.0, 1.0)
        p["ior"] = torch.clamp(p["ior"], 1.0, 2.5)
        return p

    return project


def run(steps: int = 60, spp: int = 16, lr: float = 0.05, *, use_mesh: bool = False,
        train_step: bool = False, device=None, width: int = 48, log=print):
    """Fit the perturbed scene to the target for ``steps`` steps; returns
    (losses, recovered parameters, true parameters)."""
    dev = resolve_device(device)
    cam = Camera(**dict(CAMERA, image_width=width), samples_per_pixel=spp)
    scene = build_scene(dev)
    mesh = sharding.make_mesh(device=dev)
    log(f"ranks: {mesh.size} ({dev})")
    target = sharding.render_sharded(scene, cam, mesh, 0, spp=spp) / spp
    log(f"target rendered: mean {float(target.mean()):.4f}")

    project = projector(scene)
    p0 = sharding.trainable_params(scene)
    rng = np.random.default_rng(0)
    perturbed = dict(p0)
    perturbed["color"] = torch.clamp(
        p0["color"] * torch.as_tensor(rng.uniform(0.4, 1.6, tuple(p0["color"].shape)),
                                      dtype=torch.float32, device=dev), 0.05, 15.0)
    perturbed["fuzz"] = torch.clamp(p0["fuzz"] + 0.2, 0.0, 1.0)
    scene_hat = sharding.apply_params(scene, project(perturbed))

    # Adam: the parameter families span orders of magnitude (albedo ~0.5,
    # emission ~8), so plain SGD crawls or overshoots at one lr
    adam_m = {k: torch.zeros_like(v) for k, v in p0.items()}
    adam_v = {k: torch.zeros_like(v) for k, v in p0.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for step in range(steps):
        if train_step:
            scene_hat, loss = sharding.train_step(scene_hat, cam, mesh, target, step + 1,
                                                  lr, spp=spp)
            scene_hat = sharding.apply_params(
                scene_hat, project(sharding.trainable_params(scene_hat)))
        else:
            loss, grads = render_grad(scene_hat, cam, target, spp=spp, seed=step + 1,
                                      mesh=mesh if use_mesh else None, device=dev)
            params = sharding.trainable_params(scene_hat)
            t = step + 1
            new = {}
            for k, p in params.items():
                adam_m[k] = b1 * adam_m[k] + (1 - b1) * grads[k]
                adam_v[k] = b2 * adam_v[k] + (1 - b2) * grads[k] * grads[k]
                mh = adam_m[k] / (1 - b1 ** t)
                vh = adam_v[k] / (1 - b2 ** t)
                new[k] = p - lr * mh / (torch.sqrt(vh) + eps)
            scene_hat = sharding.apply_params(scene_hat, project(new))
        losses.append(float(loss))
        if step % 10 == 0 or step == steps - 1:
            now = sharding.trainable_params(scene_hat)
            err = {k: float((now[k] - p0[k]).abs().mean()) for k in ("color", "fuzz")}
            log(f"step {step:3d}  loss {float(loss):.6f}  "
                f"albedo err {err['color']:.4f}  fuzz err {err['fuzz']:.4f}")
    return losses, sharding.trainable_params(scene_hat), p0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--mesh", action="store_true",
                    help="shard every gradient chunk over the mesh's ranks")
    ap.add_argument("--train-step", action="store_true",
                    help="sharding.train_step's SGD instead of render_grad + Adam")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    grouped = "WORLD_SIZE" in os.environ
    if grouped:
        multihost.initialize(device=args.device)
    try:
        _, final, p0 = run(args.steps, args.spp, args.lr, use_mesh=args.mesh,
                           train_step=args.train_step, device=args.device)
    finally:
        if grouped:
            torch.distributed.destroy_process_group()
    print("\nrecovered vs true albedo rows:")
    print(final["color"].cpu().numpy())
    print(p0["color"].cpu().numpy())


if __name__ == "__main__":
    main()
