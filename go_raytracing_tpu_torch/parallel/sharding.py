"""Multi-device rendering and differentiable training over ``torch.distributed``.

The JAX package shards the sample-major ray stream over a 1-D device mesh
``'rays'`` with ``shard_map`` under one controller and sums the partial
framebuffers and gradients with ``psum``.  Here the same data parallelism
runs as one process per device (SPMD): every rank traces one contiguous
window of the global ray ids against its own copy of the scene, and one
``all_reduce`` sums the partial framebuffers (NCCL on GPUs, gloo on the
CPU).  The RNG streams are keyed on the global ray ids, so a sharded
result is the single-device one up to the order of the sums, and at world
size 1 it is the same bits.

A rank's window is whole samples: samples ``[n * r // W, n * (r + 1) // W)``
of ``n`` for rank ``r`` of ``W`` (``sample_window``).  Where ``n < W``
some ranks take none and trace nothing: spp 1 on 4 ranks leaves the one
sample to rank 3; spp 3 on 2 ranks gives rank 0 one sample and rank 1 two.
A rank with nothing to trace still joins every collective.

``trainable_params`` names what ``render/grad.render_grad`` returns
gradients for; ``apply_params`` puts a changed set back into a scene.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..camera import Camera
from ..geometry.scene import Scene
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The ranks a sharded call spreads its rays over.

    ``group`` is the process group of the first ``size`` ranks, or None for
    a one-rank mesh without a process group (no collective runs).
    ``rank`` is this process's rank, ``device`` the device it renders on;
    ``member`` is false on a rank outside the first ``size``: such a rank
    takes no part in the mesh's calls."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    member: bool = True

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh, in place; returns it."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_dict(self, tensors: dict) -> dict:
        """Sum a dict of float32 tensors over the mesh in one collective:
        flattened into one buffer in sorted key order."""
        if self.group is None:
            return tensors
        keys = sorted(tensors)
        flat = self.all_reduce(torch.cat([tensors[k].reshape(-1) for k in keys]))
        out, pos = {}, 0
        for k in keys:
            n = tensors[k].numel()
            out[k] = flat[pos:pos + n].view_as(tensors[k])
            pos += n
        return {k: out[k] for k in tensors}

    def check_member(self):
        if not self.member:
            raise ValueError(f"rank {self.rank} is not a member of this "
                             f"{self.size}-rank mesh")


def _local_device_index(rank: int) -> int:
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    return rank % max(torch.cuda.device_count(), 1)


def mesh_device(rank: int, device=None) -> torch.device:
    """The device rank ``rank`` renders on: ``cuda:{LOCAL_RANK}`` (or rank
    modulo the device count) unless ``device`` names another; a CUDA device
    on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_device_index(rank))
    resolve_device(dev)
    return dev


def make_mesh(n_devices: Optional[int] = None, *, device=None) -> RayMesh:
    """The mesh of the first ``n_devices`` ranks of the process group
    (all of them by default).  Every rank calls it with the same
    ``n_devices`` (``dist.new_group`` requires it); a rank outside the
    first ``n_devices`` gets a mesh whose ``member`` is false.  Without an
    initialised process group it is a one-rank mesh that runs no
    collective.  Asking for more ranks than exist raises."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"need {n_devices} ranks, have 1: no process group is initialised "
                "(start the processes with torchrun or multihost.initialize)")
        return RayMesh(None, 0, 1, mesh_device(0, device))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise RuntimeError(f"need {n} ranks, have {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    member = rank < n
    return RayMesh(group if member else None, rank, n, mesh_device(rank, device),
                   member)


def sample_window(n_samples: int, size: int, rank: int) -> tuple:
    """Rank ``rank``'s share ``[lo, hi)`` of ``n_samples`` whole samples
    over ``size`` ranks (empty where ``n_samples < size`` leaves it none)."""
    return n_samples * rank // size, n_samples * (rank + 1) // size


def _window_buffer(scene: Scene, cam: Camera, mesh: RayMesh, seed: int, spp: int,
                   differentiable: bool):
    """This rank's partial accumulation buffer [H, W, 3]: its window of
    samples through the single-device renderer."""
    from ..render import renderer

    lo, hi = sample_window(spp, mesh.size, mesh.rank)
    if hi == lo:
        return torch.zeros((cam.image_height, cam.image_width, 3),
                           dtype=torch.float32, device=mesh.device)
    return renderer.render(scene, cam, spp=hi - lo, sample_offset=lo, seed=seed,
                           differentiable=differentiable, device=mesh.device)


def render_sharded(scene: Scene, cam: Camera, mesh: RayMesh, seed: int, *,
                   spp: int) -> torch.Tensor:
    """Render with the rays data-parallel over the mesh; returns on every
    rank the summed accumulation buffer [H, W, 3] (divide by spp for the
    picture).  Each rank renders its window of samples (``sample_window``)
    with ``renderer.render`` (``sample_offset``), then one ``all_reduce``
    sums the buffers.  At world size 1 the result is ``render``'s bits."""
    mesh.check_member()
    with torch.no_grad():
        fb = _window_buffer(scene, cam, mesh, seed, spp, False)
        return mesh.all_reduce(fb.contiguous())


def train_step(scene: Scene, cam: Camera, mesh: RayMesh, target, seed: int,
               lr: float, *, spp: int):
    """One SGD step of inverse rendering on the pixel MSE
    ``mean((fb / spp - target)^2)``, with the rays sharded over the mesh.
    Returns ``(new_scene, loss)``, the same on every rank.

    Each rank renders its window through ``render(differentiable=True)``
    (the standard integrator under autograd) and all-reduces a detached
    copy of its buffer.  The loss is quadratic in the framebuffer, so the
    cotangent of every rank's partial buffer is ``2 / (n * spp) * resid``
    (``n`` = H * W * 3): each rank takes the gradient of its own buffer
    with it, which is the exact gradient with no differentiable collective.
    One ``all_reduce`` sums the gradients (flattened, sorted by key), and
    every rank applies the same update."""
    mesh.check_member()
    params = {k: v.detach().requires_grad_()
              for k, v in trainable_params(scene).items()}
    with torch.enable_grad():
        part = _window_buffer(apply_params(scene, params), cam, mesh, seed, spp, True)
    fb = mesh.all_reduce(part.detach().clone())
    h, w = cam.image_height, cam.image_width
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=mesh.device).reshape(h, w, 3)
    resid = fb / spp - target
    loss = torch.mean(resid * resid)
    if part.requires_grad:
        got = torch.autograd.grad(part, list(params.values()),
                                  grad_outputs=(2.0 / (h * w * 3 * spp)) * resid,
                                  allow_unused=True)
    else:
        got = [None] * len(params)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(params.items(), got)}
    grads = mesh.all_reduce_dict(grads)
    new = {k: (v - lr * grads[k]).detach() for k, v in params.items()}
    return apply_params(scene, new), loss.detach()


def trainable_params(scene: Scene) -> dict:
    """The parameter dict gradients are taken for: material fuzz / IOR,
    texture colours (albedo and emission), texture image maps and, in a
    scene with an environment, its texels (``env_data``).  The values are
    the scene's own tensors, not copies."""
    p = dict(
        fuzz=scene.materials.fuzz,
        ior=scene.materials.ior,
        color=scene.textures.color,
        even_color=scene.textures.even_color,
        odd_color=scene.textures.odd_color,
        atlas=scene.textures.atlas,
    )
    if scene.env is not None:
        p["env_data"] = scene.env.data
    return p


def apply_params(scene: Scene, params: dict) -> Scene:
    """``scene`` with the parameters of ``params`` put in; the environment's
    alias tables stay (they are constants of the sampler)."""
    env = scene.env
    if env is not None and "env_data" in params:
        env = env._replace(data=params["env_data"])
    return dataclasses.replace(
        scene,
        env=env,
        materials=dataclasses.replace(
            scene.materials, fuzz=params["fuzz"], ior=params["ior"]),
        textures=dataclasses.replace(
            scene.textures,
            color=params["color"],
            even_color=params["even_color"],
            odd_color=params["odd_color"],
            atlas=params["atlas"],
        ),
    )
