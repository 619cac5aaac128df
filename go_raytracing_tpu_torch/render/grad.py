"""Chunked gradient rendering (inverse rendering at full resolution).

A full-resolution gradient (20 M camera rays at depth 5) cannot hold what
its reverse pass needs for every ray at once.  This module computes the
loss and its gradients in ray chunks, using that the pixel-MSE loss is
quadratic in the framebuffer:

    L(fb)       = mean((fb/spp - target)^2)
    dL/dparams  = sum_chunks  d<radiance_chunk, g_fb>/dparams,
    g_fb        = dL/dfb = 2 (fb/spp - target) / (N * spp)   (a constant
                  once fb is known)

Pass A traces every chunk with the stash-writing gradient forward
(``ops/cuda_wavefront.grad_fwd_stash``): its radiance IS the chunk's share
of the framebuffer, so no separate render is needed, and its per-bounce
stash stays in device memory.  The framebuffer gives the loss and g_fb.
Pass B runs the reverse sweep (``grad_rev_stash``) over each chunk's stash
with the constant cotangent g_fb and frees the stash at once.

A job whose stashes together exceed ``stash_budget`` keeps the stashes of
a prefix of its chunks.  The other chunks are traced by the plain forward
kernel in pass A (radiance only) and, in pass B, by the gradient forward
followed at once by the reverse sweep: the same numbers for one more
forward trace of those chunks, with one chunk's stash alive at a time.

Two tiers of gradient kernels are ported, on one device.  Scenes inside
``cuda_wavefront.grad_applicable`` (lambertian, light and isotropic
materials) take the product-chain tier: gradients of the texture colours.
Scenes with metal or glass inside ``grad_pathwise_applicable`` take the
pathwise tier: gradients of fuzz and IOR too, and of colours seen through a
specular chain.  Its stash is heavier (22 rows a bounce against 15), and
its pass B recomputes the rays' random draws, so it is given the chunk's
stream ids (ids only: it reads no camera rays).  Not ported yet, each
raising ``NotImplementedError``: environments (ROADMAP.md A15), the
image-prefactor tier (A16), the replay tier for scenes outside the kernels'
gates (A18) and ``mesh=`` (A19).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..camera import Camera
from ..geometry.scene import Scene
from ..integrator import wavefront
from ..ops import cuda_wavefront as mega
from ..parallel.sharding import trainable_params
from ..utils.device import resolve_device
from . import renderer as rmod

# Share of the device memory free at the call that the stashes kept between
# the passes may take; the rest is for a chunk's rays, outputs and one more
# stash (a chunk over budget).
STASH_SHARE_OF_FREE_MEMORY = 0.5
# On the CPU, where the plain versions run at test sizes.
CPU_STASH_BUDGET = 2 << 30


def stash_bytes_per_ray(max_depth: int, pathwise: bool = False) -> int:
    """Bytes a ray keeps between the passes: the stash rows of every bounce
    (15 in the product tier, 22 in the pathwise tier) and the 3 miss colour
    rows."""
    rows = ((mega.PW_STASH_F_ROWS + mega.PW_STASH_I_ROWS) if pathwise
            else (mega.STASH_F_ROWS + mega.STASH_I_ROWS))
    return (max_depth * rows + 3) * 4


def _virtual_pixels(w: int, h: int, device):
    """Pixel index and in-bounds mask of every virtual pixel of the tiled
    layout (the untiled layout needs neither)."""
    n_virt = rmod.ray_layout(w, h, True)[2]
    px, py, inb = rmod._id_to_pixel(
        torch.arange(n_virt, dtype=torch.int64, device=device), w, h, True)
    pix = torch.clamp_max(py * w + torch.clamp_max(px, w - 1), w * h - 1)
    return pix, inb


def _twophase_fwd(scene: Scene, cam: Camera, ray_start: int, seed, *,
                  spp: int, chunk: int, max_depth: int, keep_stash: bool,
                  pathwise: bool = False):
    """Pass A for one chunk.  Returns ([n_virt, 3] sums of the chunk's
    radiance per virtual pixel, carry for pass B or None)."""
    cam2, o, d, tm, stream, _, valid = rmod._chunk_rays(
        scene, cam, ray_start, seed, spp=spp, chunk=chunk,
        max_depth=max_depth, device=scene.device)
    if keep_stash:
        rad, carry = mega.grad_fwd_stash(scene, cam2, o, d, tm, stream, seed,
                                         pathwise=pathwise)
    else:
        rad, carry = wavefront.trace(scene, cam2, o, d, tm, stream, seed), None
    rows = torch.where(valid, torch.stack(list(rad)), 0.0)   # [3, chunk]
    n_virt = rmod.ray_layout(cam.image_width, cam.image_height,
                             rmod.scene_tiled(scene))[2]
    return rows.reshape(3, chunk // n_virt, n_virt).sum(dim=1).t(), carry


def _chunk_cotangent(g_virt, ray_start: int, chunk: int, total: int):
    """[3, chunk] cotangent of a chunk's radiance.  Chunks are whole
    samples, so it is the per-virtual-pixel cotangent repeated, with zeros
    for ray ids past the job's end.  Needs no rays: pass B reads no
    geometry."""
    n_virt = g_virt.shape[0]
    g3 = g_virt.t().repeat(1, chunk // n_virt)
    if ray_start + chunk > total:
        g3[:, max(total - ray_start, 0):] = 0.0
    return g3


def _twophase_rev(scene: Scene, cam: Camera, g_virt, ray_start: int, seed,
                  carry, *, spp: int, chunk: int, max_depth: int,
                  pathwise: bool = False):
    """Pass B for one chunk: the reverse sweep over the chunk's stash.  A
    chunk without one (over budget in pass A) is traced again first."""
    cam2 = dataclasses.replace(cam, max_depth=max_depth)
    total = g_virt.shape[0] * spp
    stream = None
    if carry is None:
        _, o, d, tm, stream, _, _ = rmod._chunk_rays(
            scene, cam, ray_start, seed, spp=spp, chunk=chunk,
            max_depth=max_depth, device=scene.device)
        _, carry = mega.grad_fwd_stash(scene, cam2, o, d, tm, stream, seed,
                                       pathwise=pathwise)
    elif pathwise:
        # the stream ids of _chunk_rays, without its rays
        stream = torch.clamp_max(
            ray_start + torch.arange(chunk, dtype=torch.int64,
                                     device=scene.device), total - 1)
    g3 = _chunk_cotangent(g_virt, ray_start, chunk, total)
    return mega.grad_rev_stash(scene, cam2, g3, carry, pathwise=pathwise,
                               stream=stream, seed=seed)


@torch.no_grad()
def render_grad(scene: Scene, cam: Camera, target, *, spp: Optional[int] = None,
                max_depth: Optional[int] = None, seed: int = 0,
                chunk: Optional[int] = None,
                stats: Optional[rmod.RenderStats] = None, mesh=None,
                stash_budget: Optional[int] = None, device=None):
    """Full-resolution loss + parameter gradients, chunked.

    target: [H, W, 3] image the render is being fit to.
    Returns (loss, grads dict) where grads matches
    ``sharding.trainable_params``.  Gradients are exactly those of
    mean((render/spp - target)^2): the loss is quadratic in the framebuffer
    (see the module docstring) and both passes use the same RNG streams.
    A scene without metal and glass goes through the product-chain kernels
    (``fuzz``, ``ior`` and ``atlas`` are then zero by structure), one with
    them through the pathwise kernels (``atlas`` zero); a scene outside both
    gates raises ``NotImplementedError``.

    ``device=None`` means "cuda" (a machine without one raises); the scene
    must have been built on the same device.
    ``stash_budget``: bytes the stashes kept between the passes may take;
    by default half of the device memory that is free at the call.
    ``stats.chunks`` counts ray chunks, once, whatever route they took.
    """
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene lies on {scene.device}, render_grad asked for {dev}")
    dev = scene.device
    if mesh is not None:
        raise NotImplementedError(
            "render_grad(mesh=...) is not ported yet (ROADMAP.md A19)")
    spp = cam.samples_per_pixel if spp is None else spp
    max_depth = cam.max_depth if max_depth is None else max_depth
    if scene.meshes:
        raise NotImplementedError(
            "render_grad of a mesh scene needs the replay tier, which is not "
            "ported yet (ROADMAP.md A18); torch.autograd through "
            "render(differentiable=True) gives its colour gradients")
    # the product tier wins where both gates hold: its stash is lighter
    pathwise = not mega.grad_applicable(scene, max_depth)
    if pathwise and not mega.grad_pathwise_applicable(scene, max_depth):
        raise NotImplementedError(
            "the scene is outside the gates of both ported gradient tiers "
            "(product chain and pathwise): environments are ROADMAP.md A15, "
            "image textures A16, and the replay tier for every other scene "
            "(meshes, noise textures, non-box media, too many primitives, "
            "textures or materials) A18")
    w, h = cam.image_width, cam.image_height
    tiled = rmod.scene_tiled(scene)
    _, _, n_virt = rmod.ray_layout(w, h, tiled)
    total = n_virt * spp

    # Chunks are whole samples; without a caller's size they are equalised,
    # so that no launch pays its fixed costs for a sliver of work.
    kchunk = max(rmod.pick_chunk_size(scene) if chunk is None else chunk, 1024)
    kchunk = min(kchunk, max(1024, -(-total // 1024) * 1024))
    kchunk = max(kchunk // n_virt, 1) * n_virt
    if chunk is None:
        nch = max(-(-total // kchunk), 1)
        kchunk = -(-(-(-total // nch)) // n_virt) * n_virt
    n_chunks = -(-total // kchunk)

    if stash_budget is None:
        if dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(dev)
            stash_budget = int(STASH_SHARE_OF_FREE_MEMORY * free)
        else:
            stash_budget = CPU_STASH_BUDGET
    chunk_bytes = kchunk * stash_bytes_per_ray(max_depth, pathwise)
    n_stash = min(int(stash_budget) // chunk_bytes, n_chunks)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    _sync()
    t0 = time.perf_counter()
    args = dict(spp=spp, chunk=kchunk, max_depth=max_depth, pathwise=pathwise)

    # ---- pass A: framebuffer, and the stashes of the first n_stash chunks
    flat_vs = torch.zeros((n_virt, 3), dtype=torch.float32, device=dev)
    carries = []
    for i in range(n_chunks):
        vs, carry = _twophase_fwd(scene, cam, i * kchunk, seed,
                                  keep_stash=i < n_stash, **args)
        flat_vs += vs
        carries.append(carry)

    target = torch.as_tensor(target, dtype=torch.float32, device=dev).reshape(h, w, 3)
    if tiled:
        pixv, inb = _virtual_pixels(w, h, dev)
        fb = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
        fb = fb.index_add_(0, pixv, flat_vs).reshape(h, w, 3)
    else:
        fb = flat_vs.reshape(h, w, 3)
    resid = fb / spp - target
    loss = torch.mean(resid * resid)
    g_fb_flat = (2.0 / (w * h * 3 * spp)) * resid.reshape(w * h, 3)
    # per-virtual-pixel cotangent: one gather for the tiled layout, the
    # framebuffer's own for the untiled one
    g_virt = torch.where(inb[:, None], g_fb_flat[pixv], 0.0) if tiled else g_fb_flat

    # ---- pass B: reverse sweeps; each stash is dropped as soon as it is used
    grads = {k: torch.zeros_like(v) for k, v in trainable_params(scene).items()}
    for i in range(n_chunks):
        carry, carries[i] = carries[i], None
        g = _twophase_rev(scene, cam, g_virt, i * kchunk, seed, carry, **args)
        del carry
        for k, v in g.items():
            grads[k] += v
    _sync()

    if stats is not None:
        stats.rays_traced += total
        stats.wall_seconds += time.perf_counter() - t0
        stats.chunks += n_chunks
    return loss, grads
