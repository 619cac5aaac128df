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

Four tiers, on one device (``grad_tier`` picks).  Scenes inside
``cuda_wavefront.grad_applicable`` (lambertian, light and isotropic
materials) take the product-chain tier: gradients of the texture colours.
Scenes with metal or glass inside ``grad_pathwise_applicable`` take the
pathwise tier: gradients of fuzz and IOR too, and of colours seen through a
specular chain.  Its stash is heavier (22 rows a bounce against 15), and
its pass B recomputes the rays' random draws, so it is given the chunk's
stream ids (ids only: it reads no camera rays).  Under an environment map
(and no quad lights) either tier also keeps each ray's miss footprint (12
texel values) and miss records between the passes (19 rows a ray), and pass
B computes the miss colour and the cotangents of the miss direction and of
the texels from them (``cuda_wavefront.grad_rev_stash``): ``env_data`` is
then among the gradients.  Environment chunks grow to the stash budget, as
the JAX package's do: their per-chunk costs (the texel sums) are large.

A scene with an environment and quad lights inside the pathwise gate takes
the fused tier, the route of chunks over budget for every chunk: pass A
renders each chunk (``wavefront.trace``), pass B runs the fused kernel on it
(``cuda_wavefront.grad_megakernel``: a forward launch for the miss records,
then forward and reverse in one launch, the environment samples' texel
cotangents summed per texel).  Nothing is kept between the passes; a chunk
holds as many rays as ``stash_budget`` allows the kernel's working set
(``fused_bytes_per_ray``).

Every other scene (meshes, non-box media, more than 1,024 primitives or 8
lights, more textures and materials than the pathwise kernel's accumulator
holds, environments among them) takes the replay tier.  Pass A records each chunk: its radiance and
its ``Decisions``, the outcome of every sweep (the record kernel of
``ops/cuda_wavefront`` for scenes inside the megakernel's gate, the
standard integrator for the others).  Pass B replays each chunk's record
under ``torch.autograd`` (``integrator/wavefront.trace(decisions=...)``): no
closest-hit or shadow sweep runs again, and the gradients of colours, fuzz
and IOR include the terms through the hit distance.  A job whose records
exceed ``dec_budget`` keeps none: pass A traces without recording, and pass
B records each chunk again just before its replay.  Replay chunks hold at
most ``renderer.MAX_CHUNK_RAYS_DIFFERENTIABLE`` rays: autograd keeps a few
kilobytes a ray.

Not ported yet, each raising ``NotImplementedError``: image textures
(ROADMAP.md A16), noise textures (A13) and ``mesh=`` (A19).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..camera import Camera
from ..core.vec3 import V3
from ..geometry.scene import Scene
from ..integrator import wavefront
from ..ops import cuda_wavefront as mega
from ..parallel.sharding import apply_params, trainable_params
from ..utils.device import resolve_device
from . import renderer as rmod

# Share of the device memory free at the call that the stashes kept between
# the passes may take; the rest is for a chunk's rays, outputs and one more
# stash (a chunk over budget).
STASH_SHARE_OF_FREE_MEMORY = 0.5
# On the CPU, where the plain versions run at test sizes.
CPU_STASH_BUDGET = 2 << 30
# Bytes the replay tier's records kept between its passes may take, the JAX
# package's default (its GRT_DEC_BUDGET).
DEC_BUDGET = 6_000_000_000


def grad_tier(scene: Scene, max_depth: int) -> str:
    """The tier ``render_grad`` takes: 'product', 'pathwise', 'fused' or
    'replay'.  The product tier wins where both two-phase tiers' gates hold:
    its stash is lighter.  'fused' serves the pathwise gate's scenes that
    cannot run two-phase (an environment and quad lights)."""
    if mega.grad_applicable(scene, max_depth):
        return "product"
    if mega.grad_pathwise_applicable(scene, max_depth):
        if mega.grad_two_phase_ok(scene, max_depth):
            return "pathwise"
        if mega.grad_fused_applicable(scene, max_depth):
            return "fused"
    return "replay"


def dec_bytes_per_ray(scene: Scene, max_depth: int) -> int:
    """Bytes the replay tier keeps a ray between its passes: its
    ``Decisions`` of every bounce."""
    return max_depth * wavefront.decision_bytes(scene)


def stash_bytes_per_ray(max_depth: int, pathwise: bool = False,
                        env: bool = False) -> int:
    """Bytes a ray keeps between the passes: the stash rows of every bounce
    (15 in the product tier, 22 in the pathwise tier) and the 3 miss colour
    rows, or under an environment the 19 rows of ``EnvCarry``."""
    rows = ((mega.PW_STASH_F_ROWS + mega.PW_STASH_I_ROWS) if pathwise
            else (mega.STASH_F_ROWS + mega.STASH_I_ROWS))
    return (max_depth * rows + (19 if env else 3)) * 4


def fused_bytes_per_ray(max_depth: int, hdri: bool) -> int:
    """Bytes a ray of a fused-tier chunk takes while its gradient runs: the
    rays, cotangent, outputs and environment rows (about 40 rows), and with
    HDRI NEE per bounce 7 sample rows, 3 ``eout`` rows, the texel id and
    what the per-texel sum sorts and gathers (8 + 8 + 12 bytes)."""
    return 40 * 4 + (max_depth * (10 * 4 + 8 + 28) if hdri else 0)


def _virtual_pixels(w: int, h: int, device):
    """Pixel index and in-bounds mask of every virtual pixel of the tiled
    layout (the untiled layout needs neither)."""
    n_virt = rmod.ray_layout(w, h, True)[2]
    px, py, inb = rmod._id_to_pixel(
        torch.arange(n_virt, dtype=torch.int64, device=device), w, h, True)
    pix = torch.clamp_max(py * w + torch.clamp_max(px, w - 1), w * h - 1)
    return pix, inb


def _chunking(scene: Scene, cam: Camera, spp: int, chunk: Optional[int],
              largest: int):
    """(chunk size, chunks, ray ids of the job, virtual pixels a sample).
    Chunks are whole samples; without a caller's size they are equalised,
    so that no launch pays its fixed costs for a sliver of work."""
    tiled = rmod.scene_tiled(scene)
    _, _, n_virt = rmod.ray_layout(cam.image_width, cam.image_height, tiled)
    total = n_virt * spp
    kchunk = max(largest if chunk is None else chunk, 1024)
    kchunk = min(kchunk, max(1024, -(-total // 1024) * 1024))
    kchunk = max(kchunk // n_virt, 1) * n_virt
    if chunk is None:
        nch = max(-(-total // kchunk), 1)
        kchunk = -(-(-(-total // nch)) // n_virt) * n_virt
    return kchunk, -(-total // kchunk), total, n_virt


def _loss_and_cotangent(flat_vs, target, w: int, h: int, spp: int, tiled: bool,
                        dev):
    """The framebuffer's loss and the per-virtual-pixel cotangent [n_virt, 3]
    from the per-virtual-pixel radiance sums."""
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
    return loss, g_virt


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
    return _virtual_sums(scene, cam, rad, valid, chunk), carry


def _virtual_sums(scene: Scene, cam: Camera, rad, valid, chunk: int):
    """A chunk's radiance (whole samples) -> [n_virt, 3] sums per virtual
    pixel, in a fixed order."""
    rows = torch.where(valid, torch.stack(list(rad)), 0.0)   # [3, chunk]
    n_virt = rmod.ray_layout(cam.image_width, cam.image_height,
                             rmod.scene_tiled(scene))[2]
    return rows.reshape(3, chunk // n_virt, n_virt).sum(dim=1).t()


def _record_fwd(scene: Scene, cam: Camera, ray_start: int, seed, *, spp: int,
                chunk: int, max_depth: int, keep: bool):
    """Pass A of the replay tier for one chunk: ([n_virt, 3] sums of the
    chunk's radiance per virtual pixel, its ``Decisions`` or None).  The
    trace picks its recorder: the megakernel's record kernel inside its
    gate, the standard integrator outside."""
    cam2, o, d, tm, stream, _, valid = rmod._chunk_rays(
        scene, cam, ray_start, seed, spp=spp, chunk=chunk,
        max_depth=max_depth, device=scene.device)
    if keep:
        rad, dec = wavefront.trace(scene, cam2, o, d, tm, stream, seed, record=True)
    else:
        rad, dec = wavefront.trace(scene, cam2, o, d, tm, stream, seed), None
    return _virtual_sums(scene, cam, rad, valid, chunk), dec


def _replay_rev(scene: Scene, cam: Camera, g_virt, ray_start: int, seed, dec,
                *, spp: int, chunk: int, max_depth: int):
    """Pass B of the replay tier for one chunk: the gradients of
    <radiance, cotangent> by ``torch.autograd`` through the replay of the
    chunk's record (recorded here first when pass A kept none)."""
    cam2, o, d, tm, stream, _, _ = rmod._chunk_rays(
        scene, cam, ray_start, seed, spp=spp, chunk=chunk,
        max_depth=max_depth, device=scene.device)
    if dec is None:
        _, dec = wavefront.trace(scene, cam2, o, d, tm, stream, seed, record=True)
    g3 = _chunk_cotangent(g_virt, ray_start, chunk, g_virt.shape[0] * spp)
    params = {k: v.detach().requires_grad_()
              for k, v in trainable_params(scene).items()}
    with torch.enable_grad():
        rad = wavefront.trace(apply_params(scene, params), cam2, o, d, tm,
                              stream, seed, decisions=dec)
        inner = sum((rad[c] * g3[c]).sum() for c in range(3))
        got = torch.autograd.grad(inner, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(params.items(), got)}


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
                  pathwise: bool = False, fused: bool = False):
    """Pass B for one chunk: the reverse sweep over the chunk's stash.  A
    chunk without one (over budget in pass A) is traced again first, or,
    on the fused tier, run through the fused kernel."""
    cam2 = dataclasses.replace(cam, max_depth=max_depth)
    total = g_virt.shape[0] * spp
    stream = None
    g3 = _chunk_cotangent(g_virt, ray_start, chunk, total)
    if carry is None:
        _, o, d, tm, stream, _, _ = rmod._chunk_rays(
            scene, cam, ray_start, seed, spp=spp, chunk=chunk,
            max_depth=max_depth, device=scene.device)
        o, d, tm = V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)), \
            tm.contiguous()
        if fused:
            return mega.grad_megakernel(scene, cam2, o, d, tm, stream, seed, g3)[1]
        _, carry = mega.grad_fwd_stash(scene, cam2, o, d, tm, stream, seed,
                                       pathwise=pathwise)
    elif pathwise:
        # the stream ids of _chunk_rays, without its rays
        stream = torch.clamp_max(
            ray_start + torch.arange(chunk, dtype=torch.int64,
                                     device=scene.device), total - 1)
    return mega.grad_rev_stash(scene, cam2, g3, carry, pathwise=pathwise,
                               stream=stream, seed=seed)


@torch.no_grad()
def render_grad(scene: Scene, cam: Camera, target, *, spp: Optional[int] = None,
                max_depth: Optional[int] = None, seed: int = 0,
                chunk: Optional[int] = None,
                stats: Optional[rmod.RenderStats] = None, mesh=None,
                stash_budget: Optional[int] = None,
                dec_budget: Optional[int] = None, device=None):
    """Full-resolution loss + parameter gradients, chunked.

    target: [H, W, 3] image the render is being fit to.
    Returns (loss, grads dict) where grads matches
    ``sharding.trainable_params``.  Gradients are exactly those of
    mean((render/spp - target)^2): the loss is quadratic in the framebuffer
    (see the module docstring) and both passes use the same RNG streams.
    A scene without metal and glass goes through the product-chain kernels
    (``fuzz``, ``ior`` and ``atlas`` are then zero by structure), one with
    them through the pathwise kernels (``atlas`` zero), one with an
    environment and quad lights through the fused kernel, any other through
    the replay tier (``grad_tier``).  A scene with an environment also has
    ``env_data``, the gradient of its texels.

    ``device=None`` means "cuda" (a machine without one raises); the scene
    must have been built on the same device.
    ``stash_budget``: bytes the stashes kept between the passes may take
    (the fused tier: a chunk's working set); by default half of the device
    memory that is free at the call.
    ``dec_budget``: bytes the replay tier's records may take between its
    passes (``DEC_BUDGET`` by default); a job over it records every chunk
    twice.  ``stats.chunks`` counts ray chunks, once, whatever route they
    took.
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
    tier = grad_tier(scene, max_depth)
    if tier == "replay":
        wavefront._check_standard(scene)   # noise, images
        return _render_grad_replay(scene, cam, target, spp=spp,
                                   max_depth=max_depth, seed=seed, chunk=chunk,
                                   stats=stats, dec_budget=dec_budget)
    if stash_budget is None:
        if dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(dev)
            stash_budget = int(STASH_SHARE_OF_FREE_MEMORY * free)
        else:
            stash_budget = CPU_STASH_BUDGET
    # the fused tier is the route of chunks over budget, for every chunk:
    # pass A renders, pass B runs the fused kernel
    fused = tier == "fused"
    pathwise = tier in ("pathwise", "fused")
    w, h = cam.image_width, cam.image_height
    tiled = rmod.scene_tiled(scene)
    per_ray = (fused_bytes_per_ray(max_depth, mega.uses_hdri_nee(scene)) if fused
               else stash_bytes_per_ray(max_depth, pathwise, scene.env is not None))
    largest = rmod.pick_chunk_size(scene)
    if scene.env is not None and chunk is None:
        # an environment chunk pays large fixed costs (the per-texel sums):
        # grow it to the budget
        largest = max(largest, int(stash_budget) // per_ray)
    kchunk, n_chunks, total, n_virt = _chunking(scene, cam, spp, chunk, largest)
    n_stash = 0 if fused else min(int(stash_budget) // (kchunk * per_ray), n_chunks)

    _sync(dev)
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

    loss, g_virt = _loss_and_cotangent(flat_vs, target, w, h, spp, tiled, dev)

    # ---- pass B: reverse sweeps; each stash is dropped as soon as it is used
    grads = {k: torch.zeros_like(v) for k, v in trainable_params(scene).items()}
    for i in range(n_chunks):
        carry, carries[i] = carries[i], None
        g = _twophase_rev(scene, cam, g_virt, i * kchunk, seed, carry, fused=fused,
                          **args)
        del carry
        for k, v in g.items():
            grads[k] += v
    _sync(dev)

    if stats is not None:
        stats.rays_traced += total
        stats.wall_seconds += time.perf_counter() - t0
        stats.chunks += n_chunks
    return loss, grads


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _render_grad_replay(scene: Scene, cam: Camera, target, *, spp: int,
                        max_depth: int, seed: int, chunk: Optional[int],
                        stats: Optional[rmod.RenderStats],
                        dec_budget: Optional[int]):
    """``render_grad``'s replay tier (see the module docstring).  The last
    chunk holds only the samples left, so no ray is traced twice in a pass."""
    dev = scene.device
    w, h = cam.image_width, cam.image_height
    tiled = rmod.scene_tiled(scene)
    kchunk, n_chunks, total, n_virt = _chunking(
        scene, cam, spp, chunk, rmod.pick_chunk_size(scene, differentiable=True))
    starts = [i * kchunk for i in range(n_chunks)]
    sizes = [min(kchunk, total - s0) for s0 in starts]
    budget = DEC_BUDGET if dec_budget is None else int(dec_budget)
    keep = total * dec_bytes_per_ray(scene, max_depth) <= budget

    _sync(dev)
    t0 = time.perf_counter()
    args = dict(spp=spp, max_depth=max_depth)

    # ---- pass A: framebuffer, and every chunk's record if they all fit
    flat_vs = torch.zeros((n_virt, 3), dtype=torch.float32, device=dev)
    decs = []
    for s0, size in zip(starts, sizes):
        vs, dec = _record_fwd(scene, cam, s0, seed, chunk=size, keep=keep, **args)
        flat_vs += vs
        decs.append(dec)

    loss, g_virt = _loss_and_cotangent(flat_vs, target, w, h, spp, tiled, dev)

    # ---- pass B: replays; each record is dropped as soon as it is used
    grads = {k: torch.zeros_like(v) for k, v in trainable_params(scene).items()}
    for i, (s0, size) in enumerate(zip(starts, sizes)):
        dec, decs[i] = decs[i], None
        g = _replay_rev(scene, cam, g_virt, s0, seed, dec, chunk=size, **args)
        del dec
        for k, v in g.items():
            grads[k] += v
    _sync(dev)

    if stats is not None:
        stats.rays_traced += total
        stats.wall_seconds += time.perf_counter() - t0
        stats.chunks += n_chunks
    return loss, grads
