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
materials, marble textures among them) take the product-chain tier:
gradients of the texture colours.
Scenes with metal or glass inside ``grad_pathwise_applicable`` take the
pathwise tier: gradients of fuzz and IOR too, and of colours seen through a
specular chain.  Its stash is heavier (22 rows a bounce against 15, 23
with marble), and
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

Marble textures ride the tier their materials pick: with metal or glass
(or under an environment with quad lights) the marble moves with the hit
point, and the pathwise and fused kernels carry its derivative by the hit
point (their stash keeps the winner's marble scale, one more row a bounce).

A scene inside ``integrator/wavefront.image_prefactor_ok`` (one sphere with
an image texture and nothing else: the earth scene) takes the image tier.
Its radiance is A * W exactly: A the image albedo of the camera ray's first
hit (1 on a miss), W the radiance of the scene with its images made white.
Pass A runs the product-chain tier's stash-writing forward on the white
scene and keeps A, W and the first hit's atlas row of each ray beside the
stash (``ImageCarry``); pass B runs the reverse sweep with the cotangent
g * A, which gives the white scene's colour gradients, and sums g * W per
texel (``core/segsum.cols_segment_sum``), which gives the atlas gradient.

Every other scene (meshes, non-box media, image textures outside the image
tier, more than 1,024 primitives or 8 lights, more textures and materials
than the pathwise kernel's accumulator holds, environments among them)
takes the replay tier.  Pass A records each chunk: its radiance and
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

Under a mesh (``parallel/sharding.RayMesh``, one process a device) every
chunk is split over the ranks in whole samples (``sharding.sample_window``)
and each rank runs both passes on its window of every chunk, keeping its
own stashes and records.  Two collectives join them: one ``all_reduce`` of
the per-virtual-pixel sums after pass A, from which every rank computes the
same loss and cotangent, and one of the flattened gradients after pass B.
The JAX package sums per chunk (a ``psum`` each) and runs the image tier
fused under a mesh; the port keeps its two-phase image tier on every rank.
Both give the single-device numbers up to the order of the sums, and at
world size 1 the port gives the same bits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from ..camera import Camera
from ..core.segsum import cols_segment_sum
from ..core.vec3 import V3
from ..geometry.scene import Scene
from ..integrator import wavefront
from ..materials import textures as tex
from ..ops import cuda_wavefront as mega
from ..parallel.sharding import RayMesh, apply_params, sample_window, trainable_params
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
    """The tier ``render_grad`` takes: 'product', 'pathwise', 'fused',
    'image' or 'replay'.  The product tier wins where both two-phase tiers'
    gates hold: its stash is lighter.  'fused' serves the pathwise gate's
    scenes that cannot run two-phase (an environment and quad lights).
    'image' serves the scenes of ``wavefront.image_prefactor_ok`` whose
    white scene the product tier takes; every other image scene replays."""
    if mega.grad_applicable(scene, max_depth):
        return "product"
    if mega.grad_pathwise_applicable(scene, max_depth):
        if mega.grad_two_phase_ok(scene, max_depth):
            return "pathwise"
        if mega.grad_fused_applicable(scene, max_depth):
            return "fused"
    if (wavefront.image_prefactor_ok(scene)
            and mega.grad_applicable(wavefront._strip_image(scene), max_depth)):
        return "image"
    return "replay"


def dec_bytes_per_ray(scene: Scene, max_depth: int) -> int:
    """Bytes the replay tier keeps a ray between its passes: its
    ``Decisions`` of every bounce."""
    return max_depth * wavefront.decision_bytes(scene)


def stash_bytes_per_ray(max_depth: int, pathwise: bool = False,
                        env: bool = False, noise: bool = False,
                        image: bool = False) -> int:
    """Bytes a ray keeps between the passes: the stash rows of every bounce
    (15 in the product tier, 22 in the pathwise tier, 23 there in a scene
    with marble) and the 3 miss colour rows, or under an environment the 19
    rows of ``EnvCarry``; on the image tier 7 more (``ImageCarry``: A 3, W
    3, the texel row; the JAX package keeps the hit mask as an eighth)."""
    if pathwise:
        f_rows = mega.PW_STASH_F_ROWS_MARBLE if noise else mega.PW_STASH_F_ROWS
        rows = f_rows + mega.PW_STASH_I_ROWS
    else:
        rows = mega.STASH_F_ROWS + mega.STASH_I_ROWS
    return (max_depth * rows + (19 if env else 10 if image else 3)) * 4


def fused_bytes_per_ray(max_depth: int, hdri: bool) -> int:
    """Bytes a ray of a fused-tier chunk takes while its gradient runs: the
    rays, cotangent, outputs and environment rows (about 40 rows), and with
    HDRI NEE per bounce 7 sample rows, 3 ``eout`` rows, the texel id and
    what the per-texel sum sorts and gathers (8 + 8 + 12 bytes).  The
    stash (19 or, with marble, 20 float rows a bounce) is not among them:
    it lives in the local memory of the threads resident on the card, a
    size set by the card and ``FUSED_MAX_DEPTH``, not by the chunk."""
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


def _rank_windows(starts, sizes, n_virt: int, total: int, mesh: RayMesh):
    """(ray start, rays) of this rank's window of every chunk: its whole
    samples of the chunk (``sharding.sample_window``; on one rank the whole
    chunk), 0 rays where it takes none or its window starts past the job's
    end."""
    out = []
    for s0, n in zip(starts, sizes):
        lo, hi = sample_window(n // n_virt, mesh.size, mesh.rank)
        start = s0 + lo * n_virt
        out.append((start, (hi - lo) * n_virt if start < total else 0))
    return out


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


class ImageCarry(NamedTuple):
    """What a chunk of the image tier keeps between the passes besides the
    white scene's stash: 7 rows a ray."""

    white: tuple        # the white scene's carry of ``grad_fwd_stash``
    albedo: torch.Tensor  # [3, R] A: the first hit's texel, 1 on a miss
    white_rad: torch.Tensor  # [3, R] W: the white scene's radiance
    texel: torch.Tensor  # [R] i32 the first hit's atlas row, out of range on a miss


def _image_fwd(scene: Scene, cam: Camera, o: V3, d: V3, tm, stream, seed):
    """Pass A of the image tier for one chunk: the white scene through the
    product-chain tier's gradient forward, times the first hits' texels.
    Returns (radiance A * W, ``ImageCarry``)."""
    rad_w, carry_w = mega.grad_fwd_stash(wavefront._strip_image(scene), cam,
                                         o, d, tm, stream, seed)
    albedo, texel, hit = wavefront._primary_image_records(scene, o, d, tm)
    n_texels = scene.textures.atlas.shape[:3].numel()
    carry = ImageCarry(carry_w, torch.stack(list(albedo)), torch.stack(list(rad_w)),
                       torch.where(hit, texel, n_texels).to(torch.int32))
    return albedo * rad_w, carry


def _image_rev(scene: Scene, cam: Camera, g3, carry: ImageCarry):
    """Pass B of the image tier for one chunk.  d<g, A * W> is, by the
    product rule, the reverse sweep of the white scene with the cotangent
    g * A (its image rows' colour gradient dropped: the real scene reads the
    atlas there), and for the atlas the per-texel sums of g * W over the
    rays whose first hit took that texel."""
    grads = mega.grad_rev_stash(wavefront._strip_image(scene), cam,
                                g3 * carry.albedo, carry.white)
    is_img = scene.textures.kind == tex.TEX_IMAGE
    grads["color"] = torch.where(is_img[:, None], 0.0, grads["color"])
    atlas = scene.textures.atlas
    grads["atlas"] = cols_segment_sum(
        carry.texel, g3 * carry.white_rad, atlas.shape[:3].numel()
    ).reshape(atlas.shape)
    return grads


def _twophase_fwd(scene: Scene, cam: Camera, ray_start: int, seed, *,
                  spp: int, chunk: int, max_depth: int, keep_stash: bool,
                  pathwise: bool = False, image: bool = False):
    """Pass A for one chunk.  Returns ([n_virt, 3] sums of the chunk's
    radiance per virtual pixel, carry for pass B or None)."""
    cam2, o, d, tm, stream, _, valid = rmod._chunk_rays(
        scene, cam, ray_start, seed, spp=spp, chunk=chunk,
        max_depth=max_depth, device=scene.device)
    if keep_stash and image:
        rad, carry = _image_fwd(scene, cam2, o, d, tm, stream, seed)
    elif keep_stash:
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
                  pathwise: bool = False, fused: bool = False,
                  image: bool = False):
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
        if image:
            _, carry = _image_fwd(scene, cam2, o, d, tm, stream, seed)
        else:
            _, carry = mega.grad_fwd_stash(scene, cam2, o, d, tm, stream, seed,
                                           pathwise=pathwise)
    elif pathwise:
        # the stream ids of _chunk_rays, without its rays
        stream = torch.clamp_max(
            ray_start + torch.arange(chunk, dtype=torch.int64,
                                     device=scene.device), total - 1)
    if image:
        return _image_rev(scene, cam2, g3, carry)
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
    environment and quad lights through the fused kernel, a sphere with an
    image texture alone (the earth scene) through the image tier (the
    product-chain kernels on the white scene, and the atlas gradient by
    per-texel sums), any other through the replay tier (``grad_tier``),
    image textures among them.  A scene with an environment also has
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

    ``mesh``: a ``parallel/sharding.RayMesh``; every rank of it makes the
    call with the same arguments and gets the same loss and gradients (see
    the module docstring).  The device is then the mesh's unless ``device``
    says otherwise.  ``stash_budget`` and ``dec_budget`` hold for each rank
    alone, and the default share of free memory is taken on each rank's
    device when it is called: ranks that share a card each see what the
    others have not taken yet, so give them an explicit budget.
    """
    if mesh is not None:
        mesh.check_member()
        device = mesh.device if device is None else device
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene lies on {scene.device}, render_grad asked for {dev}")
    dev = scene.device
    mesh = RayMesh(None, 0, 1, dev) if mesh is None else mesh
    spp = cam.samples_per_pixel if spp is None else spp
    max_depth = cam.max_depth if max_depth is None else max_depth
    tier = grad_tier(scene, max_depth)
    if tier == "replay":
        return _render_grad_replay(scene, cam, target, spp=spp,
                                   max_depth=max_depth, seed=seed, chunk=chunk,
                                   stats=stats, dec_budget=dec_budget, mesh=mesh)
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
    image = tier == "image"
    w, h = cam.image_width, cam.image_height
    tiled = rmod.scene_tiled(scene)
    per_ray = (fused_bytes_per_ray(max_depth, mega.uses_hdri_nee(scene)) if fused
               else stash_bytes_per_ray(max_depth, pathwise, scene.env is not None,
                                        scene.has_noise, image))
    largest = rmod.pick_chunk_size(scene)
    if scene.env is not None and chunk is None:
        # an environment chunk pays large fixed costs (the per-texel sums):
        # grow each rank's window of it to the budget
        largest = max(largest, mesh.size * int(stash_budget) // per_ray)
    kchunk, n_chunks, total, n_virt = _chunking(scene, cam, spp, chunk, largest)
    windows = _rank_windows([i * kchunk for i in range(n_chunks)],
                            [kchunk] * n_chunks, n_virt, total, mesh)
    widest = max(max(n for _, n in windows), 1)
    n_stash = 0 if fused else min(int(stash_budget) // (widest * per_ray), n_chunks)

    _sync(dev)
    t0 = time.perf_counter()
    args = dict(spp=spp, max_depth=max_depth, pathwise=pathwise, image=image)

    # ---- pass A: framebuffer, and the stashes of the first n_stash chunks;
    # the trace of a chunk over budget picks its mode for the rank's window
    flat_vs = torch.zeros((n_virt, 3), dtype=torch.float32, device=dev)
    carries = []
    for i, (s0, n) in enumerate(windows):
        carry = None
        if n:
            vs, carry = _twophase_fwd(scene, cam, s0, seed, chunk=n,
                                      keep_stash=i < n_stash, **args)
            flat_vs += vs
        carries.append(carry)
    mesh.all_reduce(flat_vs)

    loss, g_virt = _loss_and_cotangent(flat_vs, target, w, h, spp, tiled, dev)

    # ---- pass B: reverse sweeps; each stash is dropped as soon as it is used
    grads = {k: torch.zeros_like(v) for k, v in trainable_params(scene).items()}
    for i, (s0, n) in enumerate(windows):
        carry, carries[i] = carries[i], None
        if not n:
            continue
        g = _twophase_rev(scene, cam, g_virt, s0, seed, carry, chunk=n, fused=fused,
                          **args)
        del carry
        for k, v in g.items():
            grads[k] += v
    grads = mesh.all_reduce_dict(grads)
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
                        dec_budget: Optional[int], mesh=None):
    """``render_grad``'s replay tier (see the module docstring).  The last
    chunk holds only the samples left, so no ray is traced twice in a pass.
    A rank keeps the records of its own windows, within ``dec_budget``."""
    dev = scene.device
    mesh = RayMesh(None, 0, 1, dev) if mesh is None else mesh
    w, h = cam.image_width, cam.image_height
    tiled = rmod.scene_tiled(scene)
    kchunk, n_chunks, total, n_virt = _chunking(
        scene, cam, spp, chunk, rmod.pick_chunk_size(scene, differentiable=True))
    starts = [i * kchunk for i in range(n_chunks)]
    windows = _rank_windows(starts, [min(kchunk, total - s0) for s0 in starts],
                            n_virt, total, mesh)
    budget = DEC_BUDGET if dec_budget is None else int(dec_budget)
    keep = sum(n for _, n in windows) * dec_bytes_per_ray(scene, max_depth) <= budget

    _sync(dev)
    t0 = time.perf_counter()
    args = dict(spp=spp, max_depth=max_depth)

    # ---- pass A: framebuffer, and every chunk's record if they all fit
    flat_vs = torch.zeros((n_virt, 3), dtype=torch.float32, device=dev)
    decs = []
    for s0, n in windows:
        dec = None
        if n:
            vs, dec = _record_fwd(scene, cam, s0, seed, chunk=n, keep=keep, **args)
            flat_vs += vs
        decs.append(dec)
    mesh.all_reduce(flat_vs)

    loss, g_virt = _loss_and_cotangent(flat_vs, target, w, h, spp, tiled, dev)

    # ---- pass B: replays; each record is dropped as soon as it is used
    grads = {k: torch.zeros_like(v) for k, v in trainable_params(scene).items()}
    for i, (s0, n) in enumerate(windows):
        dec, decs[i] = decs[i], None
        if not n:
            continue
        g = _replay_rev(scene, cam, g_virt, s0, seed, dec, chunk=n, **args)
        del dec
        for k, v in g.items():
            grads[k] += v
    grads = mesh.all_reduce_dict(grads)
    _sync(dev)

    if stats is not None:
        stats.rays_traced += total
        stats.wall_seconds += time.perf_counter() - t0
        stats.chunks += n_chunks
    return loss, grads
