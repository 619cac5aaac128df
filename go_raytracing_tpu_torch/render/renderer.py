"""Megabatch renderer.

(pixels x samples) are flattened into one ray stream and traced in
fixed-size chunks, one kernel launch per chunk; per-pixel accumulation is
a reshape-and-sum over the chunk's whole samples.

Progressive multi-pass rendering (preview 1 SPP/depth 3 -> refine ->
final) maps to SPP-chunked scheduling: see ``render_progressive``.
Because the RNG is counter-based over (pixel, sample), SPP chunks also
double as checkpoint units: the accumulator + the number of completed
samples fully determine resumption.

A render runs under ``torch.no_grad()`` unless the caller asks for
``differentiable=True`` with autograd enabled: the framebuffer then keeps
its ``grad_fn`` and ``loss.backward()`` reaches the scene's parameters
through the standard integrator (``integrator/wavefront``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..camera import Camera, generate_rays
from ..core import film
from ..geometry.scene import Scene
from ..integrator import wavefront
from ..utils.device import resolve_device

# Cap on rays*primitives work per chunk.  Carried over from the JAX package
# as a starting value; not tuned for any GPU.
DEFAULT_PAIR_BUDGET = 1 << 26
# Largest chunk, in rays.  Likewise a carried-over starting value.
MAX_CHUNK_RAYS = 1 << 22
# Largest chunk of a differentiable render.  Under autograd every bounce of
# the standard integrator keeps a few hundred [R] tensors for the backward
# pass (kilobytes a ray and bounce), and the temporaries of one chunk's
# forward come on top of the graphs of all chunks before it: a quarter of
# the forward chunk keeps that share small.  A starting value, not tuned.
MAX_CHUNK_RAYS_DIFFERENTIABLE = 1 << 20


def pick_chunk_size(scene: Scene, *, pair_budget: int = DEFAULT_PAIR_BUDGET,
                    max_rays: Optional[int] = None,
                    differentiable: bool = False) -> int:
    # The kernels never materialize [R, N] pair buffers over primitives, so
    # only the per-ray rows (and the [R, n_volumes] free-flight buffers)
    # bound memory: size launches large.
    if max_rays is None:
        max_rays = (MAX_CHUNK_RAYS_DIFFERENTIABLE if differentiable
                    else MAX_CHUNK_RAYS)
    n = max(scene.n_volumes * 4, 16)
    chunk = min(max_rays, max(pair_budget // n, 4096))
    return int(max(1024, (chunk // 1024) * 1024))


BUCKET = 32  # pixel tile side of the tiled ray layout


def ray_layout(w: int, h: int, tiled: bool):
    """Pixel-grid layout for ray ids.

    ``tiled``: rays ordered in 32x32 pixel buckets (padded grid) so that
    consecutive ray ids — and therefore the threads of a warp and the
    warps of a block — are spatially coherent.  Other scenes use the plain
    linear layout (no padding, no index math).
    Returns (tiles_x, tiles_y, n_virtual_pixels).
    """
    if not tiled:
        return 0, 0, w * h
    tiles_x = -(-w // BUCKET)
    tiles_y = -(-h // BUCKET)
    return tiles_x, tiles_y, tiles_x * tiles_y * BUCKET * BUCKET


def _id_to_pixel(ids, w: int, h: int, tiled: bool):
    """Ray id (within one sample) -> (px, py, in-bounds mask)."""
    if not tiled:
        px = ids % w
        py = ids // w
        return px, py, py < h
    tiles_x, _, _ = ray_layout(w, h, True)
    per_tile = BUCKET * BUCKET
    tile = ids // per_tile
    within = ids % per_tile
    px = (tile % tiles_x) * BUCKET + within % BUCKET
    py = (tile // tiles_x) * BUCKET + within // BUCKET
    return px, py, (px < w) & (py < h)


def scene_tiled(scene) -> bool:
    """Tiled ray layout for mesh scenes and sphere-heavy scenes (>=
    SPH_CULL_MIN spheres), the same rule as the JAX package's, so that a
    ray has the same stream id in both."""
    from ..ops.cuda_wavefront import SPH_CULL_MIN

    return (len(scene.meshes) > 0
            or int(scene.spheres.radius.shape[0]) >= SPH_CULL_MIN)


def _chunk_rays(scene, cam: Camera, ray_start: int, seed, *, spp: int,
                chunk: int, max_depth: int, device):
    """The camera rays of one chunk: ray ids ``ray_start .. ray_start +
    chunk`` of the scene's ray layout.  Returns (camera at ``max_depth``,
    o, d, tm, stream ids, pixel index, valid mask); iterating over all
    chunks covers every (pixel, sample) once."""
    w, h = cam.image_width, cam.image_height
    tiled = scene_tiled(scene)
    _, _, n_virt = ray_layout(w, h, tiled)
    total = n_virt * spp

    ids = ray_start + torch.arange(chunk, dtype=torch.int64, device=device)
    valid = ids < total
    ids = torch.clamp_max(ids, total - 1)
    px, py, in_bounds = _id_to_pixel(ids % n_virt, w, h, tiled)
    valid = valid & in_bounds
    pixel = torch.clamp_max(py * w + torch.clamp_max(px, w - 1), w * h - 1)
    # Stream id = sample * n_virt + virtual_pixel == the global ray id:
    # independent of the total spp, so SPP-chunked/resumed renders and any
    # chunking layout produce identical samples.
    cam2 = dataclasses.replace(cam, max_depth=max_depth)
    o, d, tm = generate_rays(cam2, px, py, ids, seed)
    return cam2, o, d, tm, ids, pixel, valid


def _render_chunk(scene, cam: Camera, accum, ray_start: int, seed, *, spp: int,
                  chunk: int, max_depth: int, differentiable: bool = False,
                  mega_mode: Optional[str] = None):
    """Trace ``chunk`` rays starting at global ray id ``ray_start`` and add
    their radiance into the flat accumulator [W*H, 3]: in place (the buffer
    belongs to ``render``; nothing else holds it) unless autograd records
    the render, which needs a new tensor per chunk."""
    tiled = scene_tiled(scene)
    _, _, n_virt = ray_layout(cam.image_width, cam.image_height, tiled)
    cam2, o, d, tm, stream, pixel, valid = _chunk_rays(
        scene, cam, ray_start, seed, spp=spp, chunk=chunk,
        max_depth=max_depth, device=accum.device)
    radiance, tstats = wavefront.trace(
        scene, cam2, o, d, tm, stream, seed, differentiable=differentiable,
        mega_mode=mega_mode, with_stats=True,
    )
    rows = torch.where(valid[:, None], radiance.rows(), 0.0)
    # Sample-aligned chunks (render() rounds chunk to a multiple of n_virt
    # and starts chunks on sample boundaries): ids % n_virt is the same
    # arange pattern for every chunk, so per-pixel accumulation is a
    # reshape+sum over the chunk's whole samples, in a fixed order.
    # Untiled layouts need no scatter at all (virtual pixel == pixel);
    # tiled layouts scatter once per chunk at n_virt elements.
    if chunk % n_virt == 0:
        if ray_start % n_virt != 0:
            raise ValueError("sample-aligned chunks must start on a sample "
                             "boundary (ray_start % n_virt == 0)")
        vs = rows.reshape(chunk // n_virt, n_virt, 3).sum(dim=0)
        if not tiled:
            accum = accum + vs if rows.requires_grad else accum.add_(vs)
        else:
            accum = _index_add(accum, pixel[:n_virt], vs)
        return accum, tstats["mesh_overflow"]
    # Unaligned chunks: a scatter-add.  On a GPU index_add uses atomics,
    # so the order of the sums (and the last bits) changes from run to run.
    return _index_add(accum, pixel, rows), tstats["mesh_overflow"]


def _index_add(accum, index, rows):
    if rows.requires_grad:
        return accum.index_add(0, index, rows)
    return accum.index_add_(0, index, rows)


@dataclasses.dataclass
class RenderStats:
    rays_traced: int = 0
    wall_seconds: float = 0.0
    chunks: int = 0
    # Work the mesh kernels dropped, summed over chunks: always 0 (they
    # have no slot cap; the JAX package's frontier traversal could drop).
    mesh_overflow: int = 0

    @property
    def rays_per_second(self) -> float:
        return self.rays_traced / self.wall_seconds if self.wall_seconds > 0 else 0.0


def render(scene: Scene, cam: Camera, *, spp: Optional[int] = None,
           max_depth: Optional[int] = None, seed: int = 0,
           chunk: Optional[int] = None, sample_offset: int = 0,
           accum: Optional[torch.Tensor] = None,
           stats: Optional[RenderStats] = None,
           differentiable: bool = False, sync: bool = True,
           mega_mode: Optional[str] = None, device=None):
    """Render ``spp`` samples/pixel; returns the accumulation buffer
    [H, W, 3] of *summed* radiance (divide by spp via film.tonemap).

    ``device=None`` means "cuda" (a machine without one raises); the scene
    must have been built on the same device.
    ``sample_offset`` starts sampling at a given global sample index so
    progressive / resumed renders continue the same RNG streams; ``accum``
    is the buffer to continue from (it is copied, not modified).
    ``sync=False`` skips the final device synchronization; wall-clock stats
    are only recorded when ``sync`` is true.
    ``differentiable=True`` renders through the standard integrator's
    gather route and, where autograd is enabled, records the render: the
    returned buffer then has a ``grad_fn`` (see ``wavefront.trace`` for what
    the gradients hold).  ``mega_mode`` forces 'off' (standard integrator)
    or 'single' (megakernel); None picks by scene.
    """
    record_graph = differentiable and torch.is_grad_enabled()
    with torch.set_grad_enabled(record_graph):
        return _render(scene, cam, spp, max_depth, seed, chunk, sample_offset,
                       accum, stats, differentiable, sync, mega_mode, device)


def _render(scene, cam, spp, max_depth, seed, chunk, sample_offset, accum,
            stats, differentiable, sync, mega_mode, device):
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene lies on {scene.device}, render asked for {dev}")
    dev = scene.device
    spp = cam.samples_per_pixel if spp is None else spp
    max_depth = cam.max_depth if max_depth is None else max_depth
    w, h = cam.image_width, cam.image_height
    n_pixels = w * h
    _, _, n_virt = ray_layout(w, h, scene_tiled(scene))
    if chunk is None:
        chunk = pick_chunk_size(scene, differentiable=differentiable)
        # Never launch (much) more than the job itself.
        chunk = min(chunk, max(1024, -(-n_virt * spp // 1024) * 1024))
    if chunk >= n_virt:
        # Round to whole samples: chunks then start on sample boundaries
        # (start = sample_offset * n_virt is one; increments keep it), so
        # _render_chunk accumulates by reshape+sum instead of a
        # chunk-sized scatter-add.
        chunk = min(chunk // n_virt, max(spp, 1)) * n_virt

    # The accumulator is updated in place chunk by chunk; a caller's buffer
    # is copied first so that it stays as it was.
    flat = (
        torch.zeros((n_pixels, 3), dtype=torch.float32, device=dev)
        if accum is None
        else torch.as_tensor(accum, dtype=torch.float32, device=dev)
        .reshape(n_pixels, 3).clone()
    )

    # Virtual stream window: samples [sample_offset, sample_offset + spp).
    # The chunk sees a logical spp' = sample_offset + spp and we skip the
    # first sample_offset * n_virt rays.
    logical_spp = sample_offset + spp
    start = sample_offset * n_virt
    total = logical_spp * n_virt

    if mega_mode is None:
        cam_d = dataclasses.replace(cam, max_depth=max_depth)
        mega_mode = wavefront.choose_mega_mode(scene, cam_d, chunk,
                                               differentiable)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if sync:
        _sync()
    t0 = time.perf_counter()
    pos = start
    n_chunks = 0
    overflow = 0
    while pos < total:
        flat, ovf = _render_chunk(
            scene, cam, flat, pos, seed,
            spp=logical_spp, chunk=chunk, max_depth=max_depth,
            differentiable=differentiable, mega_mode=mega_mode,
        )
        overflow += ovf
        pos += chunk
        n_chunks += 1
    if sync:
        _sync()
    dt = time.perf_counter() - t0

    if stats is not None:
        stats.rays_traced += total - start
        if sync:
            stats.wall_seconds += dt
        stats.chunks += n_chunks
        stats.mesh_overflow += overflow
    return flat.reshape(h, w, 3)


def render_image(scene: Scene, cam: Camera, *, spp: Optional[int] = None,
                 max_depth: Optional[int] = None, seed: int = 0,
                 chunk: Optional[int] = None,
                 stats: Optional[RenderStats] = None,
                 differentiable: bool = False,
                 mega_mode: Optional[str] = None, device=None):
    """Render and tonemap to [H, W, 3] floats in [0, 0.999]."""
    spp_eff = cam.samples_per_pixel if spp is None else spp
    accum = render(
        scene, cam, spp=spp_eff, max_depth=max_depth, seed=seed, chunk=chunk,
        stats=stats, differentiable=differentiable, mega_mode=mega_mode,
        device=device,
    )
    return film.tonemap(accum, spp_eff)


PROGRESSIVE_PASSES = "preview", "refining", "final"


def render_progressive(scene: Scene, cam: Camera, *, seed: int = 0,
                       callback=None, differentiable: bool = False,
                       mega_mode: Optional[str] = None, device=None):
    """Progressive schedule: preview = 1 SPP / depth 3, refine = spp/4 /
    depth/2, final = full quality.  Each pass renders afresh and replaces
    the displayed image (the final image is the full-quality pass alone).
    Yields (pass_name, image01) tuples."""
    spp = cam.samples_per_pixel
    schedule = [
        ("preview", 1, 3),
        ("refining", max(spp // 4, 1), max(cam.max_depth // 2, 1)),
        ("final", spp, cam.max_depth),
    ]
    for name, n, depth in schedule:
        img = render_image(scene, cam, spp=n, max_depth=depth, seed=seed,
                           differentiable=differentiable, mega_mode=mega_mode,
                           device=device)
        if callback is not None:
            callback(name, img)
        yield name, img
