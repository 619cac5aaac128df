"""Wavefront path-tracing integrator: dispatch around the megakernel.

The forward render runs the whole bounce loop in one kernel
(``ops/cuda_wavefront``) and applies the miss shader afterwards from the
kernel's miss records, so the kernel needs no environment lookups.

Ported so far: the megakernel branch of ``trace`` and the flat-background
and sky-gradient miss shaders.  The gather integrator (``bounce_step``,
``closest_hit``, ``extract_record``, ``occluded``, ``sample_area_light``)
is the oracle of the gradient slice and comes with it (ROADMAP.md A7); a
scene outside the kernel's gate, or ``differentiable=True``, raises
``NotImplementedError`` until then.
"""

from __future__ import annotations

from ..camera import Camera
from ..core.vec3 import V3
from ..geometry.scene import Scene
from ..ops import cuda_wavefront as mega


def _miss_radiance(scene: Scene, cam: Camera, d: V3, primary) -> V3:
    """Sky gradient / flat background for rays that left the scene.

    ``primary``: bool mask — the lane's miss happened on the first segment
    (used by the phantom-HDRI rule once environments are ported)."""
    if scene.env is not None:
        raise NotImplementedError(
            "HDRI environments are not ported yet (ROADMAP.md A15)")
    if cam.use_sky_gradient:
        unit_d = d.unit()
        a = 0.5 * (unit_d.y + 1.0)
        return V3(
            (1.0 - a) + a * 0.5,
            (1.0 - a) + a * 0.7,
            (1.0 - a) + a * 1.0,
        )
    return V3.full(d.x.shape, cam.background, d.x.dtype, d.x.device)


def choose_mega_mode(scene: Scene, cam, r: int, differentiable: bool) -> str:
    """Megakernel dispatch decision: 'off' | 'single'.

    The JAX package also has 'split', 'compact' (both need the resumable
    kernel, ROADMAP.md B11) and 'image' (ROADMAP.md A16); the port picks
    'single' wherever the kernel applies."""
    if differentiable or not mega.applicable(scene):
        return "off"
    return "single"


def trace(scene: Scene, cam: Camera, o, d, tm, stream, seed, *,
          differentiable: bool = False, mega_mode=None,
          with_stats: bool = False):
    """Radiance for a ray megabatch, on the device the rays lie on.

    o/d: V3 (or [R,3] tensors, converted); tm/stream [R].  Returns V3, or
    (V3, stats dict) when ``with_stats``; ``stats["mesh_overflow"]`` is 0
    here since megakernel scenes have no meshes."""
    if not isinstance(o, V3):
        o = V3.from_rows(o)
    if not isinstance(d, V3):
        d = V3.from_rows(d)
    r = o.x.shape[0]
    dev = o.x.device

    if differentiable:
        raise NotImplementedError(
            "differentiable tracing comes with the gradient slice "
            "(ROADMAP.md A7, A9)")
    if mega_mode is None:
        mega_mode = choose_mega_mode(scene, cam, r, differentiable)
    if mega_mode != "single":
        raise NotImplementedError(
            f"mega_mode {mega_mode!r}: only the single-launch megakernel "
            "path is ported; the gather integrator for scenes outside its "
            "gate comes with the gradient slice (ROADMAP.md A7)")

    radiance, miss_dir, miss_tp, flags = mega.trace_megakernel(
        scene, cam, V3(*(c.contiguous() for c in o)),
        V3(*(c.contiguous() for c in d)), tm.contiguous(), stream, seed)
    missed = (flags & mega.FLAG_MISSED) != 0
    miss_primary = (flags & mega.FLAG_PRIMARY) != 0
    safe_dir = V3.select(missed, miss_dir,
                         V3.full((r,), (0.0, 0.0, 1.0), device=dev))
    miss_col = _miss_radiance(scene, cam, safe_dir, miss_primary)
    rad = radiance + V3.select(missed, miss_tp * miss_col,
                               V3.zeros((r,), device=dev))
    if with_stats:
        return rad, dict(mesh_overflow=0)
    return rad
