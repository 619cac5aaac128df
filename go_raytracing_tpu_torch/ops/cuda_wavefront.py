"""Wavefront megakernel: the whole bounce loop in one CUDA kernel, and its
gradient in two more for each of two tiers (product chain and pathwise).

Counterpart of the JAX package's ``ops/pallas_wavefront.py``.  One launch
of the forward kernel traces a chunk of camera rays through every bounce:
planar + sphere closest hit, box-volume free flight, miss capture for the
deferred miss shader, emission with the allowLightHits bit, scatter for
the five material kinds, checker and marble textures, and NEE toward a
uniformly picked quad light with a shadow sweep and balance-heuristic MIS.
The RNG is the PCG3D counter scheme of ``core/rng.py``, recomputed per ray
inside the kernel.

The resumable kernel (``wavefront_resume``) runs bounces [b_start, b_end)
of a path state carried in and out (21 rows in, 19 out).  It serves the
two-phase modes of ``trace_megakernel``: 'split' re-sorts the survivors of
the first bounces into coherent blocks (``_phase_state_sort``) before the
rest of the loop, 'compact' packs them to the front in their order
(``_compact_partition``).

The record kernel (``wavefront_record``) is the forward once more, and it
also writes each bounce's discrete outcome: the winner's kind and index and
whether the shadow rays (toward the area light, toward the environment)
were blocked.

Environments (``lights/hdri``): the miss shader runs outside the kernels,
once per ray, from the miss records (direction, throughput, flags).  In a
scene with quad lights and an importance-sampled environment a lambertian
hit also samples the environment (HDRI NEE): the sample depends on the
ray's counter alone, so it is drawn in torch (``hdri_rows_for``: alias
table) and streamed into the forward and record kernels as 7 rows a
bounce, and the kernels trace its shadow ray and weigh it.  The replay tier of
``render/grad`` keeps that record and replays it differentiably on the
standard integrator (``integrator/wavefront.trace(decisions=...)``).

The gradient of a chunk's radiance with respect to the texture colours
takes two kernels, for scenes inside ``grad_applicable`` (no scatter
direction depends on a trainable parameter): the gradient forward is the
same bounce loop and also writes a per-bounce stash (``grad_fwd_stash``);
the reverse sweep reads the stash, the loss cotangent and the miss colour
and returns the cotangent of every colour (``grad_rev_stash``).
``ProductChainTrace`` joins the two for ``torch.autograd``.

Scenes with metal or dielectric materials take the pathwise tier
(``grad_pathwise_applicable``; ``pathwise=True`` on both wrappers,
``PathwiseTrace`` for ``torch.autograd``): their scatter directions depend
on fuzz and IOR, and an albedo behind a specular chain is also reached
through hit positions.  Under an environment map the two-phase tiers get
the miss colour, and the pathwise reverse sweep the cotangent of the miss
direction, as per-ray rows computed in torch between the passes
(``MISS_STREAM``); the texel gradients are summed per texel in torch
(``lights/hdri.miss_texel_grad``).

A scene with both an environment and quad lights takes the fused kernel
(``grad_megakernel``, ``wavefront_grad_fused``): forward and pathwise
reverse in one launch, the stash in each thread's local memory, the HDRI
rows in and the cotangent of every bounce's environment sample out
(``eout``), summed per texel in torch.  The gradient forward then stashes, per bounce, the
hit point, the incoming direction, the normal and the material constants
(19 float + 3 int rows, and in a scene with marble a 20th float row, the
winner's marble scale); the reverse sweep carries three adjoints (of the
throughput, the origin and the direction) from the last bounce to the
first, recomputes the random draws and the light sample from the ray's
counter, adds a marble winner's dmarble/dp to the hit point's adjoint, and
also returns the cotangents of fuzz and IOR per material.

What lives here:

  * ``build_tables`` — scene -> PT/ST/VT/LT float tables, same row layout
    as the JAX package's (columns are the real primitive counts, with no
    padding);
  * the kernel wrappers ``wavefront_fwd``, ``wavefront_record``,
    ``wavefront_resume``, ``wavefront_grad_fwd``, ``wavefront_grad_rev``,
    ``wavefront_grad_rev_pathwise`` and ``wavefront_grad_fused`` and, over
    them, ``trace_megakernel`` (``record=True`` for the record,
    ``split=True`` / ``compact=True`` for the two-phase modes),
    ``grad_fwd_stash``, ``grad_rev_stash`` and ``grad_megakernel``.
    A CUDA tensor launches the kernel (``csrc/wavefront.cu``,
    ``csrc/wavefront_grad.cu``, ``csrc/wavefront_grad_pathwise.cu``,
    ``csrc/wavefront_grad_fused.cu``, built at first use by
    ``ops/_build.py``) or raises; a CPU tensor runs the plain version, and
    only because it lies on the CPU.  There is no fallback from one to the
    other;
  * the plain versions ``_wavefront_fwd_plain``, ``_wavefront_record_plain``,
    ``_wavefront_resume_plain``, ``_wavefront_grad_fwd_plain``, ``_wavefront_grad_rev_plain``,
    ``_wavefront_grad_rev_pathwise_plain`` and ``_wavefront_grad_fused_plain``
    — the
    same functions of the same inputs written with ``[R]`` tensors and
    Python loops over primitives and bounces.  The tests use them and the
    chip check holds the kernels against them; nothing on the render path
    calls them when the rays are on a GPU.  ``autograd_colour_grads`` is
    the oracle of the product-chain gradient: ``torch.autograd`` through
    the plain forward with the geometry detached (not an oracle of the
    pathwise tier, where colour gradients also flow through positions).

Sphere culling, the JAX kernel's sweep from SPH_CULL_MIN spheres on: the
forward, record and resumable kernels sweep the spheres of such a scene by
segments under boxes, the segments in groups under boxes, with the brute
sweep's winners (``build_tables`` makes the segments and groups,
``culled_sweep_counts`` mirrors the culled sweep and counts its tests); the
gradient kernels sweep every sphere.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng as rngmod
from ..core import vec as vec_consts
from ..core.segsum import cols_segment_sum
from ..core.vec3 import V3
from ..geometry import packs
from ..lights import hdri as hdri_mod
from ..materials import textures

BIG = float(packs.BIG)
EPS_HIT = float(np.float32(vec_consts.EPS_HIT))
EPS_PARALLEL = float(np.float32(1e-8))
FIREFLY = 20.0

# Table row counts ---------------------------------------------------------
PT_ROWS = 31  # planar: n(3) d q(3) vxw(3) wxu(3) rad2 kind [14 mat rows] + tex id + mat id
ST_ROWS = 23  # sphere: c(3) vel(3) rad2 [14 mat rows] + tex id + mat id
VT_ROWS = 25  # volume: w2l(12) bmin(3) bmax(3) nid mat tex col(3) + tex id
LT_ROWS = 17  # light: q(3) u(3) v(3) n(3) area em(3) + tex id

# From this many spheres on, the renderer orders rays in 32x32 pixel
# buckets (render/renderer.scene_tiled) and the forward, record and
# resumable kernels sweep the spheres culled, both as the JAX package does
# from there on (so both packages give a ray the same stream id).
SPH_CULL_MIN = 64
# The culled sweep's segments and groups (``sphere_segments``): SPH_SEG
# spheres a segment and SEG_GROUP segments a group under the union of their
# boxes (a ray tests a group's segment boxes only when it reaches the
# group's box; 4 and 8 measured fastest of 4 / 6 / 8 and 4 / 8 / 16 on
# ``random`` in B1, B6 and B11, PERF.md; the JAX kernel's 16, one level, was
# chosen on the TPU); a sphere whose radius exceeds SEG_LARGE times the
# median takes a segment of its own under an infinite box, swept by every
# ray (a ground sphere would widen its neighbours' boxes to the whole
# scene), those segments a group of their own; and SEG_PAD, the
# padding a ray gives the other boxes: a grazing ray's computed root can put
# its hit point outside the exact sphere by about 4 ulp |o - c|^2 / r (h^2 -
# a c cancels), and the slab test rounds by a few ulp of |o| + |box|, so a
# box grows by 8 float32 ulps of D (D / r_min + 1), D = |o| + max(|c| + r)
# (``seg_c``, ``seg_inv_r``), for every origin.
SPH_SEG = 4
SEG_GROUP = 8
SEG_LARGE = 8.0
SEG_PAD = float(np.float32(8 * 2.0 ** -23))

# Output flag word bits
FLAG_MISSED = 1
FLAG_PRIMARY = 2
FLAG_ALIVE = 4
FLAG_ALLOW = 8

# Gradient stash: per bounce 12 float rows (throughput at entry T, albedo,
# d(NEE term)/d(albedo) em_su, d(NEE term)/d(emission) alb_su, 3 channels
# each) and 3 int rows (albedo slot = texture * 3 + variant, light slot =
# light texture * 3, mask).  Same rows as the JAX package's product stash.
STASH_F_ROWS = 12
STASH_I_ROWS = 3
SLOT_NONE = -3    # albedo slot of a row without a trainable colour
LSLOT_NONE = -9   # light slot of a row that sampled no light
MK_EMIT = 1         # the ray hit a light and its emission counted
MK_ALIVE_NEXT = 2   # the ray scattered on
MK_LIT = 4          # the ray left the scene at this bounce
MK_CLAMPED = 8      # << channel: the firefly clamp cut the NEE term

# Most textures the reverse kernel's accumulator holds: one block keeps
# 9 floats a texture (3 variants x 3 channels) for each of its 8 warps in
# 48 KB of shared memory (csrc/wavefront_grad.cu, MAX_ACC).
GRAD_MAX_TEX = 170

# Pathwise stash: per bounce 19 float rows (throughput at entry T, atten,
# hit point p, incoming direction d, flipped normal n, 3 each; fuzz, ior,
# dndp = flip / radius for a sphere winner else 0, hit distance t) and 3 int
# rows (albedo slot, material id, mask); in a scene with marble textures a
# 20th float row, the winner's marble scale, which the reverse sweep needs
# for dmarble/dp.  Same rows as the JAX package's pathwise stash.
PW_STASH_F_ROWS = 19
PW_STASH_F_ROWS_MARBLE = 20
PW_STASH_I_ROWS = 3
MSLOT_NONE = -9      # material slot of a row without fuzz / ior (miss, volume)
PW_EMIT = 1          # the ray hit a light and its emission counted
PW_ALIVE_NEXT = 2    # the ray scattered on
PW_LIT = 4           # the ray left the scene at this bounce
PW_BLK_A = 8         # the shadow ray toward the area light was blocked
PW_FRONT = 16        # the ray met the front face (or a volume)
PW_METAL = 32
PW_DIELECTRIC = 64
PW_HIT = 128
PW_USE_MIS = 256     # lambertian hit in a scene with lights: NEE was sampled
PW_BLK_H = 512       # the shadow ray toward the environment sample was blocked
PW_VOLUME = 1024     # a volume won; its index sits in bits 11-12
PW_VOL_SHIFT = 11
PW_MARBLE = 8192     # a marble winner (not a dielectric): dmarble/dp enters

# Most accumulators of the pathwise reverse kernel: 9 a texture and 2 a
# material (fuzz, ior), one row for each of a block's 8 warps in 48 KB of
# shared memory (csrc/wavefront_grad_pathwise.cu, MAX_ACC).
GRAD_PATHWISE_MAX_ACC = 1536

# The record's code byte: winner kind (HIT_NONE 0, sphere 1, planar 2,
# volume 3) in bits 0-1, the area light's shadow ray blocked in bit 2, the
# environment sample's shadow ray blocked in bit 3.  The winner's index is a
# separate int32 row.
DEC_KIND_MASK = 3
DEC_BLK_A = 4
DEC_BLK_H = 8

# HDRI NEE rows a bounce: direction (3), emission (3), solid-angle pdf.
HDRI_ROWS = 7
# The miss shader of the gradient kernels: the flat background, the sky
# gradient, or a per-ray colour (an environment map) computed in torch.
MISS_FLAT, MISS_SKY, MISS_STREAM = 0, 1, 2
# Deepest path the fused gradient kernel takes (its stash is a local array
# of this many bounces; the JAX package's GRAD_DEPTH_MAX).
FUSED_MAX_DEPTH = 50
# Accumulators the fused kernel's shared memory holds (9 a texture, 2 a
# material), as the pathwise reverse kernel's.
GRAD_FUSED_MAX_ACC = 1536

# The resumable kernel's path state: 21 rows in (origin 3, direction 3,
# time, stream, throughput 3, radiance 3, flag word, miss direction 3, miss
# throughput 3), 19 out (radiance 3, miss direction 3, miss throughput 3,
# flag word, origin 3, direction 3, throughput 3), the JAX package's order.
RESUME_IN_ROWS = 21
RESUME_OUT_ROWS = 19
# The megakernel's two-phase modes (``trace_megakernel``).  'split' runs
# bounces [0, SPLIT_AT), re-sorts the survivors by origin cell and direction
# octant, and finishes the loop; ``integrator/wavefront.choose_mega_mode``
# picks it from SPLIT_DEPTH_MIN bounces and SPLIT_R_MIN rays on, the JAX
# package's thresholds.  'compact' (never picked by itself) moves the
# survivors of bounces [0, COMPACT_AT) to the front in their order.  Read at
# call time, so a test may change them.
SPLIT_DEPTH_MIN = 16
SPLIT_R_MIN = 1 << 18
SPLIT_AT = 4
COMPACT_AT = 3

# Kernel launches made by the wrappers (CUDA tensors only).
LAUNCHES = 0                     # wavefront_fwd
LAUNCHES_RECORD = 0              # wavefront_record
LAUNCHES_RESUME = 0              # wavefront_resume
LAUNCHES_GRAD_FWD = 0            # wavefront_grad_fwd, product rows
LAUNCHES_GRAD_REV = 0            # wavefront_grad_rev
LAUNCHES_GRAD_FWD_PATHWISE = 0   # wavefront_grad_fwd(pathwise=True)
LAUNCHES_GRAD_REV_PATHWISE = 0   # wavefront_grad_rev_pathwise
LAUNCHES_GRAD_FUSED = 0          # wavefront_grad_fused


class Tables(NamedTuple):
    pt: torch.Tensor  # [PT_ROWS, max(n_planar, 1)] f32
    st: torch.Tensor  # [ST_ROWS, max(n_sphere, 1)] f32
    vt: torch.Tensor  # [VT_ROWS, max(n_vol, 1)] f32
    lt: torch.Tensor  # [LT_ROWS, max(n_lights, 1)] f32
    n_planar: int
    n_sphere: int
    n_vol: int
    n_lights: int
    # The culled sphere sweep of the forward, record and resumable kernels
    # (SPH_CULL_MIN spheres and more; None and 0 below): the scene indices
    # of the spheres in spatial order, segment s holding
    # seg_order[seg_start[s]:seg_start[s + 1]] under the box seg_box[:, s]
    # (lo xyz, hi xyz over tm in [0, 1]; +-inf for a large sphere), group g
    # holding segments [grp_start[g], grp_start[g + 1]) under the union of
    # their boxes grp_box[:, g]; each ray pads the boxes (SEG_PAD).
    seg_order: torch.Tensor | None = None   # [n_sphere] i16
    seg_start: torch.Tensor | None = None   # [n_seg + 1] i32
    seg_box: torch.Tensor | None = None     # [6, n_seg] f32
    grp_start: torch.Tensor | None = None   # [n_grp + 1] i32
    grp_box: torch.Tensor | None = None     # [6, n_grp] f32
    n_seg: int = 0
    n_grp: int = 0
    seg_c: float = 0.0       # the padding's scale: max |centre| + radius of
    seg_inv_r: float = 0.0   # the boxed spheres, 1 / their least radius
    # a marble texture in the scene (``scene.has_noise``, known on the host):
    # the brute forward and resumable kernels take their marble instantiation
    marble: bool = False


def applicable(scene, max_prims: int = 1024) -> bool:
    """Can this scene run through the megakernel?  Environments are
    admitted: the miss shader runs outside, HDRI NEE comes in as rows; so
    are marble textures, which the kernels evaluate themselves."""
    return (
        not scene.meshes
        and not scene.has_image
        and scene.planar.d.shape[0] <= max_prims
        and scene.spheres.radius.shape[0] <= max_prims
        and scene.n_volumes <= 4
        and scene.n_lights <= 8
        # the in-kernel volume window is box-only
        and (scene.n_volumes == 0
             or bool((scene.volumes.kind == packs.VOL_BOX).all()))
    )


def grad_applicable(scene, max_depth: int) -> bool:
    """Can the product-chain gradient kernels take this scene?  On top of
    ``applicable``: no metal and no dielectric material, so that no scatter
    direction depends on a trainable parameter (fuzz, IOR); the gradients
    of fuzz, ior and atlas are then zero by structure and the adjoint of
    the path is an exact product-chain reverse sweep.  Marble textures are
    admitted, as in the JAX package: they have no trainable parameter and,
    with every hit point fixed, their value is a constant of the path (a
    marble winner's albedo slot is the null slot).  The number of
    textures is bounded by the reverse kernel's accumulator; the depth is
    bounded by memory alone (``render/grad.render_grad`` budgets it)."""
    if not applicable(scene) or max_depth < 1:
        return False
    if scene.env is not None and scene.n_lights > 0:
        return False   # HDRI NEE's texel cotangents: the fused kernel
    kinds = scene.materials.kind
    if bool(((kinds == 1) | (kinds == 2)).any()):   # metal / dielectric
        return False
    return int(scene.textures.color.shape[0]) <= GRAD_MAX_TEX


def grad_pathwise_applicable(scene, max_depth: int) -> bool:
    """Can the pathwise gradient kernels take this scene?  ``applicable``,
    at least one bounce, and 9 accumulators a texture plus 2 a material
    within the reverse kernel's shared memory.  Metal, dielectric, volumes,
    environments and marble textures are admitted; a scene with an
    environment and quad lights takes the fused kernel
    (``grad_fused_applicable``), not the two-phase route.  Where
    ``grad_applicable`` holds too, the product-chain tier is the one to
    use: its stash is lighter.

    Behind metal or glass a marble's value moves with the hit point: the
    stash then keeps the winner's marble scale (row 19, mask bit
    ``PW_MARBLE``) and the reverse sweep carries dmarble/dp into the hit
    point's adjoint, as the JAX package's pathwise kernels do."""
    if not applicable(scene) or max_depth < 1:
        return False
    n_tex = int(scene.textures.color.shape[0])
    n_mat = int(scene.materials.kind.shape[0])
    return 9 * n_tex + 2 * n_mat <= GRAD_PATHWISE_MAX_ACC


def grad_two_phase_ok(scene, max_depth: int) -> bool:
    """Can the gradient run as stash-writing forward, then reverse sweep?
    Every scene either tier of gradient kernels takes, except one with an
    environment and quad lights: the texel cotangents of its environment
    samples come out of the fused kernel (``grad_megakernel``)."""
    if scene.env is not None and scene.n_lights > 0:
        return False
    return (grad_applicable(scene, max_depth)
            or grad_pathwise_applicable(scene, max_depth))


def grad_fused_applicable(scene, max_depth: int) -> bool:
    """Can the fused gradient kernel take this scene?  The pathwise gate
    (marble textures among it: the fused kernel's reverse sweep is the
    pathwise one) and at most ``FUSED_MAX_DEPTH`` bounces (its stash is a
    local array)."""
    return (grad_pathwise_applicable(scene, max_depth)
            and max_depth <= FUSED_MAX_DEPTH)


# -----------------------------------------------------------------------------
# Table packing
# -----------------------------------------------------------------------------

def _stack_rows(rows, n_rows, n, device):
    if n == 0:
        return torch.zeros((n_rows, 1), dtype=torch.float32, device=device)
    return torch.stack([r.to(torch.float32) for r in rows], dim=0).contiguous()


def _mat_rows(materials, textures, mat_ids):
    mat_ids = mat_ids.long()
    tex = materials.tex[mat_ids].long()
    texkind = textures.kind[tex]
    scale = torch.where(texkind == 1, textures.inv_scale[tex],
                        textures.noise_scale[tex])
    return [
        materials.kind[mat_ids], texkind,
        materials.fuzz[mat_ids], materials.ior[mat_ids],
        textures.color[:, 0][tex], textures.color[:, 1][tex], textures.color[:, 2][tex],
        textures.even_color[:, 0][tex], textures.even_color[:, 1][tex], textures.even_color[:, 2][tex],
        textures.odd_color[:, 0][tex], textures.odd_color[:, 1][tex], textures.odd_color[:, 2][tex],
        scale,
        tex,       # gradient kernels: cotangent routing
        mat_ids,   # gradient kernels: fuzz/ior cotangent routing
    ]


def _spread_bits(v, bits):
    """Integer tensor -> its low ``bits`` bits at every third position."""
    out = torch.zeros_like(v)
    for b in range(bits):
        out = out | (((v >> b) & 1) << (3 * b))
    return out


def _boxes(seg_id, n, lo, hi):
    """[6, n] boxes: lo xyz, hi xyz of the rows of ``lo`` / ``hi`` [m, 3] by
    their segment ``seg_id`` [m]."""
    box = torch.empty((6, n), dtype=torch.float32, device=lo.device)
    for i in range(3):
        box[i] = torch.full_like(box[i], float("inf")).scatter_reduce(
            0, seg_id, lo[:, i], "amin")
        box[3 + i] = torch.full_like(box[i], -float("inf")).scatter_reduce(
            0, seg_id, hi[:, i], "amax")
    return box.contiguous()


def _runs(sizes, device):
    """Run lengths -> (starts [len + 1] i32, each element's run id)."""
    start = torch.tensor([0] + sizes, dtype=torch.int64, device=device).cumsum(0)
    ids = torch.repeat_interleave(torch.arange(len(sizes), device=device),
                                  torch.tensor(sizes, device=device))
    return start.to(torch.int32), ids


def sphere_segments(spheres):
    """The culled sweep's tables of a sphere pack, on its device: the
    ``Tables`` fields seg_order, seg_start, seg_box, grp_start, grp_box,
    n_seg, n_grp, seg_c and seg_inv_r, as a dict.  Large spheres (radius
    over SEG_LARGE times the median) come first, a segment each under an
    infinite box, those segments one group; the others follow in the order
    of a 10-bit-an-axis Morton key of their motion midpoint, SPH_SEG to a
    segment under a box that holds them over the whole motion sweep (tm in
    [0, 1]), SEG_GROUP segments in order to a group under the union of their
    boxes.  seg_c and seg_inv_r scale the padding a ray gives the boxes
    (SEG_PAD).  seg_order is int16 (the kernels' gate takes 1,024 spheres):
    two bytes a sphere keep ``random``'s tables in shared memory small
    enough for six blocks an SM."""
    r = spheres.radius.to(torch.float32)
    n = int(r.shape[0])
    c0 = spheres.center.to(torch.float32)
    c1 = c0 + spheres.velocity.to(torch.float32)
    large = r > SEG_LARGE * r.median()
    small = ~large
    inf = torch.full_like(c0, float("inf"))
    lo = torch.where(large[:, None], -inf, torch.minimum(c0, c1) - r[:, None])
    hi = torch.where(large[:, None], inf, torch.maximum(c0, c1) + r[:, None])
    reach = torch.maximum(torch.linalg.vector_norm(c0, dim=1),
                          torch.linalg.vector_norm(c1, dim=1)) + r
    seg_c = float(reach[small].max())
    seg_inv_r = float(1.0 / r[small].min())

    mid = c0 + 0.5 * spheres.velocity.to(torch.float32)
    mn = mid[small].min(dim=0).values
    span = torch.clamp_min(mid[small].max(dim=0).values - mn, 1e-6)
    q = torch.clamp(((mid - mn) / span * 1023.999).long(), 0, 1023)
    key = (_spread_bits(q[:, 0], 10) | (_spread_bits(q[:, 1], 10) << 1)
           | (_spread_bits(q[:, 2], 10) << 2))
    key = torch.where(large, -1, key)           # large spheres first
    order = torch.sort(key, stable=True).indices
    n_large = int(large.sum())
    full, rest = divmod(n - n_large, SPH_SEG)
    sizes = [1] * n_large + [SPH_SEG] * full + ([rest] if rest else [])
    seg_start, seg_id = _runs(sizes, r.device)
    seg_box = _boxes(seg_id, len(sizes), lo[order], hi[order])
    full, rest = divmod(len(sizes) - n_large, SEG_GROUP)
    groups = [n_large] * (n_large > 0) + [SEG_GROUP] * full + ([rest] if rest else [])
    grp_start, grp_id = _runs(groups, r.device)
    grp_box = _boxes(grp_id, len(groups), seg_box[:3].T, seg_box[3:].T)
    return dict(seg_order=order.to(torch.int16), seg_start=seg_start, seg_box=seg_box,
                grp_start=grp_start, grp_box=grp_box, n_seg=len(sizes), n_grp=len(groups),
                seg_c=seg_c, seg_inv_r=seg_inv_r)


def build_tables(scene) -> Tables:
    """Scene -> (PT, ST, VT, LT) tables + counts, on the scene's device,
    and in a scene of SPH_CULL_MIN spheres and more the culled sweep's
    segments and groups (``sphere_segments``).  Spheres keep the order they
    were built in."""
    dev = scene.device
    p = scene.planar
    n_planar = int(p.d.shape[0])
    rows = []
    if n_planar:
        vxw = torch.linalg.cross(p.v, p.w, dim=-1)
        wxu = torch.linalg.cross(p.w, p.u, dim=-1)
        rows = [
            p.normal[:, 0], p.normal[:, 1], p.normal[:, 2], p.d,
            p.q[:, 0], p.q[:, 1], p.q[:, 2],
            vxw[:, 0], vxw[:, 1], vxw[:, 2],
            wxu[:, 0], wxu[:, 1], wxu[:, 2],
            p.radius * p.radius, p.kind,
        ] + _mat_rows(scene.materials, scene.textures, p.mat)
    pt = _stack_rows(rows, PT_ROWS, n_planar, dev)

    s = scene.spheres
    n_sphere = int(s.radius.shape[0])
    rows = []
    if n_sphere:
        rows = [
            s.center[:, 0], s.center[:, 1], s.center[:, 2],
            s.velocity[:, 0], s.velocity[:, 1], s.velocity[:, 2],
            s.radius * s.radius,
        ] + _mat_rows(scene.materials, scene.textures, s.mat)
    st = _stack_rows(rows, ST_ROWS, n_sphere, dev)

    v = scene.volumes
    n_vol = scene.n_volumes
    rows = []
    if n_vol:
        m = v.world_to_local.reshape(n_vol, 12)
        vmat = v.mat.long()
        vtex = scene.materials.tex[vmat].long()
        rows = (
            [m[:, i] for i in range(12)]
            + [v.box_min[:, i] for i in range(3)]
            + [v.box_max[:, i] for i in range(3)]
            + [v.neg_inv_density, scene.materials.kind[vmat],
               scene.textures.kind[vtex]]
            + [scene.textures.color[:, i][vtex] for i in range(3)]
            + [vtex]
        )
    vt = _stack_rows(rows, VT_ROWS, n_vol, dev)

    n_lights = scene.n_lights
    rows = []
    if n_lights:
        ltex = scene.materials.tex[scene.light_mat.long()].long()
        rows = (
            [scene.light_q[:, i] for i in range(3)]
            + [scene.light_u[:, i] for i in range(3)]
            + [scene.light_v[:, i] for i in range(3)]
            + [scene.light_normal[:, i] for i in range(3)]
            + [scene.light_area]
            + [scene.textures.color[:, i][ltex] for i in range(3)]
            + [ltex]
        )
    lt = _stack_rows(rows, LT_ROWS, n_lights, dev)
    tb = Tables(pt, st, vt, lt, n_planar, n_sphere, n_vol, n_lights,
                marble=bool(scene.has_noise))
    if n_sphere >= SPH_CULL_MIN:
        tb = tb._replace(**sphere_segments(s))
    return tb


# -----------------------------------------------------------------------------
# Plain PyTorch version
# -----------------------------------------------------------------------------
# Written to repeat the kernel's arithmetic operation for operation (same
# order of products and sums).  The kernel is built without fused
# multiply-add contraction (ops/_build.py), so on one GPU the two give the
# same numbers; a contracted build differs by an ulp here and there, which
# is enough to flip a discrete decision on some rays.

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _planar_sweep(tb, kinds, o, d, t_best, hitk, hidx):
    pt = tb.pt
    for j, kind in enumerate(kinds):
        nx, ny, nz = pt[0, j], pt[1, j], pt[2, j]
        denom = d[0] * nx + d[1] * ny + d[2] * nz
        not_par = torch.abs(denom) >= EPS_PARALLEL
        t = (pt[3, j] - (o[0] * nx + o[1] * ny + o[2] * nz)) / torch.where(
            not_par, denom, 1.0)
        if kind == packs.KIND_PLANE:
            t_ok = (t > EPS_HIT) & (t < t_best)
        else:
            t_ok = (t >= EPS_HIT) & (t <= t_best)
        rx = o[0] + t * d[0] - pt[4, j]
        ry = o[1] + t * d[1] - pt[5, j]
        rz = o[2] + t * d[2] - pt[6, j]
        alpha = rx * pt[7, j] + ry * pt[8, j] + rz * pt[9, j]
        beta = rx * pt[10, j] + ry * pt[11, j] + rz * pt[12, j]
        if kind == packs.KIND_QUAD:
            interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
        elif kind == packs.KIND_TRI:
            interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (alpha + beta <= 1.0)
        elif kind == packs.KIND_CIRCLE:
            interior = (rx * rx + ry * ry + rz * rz) <= pt[13, j]
        else:
            interior = torch.ones_like(not_par)
        upd = not_par & t_ok & interior
        t_best = torch.where(upd, t, t_best)
        hitk = torch.where(upd, 2, hitk)
        hidx = torch.where(upd, j, hidx)
    return t_best, hitk, hidx


def _sphere_sweep(tb, o, d, tmv, t_best, hitk, hidx):
    st = tb.st
    if not tb.n_sphere:
        return t_best, hitk, hidx
    a_coef = _dot3(d, d)
    inv_a = 1.0 / a_coef
    for j in range(tb.n_sphere):
        ocx = (st[0, j] + tmv * st[3, j]) - o[0]
        ocy = (st[1, j] + tmv * st[4, j]) - o[1]
        ocz = (st[2, j] + tmv * st[5, j]) - o[2]
        h = d[0] * ocx + d[1] * ocy + d[2] * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - st[6, j]
        disc = h * h - a_coef * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        r0 = (h - sq) * inv_a
        r1 = (h + sq) * inv_a
        ok0 = (r0 > EPS_HIT) & (r0 < t_best)
        ok1 = (r1 > EPS_HIT) & (r1 < t_best)
        root = torch.where(ok0, r0, r1)
        upd = (disc >= 0.0) & (ok0 | ok1)
        t_best = torch.where(upd, root, t_best)
        hitk = torch.where(upd, 1, hitk)
        hidx = torch.where(upd, j, hidx)
    return t_best, hitk, hidx


def _box_reached(box, k, o_lo, o_hi, inv_d, t_best):
    """Do the rays reach box k of a [6, n] table (nested lists), grown by
    their padding, within (EPS_HIT, t_best]?  ``box_reached`` in
    csrc/wavefront_trace.cuh."""
    near = torch.full_like(t_best, EPS_HIT)
    far = t_best
    for i in range(3):
        ta = (box[i][k] - o_lo[i]) * inv_d[i]
        tb_ = (box[3 + i][k] - o_hi[i]) * inv_d[i]
        near = torch.maximum(near, torch.minimum(ta, tb_))
        far = torch.minimum(far, torch.maximum(ta, tb_))
    return near <= far


def _warp_lanes(mask):
    """32 for each warp of 32 consecutive rays with a lane set in ``mask``:
    the lane slots a warp spends when one of its lanes takes a branch."""
    warps = torch.nn.functional.pad(mask, (0, -mask.shape[0] % 32)).reshape(-1, 32)
    return int(warps.any(dim=1).sum()) * 32


def _sphere_sweep_culled(tb, o, d, tmv, t_best, hitk, hidx, counts, kind,
                         any_hit=False):
    """The culled sphere sweep of the forward, record and resumable kernels
    (``sphere_sweep_culled`` in csrc/wavefront_trace.cuh), a mirror that
    counts its work: groups in order, a group's box (grown by the ray's
    padding) tested by every ray that sweeps (a ray with t_best above
    EPS_HIT: dead and inactive lanes sweep with 0), its segments' boxes by
    the rays that reach it, a segment's spheres by the rays that reach the
    segment's box, each within (EPS_HIT, t_best], the least (t, scene index)
    winning.  The winners are the brute sweep's (``_sphere_sweep``).  Adds to
    ``counts`` (``SWEEP_COUNTS``) each ray's own tests, what the inputs need:
    ``<kind>_group_box_tests``, ``<kind>_box_tests`` (segment boxes),
    ``<kind>_sphere_tests``; and the lane slots a warp of 32 consecutive rays
    spends, its lanes running the loop together: ``<kind>_warp_box_tests``
    (32 a segment box of a group one lane reaches) and
    ``<kind>_warp_sphere_tests`` (32 a sphere of a segment one lane
    reaches).  ``any_hit``: a ray stops at its first hit (the shadow
    sweep)."""
    st = tb.st
    a_coef = _dot3(d, d)
    inv_a = 1.0 / a_coef
    inv_d = [1.0 / torch.where(torch.abs(d[i]) < 1e-12,
                               torch.where(d[i] < 0, -1e-12, 1e-12), d[i])
             for i in range(3)]
    dist = torch.sqrt(_dot3(o, o)) + tb.seg_c
    pad = SEG_PAD * dist * (dist * tb.seg_inv_r + 1.0)
    o_lo = [o[i] + pad for i in range(3)]
    o_hi = [o[i] - pad for i in range(3)]
    seg_box, grp_box = tb.seg_box.tolist(), tb.grp_box.tolist()
    start, grp_start = tb.seg_start.tolist(), tb.grp_start.tolist()
    order = tb.seg_order.tolist()
    sweeps = t_best > EPS_HIT
    found = torch.zeros_like(sweeps)
    for g in range(tb.n_grp):
        active = sweeps & ~found if any_hit else sweeps
        greach = active & _box_reached(grp_box, g, o_lo, o_hi, inv_d, t_best)
        counts[f"{kind}_group_box_tests"] += int(active.sum())
        if not bool(greach.any()):
            continue
        g_lanes = _warp_lanes(greach)
        for sg in range(grp_start[g], grp_start[g + 1]):
            active = greach & ~found if any_hit else greach
            reach = active & _box_reached(seg_box, sg, o_lo, o_hi, inv_d, t_best)
            size = start[sg + 1] - start[sg]
            counts[f"{kind}_box_tests"] += int(active.sum())
            counts[f"{kind}_warp_box_tests"] += g_lanes
            counts[f"{kind}_sphere_tests"] += int(reach.sum()) * size
            counts[f"{kind}_warp_sphere_tests"] += _warp_lanes(reach) * size
            if not bool(reach.any()):
                continue
            for j in order[start[sg]:start[sg + 1]]:
                ocx = (st[0, j] + tmv * st[3, j]) - o[0]
                ocy = (st[1, j] + tmv * st[4, j]) - o[1]
                ocz = (st[2, j] + tmv * st[5, j]) - o[2]
                h = d[0] * ocx + d[1] * ocy + d[2] * ocz
                c = ocx * ocx + ocy * ocy + ocz * ocz - st[6, j]
                disc = h * h - a_coef * c
                sq = torch.sqrt(torch.clamp_min(disc, 0.0))
                r0 = (h - sq) * inv_a
                r1 = (h + sq) * inv_a
                cand = torch.where(r0 > EPS_HIT, r0, r1)
                upd = (reach & (disc >= 0.0) & (cand > EPS_HIT)
                       & ((cand < t_best) | (found & (cand == t_best) & (hidx > j))))
                t_best = torch.where(upd, cand, t_best)
                hitk = torch.where(upd, 1, hitk)
                hidx = torch.where(upd, j, hidx)
                found = found | upd
    return t_best, hitk, hidx


def _volume_scatter(tb, o, d, t_cap, vi, u):
    vt = tb.vt
    near = torch.full_like(t_cap, -BIG)
    far = torch.full_like(t_cap, BIG)
    for i in range(3):
        ol = (vt[4 * i + 0, vi] * o[0] + vt[4 * i + 1, vi] * o[1]
              + vt[4 * i + 2, vi] * o[2] + vt[4 * i + 3, vi])
        dl = (vt[4 * i + 0, vi] * d[0] + vt[4 * i + 1, vi] * d[1]
              + vt[4 * i + 2, vi] * d[2])
        safe = torch.where(torch.abs(dl) < 1e-12,
                           torch.where(dl < 0, -1e-12, 1e-12), dl)
        inv = 1.0 / safe
        ta = (vt[12 + i, vi] - ol) * inv
        tb_ = (vt[15 + i, vi] - ol) * inv
        near = torch.maximum(near, torch.minimum(ta, tb_))
        far = torch.minimum(far, torch.maximum(ta, tb_))
    crosses = far > near
    t0c = torch.clamp_min(near, EPS_HIT)
    t1c = torch.minimum(far, t_cap)
    inside = crosses & (t0c < t1c)
    ray_len = torch.sqrt(torch.clamp_min(_dot3(d, d), 1e-20))
    dist_inside = (t1c - t0c) * ray_len
    # 1e-38 is a float32 denormal: the floor keeps log finite at u == 0
    hit_dist = vt[18, vi] * torch.log(torch.clamp_min(u, 1e-38))
    accept = inside & (hit_dist <= dist_inside)
    return accept, t0c + hit_dist / ray_len


def _occluded(tb, kinds, o, d, t_cap, seed, stream, bounce, purpose_base,
              counts=None):
    """``counts``: sweep the spheres culled and count (``_sphere_sweep_culled``)."""
    zero_i = torch.zeros_like(stream, dtype=torch.int32)
    t_best, hitk, _ = _planar_sweep(tb, kinds, o, d, t_cap, zero_i, zero_i)
    if counts is None:
        t_best, hitk, _ = _sphere_sweep(tb, o, d, torch.zeros_like(t_cap),
                                        t_best, hitk, zero_i)
    else:
        t_best, hitk, _ = _sphere_sweep_culled(tb, o, d, torch.zeros_like(t_cap), t_best,
                                               hitk, zero_i, counts, "shadow", any_hit=True)
    blocked = hitk > 0
    for vi in range(tb.n_vol):
        u = rngmod.uniform(seed, stream, bounce, purpose_base + 32 * vi)
        acc, _ = _volume_scatter(tb, o, d, torch.minimum(t_best, t_cap), vi, u)
        blocked = blocked | acc
    return blocked


def _has_noise(tb: Tables) -> bool:
    """Does a primitive or volume of the tables carry a marble texture?"""
    return bool((tb.pt[16, :tb.n_planar] == 2.0).any()
                or (tb.st[8, :tb.n_sphere] == 2.0).any()
                or (tb.vt[20, :tb.n_vol] == 2.0).any())


def brute_route(tb: Tables) -> str:
    """The instantiation of the forward and the resumable kernel that the
    tables take: "culled" where they have sphere segments (``SPH_CULL_MIN``
    spheres and more), else the brute sweep's, "marble" in a scene with a
    marble texture (the marble across the warp where few lanes hit it) and
    "brute" without.  Read on the host: a launch waits on nothing."""
    if tb.n_seg > 0:
        return "culled"
    return "marble" if tb.marble else "brute"


def _bounce_loop(tb: Tables, o, d, tm, stream, seed, max_depth, stash=None,
                 pathwise=False, record=None, hdri=None, start=None, counts=None):
    """The bounce loop on component lists.  Returns ([9, R] f32 rows:
    radiance, miss direction, miss throughput; [R] i32 flag word).

    ``start``: (b_start, throughput, radiance, flags, miss direction, miss
    throughput), a path state carried in (``wavefront_resume``): the loop
    then runs bounces [b_start, max_depth) from it and also returns the
    rays' origin, direction and throughput after them, (o, d, tp) lists.
    Every random draw is keyed on the absolute bounce.

    ``hdri``: [(max_depth - b_start) * 7, R] rows of HDRI NEE
    (``hdri_rows_for``), or None.

    ``record``: (code [D, R] u8, idx [D, R] i32) holding zeros; the outcome
    of every bounce a ray enters is written into it (``DEC_*``).

    ``stash``: (stash_f [D, 12, R] f32, stash_i [D, 3, R] i32) holding inert
    rows; the rows of every bounce a ray enters are written into it.  With
    ``pathwise`` the stash is [D, 19 or 20, R] and [D, 3, R] in the pathwise
    layout (``pathwise_stash_rows``).  The radiance does not depend on either.

    ``counts``: a dict of zeros; the sphere sweeps (closest hit and shadow)
    are then the culled sweep of the forward, record and resumable kernels,
    which counts its tests into it (``_sphere_sweep_culled``; tables with
    segments only)."""
    f32 = torch.float32
    zero = torch.zeros_like(tm)
    one = torch.ones_like(tm)
    o, d = list(o), list(d)
    if start is None:
        b_start = 0
        tp = [one.clone(), one.clone(), one.clone()]
        rad = [zero.clone(), zero.clone(), zero.clone()]
        m_dir = [zero.clone(), zero.clone(), zero.clone()]
        m_tp = [zero.clone(), zero.clone(), zero.clone()]
        flags0 = torch.full_like(stream, FLAG_ALIVE | FLAG_ALLOW, dtype=torch.int32)
    else:
        b_start, tp, rad, flags0, m_dir, m_tp = start
        tp, rad, m_dir, m_tp = list(tp), list(rad), list(m_dir), list(m_tp)
    alive = (flags0 & FLAG_ALIVE) != 0
    allow = (flags0 & FLAG_ALLOW) != 0
    missed = (flags0 & FLAG_MISSED) != 0
    m_prim = (flags0 & FLAG_PRIMARY) != 0
    zero_i = torch.zeros_like(stream, dtype=torch.int32)
    use_nee = tb.n_lights > 0
    noise = _has_noise(tb)
    two_pi = float(np.float32(2.0 * np.pi))
    inv_pi = float(np.float32(1.0 / np.pi))
    # planar kinds as host ints: one read, not one per primitive and sweep
    kinds = [int(k) for k in tb.pt[14, :tb.n_planar].tolist()]

    for bounce in range(b_start, max_depth):
        if not bool(alive.any()):
            # every ray died before the last bounce: a further bounce would
            # leave allowLightHits set on all of them
            allow = torch.ones_like(alive)
            break
        # dead lanes sweep with t_cap = 0 and so find nothing
        t = torch.where(alive, BIG, 0.0).to(f32)
        t, hitk, hidx = _planar_sweep(tb, kinds, o, d, t, zero_i, zero_i)
        if counts is None:
            t, hitk, hidx = _sphere_sweep(tb, o, d, tm, t, hitk, hidx)
        else:
            t, hitk, hidx = _sphere_sweep_culled(tb, o, d, tm, t, hitk, hidx, counts,
                                                 "closest")
        hit = (hitk > 0) & alive

        is_vol = torch.zeros_like(alive)
        vwin = zero_i
        for vi in range(tb.n_vol):
            u = rngmod.uniform(seed, stream, bounce, 64 + 32 * vi)
            t_limit = torch.where(hit, t, BIG)
            acc, t_v = _volume_scatter(tb, o, d, t_limit, vi, u)
            win = acc & (~hit | (t_v < t))
            t = torch.where(win, t_v, t)
            hit = hit | win
            is_vol = is_vol | win
            vwin = torch.where(win, vi, vwin)
            hitk = torch.where(win, 3, hitk)

        lit = alive & ~hit
        for c in range(3):
            m_dir[c] = torch.where(lit, d[c], m_dir[c])
            m_tp[c] = torch.where(lit, tp[c], m_tp[c])
        if bounce == 0:
            m_prim = m_prim | lit
        missed = missed | lit

        t_rec = torch.where(hit, t, 1.0)
        p = [o[c] + t_rec * d[c] for c in range(3)]

        # winner constants, gathered by index (the kernel reads them from
        # its tables once the sweeps are over)
        is_sphere = hitk == 1
        is_planar = hitk == 2
        pj = torch.where(is_planar, hidx, 0).long()
        sj = torch.where(is_sphere, hidx, 0).long()
        vj = vwin.long()

        def pick(prow, srow, vval):
            out = torch.where(is_vol, vval, zero) if tb.n_vol else zero
            if tb.n_planar:
                out = torch.where(is_planar, tb.pt[prow][pj], out)
            if tb.n_sphere:
                out = torch.where(is_sphere, tb.st[srow][sj], out)
            return out

        vrow = (lambda r: tb.vt[r][vj]) if tb.n_vol else (lambda r: zero)
        matkind = pick(15, 7, vrow(19))
        texkind = pick(16, 8, vrow(20))
        fuzz = pick(17, 9, zero)
        ior = torch.clamp_min(pick(18, 10, one), 1e-3)
        col = [pick(19 + c, 11 + c, vrow(21 + c)) for c in range(3)]
        even = [pick(22 + c, 14 + c, zero) for c in range(3)]
        odd = [pick(25 + c, 17 + c, zero) for c in range(3)]
        inv_scale = pick(28, 20, zero)

        if tb.n_sphere:
            sc = [tb.st[c][sj] + tm * tb.st[3 + c][sj] for c in range(3)]
            inv_rad = 1.0 / torch.sqrt(torch.clamp_min(tb.st[6][sj], 1e-20))
        outn = []
        for c in range(3):
            n_c = tb.pt[c][pj] if tb.n_planar else zero
            n_c = torch.where(is_planar, n_c, zero)
            if tb.n_sphere:
                n_c = torch.where(is_sphere, (p[c] - sc[c]) * inv_rad, n_c)
            outn.append(n_c)
        ddn = _dot3(d, outn)
        front = (ddn < 0.0) | is_vol
        flip = torch.where(front, 1.0, -1.0)
        nrm = [outn[c] * flip for c in range(3)]
        nrm[0] = torch.where(is_vol, one, nrm[0])
        nrm[1] = torch.where(is_vol, zero, nrm[1])
        nrm[2] = torch.where(is_vol, zero, nrm[2])

        lat = (torch.floor(inv_scale * p[0] + 1e-4)
               + torch.floor(inv_scale * p[1] + 1e-4)
               + torch.floor(inv_scale * p[2] + 1e-4))
        is_even = lat - 2.0 * torch.floor(lat * 0.5) == 0.0
        is_checker = texkind == 1.0
        albedo = [
            torch.where(is_checker, torch.where(is_even, even[c], odd[c]), col[c])
            for c in range(3)
        ]
        if noise:
            # the marble's scale sits in the checker's scale row
            marble = textures.marble(V3(*p), inv_scale)
            albedo = [torch.where(texkind == 2.0, marble, albedo[c]) for c in range(3)]

        su1, su2, _ = rngmod.uniform3(seed, stream, bounce, rngmod.SCATTER_U)
        zr = 1.0 - 2.0 * su1
        phi = two_pi * su2
        rrr = torch.sqrt(torch.clamp_min(1.0 - zr * zr, 0.0))
        ru = [rrr * torch.cos(phi), rrr * torch.sin(phi), zr]
        ufr = rngmod.uniform(seed, stream, bounce, rngmod.FRESNEL)

        lam = [nrm[c] + ru[c] for c in range(3)]
        near0 = ((torch.abs(lam[0]) < 1e-8) & (torch.abs(lam[1]) < 1e-8)
                 & (torch.abs(lam[2]) < 1e-8))
        lam = [torch.where(near0, nrm[c], lam[c]) for c in range(3)]

        ddn_f = _dot3(d, nrm)
        rfl = [d[c] - nrm[c] * (2.0 * ddn_f) for c in range(3)]
        rlen = torch.sqrt(torch.clamp_min(_dot3(rfl, rfl), 1e-20))
        met = [rfl[c] / rlen + ru[c] * fuzz for c in range(3)]
        metal_ok = _dot3(met, nrm) > 0.0

        ri = torch.where(front, 1.0 / ior, ior)
        dlen = torch.sqrt(torch.clamp_min(_dot3(d, d), 1e-20))
        ud = [d[c] / dlen for c in range(3)]
        udn = _dot3(ud, nrm)
        cos_t = torch.clamp_max(-udn, 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        cannot = ri * sin_t > 1.0
        r0s = (1.0 - ri) / (1.0 + ri)
        r0s = r0s * r0s
        omc = torch.clamp_min(1.0 - cos_t, 0.0)
        omc2 = omc * omc
        schl = r0s + (1.0 - r0s) * omc2 * omc2 * omc
        do_refl = cannot | (schl > ufr)
        perp = [(ud[c] + nrm[c] * cos_t) * ri for c in range(3)]
        parl = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - _dot3(perp, perp)), 1e-20))
        refr = [perp[c] + nrm[c] * parl for c in range(3)]
        drefl = [ud[c] - nrm[c] * (2.0 * udn) for c in range(3)]
        diel = [torch.where(do_refl, drefl[c], refr[c]) for c in range(3)]

        is_lam = matkind == 0.0
        is_met = matkind == 1.0
        is_die = matkind == 2.0
        is_light = matkind == 3.0
        new_d = [
            torch.where(is_lam, lam[c],
                        torch.where(is_met, met[c],
                                    torch.where(is_die, diel[c], ru[c])))
            for c in range(3)
        ]
        atten = [torch.where(is_die, one, albedo[c]) for c in range(3)]
        scattered = ~is_light & ((is_met & metal_ok) | ~is_met)

        emit_mask = alive & hit & allow & is_light
        for c in range(3):
            rad[c] = rad[c] + torch.where(emit_mask, tp[c] * albedo[c], 0.0)

        use_mis = (alive & hit & is_lam) if use_nee else torch.zeros_like(alive)
        blk_a = blk_h = torch.zeros_like(alive)
        if stash is not None and not pathwise:
            em_su = [zero, zero, zero]
            alb_su = [zero, zero, zero]
            clamped = [torch.zeros_like(alive)] * 3
            lslot = torch.full_like(zero_i, LSLOT_NONE)
        if use_nee:
            # The clamp floors (1e-20, 1e-12, cos_l < 1e-3) are the JAX
            # kernel's: the gradient kernels differentiate against them.
            nl = tb.n_lights
            up = rngmod.uniform(seed, stream, bounce, rngmod.LIGHT_PICK)
            li = torch.clamp_max(torch.floor(up * float(nl)), float(nl - 1)).long()
            ua, ub, _ = rngmod.uniform3(seed, stream, bounce, rngmod.LIGHT_U)
            lsel = [tb.lt[f][li] for f in range(LT_ROWS)]
            lp = [lsel[c] + ua * lsel[3 + c] + ub * lsel[6 + c] for c in range(3)]
            tl = [lp[c] - p[c] for c in range(3)]
            dist = torch.sqrt(torch.clamp_min(_dot3(tl, tl), 1e-20))
            ld = [tl[c] / dist for c in range(3)]
            cos_th = _dot3(nrm, ld)
            facing = cos_th > 0.0
            # inactive shadow lanes sweep with t_cap = 0 and find nothing
            shadow_cap = torch.where(use_mis & facing, dist - EPS_HIT, zero)
            blocked = _occluded(tb, kinds, p, ld, shadow_cap, seed, stream,
                                bounce, 65, counts)
            blk_a = blocked
            cos_l = torch.abs(-(lsel[9] * ld[0] + lsel[10] * ld[1] + lsel[11] * ld[2]))
            grazing = cos_l < 1e-3
            pdf_l = (dist * dist) / torch.clamp_min(cos_l * lsel[12], 1e-20)
            pdf_b = torch.clamp_min(cos_th, 0.0) * inv_pi
            weight = pdf_l / torch.clamp_min(pdf_l + pdf_b, 1e-20)
            scale = cos_th / torch.clamp_min(pdf_l, 1e-12) * weight * float(nl)
            ok = facing & ~blocked & ~grazing & use_mis
            for c in range(3):
                raw = lsel[13 + c] * atten[c] * scale
                contrib = torch.clamp_max(raw, FIREFLY)
                rad[c] = rad[c] + torch.where(ok, tp[c] * contrib, 0.0)
                if stash is not None and not pathwise:
                    kept = ok & (raw < FIREFLY)
                    em_su[c] = torch.where(kept, lsel[13 + c] * scale, 0.0)
                    alb_su[c] = torch.where(kept, atten[c] * scale, 0.0)
                    clamped[c] = ok & ~kept
            if stash is not None and not pathwise:
                lslot = torch.where(use_mis, (lsel[16] * 3.0).to(torch.int32),
                                    LSLOT_NONE)

        if hdri is not None and use_nee:
            # NEE toward the environment: the sample comes in as rows; the
            # shadow ray is capped at 3e38 (inactive lanes at 0 find nothing)
            hrow = [hdri[(bounce - b_start) * HDRI_ROWS + c] for c in range(HDRI_ROWS)]
            hd, hem, pdf_h = hrow[0:3], hrow[3:6], hrow[6]
            cos_h = _dot3(nrm, hd)
            facing_h = cos_h > 0.0
            shadow_cap_h = torch.where(use_mis & facing_h, 3.0e38, zero)
            blocked_h = _occluded(tb, kinds, p, hd, shadow_cap_h, seed, stream,
                                  bounce, 66, counts)
            blk_h = blocked_h
            pdf_bh = torch.clamp_min(cos_h, 0.0) * inv_pi
            weight_h = pdf_h / torch.clamp_min(pdf_h + pdf_bh, 1e-20)
            scale_h = cos_h / torch.clamp_min(pdf_h, 1e-12) * weight_h
            ok_h = facing_h & ~blocked_h & use_mis
            for c in range(3):
                contrib = torch.clamp_max(hem[c] * atten[c] * scale_h, FIREFLY)
                rad[c] = rad[c] + torch.where(ok_h, tp[c] * contrib, 0.0)

        if record is not None:
            hit_a = alive & hit
            code = (torch.where(hit_a, hitk, 0)
                    + (alive & blk_a).to(torch.int32) * DEC_BLK_A
                    + (alive & blk_h).to(torch.int32) * DEC_BLK_H)
            record[0][bounce] = code.to(torch.uint8)
            record[1][bounce] = torch.where(hit_a, torch.where(is_vol, vwin, hidx), 0)

        if stash is not None and pathwise:
            # The reverse sweep recomputes the NEE chain and every random
            # draw; of the shadow sweep only the outcome is kept, as a bit.
            # Lanes that did not enter this bounce keep inert rows.
            stash_f, stash_i = stash
            hit_a = alive & hit
            variant = torch.where(is_checker, torch.where(is_even, 1.0, 2.0), 0.0)
            tex_id = pick(29, 21, vrow(24))
            mat_id = pick(30, 22, zero + float(MSLOT_NONE))
            rows = (tp + atten + p + d + nrm
                    + [fuzz, ior,
                       torch.where(is_sphere & hit_a, flip * inv_rad, zero)
                       if tb.n_sphere else zero,
                       t_rec])
            if stash_f.shape[1] == PW_STASH_F_ROWS_MARBLE:
                rows.append(inv_scale)   # the marble's scale
            for r_, v in enumerate(rows):
                stash_f[bounce, r_] = torch.where(alive, v, 0.0)
            # a dielectric's albedo never enters (atten = 1) and a noise
            # texture has no trainable colour
            slot = torch.where(hit_a & ~is_die & (texkind != 2.0),
                               (tex_id * 3.0 + variant).to(torch.int32), SLOT_NONE)
            mslot = torch.where(hit_a, mat_id.to(torch.int32), MSLOT_NONE)
            i32 = torch.int32
            mk = (emit_mask.to(i32) * PW_EMIT
                  + (hit_a & scattered).to(i32) * PW_ALIVE_NEXT
                  + lit.to(i32) * PW_LIT
                  + (alive & blk_a).to(i32) * PW_BLK_A
                  + (alive & front).to(i32) * PW_FRONT
                  + (hit_a & is_met).to(i32) * PW_METAL
                  + (hit_a & is_die).to(i32) * PW_DIELECTRIC
                  + hit_a.to(i32) * PW_HIT
                  + use_mis.to(i32) * PW_USE_MIS
                  + (alive & blk_h).to(i32) * PW_BLK_H
                  + (hit_a & is_vol).to(i32) * PW_VOLUME
                  + torch.where(hit_a & is_vol, vwin, 0).to(i32) * (1 << PW_VOL_SHIFT)
                  + (hit_a & ~is_die & (texkind == 2.0)).to(i32) * PW_MARBLE)
            stash_i[bounce, 0] = slot
            stash_i[bounce, 1] = mslot
            stash_i[bounce, 2] = mk
        elif stash is not None:
            # rows of the lanes that entered this bounce; the others keep
            # inert rows (a dead lane can still "hit" a volume: its free
            # flight is not capped)
            stash_f, stash_i = stash
            hit_a = alive & hit
            variant = torch.where(is_checker, torch.where(is_even, 1.0, 2.0), 0.0)
            tex_id = pick(29, 21, vrow(24))
            # noise textures (kind 2) have no trainable colour
            slot = torch.where(hit_a & (texkind != 2.0),
                               (tex_id * 3.0 + variant).to(torch.int32), SLOT_NONE)
            mk = (emit_mask.to(torch.int32) * MK_EMIT
                  + (hit_a & scattered).to(torch.int32) * MK_ALIVE_NEXT
                  + lit.to(torch.int32) * MK_LIT)
            for c in range(3):
                stash_f[bounce, 0 + c] = torch.where(alive, tp[c], 0.0)
                stash_f[bounce, 3 + c] = torch.where(hit_a, atten[c], 0.0)
                stash_f[bounce, 6 + c] = em_su[c]
                stash_f[bounce, 9 + c] = alb_su[c]
                mk = mk + clamped[c].to(torch.int32) * (MK_CLAMPED << c)
            stash_i[bounce, 0] = slot
            stash_i[bounce, 1] = lslot
            stash_i[bounce, 2] = mk

        alive = alive & hit & scattered
        for c in range(3):
            tp[c] = torch.where(alive, tp[c] * atten[c], tp[c])
            o[c] = torch.where(alive, p[c], o[c])
            d[c] = torch.where(alive, new_d[c], d[c])
        allow = ~use_mis

    out = torch.stack(rad + m_dir + m_tp, dim=0)
    flags = (missed.to(torch.int32) * FLAG_MISSED
             + m_prim.to(torch.int32) * FLAG_PRIMARY
             + alive.to(torch.int32) * FLAG_ALIVE
             + allow.to(torch.int32) * FLAG_ALLOW)
    if start is not None:
        return out, flags, (o, d, tp)
    return out, flags


def _wavefront_fwd_plain(tb: Tables, o, d, tm, stream, seed, max_depth,
                        hdri=None, counts=None):
    """Plain version of the forward kernel: ([9, R] f32, [R] i32).  Its
    sphere sweeps are the brute sweep in table order, the specification of
    the kernel's culled one; ``counts`` (see ``culled_sweep_counts``) takes
    the culled sweep's mirror instead.  So do the record's and the resumable
    kernel's plain versions."""
    return _bounce_loop(tb, o, d, tm, stream, seed, max_depth, hdri=hdri, counts=counts)


def _wavefront_record_plain(tb: Tables, o, d, tm, stream, seed, max_depth,
                            hdri=None, counts=None):
    """Plain version of the record kernel: the forward's ([9, R] f32,
    [R] i32) and the record (code [D, R] u8, idx [D, R] i32)."""
    record = (torch.zeros((max_depth, tm.shape[0]), dtype=torch.uint8, device=tm.device),
              torch.zeros((max_depth, tm.shape[0]), dtype=torch.int32, device=tm.device))
    out, flags = _bounce_loop(tb, o, d, tm, stream, seed, max_depth,
                              record=record, hdri=hdri, counts=counts)
    return out, flags, record[0], record[1]


def _wavefront_resume_plain(tb: Tables, flat, seed, b_start, b_end, hdri=None,
                            counts=None):
    """Plain version of the resumable kernel: bounces [b_start, b_end) of
    the 21-row path state ``flat`` (``wavefront_resume``).  Returns the
    19-tuple of [R] tensors (radiance 3, miss direction 3, miss throughput
    3, flags, origin 3, direction 3, throughput 3)."""
    o, d, tm, stream = flat[0:3], flat[3:6], flat[6], flat[7]
    start = (b_start, flat[8:11], flat[11:14], flat[14], flat[15:18], flat[18:21])
    out, flags, (o2, d2, tp) = _bounce_loop(tb, o, d, tm, stream, seed, b_end,
                                            hdri=hdri, start=start, counts=counts)
    return tuple(out) + (flags,) + tuple(o2) + tuple(d2) + tuple(tp)


SWEEP_COUNTS = tuple(f"{kind}_{what}" for kind in ("closest", "shadow")
                     for what in ("group_box_tests", "box_tests", "sphere_tests",
                                  "warp_box_tests", "warp_sphere_tests"))


def culled_sweep_counts(plain, tb: Tables, *args, **kwargs):
    """The plain version ``plain`` (``_wavefront_fwd_plain``,
    ``_wavefront_record_plain`` or ``_wavefront_resume_plain``, called with
    ``args`` and ``kwargs``) with its sphere sweeps the culled sweep's mirror
    (tables with segments only): what it returns (the same bits as the brute
    sweep's), and the group box, segment box and sphere tests of its
    closest-hit and shadow sweeps (``SWEEP_COUNTS``; see
    ``_sphere_sweep_culled``).  The mirror of B1, B6 and B11 on the same
    inputs."""
    if tb.n_seg < 1:
        raise ValueError("the tables have no segments (fewer than SPH_CULL_MIN spheres)")
    counts = dict.fromkeys(SWEEP_COUNTS, 0)
    out = plain(tb, *args, **kwargs, counts=counts)
    return out, counts


def _miss_colour_rows(out, flags, miss):
    """[3, R] miss colour, zero where the ray did not leave the scene:
    the flat background, or the sky gradient of the miss direction.
    ``miss`` = (mode, (r, g, b)): ``MISS_FLAT``, ``MISS_SKY`` (a bool
    use_sky reads as one of the two) or ``MISS_STREAM`` (an environment,
    applied outside: 0 here)."""
    mode, bg = miss
    missed = (flags & FLAG_MISSED) != 0
    if int(mode) == MISS_STREAM:
        return torch.zeros_like(out[:3])
    if int(mode) == MISS_SKY:
        m_dir = [out[3], out[4], out[5]]
        dl = torch.sqrt(torch.clamp_min(_dot3(m_dir, m_dir), 1e-20))
        aa = 0.5 * (m_dir[1] / dl + 1.0)
        cols = [(1.0 - aa) + aa * 0.5, (1.0 - aa) + aa * 0.7,
                (1.0 - aa) + aa * 1.0]
    else:
        cols = [torch.full_like(out[0], float(bg[c])) for c in range(3)]
    return torch.stack([torch.where(missed, cols[c], 0.0) for c in range(3)])


def pathwise_stash_rows(tb: Tables) -> int:
    """Float rows a bounce of the pathwise stash of this scene: 20 with a
    marble texture on a primitive or volume, else 19."""
    return PW_STASH_F_ROWS_MARBLE if _has_noise(tb) else PW_STASH_F_ROWS


def _empty_stash(r, max_depth, device, f_rows=STASH_F_ROWS):
    stash_f = torch.empty((max_depth, f_rows, r), dtype=torch.float32,
                          device=device)
    stash_i = torch.empty((max_depth, STASH_I_ROWS, r), dtype=torch.int32,
                          device=device)
    return stash_f, stash_i


def _wavefront_grad_fwd_plain(tb: Tables, o, d, tm, stream, seed, max_depth,
                              miss, pathwise=False, hdri=None):
    """Plain version of the gradient forward.  Returns (out [9, R] f32 and
    flags [R] i32 as the forward's, miss colour [3, R] f32, stash_f
    [D, 12, R] f32 (with ``pathwise`` [D, 19, R], or [D, 20, R] in a scene
    with marble: ``pathwise_stash_rows``), stash_i [D, 3, R] i32).
    Lanes that never enter a bounce keep inert rows there: floats 0, slot
    -3, light or material slot -9, mask 0."""
    stash_f, stash_i = _empty_stash(
        tm.shape[0], max_depth, tm.device,
        pathwise_stash_rows(tb) if pathwise else STASH_F_ROWS)
    stash_f.zero_()
    stash_i[:, 0] = SLOT_NONE
    stash_i[:, 1] = LSLOT_NONE   # == MSLOT_NONE
    stash_i[:, 2] = 0
    out, flags = _bounce_loop(tb, o, d, tm, stream, seed, max_depth,
                              stash=(stash_f, stash_i), pathwise=pathwise,
                              hdri=hdri)
    return out, flags, _miss_colour_rows(out, flags, miss), stash_f, stash_i


def _wavefront_grad_rev_plain(stash_f, stash_i, g3, miss_col, n_tex):
    """Plain version of the reverse sweep: the product-chain adjoint

        R_k = s_k + aeff_k * R_{k+1}
        s_c = alb*emit + alb*em_su + FIREFLY*clamped_c + miss_col*lit
        cot_alb_c = g_c T_c (R_c*alive_next + emit + em_su_c)  -> slot
        cot_lem_c = g_c T_c alb_su_c                            -> light slot

    from the last bounce to the first.  ``g3`` [3, R] is the cotangent of
    the rays' radiance.  Returns [n_tex, 3 variants, 3 channels] f32.  The
    per-ray terms are float32 as in the kernel; they are summed in float64,
    so this is the more exact of the two."""
    depth = stash_f.shape[0]
    null = 9 * n_tex   # bin of the rows without a slot
    acc = torch.zeros(null + 1, dtype=torch.float64, device=stash_f.device)
    rk = [torch.zeros_like(g3[0]) for _ in range(3)]
    for k in range(depth - 1, -1, -1):
        sf = stash_f[k]
        slot, lslot, mk = stash_i[k, 0], stash_i[k, 1], stash_i[k, 2]
        emitf = ((mk & MK_EMIT) > 0).to(torch.float32)
        alive_nf = ((mk & MK_ALIVE_NEXT) > 0).to(torch.float32)
        litf = ((mk & MK_LIT) > 0).to(torch.float32)
        a_bin, l_bin = slot.long() * 3, lslot.long() * 3
        for c in range(3):
            t_c, alb, em_su, alb_su = sf[c], sf[3 + c], sf[6 + c], sf[9 + c]
            clampf = ((mk & (MK_CLAMPED << c)) > 0).to(torch.float32)
            s_c = alb * emitf + alb * em_su + FIREFLY * clampf + miss_col[c] * litf
            cotb = g3[c] * t_c
            cot_alb = cotb * (rk[c] * alive_nf + emitf + em_su)
            cot_lem = cotb * alb_su
            acc.index_add_(0, torch.where(slot >= 0, a_bin + c, null),
                           cot_alb.double())
            acc.index_add_(0, torch.where(lslot >= 0, l_bin + c, null),
                           cot_lem.double())
            aeff = alb * alive_nf + (1.0 - alive_nf)
            rk[c] = s_c + aeff * rk[c]
    return acc[:null].to(torch.float32).reshape(n_tex, 3, 3)


def _volume_entry(tb, o, d, vi):
    """Entry slab of box volume ``vi`` for the pathwise volume adjoint:
    (near, ne[3], inv_e, act_e) where near = max_i min(ta, tb) is the
    window's entry distance, ne the world-to-local row of the axis that
    gives it, inv_e = 1 / (ne . d) with the 1e-12 guard of the window, and
    act_e whether that guard was idle.  The scatter distance is
    t = max(near, eps) + K / |d| with K from the random draw alone, so
    dt/do = -ne inv_e and dt/dd = -near ne inv_e act_e."""
    vt = tb.vt
    zero = torch.zeros_like(o[0])
    near = torch.full_like(zero, -BIG)
    tmins, invs, acts = [], [], []
    for i in range(3):
        ol = (vt[4 * i + 0, vi] * o[0] + vt[4 * i + 1, vi] * o[1]
              + vt[4 * i + 2, vi] * o[2] + vt[4 * i + 3, vi])
        dl = (vt[4 * i + 0, vi] * d[0] + vt[4 * i + 1, vi] * d[1]
              + vt[4 * i + 2, vi] * d[2])
        act = torch.abs(dl) >= 1e-12
        safe = torch.where(act, dl, torch.where(dl < 0, -1e-12, 1e-12))
        inv = 1.0 / safe
        ta = (vt[12 + i, vi] - ol) * inv
        tb_ = (vt[15 + i, vi] - ol) * inv
        tmins.append(torch.minimum(ta, tb_))
        invs.append(inv)
        acts.append(act)
        near = torch.maximum(near, tmins[i])
    ne = [zero, zero, zero]
    inv_e, act_e = zero, zero
    chosen = torch.zeros_like(zero, dtype=torch.bool)
    for i in range(3):
        wsel = ~chosen & (tmins[i] == near)
        ne = [torch.where(wsel, vt[4 * i + c, vi], ne[c]) for c in range(3)]
        inv_e = torch.where(wsel, invs[i], inv_e)
        act_e = torch.where(wsel & acts[i], 1.0, act_e)
        chosen = chosen | wsel
    return near, ne, inv_e, act_e


def _wavefront_grad_rev_pathwise_plain(tb: Tables, stash_f, stash_i, g3,
                                       miss_col, stream, seed, miss_mode,
                                       n_tex, n_mat, lmd=None):
    """Plain version of the pathwise reverse kernel: see
    ``_pathwise_reverse_plain``, without HDRI rows."""
    f_rows = pathwise_stash_rows(tb)
    if stash_f.shape[1] != f_rows:
        raise ValueError(f"this scene's pathwise stash has {f_rows} float rows a "
                         f"bounce, got {stash_f.shape[1]}")
    return _pathwise_reverse_plain(tb, stash_f, stash_i, g3, miss_col, stream,
                                   seed, miss_mode, n_tex, n_mat, lmd)[:3]


def _pathwise_reverse_plain(tb: Tables, stash_f, stash_i, g3, miss_col, stream,
                            seed, miss_mode, n_tex, n_mat, lmd=None, hdri=None):
    """Plain version of the pathwise reverse sweep: the pathwise kernel's
    arithmetic step by step on ``[R]`` tensors (not ``torch.autograd`` of
    the forward).  From the last bounce to the first it carries the adjoints
    of the throughput (ltp), the ray origin (lo) and the direction (ld), and
    per bounce

      * recomputes the scatter draw, the Fresnel draw and the light sample
        from (seed, stream, bounce), and the NEE chain with the forward's
        clamp floors, and takes the partials of the NEE scale with respect
        to the hit point and the normal;
      * reverses the scatter: lambertian (normal + draw), metal (reflect,
        normalise, + fuzz * draw -> d(fuzz)), dielectric (reflect or
        refract on the unit direction, the branch recomputed -> d(ior));
      * takes the derivative of the miss colour by the miss direction (sky),
        or adds the cotangent of the miss direction ``lmd`` [3, R] (an
        environment, ``miss_mode`` ``MISS_STREAM``);
      * with ``hdri`` rows (the fused kernel's), recomputes the HDRI NEE
        term: its albedo and clamp parts, the normal's adjoint, and the
        cotangent of each bounce's environment sample (``eout``);
      * sends the hit point's adjoint back through the hit distance by the
        implicit rule dt/do = -n / (n . d), dt/dd = t dt/do (surfaces), or
        through the entry slab and the free-flight length (volumes);
      * on a marble winner (a stash of 20 rows, mask bit ``PW_MARBLE``),
        adds the marble's derivative by the hit point times the albedo's
        summed cotangent to the hit point's adjoint;
      * adds the cotangents of the albedo (per texture slot), of the light's
        emission (per light slot) and of fuzz and ior (per material).

    ``g3`` [3, R] is the cotangent of the rays' radiance, ``miss_col``
    [3, R] the gradient forward's.  Returns ([n_tex, 3 variants, 3 channels],
    fuzz [n_mat], ior [n_mat], eout [D, 3, R] or None) f32.  Per-ray terms
    are float32 as in the kernel; they are summed in float64."""
    depth = stash_f.shape[0]
    n_col = 9 * n_tex
    null = n_col + 2 * n_mat          # bin of the rows without a slot
    acc = torch.zeros(null + 2, dtype=torch.float64, device=stash_f.device)
    zero = torch.zeros_like(g3[0])
    g = [g3[0], g3[1], g3[2]]
    lo_ = [zero, zero, zero]
    ldv = [zero, zero, zero]
    ltp = [zero, zero, zero]
    two_pi = float(np.float32(2.0 * np.pi))
    inv_pi = float(np.float32(1.0 / np.pi))
    sky_s = (0.5, 0.7, 1.0)
    use_nee = tb.n_lights > 0
    use_sky = int(miss_mode) == MISS_SKY
    stream_miss = int(miss_mode) == MISS_STREAM
    eout = (torch.zeros((depth, 3) + tuple(g3[0].shape), dtype=torch.float32,
                        device=g3.device) if hdri is not None else None)

    def fl(cond):
        return cond.to(torch.float32)

    for k in range(depth - 1, -1, -1):
        sf = stash_f[k]
        T = [sf[c] for c in range(3)]
        alb = [sf[3 + c] for c in range(3)]
        pv = [sf[6 + c] for c in range(3)]
        din = [sf[9 + c] for c in range(3)]
        nv = [sf[12 + c] for c in range(3)]
        # inert rows hold 0: the floor keeps 1 / ior finite there
        io_ = torch.clamp_min(sf[16], 1e-3)
        dndp, tk = sf[17], sf[18]
        slot, mslot, mk = stash_i[k, 0], stash_i[k, 1], stash_i[k, 2]
        emitf = fl((mk & PW_EMIT) > 0)
        Af = fl((mk & PW_ALIVE_NEXT) > 0)
        litf = fl((mk & PW_LIT) > 0)
        blkb = (mk & PW_BLK_A) > 0
        frontb = (mk & PW_FRONT) > 0
        metf = fl((mk & PW_METAL) > 0)
        dief = fl((mk & PW_DIELECTRIC) > 0)
        hitf = fl((mk & PW_HIT) > 0)
        misb = (mk & PW_USE_MIS) > 0

        su1, su2, _ = rngmod.uniform3(seed, stream, k, rngmod.SCATTER_U)
        zr = 1.0 - 2.0 * su1
        phi = two_pi * su2
        rrr = torch.sqrt(torch.clamp_min(1.0 - zr * zr, 0.0))
        ru = [rrr * torch.cos(phi), rrr * torch.sin(phi), zr]
        ufr = rngmod.uniform(seed, stream, k, rngmod.FRESNEL)

        # ---- NEE recompute (operation for operation the forward's) and the
        # partials of its scale with respect to (p, n)
        em_su = [zero, zero, zero]
        alb_su = [zero, zero, zero]
        clampf = [zero, zero, zero]
        lp_nee = [zero, zero, zero]
        ln_nee = [zero, zero, zero]
        lslot = torch.full_like(slot, LSLOT_NONE)
        if use_nee:
            nl = float(tb.n_lights)
            up = rngmod.uniform(seed, stream, k, rngmod.LIGHT_PICK)
            li = torch.clamp_max(torch.floor(up * nl), nl - 1.0).long()
            ua, ub, _ = rngmod.uniform3(seed, stream, k, rngmod.LIGHT_U)
            lsel = [tb.lt[f][li] for f in range(LT_ROWS)]
            lpnt = [lsel[c] + ua * lsel[3 + c] + ub * lsel[6 + c] for c in range(3)]
            tl = [lpnt[c] - pv[c] for c in range(3)]
            tl2 = _dot3(tl, tl)
            dist = torch.sqrt(torch.clamp_min(tl2, 1e-20))
            ldir = [tl[c] / dist for c in range(3)]
            cos_th = _dot3(nv, ldir)
            facing = cos_th > 0.0
            zlc = -(lsel[9] * ldir[0] + lsel[10] * ldir[1] + lsel[11] * ldir[2])
            cos_l = torch.abs(zlc)
            grazing = cos_l < 1e-3
            s2v = cos_l * lsel[12]
            s2 = torch.clamp_min(s2v, 1e-20)
            pdf_l = (dist * dist) / s2
            qv = torch.clamp_min(pdf_l, 1e-12)
            pdf_b = torch.clamp_min(cos_th, 0.0) * inv_pi
            rv = torch.clamp_min(pdf_l + pdf_b, 1e-20)
            weight = pdf_l / rv
            scale = cos_th / qv * weight * nl
            ok = facing & ~blkb & ~grazing & misb
            okf = fl(ok)
            W = zero
            for c in range(3):
                uf = torch.where(lsel[13 + c] * alb[c] * scale < FIREFLY, okf, zero)
                em_su[c] = lsel[13 + c] * scale * uf
                alb_su[c] = alb[c] * scale * uf
                clampf[c] = okf - uf
                W = W + g[c] * T[c] * lsel[13 + c] * alb[c] * uf
            lslot = torch.where(ok, (lsel[16] * 3.0).to(torch.int32), LSLOT_NONE)
            # Lanes that are not ok are set to 1 before the partials: with
            # both pdfs near 0 inv_qr^2 is infinite, and the W = 0 of such a
            # lane cannot cancel it (0 * inf is NaN).
            one = torch.ones_like(zero)
            dist = torch.where(ok, dist, one)
            pdf_l = torch.where(ok, pdf_l, one)
            pdf_b = torch.where(ok, pdf_b, one)
            qv = torch.where(ok, qv, one)
            rv = torch.where(ok, rv, one)
            s2 = torch.where(ok, s2, one)
            # scale = nL cos_th pdf_l / (q r)
            q_act = fl(pdf_l > 1e-12)
            r_act = fl(pdf_l + pdf_b > 1e-20)
            s2_act = fl(s2v > 1e-20)
            inv_qr = 1.0 / (qv * rv)
            ds_dcos = nl * pdf_l * inv_qr
            ds_dpl = nl * cos_th * (
                inv_qr - pdf_l * (q_act * rv + qv * r_act) * inv_qr * inv_qr)
            ds_dpb = -nl * cos_th * pdf_l * r_act * inv_qr / rv
            dpb_dcos = torch.where(cos_th > 0.0, inv_pi, 0.0)
            c_cos = W * (ds_dcos + ds_dpb * dpb_dcos)
            c_pl = W * ds_dpl
            c_dist = c_pl * (2.0 * dist / s2)
            c_cosl = c_pl * (-(dist * dist) * lsel[12] * s2_act / (s2 * s2))
            sgn_z = torch.where(zlc >= 0.0, 1.0, -1.0)
            lam_ld = [c_cos * nv[c] - c_cosl * sgn_z * lsel[9 + c] for c in range(3)]
            ln_nee = [c_cos * ldir[c] for c in range(3)]
            ldd = _dot3(ldir, lam_ld)
            dist_act = fl(tl2 > 1e-20)
            lam_tl = [(lam_ld[c] - dist_act * ldir[c] * ldd) / dist
                      + c_dist * dist_act * ldir[c] for c in range(3)]
            lp_nee = [-lam_tl[c] for c in range(3)]

        # ---- HDRI NEE: the sample comes in as rows and the shadow outcome
        # as a bit; no hit-point term (a solid-angle pdf), the normal's, and
        # the cotangent of the sample's texel (eout).  Its albedo and clamp
        # parts fold into em_su and clampf, which treat both NEE terms alike.
        if hdri is not None and use_nee:
            hrow = [hdri[k * HDRI_ROWS + c] for c in range(HDRI_ROWS)]
            hdv, hemr, pdf_h = hrow[0:3], hrow[3:6], hrow[6]
            cos_h = _dot3(nv, hdv)
            blkh_b = (mk & PW_BLK_H) > 0
            ok_h = (cos_h > 0.0) & ~blkh_b & misb
            okf_h = fl(ok_h)
            pdf_bh = torch.clamp_min(cos_h, 0.0) * inv_pi
            qh = torch.clamp_min(pdf_h, 1e-12)
            rh = torch.clamp_min(pdf_h + pdf_bh, 1e-20)
            scale_h = cos_h / qh * (pdf_h / rh)
            W_h = zero
            for c in range(3):
                uf_h = torch.where(hemr[c] * alb[c] * scale_h < FIREFLY, okf_h, zero)
                em_su[c] = em_su[c] + hemr[c] * scale_h * uf_h
                clampf[c] = clampf[c] + (okf_h - uf_h)
                eout[k, c] = g[c] * T[c] * alb[c] * scale_h * uf_h
                W_h = W_h + g[c] * T[c] * hemr[c] * alb[c] * uf_h
            # lanes that are not ok set to 1 first (0 * inf is NaN)
            one = torch.ones_like(zero)
            pdf_hs = torch.where(ok_h, pdf_h, one)
            qh_s = torch.where(ok_h, qh, one)
            rh_s = torch.where(ok_h, rh, one)
            r_act_h = fl(pdf_h + pdf_bh > 1e-20)
            inv_qr_h = 1.0 / (qh_s * rh_s)
            ds_dcos_h = pdf_hs * inv_qr_h
            ds_dpbh = -cos_h * pdf_hs * r_act_h * inv_qr_h / rh_s
            dpbh_dcos = torch.where(cos_h > 0.0, inv_pi, 0.0)
            c_cos_h = W_h * (ds_dcos_h + ds_dpbh * dpbh_dcos)
            ln_nee = [ln_nee[c] + c_cos_h * hdv[c] for c in range(3)]

        # ---- scatter Jacobians, reversed (u = adjoint of the next direction)
        u = ldv
        lamf = (1.0 - metf) * (1.0 - dief)
        # metal: new_d = rfl / |rfl| + fuzz * ru
        ddn_f = _dot3(din, nv)
        rfl = [din[c] - nv[c] * (2.0 * ddn_f) for c in range(3)]
        rlen = torch.sqrt(torch.clamp_min(_dot3(rfl, rfl), 1e-20))
        rhat = [rfl[c] / rlen for c in range(3)]
        cot_fuzz = Af * metf * _dot3(ru, u)
        rhu = _dot3(rhat, u)
        vv = [(u[c] - rhat[c] * rhu) / rlen for c in range(3)]
        nvv = _dot3(nv, vv)
        l_din_met = [vv[c] - 2.0 * nv[c] * nvv for c in range(3)]
        l_n_met = [-2.0 * din[c] * nvv - 2.0 * ddn_f * vv[c] for c in range(3)]
        # dielectric: reflect or refract the unit direction; the branch is
        # recomputed from the same bits as the forward's
        dlen = torch.sqrt(torch.clamp_min(_dot3(din, din), 1e-20))
        ud = [din[c] / dlen for c in range(3)]
        udn = _dot3(ud, nv)
        cos_t = torch.clamp_max(-udn, 1.0)
        ct_act = fl(-udn < 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        ri = torch.where(frontb, 1.0 / io_, io_)
        cannot = ri * sin_t > 1.0
        r0s = (1.0 - ri) / (1.0 + ri)
        r0s = r0s * r0s
        omc = torch.clamp_min(1.0 - cos_t, 0.0)
        omc2 = omc * omc
        schl = r0s + (1.0 - r0s) * omc2 * omc2 * omc
        do_refl = cannot | (schl > ufr)
        nu = _dot3(nv, u)
        l_ud_r = [u[c] - 2.0 * nv[c] * nu for c in range(3)]
        l_n_r = [-2.0 * ud[c] * nu - 2.0 * udn * u[c] for c in range(3)]
        perp = [(ud[c] + nv[c] * cos_t) * ri for c in range(3)]
        xv = 1.0 - _dot3(perp, perp)
        parl = -torch.sqrt(torch.clamp_min(torch.abs(xv), 1e-20))
        sx_act = torch.where(xv >= 0.0, 1.0, -1.0) * fl(torch.abs(xv) > 1e-20)
        l_parl = nu
        l_perp = [u[c] - sx_act * (l_parl / parl) * perp[c] for c in range(3)]
        npp = _dot3(nv, l_perp)
        l_ud_t = [ri * (l_perp[c] - ct_act * nv[c] * npp) for c in range(3)]
        l_n_t = [ri * (cos_t * l_perp[c] - ct_act * ud[c] * npp) + parl * u[c]
                 for c in range(3)]
        cot_ri = ((ud[0] + nv[0] * cos_t) * l_perp[0]
                  + (ud[1] + nv[1] * cos_t) * l_perp[1]
                  + (ud[2] + nv[2] * cos_t) * l_perp[2])
        reflf = fl(do_refl)
        dri = torch.where(frontb, -1.0 / (io_ * io_), 1.0)
        cot_ior = Af * dief * (1.0 - reflf) * cot_ri * dri
        l_ud = [reflf * l_ud_r[c] + (1.0 - reflf) * l_ud_t[c] for c in range(3)]
        l_n_die = [reflf * l_n_r[c] + (1.0 - reflf) * l_n_t[c] for c in range(3)]
        udu = _dot3(ud, l_ud)
        l_din_die = [(l_ud[c] - ud[c] * udu) / dlen for c in range(3)]

        l_n_s = [Af * (lamf * u[c] + metf * l_n_met[c] + dief * l_n_die[c])
                 for c in range(3)]
        l_din_s = [Af * (metf * l_din_met[c] + dief * l_din_die[c])
                   for c in range(3)]

        # ---- cotangents of the colours, and the throughput adjoint
        cot_alb = [g[c] * T[c] * (emitf + em_su[c]) + ltp[c] * T[c] * Af
                   for c in range(3)]
        cot_lem = [g[c] * T[c] * alb_su[c] for c in range(3)]
        # the miss colour's derivative by the miss direction (on a lit row
        # the stashed direction is the miss direction)
        if use_sky:
            dl2 = torch.clamp_min(_dot3(din, din), 1e-20)
            dlm = torch.sqrt(dl2)
            w_sky = (g[0] * T[0] * (sky_s[0] - 1.0) + g[1] * T[1] * (sky_s[1] - 1.0)
                     + g[2] * T[2] * (sky_s[2] - 1.0))
            l_d_sky = [litf * w_sky * 0.5
                       * ((1.0 if c == 1 else 0.0) / dlm - din[1] * din[c] / (dl2 * dlm))
                       for c in range(3)]
        elif stream_miss:
            l_d_sky = [litf * lmd[c] for c in range(3)]
        else:
            l_d_sky = [zero, zero, zero]
        ltp = [ltp[c] * (Af * alb[c] + (1.0 - Af))
               + g[c] * (alb[c] * emitf + em_su[c] * alb[c] + FIREFLY * clampf[c])
               + litf * g[c] * miss_col[c] for c in range(3)]

        # ---- the hit point's and the normal's adjoints, back through the
        # hit distance
        lam_n = [l_n_s[c] + ln_nee[c] for c in range(3)]
        lam_p = [Af * lo_[c] + lp_nee[c] + dndp * lam_n[c] for c in range(3)]
        if stash_f.shape[1] == PW_STASH_F_ROWS_MARBLE:
            # a marble winner: the marble is grayscale, so its value's
            # cotangent is the sum of the albedo's three, and it moves with
            # the hit point (dmarble/dp, ``textures.marble_grad``)
            _, dm = textures.marble_grad(V3(*pv), sf[19])
            cotm = fl((mk & PW_MARBLE) > 0) * (cot_alb[0] + cot_alb[1] + cot_alb[2])
            lam_p = [lam_p[c] + cotm * dm[c] for c in range(3)]
        den = _dot3(nv, din)
        dsafe = torch.where(torch.abs(den) > 1e-20, den, 1.0)
        dlp = _dot3(din, lam_p)
        bb_c = [lam_p[c] - nv[c] * dlp / dsafe for c in range(3)]
        ld_t = [tk * bb_c[c] for c in range(3)]
        if tb.n_vol:
            volf = (mk & PW_VOLUME) > 0
            vidx = (mk >> PW_VOL_SHIFT) & 3
            o_rec = [pv[c] - tk * din[c] for c in range(3)]
            near_v, inv_v, act_v = zero, zero, zero
            ne_v = [zero, zero, zero]
            for vi in range(tb.n_vol):
                vm = volf & (vidx == vi)
                nr, ne_, inv_e, act_e = _volume_entry(tb, o_rec, din, vi)
                near_v = torch.where(vm, nr, near_v)
                ne_v = [torch.where(vm, ne_[c], ne_v[c]) for c in range(3)]
                inv_v = torch.where(vm, inv_e, inv_v)
                act_v = torch.where(vm, act_e, act_v)
            # origin inside the box: the entry clamps to the constant eps
            # and the slab term drops out
            ent = fl(near_v >= EPS_HIT)
            t0c_v = torch.clamp_min(near_v, EPS_HIT)
            dl2v = torch.clamp_min(_dot3(din, din), 1e-20)
            for c in range(3):
                bvol = lam_p[c] - ent * ne_v[c] * inv_v * dlp
                lvol = (tk * lam_p[c] - ent * act_v * near_v * ne_v[c] * inv_v * dlp
                        - (tk - t0c_v) * din[c] * dlp / dl2v)
                bb_c[c] = torch.where(volf, bvol, bb_c[c])
                ld_t[c] = torch.where(volf, lvol, ld_t[c])
        bb = [hitf * bb_c[c] for c in range(3)]
        lo_ = [(1.0 - Af) * lo_[c] + bb[c] for c in range(3)]
        ldv = [(1.0 - Af) * ldv[c] + l_din_s[c] + hitf * ld_t[c] + l_d_sky[c]
               for c in range(3)]

        # ---- sums per slot
        a_bin, l_bin = slot.long() * 3, lslot.long() * 3
        for c in range(3):
            acc.index_add_(0, torch.where(slot >= 0, a_bin + c, null),
                           cot_alb[c].double())
            acc.index_add_(0, torch.where(lslot >= 0, l_bin + c, null),
                           cot_lem[c].double())
        m_bin = torch.where(mslot >= 0, n_col + 2 * mslot.long(), null)
        acc.index_add_(0, m_bin, cot_fuzz.double())
        acc.index_add_(0, m_bin + 1, cot_ior.double())
    out = acc[:null].to(torch.float32)
    mats = out[n_col:].reshape(n_mat, 2)
    return (out[:n_col].reshape(n_tex, 3, 3), mats[:, 0].contiguous(),
            mats[:, 1].contiguous(), eout)


# -----------------------------------------------------------------------------
# Kernel wrapper
# -----------------------------------------------------------------------------

_P = ctypes.c_void_p
_I, _F = ctypes.c_int, ctypes.c_float
_TABLES_AND_RAYS = (
    [_P] * 4 + [_I] * 4                  # tables, counts
    + [_P] * 8                           # ox oy oz dx dy dz tm stream
)
_SIZES = [ctypes.c_longlong, ctypes.c_uint, _I]   # R, seed, depth
# the culled sweep's tables: seg_order seg_start seg_box n_seg grp_start
# grp_box n_grp seg_c seg_inv_r
_SEG = [_P] * 3 + [_I] + [_P] * 2 + [_I, _F, _F]
_FWD_ARGTYPES = (_TABLES_AND_RAYS + [_P] + _SEG + [_P] * 2 + _SIZES   # hdri out flags
                 + [_I, _P])                                          # marble
_RECORD_ARGTYPES = (_TABLES_AND_RAYS + [_P] + _SEG                   # hdri
                    + [_P] * 4 + _SIZES + [_P])                     # out flags code idx
# + marble (the product-chain tier's) or f_rows (the pathwise tier's)
_GRAD_FWD_ARGTYPES = (_TABLES_AND_RAYS + [_P] * 5 + _SIZES
                      + [_I, _F, _F, _F] + [_I, _P])
_RESUME_ARGTYPES = ([_P] * 4 + [_I] * 4 + [_P] * 3 + _SEG   # tables, counts, in out hdri
                    + [ctypes.c_longlong, ctypes.c_uint, _I, _I, _I, _P])   # ... marble
_GRAD_REV_ARGTYPES = [_P] * 5 + [ctypes.c_longlong, _I, _I, _P]
_GRAD_REV_PATHWISE_ARGTYPES = (
    [_P, _I, _P, _I]                     # light table, volume table, counts
    + [_P] * 7                           # stash_f stash_i g3 miss_col lmd stream partial
    + [ctypes.c_longlong, ctypes.c_uint, _I, _I, _I, _I, _I, _P])   # ... f_rows
_GRAD_FUSED_ARGTYPES = (
    _TABLES_AND_RAYS + [_P] * 3          # g3 env_rows hdri
    + [_I, _F, _F, _F]                   # miss mode, background
    + [_P] * 3                           # rad eout partial
    + [ctypes.c_longlong, ctypes.c_uint, _I, _I, _I, _I, _P])   # ... noise


def _kernel(library: str, function: str, argtypes, fmad: bool = False):
    from . import _build

    fn = getattr(_build.load(library, fmad=fmad).lib, function)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_hdri(hdri, tb: Tables, max_depth, r, dev):
    """Raise unless ``hdri`` is None or [max_depth * 7, R] float32 rows on
    the rays' device, in a scene with lights."""
    if hdri is None:
        return
    if hdri.device != dev or hdri.dtype != torch.float32 \
            or tuple(hdri.shape) != (max_depth * HDRI_ROWS, r) \
            or not hdri.is_contiguous():
        raise ValueError(
            f"HDRI rows must be a contiguous float32 [{max_depth * HDRI_ROWS}, "
            f"{r}] tensor on {dev}, got {hdri.dtype} {tuple(hdri.shape)} on "
            f"{hdri.device}")
    if tb.n_lights < 1:
        raise ValueError("HDRI NEE rows in a scene without quad lights")


def _check_rays(tb: Tables, o, d, tm, stream, max_depth):
    """Raise on what the tracing kernels do not take."""
    r = tm.shape[0]
    dev = tm.device
    for a in list(o) + list(d) + [tm]:
        if a.device != dev or a.dtype != torch.float32 or a.shape != (r,) \
                or not a.is_contiguous():
            raise ValueError(
                "rays must be contiguous float32 [R] tensors on one CUDA "
                f"device, got {a.dtype} {tuple(a.shape)} on {a.device}")
    if stream.device != dev or stream.dtype != torch.int32 \
            or stream.shape != (r,) or not stream.is_contiguous():
        raise ValueError("stream must be a contiguous int32 [R] tensor "
                         "(the unsigned 32-bit ray counter's bit pattern)")
    for tab, rows in ((tb.pt, PT_ROWS), (tb.st, ST_ROWS), (tb.vt, VT_ROWS),
                      (tb.lt, LT_ROWS)):
        if tab.device != dev or tab.dtype != torch.float32 \
                or tab.shape[0] != rows or not tab.is_contiguous():
            raise ValueError("tables must be contiguous float32 on the rays' device")
    if tb.n_vol > 4 or tb.n_lights > 8:
        raise ValueError("the kernel takes at most 4 volumes and 8 lights")
    if not 0 < max_depth:
        raise ValueError("max_depth must be positive")


def _table_and_ray_args(tb: Tables, o, d, tm, stream):
    return (
        tb.pt.data_ptr(), tb.st.data_ptr(), tb.vt.data_ptr(),
        tb.lt.data_ptr(), tb.n_planar, tb.n_sphere, tb.n_vol, tb.n_lights,
        *[a.data_ptr() for a in list(o) + list(d) + [tm]], stream.data_ptr(),
    )


def _segment_args(tb: Tables, dev):
    """The culled sweep's arguments of the forward, record and resumable
    kernels (``_SEG``): the tables' segments and groups, checked, or nulls
    and zeros (the brute sweep) in a scene without them."""
    if tb.n_seg < 1:
        return [None] * 3 + [0] + [None] * 2 + [0, 0.0, 0.0]
    for t, dtype, shape in ((tb.seg_order, torch.int16, (tb.n_sphere,)),
                            (tb.seg_start, torch.int32, (tb.n_seg + 1,)),
                            (tb.seg_box, torch.float32, (6, tb.n_seg)),
                            (tb.grp_start, torch.int32, (tb.n_grp + 1,)),
                            (tb.grp_box, torch.float32, (6, tb.n_grp))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"segment tables must be contiguous {dtype} {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return [tb.seg_order.data_ptr(), tb.seg_start.data_ptr(), tb.seg_box.data_ptr(),
            tb.n_seg, tb.grp_start.data_ptr(), tb.grp_box.data_ptr(), tb.n_grp,
            tb.seg_c, tb.seg_inv_r]


def _wavefront_fwd_cuda(tb: Tables, o, d, tm, stream, seed, max_depth,
                        hdri=None, fmad: bool = False):
    """Launch the kernel on PyTorch's current stream.  Does not
    synchronize.  Returns ([9, R] f32, [R] i32).

    The inputs may be freed by the caller right after the call: PyTorch's
    allocator hands their memory only to later work on the same stream."""
    global LAUNCHES
    _check_rays(tb, o, d, tm, stream, max_depth)
    r = tm.shape[0]
    dev = tm.device
    _check_hdri(hdri, tb, max_depth, r, dev)
    out = torch.empty((9, r), dtype=torch.float32, device=dev)
    flags = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return out, flags
    seg = _segment_args(tb, dev)
    fn = _kernel("wavefront", "wavefront_fwd_launch", _FWD_ARGTYPES, fmad)
    with torch.cuda.device(dev):
        err = fn(
            *_table_and_ray_args(tb, o, d, tm, stream),
            None if hdri is None else hdri.data_ptr(), *seg,
            out.data_ptr(), flags.data_ptr(),
            r, int(seed) & 0xFFFFFFFF, int(max_depth), int(brute_route(tb) == "marble"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wavefront_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, flags


def _wavefront_record_cuda(tb: Tables, o, d, tm, stream, seed, max_depth,
                           hdri=None):
    """Launch the record kernel on PyTorch's current stream; does not
    synchronize.  Returns what ``_wavefront_record_plain`` returns."""
    global LAUNCHES_RECORD
    _check_rays(tb, o, d, tm, stream, max_depth)
    r = tm.shape[0]
    dev = tm.device
    _check_hdri(hdri, tb, max_depth, r, dev)
    out = torch.empty((9, r), dtype=torch.float32, device=dev)
    flags = torch.empty((r,), dtype=torch.int32, device=dev)
    code = torch.empty((max_depth, r), dtype=torch.uint8, device=dev)
    idx = torch.empty((max_depth, r), dtype=torch.int32, device=dev)
    if r == 0:
        return out, flags, code, idx
    seg = _segment_args(tb, dev)
    fn = _kernel("wavefront", "wavefront_record_launch", _RECORD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *_table_and_ray_args(tb, o, d, tm, stream),
            None if hdri is None else hdri.data_ptr(), *seg,
            out.data_ptr(), flags.data_ptr(), code.data_ptr(), idx.data_ptr(),
            r, int(seed) & 0xFFFFFFFF, int(max_depth),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wavefront_record kernel launch failed: CUDA error {err}")
    LAUNCHES_RECORD += 1
    return out, flags, code, idx


def _check_state(flat):
    """Raise unless ``flat`` is the resumable kernel's 21-row path state:
    contiguous [R] tensors on one device, float32 but for the stream and
    the flag word (int32)."""
    if len(flat) != RESUME_IN_ROWS:
        raise ValueError(f"the path state has {RESUME_IN_ROWS} rows, got {len(flat)}")
    r, dev = flat[0].shape[0], flat[0].device
    for i, a in enumerate(flat):
        want = torch.int32 if i in (7, 14) else torch.float32
        if a.device != dev or a.dtype != want or a.shape != (r,) \
                or not a.is_contiguous():
            raise ValueError(
                f"path state row {i} must be a contiguous {want} [{r}] tensor on "
                f"{dev}, got {a.dtype} {tuple(a.shape)} on {a.device}")


def _wavefront_resume_cuda(tb: Tables, flat, seed, b_start, b_end, hdri=None):
    """Launch the resumable kernel on PyTorch's current stream; does not
    synchronize.  Returns what ``_wavefront_resume_plain`` returns (views
    of one [18, R] float32 tensor, and the [R] int32 flag word)."""
    global LAUNCHES_RESUME
    _check_state(flat)
    o, d, tm, stream = flat[0:3], flat[3:6], flat[6], flat[7]
    if not 0 <= b_start <= b_end:
        raise ValueError(f"bounces [{b_start}, {b_end}) are not a range")
    _check_rays(tb, o, d, tm, stream, max(b_end, 1))
    r, dev = tm.shape[0], tm.device
    _check_hdri(hdri, tb, b_end - b_start, r, dev)
    out = torch.empty((18, r), dtype=torch.float32, device=dev)
    flags = torch.empty((r,), dtype=torch.int32, device=dev)
    # the 19 outputs in the order of the JAX package's _call_resume
    res = tuple(out[0:9]) + (flags,) + tuple(out[9:18])
    if r == 0:
        return res
    seg = _segment_args(tb, dev)
    fn = _kernel("wavefront", "wavefront_resume_launch", _RESUME_ARGTYPES)
    ins = (ctypes.c_void_p * RESUME_IN_ROWS)(*[a.data_ptr() for a in flat])
    outs = (ctypes.c_void_p * RESUME_OUT_ROWS)(*[a.data_ptr() for a in res])
    with torch.cuda.device(dev):
        err = fn(tb.pt.data_ptr(), tb.st.data_ptr(), tb.vt.data_ptr(),
                 tb.lt.data_ptr(), tb.n_planar, tb.n_sphere, tb.n_vol, tb.n_lights,
                 ins, outs, None if hdri is None else hdri.data_ptr(), *seg, r,
                 int(seed) & 0xFFFFFFFF, int(b_start), int(b_end),
                 int(brute_route(tb) == "marble"), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wavefront_resume kernel launch failed: CUDA error {err}")
    LAUNCHES_RESUME += 1
    return res


def _wavefront_grad_fwd_cuda(tb: Tables, o, d, tm, stream, seed, max_depth,
                             miss, pathwise=False):
    """Launch the gradient forward on PyTorch's current stream; does not
    synchronize.  Returns what ``_wavefront_grad_fwd_plain`` returns."""
    global LAUNCHES_GRAD_FWD, LAUNCHES_GRAD_FWD_PATHWISE
    _check_rays(tb, o, d, tm, stream, max_depth)
    r = tm.shape[0]
    dev = tm.device
    out = torch.empty((9, r), dtype=torch.float32, device=dev)
    flags = torch.empty((r,), dtype=torch.int32, device=dev)
    miss_col = torch.empty((3, r), dtype=torch.float32, device=dev)
    f_rows = pathwise_stash_rows(tb) if pathwise else STASH_F_ROWS
    stash_f, stash_i = _empty_stash(r, max_depth, dev, f_rows)
    if r == 0:
        return out, flags, miss_col, stash_f, stash_i
    mode, bg = miss
    fn = _kernel("wavefront", "wavefront_grad_fwd_pathwise_launch" if pathwise
                 else "wavefront_grad_fwd_launch", _GRAD_FWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *_table_and_ray_args(tb, o, d, tm, stream),
            out.data_ptr(), flags.data_ptr(), miss_col.data_ptr(),
            stash_f.data_ptr(), stash_i.data_ptr(),
            r, int(seed) & 0xFFFFFFFF, int(max_depth),
            int(mode), float(bg[0]), float(bg[1]), float(bg[2]),
            f_rows if pathwise else int(_has_noise(tb)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"wavefront_grad_fwd kernel launch failed: CUDA error {err}")
    if pathwise:
        LAUNCHES_GRAD_FWD_PATHWISE += 1
    else:
        LAUNCHES_GRAD_FWD += 1
    return out, flags, miss_col, stash_f, stash_i


def _check_rev_inputs(stash_f, stash_i, g3, miss_col, f_rows):
    dev = stash_f.device
    depth, r = stash_f.shape[0], stash_f.shape[2]
    for a, shape, dtype in ((stash_f, (depth, f_rows, r), torch.float32),
                            (stash_i, (depth, STASH_I_ROWS, r), torch.int32),
                            (g3, (3, r), torch.float32),
                            (miss_col, (3, r), torch.float32)):
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(
                f"expected a contiguous {dtype} {shape} tensor on {dev}, got "
                f"{a.dtype} {tuple(a.shape)} on {a.device}")
    if depth < 1:
        raise ValueError("the stash holds no bounce")


def _wavefront_grad_rev_cuda(stash_f, stash_i, g3, miss_col, n_tex):
    """Launch the reverse sweep on PyTorch's current stream; does not
    synchronize.  Returns [n_tex, 3, 3] f32: the kernel writes one row of
    partial sums a block, in an order fixed by the ray count, and the rows
    are added here."""
    global LAUNCHES_GRAD_REV
    dev = stash_f.device
    depth, r = stash_f.shape[0], stash_f.shape[2]
    _check_rev_inputs(stash_f, stash_i, g3, miss_col, STASH_F_ROWS)
    if not 0 < n_tex <= GRAD_MAX_TEX:
        raise ValueError(
            f"the reverse kernel's accumulator holds 1 to {GRAD_MAX_TEX} "
            f"textures, got {n_tex}")
    n_acc = 9 * n_tex
    if r == 0:
        return torch.zeros((n_tex, 3, 3), dtype=torch.float32, device=dev)
    block_rays = _kernel("wavefront_grad", "wavefront_grad_rev_block_rays", [])()
    partial = torch.empty((-(-r // block_rays), n_acc), dtype=torch.float32,
                          device=dev)
    fn = _kernel("wavefront_grad", "wavefront_grad_rev_launch",
                 _GRAD_REV_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(stash_f.data_ptr(), stash_i.data_ptr(), g3.data_ptr(),
                 miss_col.data_ptr(), partial.data_ptr(), r, depth, n_acc,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"wavefront_grad_rev kernel launch failed: CUDA error {err}")
    LAUNCHES_GRAD_REV += 1
    return partial.sum(dim=0).reshape(n_tex, 3, 3)


def _wavefront_grad_rev_pathwise_cuda(tb: Tables, stash_f, stash_i, g3,
                                      miss_col, stream, seed, miss_mode, n_tex,
                                      n_mat, lmd=None):
    """Launch the pathwise reverse sweep on PyTorch's current stream; does
    not synchronize.  Returns what ``_wavefront_grad_rev_pathwise_plain``
    returns.  As in the product reverse, the kernel writes one row of
    partial sums a block in an order fixed by the ray count, and the rows
    are added here: the result is the same bit for bit on every run."""
    global LAUNCHES_GRAD_REV_PATHWISE
    dev = stash_f.device
    depth, r = stash_f.shape[0], stash_f.shape[2]
    _check_rev_inputs(stash_f, stash_i, g3, miss_col, pathwise_stash_rows(tb))
    if stream.device != dev or stream.dtype != torch.int32 \
            or stream.shape != (r,) or not stream.is_contiguous():
        raise ValueError("stream must be a contiguous int32 [R] tensor on "
                         "the stash's device")
    for tab, rows in ((tb.vt, VT_ROWS), (tb.lt, LT_ROWS)):
        if tab.device != dev or tab.dtype != torch.float32 \
                or tab.shape[0] != rows or not tab.is_contiguous():
            raise ValueError("tables must be contiguous float32 on the stash's device")
    if tb.n_vol > 4 or tb.n_lights > 8:
        raise ValueError("the kernel takes at most 4 volumes and 8 lights")
    miss_mode = int(miss_mode)
    if (miss_mode == MISS_STREAM) != (lmd is not None):
        raise ValueError("the cotangent of the miss direction (lmd) comes with "
                         "miss_mode MISS_STREAM, and only with it")
    if lmd is not None and (lmd.device != dev or lmd.dtype != torch.float32
                            or tuple(lmd.shape) != (3, r) or not lmd.is_contiguous()):
        raise ValueError(f"lmd must be a contiguous float32 [3, {r}] tensor on {dev}")
    n_col = 9 * n_tex
    n_acc = n_col + 2 * n_mat
    if n_tex < 1 or n_mat < 1 or n_acc > GRAD_PATHWISE_MAX_ACC:
        raise ValueError(
            f"the pathwise reverse kernel holds {GRAD_PATHWISE_MAX_ACC} "
            f"accumulators (9 a texture, 2 a material), got {n_tex} textures "
            f"and {n_mat} materials")
    if r == 0:
        sums = torch.zeros(n_acc, dtype=torch.float32, device=dev)
    else:
        lib = "wavefront_grad_pathwise"
        block_rays = pathwise_rev_block_rays(stash_f.shape[1], n_acc)
        partial = torch.empty((-(-r // block_rays), n_acc), dtype=torch.float32,
                              device=dev)
        fn = _kernel(lib, "wavefront_grad_rev_pathwise_launch",
                     _GRAD_REV_PATHWISE_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(tb.lt.data_ptr(), tb.n_lights, tb.vt.data_ptr(), tb.n_vol,
                     stash_f.data_ptr(), stash_i.data_ptr(), g3.data_ptr(),
                     miss_col.data_ptr(), None if lmd is None else lmd.data_ptr(),
                     stream.data_ptr(), partial.data_ptr(),
                     r, int(seed) & 0xFFFFFFFF, depth, n_col, n_acc, miss_mode,
                     stash_f.shape[1], torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"wavefront_grad_rev_pathwise kernel launch failed: CUDA error {err}")
        LAUNCHES_GRAD_REV_PATHWISE += 1
        sums = partial.sum(dim=0)
    mats = sums[n_col:].reshape(n_mat, 2)
    return (sums[:n_col].reshape(n_tex, 3, 3), mats[:, 0].contiguous(),
            mats[:, 1].contiguous())


def _wavefront_grad_fused_plain(tb: Tables, o, d, tm, stream, seed, max_depth,
                                g3, miss, env_rows, hdri, n_tex, n_mat):
    """Plain version of the fused gradient kernel: the pathwise gradient
    forward (with the HDRI rows), the miss term, then the pathwise reverse
    sweep over its stash.  ``miss`` = (mode, background); ``env_rows``
    [6, R]: with ``MISS_STREAM`` the per-ray miss colour and the cotangent
    of the miss direction, else None.  Returns (radiance [3, R] with the
    miss term, [n_tex, 3, 3], fuzz [n_mat], ior [n_mat], eout [D, 3, R] or
    None)."""
    out, flags, mc, stash_f, stash_i = _wavefront_grad_fwd_plain(
        tb, o, d, tm, stream, seed, max_depth, miss, pathwise=True, hdri=hdri)
    lmd = None
    if int(miss[0]) == MISS_STREAM:
        missed = (flags & FLAG_MISSED) != 0
        mc = torch.where(missed, env_rows[:3], 0.0)
        lmd = env_rows[3:6]
    rad = torch.stack([out[c] + out[6 + c] * mc[c] for c in range(3)])
    grads, fuzz, ior, eout = _pathwise_reverse_plain(
        tb, stash_f, stash_i, g3, mc, stream, seed, miss[0], n_tex, n_mat,
        lmd=lmd, hdri=hdri)
    return rad, grads, fuzz, ior, eout


def _wavefront_grad_fused_cuda(tb: Tables, o, d, tm, stream, seed, max_depth,
                               g3, miss, env_rows, hdri, n_tex, n_mat):
    """Launch the fused gradient kernel on PyTorch's current stream; does
    not synchronize.  Returns what ``_wavefront_grad_fused_plain`` returns.
    The kernel writes one row of partial sums a block, in an order fixed by
    the ray count, and the rows are added here: the same bits every run."""
    global LAUNCHES_GRAD_FUSED
    _check_rays(tb, o, d, tm, stream, max_depth)
    r = tm.shape[0]
    dev = tm.device
    _check_hdri(hdri, tb, max_depth, r, dev)
    mode, bg = int(miss[0]), miss[1]
    if max_depth > FUSED_MAX_DEPTH:
        raise ValueError(f"the fused kernel takes at most {FUSED_MAX_DEPTH} bounces")
    for a, rows in ((g3, 3), (env_rows, 6)):
        if a is None:
            continue
        if a.device != dev or a.dtype != torch.float32 or tuple(a.shape) != (rows, r) \
                or not a.is_contiguous():
            raise ValueError(f"expected a contiguous float32 [{rows}, {r}] tensor on {dev}")
    if (mode == MISS_STREAM) != (env_rows is not None):
        raise ValueError("env_rows come with miss mode MISS_STREAM, and only with it")
    n_col = 9 * n_tex
    n_acc = n_col + 2 * n_mat
    if n_tex < 1 or n_mat < 1 or n_acc > GRAD_FUSED_MAX_ACC:
        raise ValueError(
            f"the fused kernel holds {GRAD_FUSED_MAX_ACC} accumulators (9 a "
            f"texture, 2 a material), got {n_tex} textures and {n_mat} materials")
    rad = torch.empty((3, r), dtype=torch.float32, device=dev)
    eout = (torch.empty((max_depth, 3, r), dtype=torch.float32, device=dev)
            if hdri is not None else None)
    if r == 0:
        sums = torch.zeros(n_acc, dtype=torch.float32, device=dev)
    else:
        lib = "wavefront_grad_fused"
        block_rays = _kernel(lib, "wavefront_grad_fused_block_rays", [])()
        partial = torch.empty((-(-r // block_rays), n_acc), dtype=torch.float32,
                              device=dev)
        fn = _kernel(lib, "wavefront_grad_fused_launch", _GRAD_FUSED_ARGTYPES)
        with torch.cuda.device(dev):
            err = fn(*_table_and_ray_args(tb, o, d, tm, stream), g3.data_ptr(),
                     None if env_rows is None else env_rows.data_ptr(),
                     None if hdri is None else hdri.data_ptr(),
                     mode, float(bg[0]), float(bg[1]), float(bg[2]),
                     rad.data_ptr(), None if eout is None else eout.data_ptr(),
                     partial.data_ptr(), r, int(seed) & 0xFFFFFFFF, int(max_depth),
                     n_col, n_acc, int(_has_noise(tb)),
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"wavefront_grad_fused kernel launch failed: CUDA error {err}")
        LAUNCHES_GRAD_FUSED += 1
        sums = partial.sum(dim=0)
    mats = sums[n_col:].reshape(n_mat, 2)
    return (rad, sums[:n_col].reshape(n_tex, 3, 3), mats[:, 0].contiguous(),
            mats[:, 1].contiguous(), eout)


def _occupancy(library: str, function: str, *ints, outputs: int = 2):
    fn = _kernel(library, function, [_I] * len(ints) + [ctypes.POINTER(ctypes.c_int)] * outputs)
    out = [ctypes.c_int() for _ in range(outputs)]
    err = fn(*(int(i) for i in ints), *(ctypes.byref(c) for c in out))
    if err != 0:
        raise RuntimeError(f"{function} failed: CUDA error {err}")
    return tuple(c.value for c in out)


def pathwise_occupancy(marble: bool, smem_bytes: int = 0):
    """(blocks an SM holds at once, threads a block) of the pathwise
    gradient forward (``marble``: its instantiation of a scene with marble)
    with ``smem_bytes`` of tables in shared memory, on the current CUDA
    device, from its registers."""
    return _occupancy("wavefront", "wavefront_pathwise_occupancy", marble, smem_bytes)


# wavefront_tracing_occupancy
TRACING_KERNELS = {"fwd": 0, "grad_fwd": 1, "record": 3, "resume": 7, "grad_fwd_marble": 8,
                   "fwd_marble": 9, "resume_marble": 10}


def tracing_occupancy(kernel: str, culled: bool, smem_bytes: int):
    """The same for ``kernel`` "fwd" (B1), "grad_fwd" (B2), "grad_fwd_marble"
    (B2's instantiation for a scene with marble), "record" (B6), "resume"
    (B11), "fwd_marble" or "resume_marble" (B1's and B11's brute
    instantiations for a scene with marble): ``culled`` its instantiation
    for tables with segments."""
    return _occupancy("wavefront", "wavefront_tracing_occupancy", TRACING_KERNELS[kernel],
                      culled, smem_bytes)


def grad_rev_occupancy(n_acc: int):
    """The same for the product-chain reverse sweep at ``n_acc``
    accumulators."""
    return _occupancy("wavefront_grad", "wavefront_grad_rev_occupancy", n_acc)


def pathwise_rev_occupancy(marble: bool, n_acc: int):
    """(blocks an SM holds at once, threads a block, shared bytes a block)
    of the pathwise reverse sweep at ``n_acc`` accumulators."""
    return _occupancy("wavefront_grad_pathwise", "wavefront_grad_rev_pathwise_occupancy",
                      marble, n_acc, outputs=3)


def pathwise_rev_block_rays(f_rows: int, n_acc: int) -> int:
    """Rays a block of the pathwise reverse sweep takes (one row of partial
    sums each) for a stash of ``f_rows`` float rows a bounce at ``n_acc``
    accumulators."""
    return _kernel("wavefront_grad_pathwise", "wavefront_grad_rev_pathwise_block_rays",
                   [_I, _I])(int(f_rows), int(n_acc))


def pathwise_rev_lane_sums(n_acc: int) -> bool:
    """Does the pathwise reverse sweep without marble sum ``n_acc``
    accumulators a column a lane in tiles sorted by path length (True), or
    a row a warp in the design it shares with the marble stash?"""
    return bool(_kernel("wavefront_grad_pathwise", "wavefront_grad_rev_pathwise_lane_sums",
                        [_I])(int(n_acc)))


def fused_occupancy(marble: bool, smem_bytes: int):
    """The same for the fused gradient kernel, ``smem_bytes`` a block (its
    accumulators, and the tables where they fit)."""
    return _occupancy("wavefront_grad_fused", "wavefront_grad_fused_occupancy", marble,
                      smem_bytes)


def stream_to_i32(stream):
    """Ray counter (any integer dtype, values mod 2**32) -> the int32
    tensor with the same 32-bit pattern, which is what the kernel reads."""
    if stream.dtype == torch.int32:
        return stream.contiguous()
    s = stream.to(torch.int64) & 0xFFFFFFFF
    return (s - ((s >> 31) << 32)).to(torch.int32).contiguous()


def wavefront_fwd(tb: Tables, o, d, tm, stream, seed, max_depth, hdri=None):
    """Forward bounce loop on prepared tables (``hdri``: the HDRI NEE rows
    of ``hdri_rows_for``, or None).  CUDA rays launch the kernel (or raise);
    CPU rays run the plain version."""
    stream = stream_to_i32(stream)
    if tm.is_cuda:
        return _wavefront_fwd_cuda(tb, o, d, tm, stream, seed, max_depth, hdri)
    return _wavefront_fwd_plain(tb, o, d, tm, stream, seed, max_depth, hdri)


def wavefront_record(tb: Tables, o, d, tm, stream, seed, max_depth, hdri=None):
    """The forward and the record of every bounce's outcome: ([9, R] f32,
    [R] i32 as ``wavefront_fwd``'s, code [D, R] u8, idx [D, R] i32; see
    ``DEC_*``).  CUDA rays launch the kernel (or raise); CPU rays run the
    plain version."""
    stream = stream_to_i32(stream)
    impl = _wavefront_record_cuda if tm.is_cuda else _wavefront_record_plain
    return impl(tb, o, d, tm, stream, seed, max_depth, hdri)


def wavefront_resume(tb: Tables, flat, seed, b_start, b_end, hdri=None):
    """Bounces [b_start, b_end) of a carried path state (the resumable
    kernel): ``flat`` is the 21-tuple of [R] tensors (``RESUME_IN_ROWS``;
    the stream and the flag word ``missed | 2 primary | 4 alive | 8 allow``
    int32, the rest float32); returns the 19-tuple (``RESUME_OUT_ROWS``).
    Every random draw is keyed on the absolute bounce, so a ray's result
    over [0, k) then [k, depth) is the forward kernel's over [0, depth).
    ``hdri``: the HDRI NEE rows of bounces [b_start, b_end), or None.  CUDA
    rays launch the kernel (or raise); CPU rays run the plain version."""
    flat = tuple(flat[:7]) + (stream_to_i32(flat[7]),) + tuple(flat[8:])
    impl = _wavefront_resume_cuda if flat[0].is_cuda else _wavefront_resume_plain
    return impl(tb, flat, seed, b_start, b_end, hdri)


def unpack_record(code, idx):
    """The record kernel's code and index rows -> (which [D, R] u8, idx,
    blk_a [D, R] bool, blk_h [D, R] bool)."""
    return ((code & DEC_KIND_MASK), idx, (code & DEC_BLK_A) != 0,
            (code & DEC_BLK_H) != 0)


def wavefront_grad_fwd(tb: Tables, o, d, tm, stream, seed, max_depth, miss,
                       pathwise=False):
    """Gradient forward on prepared tables: the forward's outputs, the miss
    colour and the stash (product rows, or the pathwise rows).  CUDA rays
    launch the kernel (or raise); CPU rays run the plain version.
    ``miss`` = (use_sky, (r, g, b))."""
    stream = stream_to_i32(stream)
    impl = _wavefront_grad_fwd_cuda if tm.is_cuda else _wavefront_grad_fwd_plain
    return impl(tb, o, d, tm, stream, seed, max_depth, miss, pathwise)


def wavefront_grad_rev(stash_f, stash_i, g3, miss_col, n_tex):
    """Reverse sweep over a stash -> [n_tex, 3 variants, 3 channels]
    cotangents.  A CUDA stash launches the kernel (or raises); a CPU stash
    runs the plain version."""
    impl = _wavefront_grad_rev_cuda if stash_f.is_cuda else _wavefront_grad_rev_plain
    return impl(stash_f, stash_i, g3, miss_col, n_tex)


def wavefront_grad_rev_pathwise(tb: Tables, stash_f, stash_i, g3, miss_col,
                                stream, seed, miss_mode, n_tex, n_mat, lmd=None):
    """Pathwise reverse sweep over a pathwise stash -> ([n_tex, 3 variants,
    3 channels], fuzz [n_mat], ior [n_mat]) cotangents.  ``miss_mode``:
    ``MISS_FLAT`` or ``MISS_SKY`` (a bool use_sky reads as one of them), or
    ``MISS_STREAM`` with ``lmd`` [3, R], the cotangent of the miss
    direction under an environment.  A CUDA stash launches the kernel (or
    raises); a CPU stash runs the plain version."""
    impl = (_wavefront_grad_rev_pathwise_cuda if stash_f.is_cuda
            else _wavefront_grad_rev_pathwise_plain)
    return impl(tb, stash_f, stash_i, g3, miss_col, stream_to_i32(stream),
                seed, int(miss_mode), n_tex, n_mat, lmd)


def wavefront_grad_fused(tb: Tables, o, d, tm, stream, seed, max_depth, g3,
                         miss, env_rows, hdri, n_tex, n_mat):
    """The fused gradient kernel on prepared tables: a chunk's pathwise
    gradient forward and reverse sweep in one launch.  Returns (radiance
    [3, R] with the miss term, [n_tex, 3 variants, 3 channels], fuzz
    [n_mat], ior [n_mat], eout [D, 3, R] (with ``hdri``) or None).  CUDA
    rays launch the kernel (or raise); CPU rays run the plain version."""
    stream = stream_to_i32(stream)
    impl = _wavefront_grad_fused_cuda if tm.is_cuda else _wavefront_grad_fused_plain
    return impl(tb, o, d, tm, stream, seed, max_depth, g3, miss, env_rows,
                hdri, n_tex, n_mat)


def _unpack(out, flags):
    return (V3(out[0], out[1], out[2]), V3(out[3], out[4], out[5]),
            V3(out[6], out[7], out[8]), flags)


def _check_scene(scene):
    if not applicable(scene):
        raise NotImplementedError(
            "scene is outside the forward megakernel's gate (meshes, image "
            "textures, non-box media, or too many primitives): see "
            "ROADMAP.md queues A and B")


def uses_hdri_nee(scene) -> bool:
    """Does a lambertian hit sample the environment too (a scene with quad
    lights and an importance-sampled environment)?"""
    return (scene.n_lights > 0 and scene.env is not None
            and scene.env_importance)


def hdri_rows_for(scene, stream, seed, max_depth, texel_ids=False, b_start=0):
    """The HDRI NEE rows of a ray chunk: per bounce of [b_start, max_depth)
    the environment sample (direction 3, emission 3, solid-angle pdf) of
    each ray, drawn from its counter (purposes HDRI_ROW, HDRI_COL) by the
    alias table, as a [(max_depth - b_start) * 7, R] float32 tensor on the
    rays' device.  With ``texel_ids`` also the [max_depth - b_start, R] flat
    texel id of each sample (the fused kernel's ``eout`` rows are summed by
    it)."""
    if b_start >= max_depth and not texel_ids:
        return torch.empty((0, stream.shape[0]), dtype=torch.float32,
                           device=stream.device)
    env = scene.env._replace(data=scene.env.data.detach())
    rows, ids = [], []
    for b in range(b_start, max_depth):
        xi1 = rngmod.uniform(seed, stream, b, rngmod.HDRI_ROW)
        xi2 = rngmod.uniform(seed, stream, b, rngmod.HDRI_COL)
        ld, em, pdf_h = hdri_mod.sample_direction_soa(env, xi1, xi2)
        rows += [ld.x, ld.y, ld.z, em.x, em.y, em.z, pdf_h]
        if texel_ids:
            ids.append(hdri_mod.texel_ids(env, xi1, xi2))
    out = torch.stack(rows).contiguous()
    return (out, torch.stack(ids)) if texel_ids else out


def _packed_gather(rows, order):
    """The [R] rows ``rows`` (int32 ones by their bits) stacked [len, R] and
    gathered along the rays by ``order`` in one launch -> [len, R] float32,
    each row contiguous.  The JAX package moves the rows as one [R, 24] row
    gather, a TPU layout: on the card, building and taking apart that
    layout cost ten times the two kernels of a chunk (PERF.md), the gather
    along [len, R] next to nothing."""
    packed = torch.stack([a if a.dtype == torch.float32 else a.view(torch.float32)
                          for a in rows])
    return packed.index_select(1, order)


def _phase_state_sort(flat, alive):
    """Sort the 21-row path state so that the live rays pack into dense
    blocks, ordered by (origin cell of an 8x8x8 grid over all rays' origins,
    direction octant) for coherent sweeps; dead rays sink to the back, where
    whole blocks find nothing to do.  A stable argsort of a 13-bit key, one
    gather of the stacked rows.  Returns (the sorted 21-tuple, the inverse
    permutation: ray i's slot)."""
    ox, oy, oz, dx, dy, dz = flat[0:6]
    mn = [torch.min(c) for c in (ox, oy, oz)]
    mx = [torch.max(c) for c in (ox, oy, oz)]

    def cell(c, i):
        scale = 8.0 / torch.clamp_min(mx[i] - mn[i], 1e-6)
        return torch.clamp(torch.floor((c - mn[i]) * scale).to(torch.int32), 0, 7)

    octant = ((dx > 0).to(torch.int32) + 2 * (dy > 0).to(torch.int32)
              + 4 * (dz > 0).to(torch.int32))
    key = ((cell(ox, 0) * 8 + cell(oy, 1)) * 8 + cell(oz, 2)) * 8 + octant
    key = torch.where(alive, key, 1 << 13)
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    rows = _packed_gather(flat, order)
    out = tuple(rows[i] if a.dtype == torch.float32 else rows[i].view(a.dtype)
                for i, a in enumerate(flat))
    return out, inv


def _compact_partition(rows12, alive):
    """Stable partition of the live rays: the survivors move to the front in
    their order (two cumsums, no sort), the dead to the back.  Only the 12
    rows a live ray needs move (``rows12`` = origin 3, direction 3, time,
    stream, throughput 3, flag word); radiance and miss rows restart at zero
    and the caller merges them back.  The missed and primary bits are
    stripped first: a live ray never has them, and a dead ray in the tail
    must not report its miss again from a slot whose miss rows are zero.
    Returns (the 21-tuple for ``wavefront_resume``, pos: ray i's slot)."""
    r = rows12[0].shape[0]
    al = alive.to(torch.int64)
    cl = torch.cumsum(al, 0)
    n_live = cl[-1] if r else cl.sum()
    cd = torch.cumsum(1 - al, 0)
    pos = torch.where(alive, cl - 1, n_live + cd - 1)
    order = torch.empty_like(pos)
    order[pos] = torch.arange(r, dtype=pos.dtype, device=pos.device)
    rows12 = tuple(rows12[:11]) + (rows12[11] & (FLAG_ALIVE | FLAG_ALLOW),)
    m = _packed_gather(rows12, order)
    zero = torch.zeros_like(m[0])
    flat2 = (tuple(m[0:7]) + (m[7].view(torch.int32),) + tuple(m[8:11])
             + (zero, zero.clone(), zero.clone(), m[11].view(torch.int32))
             + tuple(zero.clone() for _ in range(6)))
    return flat2, pos


def _start_state(o: V3, d: V3, tm, stream):
    """The 21-row path state of camera rays before their first bounce."""
    zero = torch.zeros_like(tm)
    one = torch.ones_like(tm)
    flags0 = torch.full_like(tm, FLAG_ALIVE | FLAG_ALLOW, dtype=torch.int32)
    return (tuple(o) + tuple(d) + (tm, stream_to_i32(stream))
            + (one, one.clone(), one.clone(), zero, zero.clone(), zero.clone(), flags0)
            + tuple(zero.clone() for _ in range(6)))


def _resumed_state(flat, out):
    """The 21-row state that continues ``flat`` after a ``wavefront_resume``
    launch returned ``out`` (its 19 rows; time and stream carry over)."""
    return (out[10:16] + (flat[6], flat[7]) + out[16:19] + out[0:3] + (out[9],)
            + out[3:9])


def trace_megakernel(scene, cam, o: V3, d: V3, tm, stream, seed, record=False,
                     split=False, compact=False):
    """Full bounce loop for a ray megabatch.  Returns (radiance V3,
    miss_dir V3, miss_tp V3, flags [R] i32) where ``flags`` is
    ``missed | 2*miss_primary | 4*alive | 8*allowLightHits``; the caller
    applies the deferred miss shader (integrator/wavefront.trace).
    ``record=True`` runs the record kernel and appends its record to the
    tuple as ``unpack_record`` gives it.  A scene with HDRI NEE streams its
    rows (``hdri_rows_for``) into the kernels.

    ``split=True`` runs two launches of the resumable kernel: bounces [0,
    SPLIT_AT) in the rays' own order, then, after ``_phase_state_sort``,
    the rest; one gather puts the results back in order.  The
    radiance is that of one forward launch, bit for bit.
    ``compact=True`` runs bounces [0, COMPACT_AT) (at most depth - 1), then
    the rest on the survivors packed to the front by
    ``_compact_partition``; phase 2's radiance starts at zero and is added
    to phase 1's, so the sum may round otherwise than one launch's where
    both phases add light.  Under HDRI NEE the second launch's rows are
    drawn for the moved rays' streams.  The JAX package decides
    ``split=None`` from the SPLIT_* thresholds here; the port takes the
    decision from ``integrator/wavefront.choose_mega_mode`` alone."""
    _check_scene(scene)
    if record and (split or compact):
        raise ValueError("the record kernel runs one phase: record=True takes "
                         "neither split nor compact")
    if split and compact:
        raise ValueError("split and compact exclude each other")
    tb = build_tables(scene)
    depth = cam.max_depth
    use_hdri = uses_hdri_nee(scene)

    def rows(sid, b0, b1):
        return hdri_rows_for(scene, sid, seed, b1, b_start=b0) if use_hdri else None

    if record:
        out, flags, code, idx = wavefront_record(tb, o, d, tm, stream, seed, depth,
                                                 rows(stream, 0, depth))
        return _unpack(out, flags) + (unpack_record(code, idx),)
    if not (split or compact):
        return _unpack(*wavefront_fwd(tb, o, d, tm, stream, seed, depth,
                                      rows(stream, 0, depth)))

    flat = _start_state(o, d, tm, stream)
    k = min(SPLIT_AT, depth) if split else min(COMPACT_AT, depth - 1)
    out1 = wavefront_resume(tb, flat, seed, 0, k, rows(flat[7], 0, k))
    rad1, mdir1, mtp1, flg1 = out1[0:3], out1[3:6], out1[6:9], out1[9]
    state = _resumed_state(flat, out1)
    alive1 = (flg1 & FLAG_ALIVE) != 0
    if split:
        flat2, back = _phase_state_sort(state, alive1)
    else:
        flat2, back = _compact_partition(state[0:11] + (flg1,), alive1)
    out2 = wavefront_resume(tb, flat2, seed, k, depth, rows(flat2[7], k, depth))
    # ray i's phase-2 results sit at slot back[i]: one gather puts them back
    res = _packed_gather(out2[0:10], back)
    flg2 = res[9].view(torch.int32)
    if split:
        return (V3(res[0], res[1], res[2]), V3(res[3], res[4], res[5]),
                V3(res[6], res[7], res[8]), flg2)
    # a ray misses at most once, and a phase-1 miss ends it before the
    # partition: the two miss sets are disjoint
    missed2 = (flg2 & FLAG_MISSED) != 0
    rad = V3(*(rad1[c] + res[c] for c in range(3)))
    m_dir = V3(*(torch.where(missed2, res[3 + c], mdir1[c]) for c in range(3)))
    m_tp = V3(*(torch.where(missed2, res[6 + c], mtp1[c]) for c in range(3)))
    flags = ((flg1 | flg2) & (FLAG_MISSED | FLAG_PRIMARY)) \
        | (flg2 & (FLAG_ALIVE | FLAG_ALLOW))
    return rad, m_dir, m_tp, flags


def trace_megakernel_plain(scene, cam, o: V3, d: V3, tm, stream, seed):
    """``trace_megakernel`` through the plain PyTorch version, on whatever
    device the rays lie."""
    _check_scene(scene)
    tb = build_tables(scene)
    hdri = (hdri_rows_for(scene, stream, seed, cam.max_depth)
            if uses_hdri_nee(scene) else None)
    return _unpack(*_wavefront_fwd_plain(
        tb, o, d, tm, stream_to_i32(stream), seed, cam.max_depth, hdri))


# -----------------------------------------------------------------------------
# Product-chain gradient of one ray chunk
# -----------------------------------------------------------------------------

def _check_grad_scene(scene, max_depth, pathwise=False):
    """Raise unless the scene is inside the gate of the tier asked for."""
    if pathwise:
        if not grad_pathwise_applicable(scene, max_depth):
            raise NotImplementedError(
                "scene is outside the pathwise gradient kernels' gate (more "
                f"than {GRAD_PATHWISE_MAX_ACC} accumulators at 9 a texture "
                "and 2 a material: the replay tier, ROADMAP.md A18; or "
                "otherwise outside the forward megakernel's gate): see "
                "ROADMAP.md queues A and B")
    elif not grad_applicable(scene, max_depth):
        raise NotImplementedError(
            "scene is outside the product-chain gradient kernels' gate "
            "(metal or dielectric materials take the pathwise kernels: "
            f"pass pathwise=True; more than {GRAD_MAX_TEX} textures; or "
            "outside the forward megakernel's gate): see ROADMAP.md queues "
            "A and B")


def miss_config(cam):
    """Camera -> the ``miss`` argument of the gradient kernels: (mode,
    background) with mode ``MISS_SKY`` or ``MISS_FLAT``.  (A scene with an
    environment uses ``MISS_STREAM`` instead.)"""
    return (MISS_SKY if cam.use_sky_gradient else MISS_FLAT,
            tuple(float(x) for x in cam.background))


class EnvCarry(NamedTuple):
    """What a chunk of an environment scene keeps between the two passes
    of a two-phase tier, 19 rows a ray: the 12 texel values of each ray's
    bilinear miss footprint, and its miss records."""

    qcols: torch.Tensor   # [12, R] c00 c10 c01 c11 x rgb of the footprint
    m_dir: torch.Tensor   # [3, R] miss direction
    m_tp: torch.Tensor    # [3, R] throughput at the miss
    flags: torch.Tensor   # [R] i32 flag word (FLAG_*)


def _env_safe_dir(m_dir, missed):
    """The miss direction where the ray missed, +z elsewhere (the miss
    shader's input is then defined on every ray)."""
    return V3(torch.where(missed, m_dir[0], 0.0), torch.where(missed, m_dir[1], 0.0),
              torch.where(missed, m_dir[2], 1.0))


def _env_carry(scene, out, flags) -> EnvCarry:
    """Pass A of an environment scene: the footprint texels of each ray's
    miss and its miss records, from the forward's [9, R] rows."""
    env = scene.env._replace(data=scene.env.data.detach())
    missed = (flags & FLAG_MISSED) != 0
    _, _, base = hdri_mod.miss_footprint(env, _env_safe_dir(out[3:6], missed))
    return EnvCarry(hdri_mod.quad_rows(env, base).contiguous(),
                    out[3:6].contiguous(), out[6:9].contiguous(), flags)


def _env_colour(scene, cam, carry: EnvCarry, d: V3):
    """The miss colour [3, R] of the carry's footprint texels seen from the
    directions ``d`` (the bilinear weights carry a gradient to ``d``), the
    phantom rule applied, 0 where the ray did not miss."""
    fx, fy, _ = hdri_mod.miss_footprint(scene.env, d)
    col = torch.stack(list(hdri_mod.blend_quad(
        [carry.qcols[j] for j in range(12)], fx, fy)))
    if cam.phantom_hdri:
        col = torch.where((carry.flags & FLAG_PRIMARY) != 0, 0.0, col)
    return torch.where((carry.flags & FLAG_MISSED) != 0, col, 0.0)


def _env_miss_terms(scene, cam, carry: EnvCarry, g3, want_lmd: bool):
    """The environment's miss term of a chunk, between the passes: (miss
    colour mc [3, R] (phantom rule applied, 0 where the ray did not miss),
    the cotangent of the miss direction [3, R] or None, the texels'
    cotangent [H, W, 3]).  The texel values are constants of the footprint
    (a gather's index has no derivative), so the direction's cotangent is
    ``torch.autograd`` of the bilinear weights alone, and the texels' the
    per-texel sum of ``lights/hdri.miss_texel_grad``."""
    env = scene.env._replace(data=scene.env.data.detach())
    missed = (carry.flags & FLAG_MISSED) != 0
    safe = _env_safe_dir(carry.m_dir, missed)
    lam = torch.where(missed, g3 * carry.m_tp, 0.0)
    if cam.phantom_hdri:
        lam = torch.where((carry.flags & FLAG_PRIMARY) != 0, 0.0, lam)
    env_grad = hdri_mod.miss_texel_grad(env, safe, V3(*lam))
    lmd = None
    with torch.enable_grad():
        sd = V3(*(x.detach().requires_grad_(want_lmd) for x in safe))
        mc = _env_colour(scene, cam, carry, sd)
        if want_lmd:
            lmd = torch.stack(torch.autograd.grad((lam * mc).sum(), list(sd)))
    return mc.detach().contiguous(), lmd, env_grad


def grad_fwd_stash(scene, cam, o: V3, d: V3, tm, stream, seed, pathwise=False):
    """Gradient forward for one ray chunk.  Returns (radiance V3 with the
    miss colour applied, the chunk's contribution to the framebuffer; carry
    for ``grad_rev_stash``: miss colour [3, R], stash_f, stash_i; under an
    environment (None, stash_f, stash_i, ``EnvCarry``): the kernel leaves
    the miss term out, and it is applied here from the footprint).
    ``pathwise`` picks the tier: the stash rows differ, the radiance does
    not."""
    _check_grad_scene(scene, cam.max_depth, pathwise)
    if scene.env is not None and scene.n_lights > 0:
        raise NotImplementedError(
            "a scene with an environment and quad lights takes the fused "
            "kernel (grad_megakernel), not the two-phase route")
    tb = build_tables(scene)
    miss = miss_config(cam) if scene.env is None else (MISS_STREAM, (0.0, 0.0, 0.0))
    out, flags, miss_col, stash_f, stash_i = wavefront_grad_fwd(
        tb, o, d, tm, stream, seed, cam.max_depth, miss, pathwise)
    if scene.env is None:
        rad = V3(*(out[c] + out[6 + c] * miss_col[c] for c in range(3)))
        return rad, (miss_col, stash_f, stash_i)
    env_carry = _env_carry(scene, out, flags)
    missed = (flags & FLAG_MISSED) != 0
    mc = _env_colour(scene, cam, env_carry, _env_safe_dir(env_carry.m_dir, missed))
    rad = V3(*(out[c] + out[6 + c] * mc[c] for c in range(3)))
    return rad, (None, stash_f, stash_i, env_carry)


def grad_rev_stash(scene, cam, g3, carry, pathwise=False, stream=None, seed=0):
    """Reverse sweep for one ray chunk against the carry of
    ``grad_fwd_stash``.  ``g3``: [3, R] cotangent of the chunk's radiance
    (or three [R] rows).  Returns dict(color, even_color, odd_color), each
    [n_tex, 3]: the cotangents of the scene's texture colour tables; with
    ``pathwise`` also fuzz and ior, each [n_mat]; under an environment also
    env_data [H, W, 3].  The pathwise sweep recomputes the rays' random
    draws, so it also takes the chunk's ``stream`` ids and the ``seed`` the
    forward was given."""
    _check_grad_scene(scene, cam.max_depth, pathwise)
    miss_col, stash_f, stash_i = carry[:3]
    if not isinstance(g3, torch.Tensor):
        g3 = torch.stack(list(g3))
    g3 = g3.contiguous()
    n_tex = int(scene.textures.color.shape[0])
    lmd = env_grad = None
    miss_mode = miss_config(cam)[0]
    if scene.env is not None:
        miss_col, lmd, env_grad = _env_miss_terms(scene, cam, carry[3], g3,
                                                  want_lmd=pathwise)
        miss_mode = MISS_STREAM
    if not pathwise:
        grads = wavefront_grad_rev(stash_f, stash_i, g3, miss_col, n_tex)
        out = dict(color=grads[:, 0], even_color=grads[:, 1],
                   odd_color=grads[:, 2])
    else:
        if stream is None:
            raise ValueError("the pathwise reverse sweep needs the chunk's stream ids")
        grads, fuzz, ior = wavefront_grad_rev_pathwise(
            build_tables(scene), stash_f, stash_i, g3, miss_col, stream, seed,
            miss_mode, n_tex, int(scene.materials.kind.shape[0]), lmd)
        out = dict(color=grads[:, 0], even_color=grads[:, 1],
                   odd_color=grads[:, 2], fuzz=fuzz, ior=ior)
    if env_grad is not None:
        out["env_data"] = env_grad
    return out


def grad_megakernel(scene, cam, o: V3, d: V3, tm, stream, seed, g3,
                    pathwise=True):
    """The gradient of one ray chunk by the fused kernel (forward and
    pathwise reverse sweep in one launch; the route of a scene with an
    environment and quad lights).  ``g3``: [3, R] cotangent of the chunk's
    radiance.  Returns (radiance V3 with the miss term, dict of the
    gradients: color, even_color, odd_color [n_tex, 3], fuzz, ior [n_mat],
    and under an environment env_data [H, W, 3]).

    Under an environment a forward launch first gives the miss records; the
    miss colour and the cotangents of the miss direction and of the texels
    are computed from them in torch (as between the passes of the two-phase
    tiers), and the first two go into the kernel as rows.  With HDRI NEE
    the kernel also takes the environment samples (``hdri_rows_for``) and
    gives back the cotangent of each bounce's sample's texel (``eout``),
    summed here per texel by the same draws' texel ids."""
    if not pathwise:
        raise NotImplementedError(
            "the fused kernel is the pathwise tier's: pass pathwise=True")
    if not grad_fused_applicable(scene, cam.max_depth):
        raise NotImplementedError(
            "scene is outside the fused gradient kernel's gate (the pathwise "
            f"gate and at most {FUSED_MAX_DEPTH} bounces): see ROADMAP.md "
            "queues A and B")
    if not isinstance(g3, torch.Tensor):
        g3 = torch.stack(list(g3))
    g3 = g3.contiguous()
    tb = build_tables(scene)
    depth = cam.max_depth
    hdri = ids = None
    if uses_hdri_nee(scene):
        hdri, ids = hdri_rows_for(scene, stream, seed, depth, texel_ids=True)
    n_tex = int(scene.textures.color.shape[0])
    n_mat = int(scene.materials.kind.shape[0])
    env_rows = env_grad = None
    miss = miss_config(cam)
    if scene.env is not None:
        out, flags = wavefront_fwd(tb, o, d, tm, stream, seed, depth, hdri)
        mc, lmd, env_grad = _env_miss_terms(scene, cam, _env_carry(scene, out, flags),
                                            g3, want_lmd=True)
        env_rows = torch.cat([mc, lmd]).contiguous()
        miss = (MISS_STREAM, (0.0, 0.0, 0.0))
        del out, flags
    rad, grads, fuzz, ior, eout = wavefront_grad_fused(
        tb, o, d, tm, stream, seed, depth, g3, miss, env_rows, hdri, n_tex, n_mat)
    gd = dict(color=grads[:, 0], even_color=grads[:, 1], odd_color=grads[:, 2],
              fuzz=fuzz, ior=ior)
    if env_grad is not None:
        if eout is not None:
            h, w = scene.env.data.shape[:2]
            env_grad = env_grad + cols_segment_sum(
                ids, eout.transpose(0, 1), h * w).reshape(h, w, 3)
        gd["env_data"] = env_grad
    return V3(rad[0], rad[1], rad[2]), gd


def _with_colours(scene, color, even_color, odd_color):
    return dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, color=color, even_color=even_color,
        odd_color=odd_color))


class ProductChainTrace(torch.autograd.Function):
    """Radiance [3, R] of a ray chunk as a function of the three texture
    colour tables, for a caller's own loss:

        rad = ProductChainTrace.apply(color, even_color, odd_color,
                                      scene, cam, o, d, tm, stream, seed)
        loss_of(rad).backward()

    Forward is ``grad_fwd_stash`` (it keeps the chunk's stash until the
    backward), backward is ``grad_rev_stash``."""

    @staticmethod
    def forward(ctx, color, even_color, odd_color, scene, cam, o, d, tm,
                stream, seed):
        scene = _with_colours(scene, color.detach(), even_color.detach(),
                              odd_color.detach())
        rad, carry = grad_fwd_stash(scene, cam, o, d, tm, stream, seed)
        ctx.scene, ctx.cam, ctx.carry = scene, cam, carry
        return torch.stack(list(rad))

    @staticmethod
    def backward(ctx, g):
        grads = grad_rev_stash(ctx.scene, ctx.cam, g.contiguous(), ctx.carry)
        ctx.carry = None
        return (grads["color"], grads["even_color"], grads["odd_color"],
                None, None, None, None, None, None, None)


class PathwiseTrace(torch.autograd.Function):
    """Radiance [3, R] of a ray chunk as a function of fuzz, ior and the
    three texture colour tables, for scenes with metal or glass:

        rad = PathwiseTrace.apply(fuzz, ior, color, even_color, odd_color,
                                  scene, cam, o, d, tm, stream, seed)
        loss_of(rad).backward()

    Forward is ``grad_fwd_stash(pathwise=True)``, backward is
    ``grad_rev_stash(pathwise=True)``."""

    @staticmethod
    def forward(ctx, fuzz, ior, color, even_color, odd_color, scene, cam, o, d,
                tm, stream, seed):
        scene = _with_colours(scene, color.detach(), even_color.detach(),
                              odd_color.detach())
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, fuzz=fuzz.detach(), ior=ior.detach()))
        rad, carry = grad_fwd_stash(scene, cam, o, d, tm, stream, seed,
                                    pathwise=True)
        ctx.scene, ctx.cam, ctx.carry = scene, cam, carry
        ctx.stream, ctx.seed = stream, seed
        return torch.stack(list(rad))

    @staticmethod
    def backward(ctx, g):
        grads = grad_rev_stash(ctx.scene, ctx.cam, g.contiguous(), ctx.carry,
                               pathwise=True, stream=ctx.stream, seed=ctx.seed)
        ctx.carry = None
        return (grads["fuzz"], grads["ior"], grads["color"],
                grads["even_color"], grads["odd_color"],
                None, None, None, None, None, None, None)


# Rows of the tables that hold texture colours: what a gradient flows to.
_COLOUR_ROWS = dict(pt=(19, 28), st=(11, 20), vt=(21, 24), lt=(13, 16))


def autograd_colour_grads(scene, cam, o: V3, d: V3, tm, stream, seed, g3):
    """Oracle of the gradient kernels: ``torch.autograd`` through the plain
    forward.  Returns the dict ``grad_rev_stash`` returns, for the loss
    sum(radiance * g3).

    Only the colour rows of the tables carry a gradient; geometry is
    detached, because a zero cotangent times an infinite local derivative
    (sqrt at 0, a clamped division) is NaN, and no colour depends on it."""
    _check_grad_scene(scene, cam.max_depth)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (scene.textures.color, scene.textures.even_color,
                        scene.textures.odd_color)]
    with torch.enable_grad():
        tb = build_tables(_with_colours(scene, *leaves))
        tabs = {}
        for name, (lo, hi) in _COLOUR_ROWS.items():
            tab = getattr(tb, name)
            fixed = tab.detach()
            tabs[name] = torch.cat([fixed[:lo], tab[lo:hi], fixed[hi:]])
        tb = tb._replace(**tabs)
        out, flags = _wavefront_fwd_plain(
            tb, o, d, tm, stream_to_i32(stream), seed, cam.max_depth)
        miss_col = _miss_colour_rows(out.detach(), flags, miss_config(cam))
        loss = sum(((out[c] + out[6 + c] * miss_col[c]) * g3[c]).sum()
                   for c in range(3))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return dict(color=grads[0], even_color=grads[1], odd_color=grads[2])
