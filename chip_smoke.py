#!/usr/bin/env python3
"""GPU smoke check of the PyTorch/CUDA port (go_raytracing_tpu_torch).

    python3 chip_smoke.py [--out-dir DIR]

Needs one NVIDIA GPU and ``nvcc``.  It builds the sixteen CUDA kernels
from the sources in this checkout (the forward megakernel, its record
variant and its resumable variant, the stash-writing gradient forward and
the reverse sweep of the product-chain tier, the same two of the pathwise
tier, the fused gradient kernel of environment + light scenes, the four
closest-hit kernels of the standard integrator, the two mesh kernels, the
tile-sweep probe of the mesh stream, and the row sums of ``take_rows``'
backward pass, whose file also holds the sorted segment sums of an
environment's texels), holds each against its plain
PyTorch version on the GPU, renders the Cornell box at full size (600x338,
100 spp, depth 5) through the public entry points, checks the image, times
the forward kernel at the render's own shapes beside its roofline bound,
times three more scenes for the record, then takes the loss and the
gradients of the same Cornell job through ``render_grad`` (everything
stashed, and once more with a stash budget of two chunks), checks them, and
times the two gradient kernels alone.  Then the pathwise tier: the loss and
the gradients (fuzz and IOR among them) of ``cornell-glossy`` at 600x600,
100 spp, depth 5 through ``render_grad`` on both routes, and its two
kernels alone.  Then the standard integrator: its four closest-hit kernels
against their plain versions, the Cornell job again through
``render_image(mega_mode="off")`` held against the megakernel's picture, a
scene the megakernel cannot take (round and pyramid fog) on both of the
integrator's routes, ``random`` with ``mega_mode="off"``, ``torch.autograd``
through ``render(differentiable=True)`` held against ``render_grad``, the
four kernels alone, and the two planar ones (B7a, B8p) on the launches one
Cornell chunk makes on the integrator's fast route, each with its share of
live rays and its bound (``planar_path_timing``).  Then meshes: both mesh kernels against their plain
versions (``mesh_kernels_vs_plain``), ``cornell-lucy`` at the JAX package's
bench size (600x600, 25 spp, depth 5, 112,128 triangles x 10 instances)
through ``render_image`` with a crop held against the plain versions on the
CPU (``mesh_main_path``, ``mesh_stream``), the same at the scene's default
3,744 triangles (``mesh_small_path``, ``mesh_sweep``), autograd through a
mesh scene (``mesh_autograd``) and the two kernels alone
(``mesh_kernel_timing``; each also in its any-hit instantiation on the same
chunk and on the rays that leave the chunk's first hits, as a render's
launches are, ``mesh_sweep`` on each of its four sets held to its plain
version on every ray).  Then the replay tier of ``render_grad``: the
record kernel against the forward kernel, its plain version and the
standard integrator's record (``record_kernel_vs_plain``, early; the
culled sphere sweep of B6, B1 and B11 against their plain versions on the
test sets of rays at segment and group box corners, edges and axes, ties, a
ground sphere and 63 / 64 / 65 spheres, ``culled_sweep_sets``), ``random``
(600x337, 25 spp, depth 10, recorded by the record kernel) and
``cornell-lucy`` (600x600, 25 spp, depth 5, 112,128 triangles x 10,
recorded through ``mesh_stream``) at full size (``replay_random_fwd_bwd``,
``replay_lucy_fwd_bwd``), a ``torch.profiler`` split of one replay chunk
(``replay_profile``), the record kernel alone beside B1 on the same rays,
with the box and sphere tests its culled sweep needs (counted by the
sweep's plain mirror on the whole chunk) and both bounds, the culled and
the brute sweep's (``record_kernel_timing``), the card's speed
(``card_yardstick``: three kernels that keep their design, B3, B6 culled and
B7b, beside their times in PERF.md, so that a slow card does not read as a
redesign's loss), B1 alone at ``random``'s
render chunk (4,066,304 rays, depth 10) held to its plain version bit for
bit, with its sweep's tests and both bounds (``forward_random_timing``),
both scenes at 32x32 against the CPU's plain versions and autograd
(``replay_check``), the row-sum kernel of ``take_rows``' backward pass
(``row_sums_kernel``; not a port of a TPU kernel, so not in the ``kernels``
line) and the bits of repeated gradients (``grad_bit_stable``).  Then
environments (ROADMAP A15) at the JAX bench's ``hdri-test`` size (800x450,
25 spp, depth 10, under a synthetic 1024x512 sky from a fixed seed, the
reference's asset not being in the repository): the environment kernels
against their plain versions on 16,384 rays (B1 and B6 with the HDRI NEE
rows, B5b with the environment's miss rows, the fused kernel B4, also on
4,096 of them at depth 20, and B4 against autograd on a 32x32 crop), ``hdri-test`` forward by the megakernel
and by the standard integrator (``hdri_main_path``), its ``render_grad`` on
the pathwise two-phase tier (``hdri_fwd_bwd``), the same two with a quad
light added (``env_nee_main_path``, ``env_nee_fwd_bwd``: HDRI NEE, the fused
tier), and the kernels alone (``env_kernel_timing``).  Then marble
(``noise_kernels_vs_plain`` ... ``split_profile``: B1 / B6 / B2 with marble,
perlin, the resumable kernel B11, also on ``random`` at depth 50 with its
culled sweep's tests and both bounds), then B1 below 64 spheres alone
by depth and on the same rays in order of path length, at Cornell's chunk,
``hdri-test-nee``'s with its rows and perlin's, each held to its plain
version bit for bit (``b1_brute_timing``), then marble behind metal and glass
(ROADMAP A13b): B5a, B5b and B4 with dmarble/dp against their plain versions
and the pathwise and fused tiers against the replay tier on 16,384 rays
(``marble_kernels_vs_plain``), ``marble-glossy`` (the JAX package's noise +
glossy test scene at 600x600, 100 spp, depth 5) fwd+bwd on the pathwise
tier all stashed and over budget, ``marble-glossy-nee`` (the same under the
synthetic sky with its quad light, 800x450, 25 spp, depth 10) on the fused
tier, each beside the same job through the replay tier (``marble-glossy``
cut to 25 spp there), and the three kernels alone
(``marble_kernel_timing``).  Then image textures (ROADMAP A16), under a
synthetic 1024x512 atlas from a fixed seed (the earth scene's
``earthmap.jpg`` is not in the repository): the JAX bench's ``earth``
(400x225, 25 spp, depth 10) forward on the 'image' route (B1 on the scene
with its image made white, then the sphere kernel B7b and one gather a
camera ray) against the standard integrator's picture, and once at the
scene's own camera (800x450, 100 spp, depth 50) (``image_main_path``);
``earth-fwd-bwd`` on the image tier (B2 and B3 on the white scene, the
per-texel sums for the atlas) twice with the same bits, over budget, and
against the replay tier (``image_fwd_bwd``); the Cornell box with the atlas
as a picture on its back wall through the standard integrator, one chunk
under the profiler, autograd and the replay tier at 8 spp, each twice with
the same bits (``image_standard``).  Last, the tile-sweep probe of the mesh stream
(``probe_stream_micro``: its five variants against their plain versions,
then its command line's run at 512 blocks x 512 sweeps).  The earlier
phases run at the sizes they always had.  It prints one JSON line per
phase.
The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase raises: the exit code is then not 0 and no result line
is printed.  On a machine without a CUDA device it fails at once.

Tolerances.  The kernel and its plain version share every formula and every
random bit.  An ulp can flip a discrete decision (a grazing ray's hit on
its own wall, a hit at a quad's edge, a Schlick draw, a volume accept) and
such a ray differs wholly, so the comparison is per ray: fewer than 0.5 %
of rays outside rtol 1e-3 / atol 1e-3 (or with another flag word), and
mean radiance within 1 %.  The kernel is built without fused multiply-add
contraction and is expected to agree on every ray; the contracted build is
compared and timed beside it, for the record only.  B1 and B11 below 64
spheres (both of their routes, with marble and without) are held to their
plain versions bit for bit on every set, Cornell's full chunk among them.

The gradient forward is the same bounce loop, so its radiance, flags, miss
colour and stash are held to the same per-ray gate.  The reverse kernel adds
float32 terms in a fixed tree (warp butterfly, warps of a block, blocks),
its plain version adds the same float32 terms in float64: they agree to
1e-4 of the largest entry of the result.  Against ``torch.autograd`` through
the plain forward (other formulas for the same derivative) the gate is 2e-3
of the largest entry of each colour table, the tolerance of the JAX
package's own test of its gradient kernel.

The pathwise gradient forward is held to the same per-ray gate (19 + 3 stash
rows, 20 + 3 with marble, whose rows and mask words must equal the plain
version's bits) and its radiance must be the forward kernel's bit for bit;
without marble (B5a <2>, tiles of 128 rays a bounce at a time) every output
and stash row must equal the plain version's bits, on the 16,384-ray sets and
on ``cornell-glossy``'s full chunk.  The
pathwise reverse kernel is held against its plain version on the kernel's
own stash: each key of the gradients dict (three colour tables, fuzz, ior)
within 1e-4 of the key's largest entry; and two launches on one stash must
give the same bits; with marble also on stashes whose marble rows are set
warp by warp (0, 1 or 32 marble lanes; a ray's first and last bounce),
depth 1 to 50 (``b5b_marble_lanes``).  Autograd is no oracle of this tier (behind a fuzzy
metal a colour's gradient also flows through positions): the plain version
is held against the JAX kernel, and that against ``jax.grad``, by the tests.

The closest-hit kernels are held to equality: hit, index, t and every
attribute row of a ray are the plain version's bits, or the ray counts as a
mismatch; no ray of the planar kernels may differ (on every set: t_max BIG,
halved, -1 on dead rays in several layouts, t_min 0, Cornell's full chunk and
its own launches), and the sphere kernels' gate is 0.5 % of rays (0.0
expected).  The standard integrator's
pictures are held against the megakernel's, and its two routes against each
other, on the tonemapped image at rtol 1e-3 / atol 2e-3, the tolerance of
the JAX package's own test of the same pair; a ray whose branch flips on a
last digit moves its pixel by more than that, so the share of pixel
channels outside is printed and gated at 0.5 %.  Autograd's colour
gradients are held against ``render_grad``'s at 2e-3 of the largest entry.

The mesh kernels are held to equality too: hit, the bits of t, tri and inst
(any-hit mode: hit) are the plain version's, or the ray counts as a mismatch
(gate 0.5 %, 0.0 expected).  A mesh render's 32x32 crop at 1 spp, traced on
the card and by the plain versions on the CPU, is held to rtol 1e-3 / atol
2e-3 on the tonemapped pixels (gate 0.5 % of channels).

The environment phases hold B1 and B6 with the HDRI rows to their plain
versions by equality, B5b with the environment's rows and the fused kernel
B4 to theirs within 1e-4 of each key's largest entry (B4's radiance the
forward's bits plus the miss term, its texel rows within 1e-4 of their
largest), both with the same bits on two launches, B4's colour and texel
gradients to autograd through the standard integrator within 2e-3, each
``render_grad``'s loss to that of ``render``'s picture (rtol 1e-5) and two
calls' gradients to each other's bits.

The record kernel's radiance and flags must be the forward kernel's bits and
its record its plain version's on every ray-bounce (gate 0.0; with 64
spheres and more the kernel's sweep is culled, the plain version's brute:
the least (t, scene index) makes them the same bits); each field
must equal the standard integrator's record on 99.9 % of ray-bounces (ties
break otherwise between the two sweeps).  The replay tier's loss must be
the loss of ``render``'s picture (rtol 1e-5), its gradients finite, the
card's within 2e-3 of each key's largest entry of the CPU's, colour
gradients within 2e-3 of autograd's, and the gradients of repeated calls
(and of two autograd backward passes) the same bits.  The row-sum kernel
agrees with its float64 plain version to 1e-4 of the largest entry.  The
pathwise and fused tiers with marble agree with the replay tier within 2e-3
of each key's largest entry on the same rays, and the probe's five variants
equal their plain versions (t and id).
"""

import argparse
import dataclasses
import functools
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

import go_raytracing_tpu_torch as grt
from go_raytracing_tpu_torch.camera import Camera, generate_rays
from go_raytracing_tpu_torch.core import segsum
from go_raytracing_tpu_torch.integrator import wavefront
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.ops import _build
from go_raytracing_tpu_torch.ops import cuda_intersect as ck
from go_raytracing_tpu_torch.ops import cuda_mesh as cm
from go_raytracing_tpu_torch.ops import cuda_rows as cr
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as gradmod
from go_raytracing_tpu_torch.render import renderer
from go_raytracing_tpu_torch.scenes import builders
from go_raytracing_tpu_torch.utils import stream_micro as sm

# the shared scene and ray builders of the port's tests (culled-sweep sets,
# marble lane patterns)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
import test_torch_helpers as th  # noqa: E402

RTOL = ATOL = 1e-3
MAX_MISMATCH_SHARE = 0.005
MAX_MEAN_REL_DIFF = 0.01
REV_RTOL_OF_LARGEST = 1e-4
AUTOGRAD_RTOL_OF_LARGEST = 2e-3
IMAGE_RTOL, IMAGE_ATOL = 1e-3, 2e-3
MAX_PIXEL_SHARE_OUTSIDE = 0.005

# Published peaks of one H100 SXM (NVIDIA data sheet): the yardstick of
# bound_ms whatever the card's power limit, which is printed beside it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# Least float32 operations of one closest-hit sweep step, per candidate:
#   planar: n.d (5), (D - n.o)/denom (7)                           = 12
#   sphere: centre at time t (6), oc (3), h (5), c (6), disc (3)   = 23
#   volume: 3 slabs x (local o, d (12), 1/d (1), ta tb (4),
#           min max (4)) + free-flight tail (10)                   = 73
#   per entered bounce besides the sweeps: hit point, normal, scatter
#   direction, throughput and state update                         = 60
# Shadow sweeps, texture and light sampling are left out (how many rays run
# them is not counted), so the operation bound is a floor.
FLOPS_PLANAR, FLOPS_SPHERE, FLOPS_VOLUME, FLOPS_SHADE = 12, 23, 73, 60
# Reverse sweep, per ray, entered bounce and channel: s_c (7), g*T (1),
# cot_alb (4), cot_lem (1), aeff (3), R (2).
FLOPS_REVERSE = 3 * 18
# Pathwise reverse sweep, per ray and entered bounce: the NEE chain and its
# partials (about 120 float32 operations), the scatter Jacobian of the
# material met (up to 100), the intersection backprop and the three adjoint
# recurrences (60); and four PCG3D hashes of about 30 integer operations each,
# which the card does at half its float32 rate.
FLOPS_REVERSE_PATHWISE = 120 + 100 + 60
INT_OPS_REVERSE_PATHWISE = 4 * 30
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 2
# Float32 operations of the mesh kernels (csrc/mesh.cu), per test:
#   local ray, per (ray, instance): origin (18), direction (15), 1/d (9) = 42
#   slab test of a box: per axis 2 sub, 2 mul, min, max, 2 clips (8) x 3
#     and the compare (the record kernel's sphere segments' too)        = 25
#   Moller-Trumbore: h (9), a (5), |a| test (2), f (2), s (3), u (6),
#     q (9), v (6), t (6), accept tests (7)                             = 55
#   Baldwin-Weber, every triangle: den (5), num (6), |den| test (2), t (2),
#     t tests (2)                                                       = 17
#   and a triangle whose t passes: hit point (6), u (6), v (6), u/v tests
#     (4), tie compare (2)                                              = 24
# The (ray, instance) pairs, box and triangle tests a chunk needs are
# counted by an instrumented run of the plain version on a sample of its
# rays (``counts=``): a ray whose t_max is not above t_min (dead, or
# reaching no instance) needs none of them, and the kernels skip it.
FLOPS_MESH_LOCAL_RAY, FLOPS_BOX_TEST = 42, 25
FLOPS_MOLLER_TRUMBORE, FLOPS_BW_PLANE, FLOPS_BW_UV = 55, 17, 24
# A live ray reads o, d and t_max, a dead one t_max alone; each writes t,
# tri, inst and hit.
MESH_RAYS_IN, MESH_DEAD_IN, MESH_BYTES_OUT = 7 * 4, 4, 4 + 4 + 4 + 1
# Times of three kernels that keep their design, recorded in PERF.md section 6
# on an NVIDIA H100 80GB HBM3 at 700 W (B3 at a Cornell chunk, B7b at
# random's render chunk, B6 culled at random's record chunk of 856,064 rays):
# a run that reads them slower is on a slower card.
CARD_YARDSTICK = {"sphere_closest": 1.472, "wavefront_grad_rev": 0.503,
                  "wavefront_record": 1.264}
# Registers and spill bytes (ptxas) of instantiations that keep their design,
# as recorded in PERF.md section 6: those that include the bounce loop
# (trace_ray, csrc/wavefront_trace.cuh) beside B1's and B11's brute ones, the
# culled B1, B6 and B11, B6 brute, B2 and its marble instantiation, B5a <2>
# and <4>, B4 <19> and <22>; and the sphere closest-hit kernels B7b and B8s
# (sphere_kernel<false> / <true>), which share csrc/intersect.cu with the
# planar ones.  A build that changes them changed code it must not change.
UNCHANGED_KERNELS = {"wavefront_kernelILi0ELb1E": (80, 8),
                     "wavefront_kernelILi3ELb1E": (80, 24),
                     "wavefront_kernelILi3ELb0E": (96, 0),
                     "wavefront_resume_kernelILb1E": (80, 92),
                     "wavefront_kernelILi1ELb0ELi6E": (80, 172),
                     "wavefront_kernelILi1ELb0ELi0E": (118, 0),
                     "wavefront_kernelILi2ELb0E": (87, 0),
                     "wavefront_kernelILi4ELb0E": (126, 0),
                     "wavefront_grad_fused_kernelILi19E": (118, 0),
                     "wavefront_grad_fused_kernelILi22E": (128, 0),
                     "sphere_kernelILb0E": (72, 0),
                     "sphere_kernelILb1E": (72, 12)}
# The planar closest-hit kernels (csrc/intersect.cu): planar_kernel<N_ATTR,
# GATE>, N_ATTR -1 the closest hit alone (B7a), 12 / 0 (any count) with
# the attributes (B8p); GATE the sign gate, taken where t_min > 0, as on every
# main path.
PLANAR_TAGS = {"planar_closest": "planar_kernelILin1ELb1E",
               "planar_closest_attrs": "planar_kernelILi12ELb1E"}
# B1 and B11 below SPH_CULL_MIN spheres (csrc/wavefront.cu: forward_brute,
# resume_brute), each with an instantiation for a scene without marble and
# one for a scene with it (cuda_wavefront.brute_route), whose first template
# argument is its FWD_MARBLE_TURNS / RESUME_MARBLE_TURNS (csrc/wavefront.cu).
B1_BRUTE_TAG = "forward_brute_kernelILi0E"
B1_MARBLE_TAG = "forward_brute_kernelILi16E"
B11_BRUTE_TAG = "resume_brute_kernelILi0E"
B11_MARBLE_TAG = "resume_brute_kernelILi12E"
# The pathwise reverse sweep without marble: its kernels by route
# (wavefront_grad_pathwise.cu), the tiles summing a column a lane and, above
# 93 accumulators, the design it shares with the marble stash (a row a warp).
B5B_LANE_TAG = "wavefront_grad_rev_pathwise_tiles_kernel"
B5B_WARP_TAG = "wavefront_grad_rev_pathwise_kernelILi19E"
# The product-chain gradient forward (B2): its instantiations
# (wavefront.cu), built for six blocks an SM, and for a scene with marble at
# the registers the compiler chooses.
B2_TAG = "wavefront_kernelILi1ELb0ELi6E"
B2_MARBLE_TAG = "wavefront_kernelILi1ELb0ELi0E"
# The times of the kernels last redesigned, in their previous design
# (PERF.md section 6: NVIDIA H100 80GB HBM3, 700 W; B1 brute at Cornell's
# chunk, B11 brute's two phases at perlin's; B7a and B8p at Cornell's chunk of
# camera rays, and summed over the launches one Cornell chunk makes on the
# standard integrator's fast route, "_path"), printed in their phase lines
# beside the new.
PREVIOUS_DESIGN_MS = {"wavefront_fwd": 2.733, "wavefront_resume_phase_1": 1.525,
                      "wavefront_resume_phase_2": 0.855,
                      "planar_closest": 0.2507, "planar_closest_attrs": 0.3277,
                      "planar_closest_path": 0.9405, "planar_closest_attrs_path": 1.5167}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats=1):
    """Milliseconds per call of ``fn`` on the GPU, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, out


def rounds_ms(fn, rounds=3, repeats=5):
    """``rounds`` timings of ``repeats`` calls each.  Returns (the rounds'
    ms per call in the order taken, the last output).  A kernel's time in
    the ``kernels`` line is the median round: a single round now and then
    reads several times the others on a machine whose host is shared."""
    taken = []
    for _ in range(rounds):
        ms, out = cuda_ms(fn, repeats=repeats)
        taken.append(ms)
    return taken, out


def median(values):
    return sorted(values)[len(values) // 2]


def mixed_scene(device):
    """Checker plane, metal, dielectric and moving spheres, quad, quad
    light, box volume: every material kind and primitive table at once."""
    b = grt.SceneBuilder()
    floor = b.lambertian(b.checker(0.7, (0.2, 0.2, 0.2), (0.9, 0.9, 0.9)))
    b.plane((0, 0, 0), (0, 1, 0), floor)
    b.sphere((0, 1, -1), 0.8, b.metal((0.9, 0.8, 0.5), 0.2))
    b.sphere((-1.8, 0.8, 0), 0.7, b.dielectric(1.5))
    b.moving_sphere((1.8, 0.5, 0.5), (2.2, 0.9, 0.5), 0.4,
                    b.lambertian((0.2, 0.5, 0.8)))
    b.quad((1.0, 0.2, 0.8), (1.2, 0, 0), (0, 1.2, 0), b.lambertian((0.7, 0.2, 0.2)))
    q = b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((6, 6, 6)))
    b.add_light(q)
    b.volume_box((-3, 0, -3), (3, 3, 3), 0.02, (0.8, 0.8, 0.8))
    cam = Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4,
                 max_depth=4, look_from=(0, 2, 5), look_at=(0, 0.8, 0),
                 background=(0.1, 0.1, 0.2), vfov=45.0)
    return b.build(device=device), cam


def chunk_rays(cam, n_rays, seed, device):
    """The rays of a render's first chunk, as render() makes them."""
    w, h = cam.image_width, cam.image_height
    ids = torch.arange(n_rays, dtype=torch.int64, device=device)
    px, py, _ = renderer._id_to_pixel(ids % (w * h), w, h, False)
    o, d, tm = generate_rays(cam, px, py, ids, seed)
    return o, d, tm, cw.stream_to_i32(ids)


def final_radiance(scene, cam, rows, flags):
    """Kernel outputs -> radiance with the deferred miss shader applied."""
    from go_raytracing_tpu_torch.core.vec3 import V3

    missed = (flags & cw.FLAG_MISSED) != 0
    col = wavefront._miss_radiance(scene, cam, V3(rows[3], rows[4], rows[5]),
                                   (flags & cw.FLAG_PRIMARY) != 0).rows().T
    return rows[0:3] + torch.where(missed, rows[6:9] * col, 0.0)


def compare(scene, cam, seed, name):
    """Kernel against plain version on one scene, per ray."""
    tb = cw.build_tables(scene)
    n = cam.image_width * cam.image_height * cam.samples_per_pixel
    o, d, tm, sid = chunk_rays(cam, n, seed, scene.device)
    args = (tb, o, d, tm, sid, seed, cam.max_depth)
    k_rows, k_flags = cw.wavefront_fwd(*args)
    torch.cuda.synchronize()
    p_rows, p_flags = cw._wavefront_fwd_plain(*args)
    fma_rows, fma_flags = cw._wavefront_fwd_cuda(*args, fmad=True)
    torch.cuda.synchronize()

    def share(rows, flags):
        close = torch.isclose(rows, p_rows, rtol=RTOL, atol=ATOL).all(dim=0)
        good = close & (flags == p_flags)
        err = (rows - p_rows).abs().max(dim=0).values[good]
        return 1.0 - float(good.float().mean()), float(err.max())

    mismatch, max_err = share(k_rows, k_flags)
    mismatch_fma, _ = share(fma_rows, fma_flags)
    not_bit_equal = 1.0 - float(((k_rows == p_rows).all(dim=0)
                                 & (k_flags == p_flags)).float().mean())
    k_mean = float(final_radiance(scene, cam, k_rows, k_flags).mean())
    p_mean = float(final_radiance(scene, cam, p_rows, p_flags).mean())
    rel = abs(k_mean - p_mean) / max(abs(p_mean), 1e-12)
    emit("kernel_vs_plain", scene=name, rays=n, depth=cam.max_depth,
         route=cw.brute_route(tb), share_not_bit_equal=not_bit_equal,
         mismatch_share=mismatch, mismatch_share_with_fma=mismatch_fma,
         max_abs_err_agreeing_rays=max_err, mean_kernel=k_mean,
         mean_plain=p_mean, mean_rel_diff=rel, rtol=RTOL, atol=ATOL)
    if not torch.isfinite(k_rows).all():
        raise RuntimeError(f"{name}: kernel output is not finite")
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"{name}: {mismatch:.4%} of rays disagree with the plain version")
    if tb.n_seg == 0 and not_bit_equal != 0.0:   # B1 brute: its plain version's bits
        raise RuntimeError(f"{name}: {not_bit_equal:.4%} of rays differ in their bits")
    if rel >= MAX_MEAN_REL_DIFF:
        raise RuntimeError(f"{name}: mean radiance differs by {rel:.3%}")
    return mismatch, max_err


def checker_sky_scene(device):
    """Checker floor, lambertian spheres (one moving), a quad light bright
    enough for the firefly clamp, a fog box, under the sky gradient: what
    the Cornell box does not give the gradient kernels."""
    b = grt.SceneBuilder()
    b.plane((0, 0, 0), (0, 1, 0),
            b.lambertian(b.checker(0.7, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8))))
    b.sphere((0, 1, -1), 0.8, b.lambertian((0.2, 0.5, 0.8)))
    b.moving_sphere((1.8, 0.5, 0.5), (2.2, 0.9, 0.5), 0.4,
                    b.lambertian((0.7, 0.2, 0.2)))
    b.add_light(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((120, 112, 104))))
    b.volume_box((-3, 0, -3), (3, 3, 3), 0.05, (0.8, 0.9, 1.0))
    cam = Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4,
                 max_depth=4, look_from=(0, 2, 5), look_at=(0, 0.8, 0),
                 vfov=45.0, use_sky_gradient=True)
    return b.build(device=device), cam


def grad_fwd_mismatch(k, p):
    """Gradient forward against its plain version, per ray: (share of rays
    outside the gate, largest absolute error on the agreeing rays)."""
    good = (torch.isclose(k[0], p[0], rtol=RTOL, atol=ATOL).all(dim=0)
            & (k[1] == p[1])
            & torch.isclose(k[2], p[2], rtol=RTOL, atol=ATOL).all(dim=0)
            & torch.isclose(k[3], p[3], rtol=RTOL, atol=ATOL).all(dim=1).all(dim=0)
            & (k[4] == p[4]).all(dim=1).all(dim=0))
    err = max(float((k[0] - p[0]).abs().max(dim=0).values[good].max()),
              float((k[3] - p[3]).abs().amax(dim=(0, 1))[good].max()))
    return 1.0 - float(good.float().mean()), err


def compare_grad(scene, cam, seed, name):
    """The two gradient kernels against their plain versions and against
    autograd through the plain forward, on one scene."""
    if not cw.grad_applicable(scene, cam.max_depth):
        raise RuntimeError(f"{name}: outside the gradient kernels' gate")
    tb = cw.build_tables(scene)
    n = cam.image_width * cam.image_height * cam.samples_per_pixel
    o, d, tm, sid = chunk_rays(cam, n, seed, scene.device)
    args = (tb, o, d, tm, sid, seed, cam.max_depth, cw.miss_config(cam))
    k = cw.wavefront_grad_fwd(*args)
    torch.cuda.synchronize()
    p = cw._wavefront_grad_fwd_plain(*args)
    mismatch, fwd_err = grad_fwd_mismatch(k, p)
    # B2: every output the plain version's bits (radiance, flags, miss colour, stash)
    bit_equal = all(torch.equal(a, b) for a, b in zip(k, p))
    same_as_fwd = torch.equal(k[0], cw.wavefront_fwd(*args[:-1])[0])

    gen = torch.Generator(device=scene.device).manual_seed(seed)
    g3 = torch.rand((3, n), device=scene.device, generator=gen) * 1e-3
    n_tex = int(scene.textures.color.shape[0])
    gk = cw.wavefront_grad_rev(k[3], k[4], g3, k[2], n_tex)
    torch.cuda.synchronize()
    gp = cw._wavefront_grad_rev_plain(k[3], k[4], g3, k[2], n_tex)
    rev_err = float((gk - gp).abs().max())
    rev_rel = rev_err / float(gp.abs().max())
    ga = cw.autograd_colour_grads(scene, cam, o, d, tm, sid, seed, g3)
    auto_rel = {}
    for v, key in enumerate(("color", "even_color", "odd_color")):
        if not torch.isfinite(ga[key]).all():
            raise RuntimeError(f"{name}: autograd's {key} gradient is not finite")
        big = float(ga[key].abs().max())
        if big > 0.0:
            auto_rel[key] = float((gk[:, v] - ga[key]).abs().max()) / big
        elif float(gk[:, v].abs().max()) != 0.0:
            raise RuntimeError(f"{name}: {key} gradient where autograd has none")
    clamped = float(((k[4][:, 2] & (7 * cw.MK_CLAMPED)) != 0).any(dim=0).float().mean())
    emit("grad_kernels_vs_plain", scene=name, rays=n, depth=cam.max_depth,
         textures=n_tex, fwd_mismatch_share=mismatch,
         fwd_max_abs_err_agreeing_rays=fwd_err, fwd_bit_equal_plain=bit_equal,
         radiance_equals_forward_kernel=same_as_fwd,
         rev_max_abs_err=rev_err, rev_err_of_largest=rev_rel,
         autograd_err_of_largest=auto_rel, share_of_rays_clamped=clamped,
         largest_gradient=float(gp.abs().max()))
    if not torch.isfinite(k[0]).all() or not torch.isfinite(k[3]).all():
        raise RuntimeError(f"{name}: gradient forward output is not finite")
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"{name}: {mismatch:.4%} of rays' stash rows disagree")
    if not bit_equal:
        raise RuntimeError(f"{name}: B2's outputs are not the plain version's bits")
    if not same_as_fwd:
        raise RuntimeError(f"{name}: gradient forward's radiance is not the forward's")
    if not rev_rel <= REV_RTOL_OF_LARGEST:
        raise RuntimeError(f"{name}: reverse kernel off by {rev_rel:.2e} of the largest entry")
    if not auto_rel or max(auto_rel.values()) > AUTOGRAD_RTOL_OF_LARGEST:
        raise RuntimeError(f"{name}: kernels against autograd: {auto_rel}")
    return mismatch, fwd_err, rev_err


def grad_main_path(scene, cam):
    """``render_grad`` for the Cornell job at full size: everything stashed,
    then with a stash budget of two chunks.  Returns (launches of the
    gradient forward, launches of the reverse sweep) of the first."""
    spp = cam.samples_per_pixel
    n_camera_rays = cam.image_width * cam.image_height * spp
    fb = grt.render(scene, cam, seed=0)
    target = fb / spp * 0.8
    loss_ref = float(torch.mean((fb / spp - target) ** 2))
    del fb

    def run(**kw):
        stats = grt.RenderStats()
        cw.LAUNCHES = cw.LAUNCHES_GRAD_FWD = cw.LAUNCHES_GRAD_REV = 0
        torch.cuda.reset_peak_memory_stats()
        ms, (loss, grads) = cuda_ms(
            lambda: grt.render_grad(scene, cam, target, seed=0, stats=stats, **kw))
        counts = cw.LAUNCHES, cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV
        return ms, loss, grads, stats, counts, torch.cuda.max_memory_allocated()

    grt.render_grad(scene, cam, target, seed=0)  # warm-up
    ms, loss, grads, stats, (n_b1, n_b2, n_b3), peak = run()
    if (n_b1, n_b2, n_b3) != (0, stats.chunks, stats.chunks) or stats.chunks < 1:
        raise RuntimeError(f"launches {(n_b1, n_b2, n_b3)} for {stats.chunks} chunks")
    loss_f = float(loss)
    if not loss_f == loss_f or abs(loss_f - loss_ref) > 1e-5 * loss_ref:
        raise RuntimeError(f"loss {loss_f} against {loss_ref} from render()")
    if set(grads) != {"fuzz", "ior", "color", "even_color", "odd_color", "atlas"}:
        raise RuntimeError(f"gradient keys {sorted(grads)}")
    for key, g in grads.items():
        if g.device != scene.device or not torch.isfinite(g).all():
            raise RuntimeError(f"gradient {key} is not finite on {scene.device}")
    if any(float(grads[key].abs().max()) != 0.0 for key in ("fuzz", "ior", "atlas")):
        raise RuntimeError("fuzz / ior / atlas gradients must be zero on this tier")
    # white, red, green, light and fog: every texture of the box is reached
    if not bool((grads["color"].abs().amax(dim=1) > 0).all()):
        raise RuntimeError(f"a texture got no gradient: {grads['color'].tolist()}")
    stash_bytes = n_camera_rays * gradmod.stash_bytes_per_ray(cam.max_depth)
    # one chunk of each pass alone, for the breakdown of the time above
    args = dict(spp=spp, chunk=n_camera_rays // stats.chunks,
                max_depth=cam.max_depth)
    pass_a_ms, (_, carry) = cuda_ms(lambda: gradmod._twophase_fwd(
        scene, cam, 0, 0, keep_stash=True, **args))
    g_virt = torch.full((cam.image_width * cam.image_height, 3), 1e-6,
                        device=scene.device)
    pass_b_ms, _ = cuda_ms(lambda: gradmod._twophase_rev(
        scene, cam, g_virt, 0, 0, carry, **args))
    del carry
    emit("grad_main_path", scene="cornell", width=cam.image_width,
         height=cam.image_height, spp=spp, depth=cam.max_depth,
         camera_rays=n_camera_rays, chunks=stats.chunks,
         launches_grad_fwd=n_b2, launches_grad_rev=n_b3, launches_fwd=n_b1,
         render_grad_ms_cuda_events=ms,
         fwd_bwd_camera_mrays_per_s=n_camera_rays / (ms * 1e-3) / 1e6,
         loss=loss_f, loss_from_render=loss_ref,
         pass_a_ms_one_chunk=pass_a_ms, pass_b_ms_one_chunk=pass_b_ms,
         color_grad=grads["color"].tolist(), stash_bytes=stash_bytes,
         max_memory_allocated=peak)

    # over budget: two chunks keep their stash, the others are traced by
    # the forward kernel in pass A and again, with stash, in pass B
    budget = 2 * (stash_bytes // stats.chunks) + 1
    ms2, loss2, grads2, stats2, counts2, peak2 = run(stash_budget=budget)
    want = (stats.chunks - 2, stats.chunks, stats.chunks)
    if stats2.chunks != stats.chunks or counts2 != want:
        raise RuntimeError(f"over budget: launches {counts2}, expected {want}")
    big = float(grads["color"].abs().max())
    grad_diff = float((grads2["color"] - grads["color"]).abs().max()) / big
    loss_diff = abs(float(loss2) - loss_f) / loss_f
    emit("grad_main_path_over_budget", stash_budget=budget, chunks=stats2.chunks,
         launches_fwd=counts2[0], launches_grad_fwd=counts2[1],
         launches_grad_rev=counts2[2], render_grad_ms_cuda_events=ms2,
         fwd_bwd_camera_mrays_per_s=n_camera_rays / (ms2 * 1e-3) / 1e6,
         loss_rel_diff=loss_diff, color_grad_diff_of_largest=grad_diff,
         max_memory_allocated=peak2)
    if loss_diff > 1e-6 or grad_diff > 1e-5:
        raise RuntimeError(f"over budget: loss off by {loss_diff}, grads by {grad_diff}")
    return n_b2, n_b3


def kernel_entry(rays_per_launch, name, source, replaces, launches, ms,
                 plain_ms, bound, errs):
    """One entry of the ``kernels`` line.  ``bound`` = (bytes bound ms,
    operations bound ms); no single PyTorch call computes any of these
    kernels' functions, so ``library_ms`` is null."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs),
            "ms": ms, "ms_per_launch": ms, "rays_per_launch": rays_per_launch,
            "plain_ms": plain_ms, "bound_ms": max(bound),
            "bound_by": "bytes" if bound[0] >= bound[1] else "operations",
            "library_ms": None}


def grad_kernel_timing(scene, rays, cam, entering, render_grad_launches,
                       small_checks):
    """The two gradient kernels alone at the main path's chunk, beside their
    bounds, and against their plain versions at that size.  Returns their
    entries of the ``kernels`` line; ``small_checks`` are the results of
    ``compare_grad``, folded into the entries' errors."""
    tb = cw.build_tables(scene)
    o, d, tm, sid = rays
    n = tm.shape[0]
    depth = cam.max_depth
    args = (tb, o, d, tm, sid, 0, depth, cw.miss_config(cam))
    cw.wavefront_grad_fwd(*args)
    fwd_rounds, k = rounds_ms(lambda: cw.wavefront_grad_fwd(*args))
    fwd_ms = median(fwd_rounds)
    plain_fwd_ms, p = cuda_ms(lambda: cw._wavefront_grad_fwd_plain(*args))
    mismatch, fwd_err = grad_fwd_mismatch(k, p)
    bit_equal = all(torch.equal(a, b) for a, b in zip(k, p))
    del p
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"full-size chunk: {mismatch:.4%} of rays' stash rows disagree")
    if not bit_equal:
        raise RuntimeError("full-size chunk: B2's outputs (radiance, flags, miss colour, "
                           "stash rows) are not the plain version's bits")
    # the chunk's rays in turns of path length: every warp's lanes end at
    # every bounce (entering[k]: rays alive after k bounces)
    length = torch.ones_like(tm, dtype=torch.int64)
    for b in range(1, depth):
        length += (cw.wavefront_fwd(tb, o, d, tm, sid, 0, b)[1] & cw.FLAG_ALIVE) != 0
    idx = th.lengths_in_turn(length, depth)
    t_args = (tb, V3(*(c[idx].contiguous() for c in o)), V3(*(c[idx].contiguous() for c in d)),
              tm[idx].contiguous(), sid[idx].contiguous(), 0, depth, cw.miss_config(cam))
    turns_equal = all(torch.equal(a, b) for a, b in zip(cw.wavefront_grad_fwd(*t_args),
                                                         cw._wavefront_grad_fwd_plain(*t_args)))
    del t_args
    if not turns_equal:
        raise RuntimeError("full-size chunk in turns of path length: B2's outputs are not "
                           "the plain version's bits")

    gen = torch.Generator(device=tm.device).manual_seed(0)
    g3 = torch.rand((3, n), device=tm.device, generator=gen) * 1e-6
    n_tex = int(scene.textures.color.shape[0])
    cw.wavefront_grad_rev(k[3], k[4], g3, k[2], n_tex)
    rev_rounds, gk = rounds_ms(
        lambda: cw.wavefront_grad_rev(k[3], k[4], g3, k[2], n_tex))
    rev_ms = median(rev_rounds)
    plain_rev_ms, gp = cuda_ms(
        lambda: cw._wavefront_grad_rev_plain(k[3], k[4], g3, k[2], n_tex))
    rev_err = float((gk - gp).abs().max())
    rev_rel = rev_err / float(gp.abs().max())
    if not rev_rel <= REV_RTOL_OF_LARGEST:
        raise RuntimeError(f"full-size chunk: reverse kernel off by {rev_rel:.2e}")

    table_bytes = 4 * sum(t.numel() for t in (tb.pt, tb.st, tb.vt, tb.lt))
    stash_rows = (cw.STASH_F_ROWS + cw.STASH_I_ROWS) * depth
    fwd_bytes = (8 + 10 + 3 + stash_rows) * 4 * n + table_bytes
    per_bounce = (tb.n_planar * FLOPS_PLANAR + tb.n_sphere * FLOPS_SPHERE
                  + tb.n_vol * FLOPS_VOLUME + FLOPS_SHADE)
    fwd_bound = (fwd_bytes / PEAK_BYTES_PER_S * 1e3,
                 float(sum(entering)) * per_bounce / PEAK_FP32_FLOPS * 1e3)
    # one row of partial sums for each block of the reverse kernel
    block_rays = _build.load("wavefront_grad").lib.wavefront_grad_rev_block_rays()
    rev_bytes = (stash_rows + 6) * 4 * n + 4 * gk.numel() * -(-n // block_rays)
    rev_bound = (rev_bytes / PEAK_BYTES_PER_S * 1e3,
                 float(sum(entering)) * FLOPS_REVERSE / PEAK_FP32_FLOPS * 1e3)
    emit("grad_kernel_timing", rays_per_launch=n, depth=depth,
         grad_fwd_ms=fwd_ms, grad_fwd_ms_rounds=fwd_rounds,
         grad_fwd_plain_ms=plain_fwd_ms,
         grad_fwd_bytes_counted=fwd_bytes, grad_fwd_bound_bytes_ms=fwd_bound[0],
         grad_fwd_bound_ops_ms=fwd_bound[1],
         grad_fwd_roofline_share=max(fwd_bound) / fwd_ms,
         grad_fwd_mismatch_share_full_chunk=mismatch,
         grad_fwd_bit_equal_plain_full_chunk=bit_equal,
         grad_fwd_bit_equal_plain_lengths_in_turn=turns_equal,
         grad_fwd_rays_by_path_length=torch.bincount(length, minlength=depth + 1).tolist(),
         grad_rev_ms=rev_ms, grad_rev_ms_rounds=rev_rounds,
         grad_rev_plain_ms=plain_rev_ms,
         grad_rev_bytes_counted=rev_bytes, grad_rev_bound_bytes_ms=rev_bound[0],
         grad_rev_bound_ops_ms=rev_bound[1],
         grad_rev_roofline_share=max(rev_bound) / rev_ms,
         grad_rev_err_of_largest_full_chunk=rev_rel)

    entry = functools.partial(kernel_entry, n)
    return (
        entry("wavefront_grad_fwd", "go_raytracing_tpu_torch/csrc/wavefront.cu",
              "go_raytracing_tpu/ops/pallas_wavefront.py:2087 (_call_grad_fwd)",
              render_grad_launches[0], fwd_ms, plain_fwd_ms, fwd_bound,
              [fwd_err] + [c[1] for c in small_checks])
        | {"mismatch_share": max([mismatch] + [c[0] for c in small_checks])},
        entry("wavefront_grad_rev", "go_raytracing_tpu_torch/csrc/wavefront_grad.cu",
              "go_raytracing_tpu/ops/pallas_wavefront.py:2162 (_call_grad_rev)",
              render_grad_launches[1], rev_ms, plain_rev_ms, rev_bound,
              [rev_err] + [c[2] for c in small_checks]),
    )


def glossy_sky_scene(device):
    """Checker floor, a fuzzy metal, a mirror, glass and a lambertian sphere,
    a quad light and a fog box, under the sky gradient: every term of the
    pathwise reverse sweep at once (cornell-glossy has no checker, no
    volume and a flat background)."""
    b = grt.SceneBuilder()
    b.plane((0, 0, 0), (0, 1, 0),
            b.lambertian(b.checker(0.7, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8))))
    b.sphere((-1.8, 0.9, 0), 0.9, b.metal((0.8, 0.6, 0.2), 0.25))
    b.sphere((0, 0.8, 1.0), 0.8, b.dielectric(1.5))
    b.sphere((1.8, 0.9, 0), 0.9, b.metal((0.9, 0.9, 0.9), 0.0))
    b.sphere((0, 0.7, -1.6), 0.7, b.lambertian((0.7, 0.2, 0.2)))
    b.add_light(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((13, 12, 11))))
    b.volume_box((-3, 0.05, -3), (3, 3, 3), 0.12, (0.85, 0.9, 0.95))
    cam = Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4,
                 max_depth=5, look_from=(0, 2.5, 6), look_at=(0, 0.9, 0),
                 vfov=45.0, use_sky_gradient=True)
    return b.build(device=device), cam


def pathwise_rev_err(gk, gp):
    """Pathwise reverse kernel against its plain version: (largest absolute
    error over the keys, largest error as a share of its key's largest
    entry).  ``gk`` and ``gp`` are (colours [n_tex, 3, 3], fuzz, ior)."""
    abs_err, rel_err = 0.0, 0.0
    for k, p in zip(gk, gp):
        if not torch.isfinite(k).all():
            raise RuntimeError("pathwise reverse kernel output is not finite")
        err = float((k - p).abs().max())
        big = float(p.abs().max())
        abs_err = max(abs_err, err)
        if big > 0.0:
            rel_err = max(rel_err, err / big)
        elif err != 0.0:
            raise RuntimeError("a gradient where the plain version has none")
    return abs_err, rel_err


def compare_pathwise(scene, cam, seed, name):
    """The two pathwise gradient kernels against their plain versions on one
    scene.  Returns (stash mismatch share, largest stash error on agreeing
    rays, largest absolute error of the reverse kernel)."""
    if not cw.grad_pathwise_applicable(scene, cam.max_depth):
        raise RuntimeError(f"{name}: outside the pathwise kernels' gate")
    tb = cw.build_tables(scene)
    n = cam.image_width * cam.image_height * cam.samples_per_pixel
    o, d, tm, sid = chunk_rays(cam, n, seed, scene.device)
    args = (tb, o, d, tm, sid, seed, cam.max_depth, cw.miss_config(cam))
    k = cw.wavefront_grad_fwd(*args, pathwise=True)
    torch.cuda.synchronize()
    p = cw._wavefront_grad_fwd_plain(*args, pathwise=True)
    mismatch, fwd_err = grad_fwd_mismatch(k, p)
    # B5a without marble (tiles a bounce at a time): every output the plain version's bits
    bit_equal = all(torch.equal(a, b) for a, b in zip(k, p))
    same_as_fwd = torch.equal(k[0], cw.wavefront_fwd(*args[:-1])[0])

    gen = torch.Generator(device=scene.device).manual_seed(seed)
    g3 = torch.rand((3, n), device=scene.device, generator=gen) * 1e-3
    n_tex = int(scene.textures.color.shape[0])
    n_mat = int(scene.materials.kind.shape[0])
    rev_args = (tb, k[3], k[4], g3, k[2], sid, seed, bool(cam.use_sky_gradient),
                n_tex, n_mat)
    gk = cw.wavefront_grad_rev_pathwise(*rev_args)
    gk2 = cw.wavefront_grad_rev_pathwise(*rev_args)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(gk, gk2))
    gp = cw._wavefront_grad_rev_pathwise_plain(*rev_args)
    rev_err, rev_rel = pathwise_rev_err(gk, gp)
    lane_sums = cw.pathwise_rev_lane_sums(9 * n_tex + 2 * n_mat)
    # the rays in turns of path length: every warp's lanes end at every depth
    turns = b5b_in_turns(rev_args, cam.max_depth)
    mk = k[4][:, 2]
    # The volume adjoint's entry term is on or off by near >= EPS_HIT, with
    # near recomputed from o = p - t d: the share of volume rows whose near
    # lies within 1e-3 of the threshold, where rounding could decide.
    border = 0.0
    vol_rows = (mk & cw.PW_VOLUME) != 0
    if tb.n_vol and bool(vol_rows.any()):
        sf = k[3]
        o_rec = [sf[:, 6 + c] - sf[:, 18] * sf[:, 9 + c] for c in range(3)]
        din = [sf[:, 9 + c] for c in range(3)]
        on_border = torch.zeros_like(vol_rows)
        for vi in range(tb.n_vol):
            near = cw._volume_entry(tb, o_rec, din, vi)[0]
            on_border |= (vol_rows & (((mk >> cw.PW_VOL_SHIFT) & 3) == vi)
                          & ((near / cw.EPS_HIT - 1.0).abs() < 1e-3))
        border = float(on_border.sum() / vol_rows.sum())
    emit("pathwise_kernels_vs_plain", scene=name, rays=n, depth=cam.max_depth,
         textures=n_tex, materials=n_mat, fwd_mismatch_share=mismatch,
         fwd_max_abs_err_agreeing_rays=fwd_err, fwd_bit_equal_plain=bit_equal,
         radiance_equals_forward_kernel=same_as_fwd,
         rev_max_abs_err=rev_err, rev_err_of_largest=rev_rel,
         rev_two_launches_same_bits=same_bits, rev_lane_sums=lane_sums,
         rev_lengths_in_turn=turns,
         largest_colour_gradient=float(gp[0].abs().max()),
         fuzz_grad=gk[1].tolist(), ior_grad=gk[2].tolist(),
         share_of_rows_volume=float(vol_rows.float().mean()),
         share_of_volume_rows_on_entry_border=border,
         share_of_rows_specular=float(
             ((mk & (cw.PW_METAL | cw.PW_DIELECTRIC)) != 0).float().mean()))
    if not torch.isfinite(k[0]).all() or not torch.isfinite(k[3]).all():
        raise RuntimeError(f"{name}: pathwise forward output is not finite")
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"{name}: {mismatch:.4%} of rays' stash rows disagree")
    if not bit_equal and not scene.has_noise:
        raise RuntimeError(f"{name}: B5a's outputs are not the plain version's bits")
    if not same_as_fwd:
        raise RuntimeError(f"{name}: pathwise forward's radiance is not the forward's")
    if not rev_rel <= REV_RTOL_OF_LARGEST:
        raise RuntimeError(f"{name}: pathwise reverse kernel off by {rev_rel:.2e}")
    if not same_bits:
        raise RuntimeError(f"{name}: two launches of the reverse kernel differ")
    if not (turns["err_of_largest"] <= REV_RTOL_OF_LARGEST and turns["same_bits_twice"]
            and turns["first_warp_ends_at_every_depth"]):
        raise RuntimeError(f"{name}: the reverse kernel on rays in turns of length: {turns}")
    if float(gk[1].abs().max()) == 0.0 or float(gk[2].abs().max()) == 0.0:
        raise RuntimeError(f"{name}: no fuzz or no ior gradient")
    return mismatch, fwd_err, rev_err, lane_sums


def b5b_in_turns(rev_args, depth):
    """B5b against its plain version, twice, on a stash whose rays stand in
    turns of path length 1, 2, ..., depth (``th.lengths_in_turn``): the
    lanes of every warp end at every depth.  ``rev_args`` are
    ``wavefront_grad_rev_pathwise``'s; returns the check's fields."""
    tb, sf, si, g3, mc, sid, *rest = rev_args
    length = ((si[:, 2] & (cw.PW_HIT | cw.PW_LIT)) != 0).sum(dim=0)
    idx = th.lengths_in_turn(length, depth)
    args = (tb, sf[:, :, idx].contiguous(), si[:, :, idx].contiguous(),
            g3[:, idx].contiguous(), mc[:, idx].contiguous(), sid[idx].contiguous(), *rest)
    gk, gk2 = cw.wavefront_grad_rev_pathwise(*args), cw.wavefront_grad_rev_pathwise(*args)
    gp = cw._wavefront_grad_rev_pathwise_plain(*args)
    lanes = length[idx][: idx.numel() // 32 * 32].reshape(-1, 32)
    every = bool((lanes.amin(dim=1)[0] == 1) and (lanes.amax(dim=1)[0] == depth)) \
        if depth > 1 and lanes.shape[0] else True
    return {"rays": int(idx.numel()), "first_warp_ends_at_every_depth": every,
            "err_of_largest": pathwise_rev_err(gk, gp)[1],
            "same_bits_twice": all(bool(torch.equal(a, b)) for a, b in zip(gk, gk2))}


def pathwise_main_path(scene, cam):
    """``render_grad`` for cornell-glossy at full size through the pathwise
    kernels: everything stashed, then with a stash budget of two chunks.
    Returns (launches of the pathwise gradient forward, of the pathwise
    reverse sweep, chunks) of the first."""
    spp = cam.samples_per_pixel
    n_camera_rays = cam.image_width * cam.image_height * spp
    fb = grt.render(scene, cam, seed=0)
    target = fb / spp * 0.8
    loss_ref = float(torch.mean((fb / spp - target) ** 2))
    del fb

    def run(**kw):
        stats = grt.RenderStats()
        cw.LAUNCHES = cw.LAUNCHES_GRAD_FWD = cw.LAUNCHES_GRAD_REV = 0
        cw.LAUNCHES_GRAD_FWD_PATHWISE = cw.LAUNCHES_GRAD_REV_PATHWISE = 0
        torch.cuda.reset_peak_memory_stats()
        ms, (loss, grads) = cuda_ms(
            lambda: grt.render_grad(scene, cam, target, seed=0, stats=stats, **kw))
        counts = (cw.LAUNCHES, cw.LAUNCHES_GRAD_FWD, cw.LAUNCHES_GRAD_REV,
                  cw.LAUNCHES_GRAD_FWD_PATHWISE, cw.LAUNCHES_GRAD_REV_PATHWISE)
        return ms, loss, grads, stats, counts, torch.cuda.max_memory_allocated()

    grt.render_grad(scene, cam, target, seed=0)  # warm-up
    free_before = torch.cuda.mem_get_info()[0]
    ms, loss, grads, stats, counts, peak = run()
    nch = stats.chunks
    if counts != (0, 0, 0, nch, nch) or nch < 1:
        raise RuntimeError(f"launches {counts} for {nch} chunks")
    loss_f = float(loss)
    if not loss_f == loss_f or abs(loss_f - loss_ref) > 1e-5 * loss_ref:
        raise RuntimeError(f"loss {loss_f} against {loss_ref} from render()")
    if set(grads) != {"fuzz", "ior", "color", "even_color", "odd_color", "atlas"}:
        raise RuntimeError(f"gradient keys {sorted(grads)}")
    for key, g in grads.items():
        if g.device != scene.device or not torch.isfinite(g).all():
            raise RuntimeError(f"gradient {key} is not finite on {scene.device}")
    kinds = scene.materials.kind
    for key, kind in (("fuzz", 1), ("ior", 2)):
        on, off = grads[key][kinds == kind], grads[key][kinds != kind]
        if on.numel() == 0 or not bool((on != 0).all()) or bool((off != 0).any()):
            raise RuntimeError(f"{key} gradient {grads[key].tolist()} for "
                               f"material kinds {kinds.tolist()}")
    if float(grads["atlas"].abs().max()) != 0.0:
        raise RuntimeError("atlas gradient must be zero on this tier")
    per_ray = gradmod.stash_bytes_per_ray(cam.max_depth, pathwise=True)
    stash_bytes = n_camera_rays * per_ray
    n_stash = min(int(gradmod.STASH_SHARE_OF_FREE_MEMORY * free_before)
                  // (n_camera_rays // nch * per_ray), nch)
    # one chunk of each pass alone, for the breakdown of the time above
    args = dict(spp=spp, chunk=n_camera_rays // nch, max_depth=cam.max_depth,
                pathwise=True)
    pass_a_ms, (_, carry) = cuda_ms(lambda: gradmod._twophase_fwd(
        scene, cam, 0, 0, keep_stash=True, **args))
    g_virt = torch.full((cam.image_width * cam.image_height, 3), 1e-6,
                        device=scene.device)
    pass_b_ms, _ = cuda_ms(lambda: gradmod._twophase_rev(
        scene, cam, g_virt, 0, 0, carry, **args))
    del carry
    emit("pathwise_main_path", scene="cornell-glossy", width=cam.image_width,
         height=cam.image_height, spp=spp, depth=cam.max_depth,
         camera_rays=n_camera_rays, chunks=nch, n_stash=n_stash,
         launches_grad_fwd_pathwise=counts[3], launches_grad_rev_pathwise=counts[4],
         launches_fwd=counts[0], render_grad_ms_cuda_events=ms,
         fwd_bwd_camera_mrays_per_s=n_camera_rays / (ms * 1e-3) / 1e6,
         loss=loss_f, loss_from_render=loss_ref,
         pass_a_ms_one_chunk=pass_a_ms, pass_b_ms_one_chunk=pass_b_ms,
         fuzz_grad=grads["fuzz"].tolist(), ior_grad=grads["ior"].tolist(),
         color_grad=grads["color"].tolist(),
         material_kinds=kinds.tolist(), stash_bytes_per_ray=per_ray,
         stash_bytes=stash_bytes, free_memory_before=free_before,
         max_memory_allocated=peak)
    if n_stash != nch:
        raise RuntimeError(f"only {n_stash} of {nch} stashes fit the default budget")

    # over budget: two chunks keep their stash, the others are traced by
    # the forward kernel in pass A and again, with stash, in pass B
    budget = 2 * (stash_bytes // nch) + 1
    ms2, loss2, grads2, stats2, counts2, peak2 = run(stash_budget=budget)
    want = (nch - 2, 0, 0, nch, nch)
    if stats2.chunks != nch or counts2 != want:
        raise RuntimeError(f"over budget: launches {counts2}, expected {want}")
    grad_diff = {}
    for key in ("color", "fuzz", "ior"):
        big = float(grads[key].abs().max())
        grad_diff[key] = float((grads2[key] - grads[key]).abs().max()) / big
    loss_diff = abs(float(loss2) - loss_f) / loss_f
    emit("pathwise_main_path_over_budget", stash_budget=budget, chunks=nch,
         launches_fwd=counts2[0], launches_grad_fwd_pathwise=counts2[3],
         launches_grad_rev_pathwise=counts2[4], render_grad_ms_cuda_events=ms2,
         fwd_bwd_camera_mrays_per_s=n_camera_rays / (ms2 * 1e-3) / 1e6,
         loss_rel_diff=loss_diff, grad_diff_of_largest=grad_diff,
         max_memory_allocated=peak2)
    if loss_diff > 1e-6 or max(grad_diff.values()) > 1e-5:
        raise RuntimeError(f"over budget: loss off by {loss_diff}, grads by {grad_diff}")
    return counts[3], counts[4], nch


def pathwise_kernel_timing(scene, cam, launches, small_checks):
    """The two pathwise kernels alone at the main path's chunk (one of its
    equal chunks of cornell-glossy), beside their bounds, and against their
    plain versions at that size.  Returns their entries of the ``kernels``
    line; ``small_checks`` are the results of ``compare_pathwise``."""
    tb = cw.build_tables(scene)
    n = cam.image_width * cam.image_height * cam.samples_per_pixel // launches[2]
    depth = cam.max_depth
    o, d, tm, sid = chunk_rays(cam, n, 0, scene.device)
    args = (tb, o, d, tm, sid, 0, depth, cw.miss_config(cam))
    cw.wavefront_grad_fwd(*args, pathwise=True)
    fwd_rounds, k = rounds_ms(lambda: cw.wavefront_grad_fwd(*args, pathwise=True))
    fwd_ms = median(fwd_rounds)
    plain_fwd_ms, p = cuda_ms(
        lambda: cw._wavefront_grad_fwd_plain(*args, pathwise=True))
    mismatch, fwd_err = grad_fwd_mismatch(k, p)
    bit_equal = all(torch.equal(a, b) for a, b in zip(k, p))
    del p
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"full-size chunk: {mismatch:.4%} of rays' pathwise "
                           "stash rows disagree")
    if not bit_equal:
        raise RuntimeError("full-size chunk: B5a's outputs (radiance, flags, miss colour, "
                           "stash rows) are not the plain version's bits")
    same_as_fwd = torch.equal(k[0], cw.wavefront_fwd(*args[:-1])[0])
    if not same_as_fwd:
        raise RuntimeError("full-size chunk: pathwise forward's radiance is not "
                           "the forward kernel's")

    gen = torch.Generator(device=tm.device).manual_seed(0)
    g3 = torch.rand((3, n), device=tm.device, generator=gen) * 1e-6
    n_tex = int(scene.textures.color.shape[0])
    n_mat = int(scene.materials.kind.shape[0])
    rev_args = (tb, k[3], k[4], g3, k[2], sid, 0, bool(cam.use_sky_gradient),
                n_tex, n_mat)
    first = cw.wavefront_grad_rev_pathwise(*rev_args)
    rev_rounds, gk = rounds_ms(lambda: cw.wavefront_grad_rev_pathwise(*rev_args))
    rev_ms = median(rev_rounds)
    same_bits = all(torch.equal(a, b) for a, b in zip(first, gk))
    plain_rev_ms, gp = cuda_ms(
        lambda: cw._wavefront_grad_rev_pathwise_plain(*rev_args))
    rev_err, rev_rel = pathwise_rev_err(gk, gp)
    if not rev_rel <= REV_RTOL_OF_LARGEST:
        raise RuntimeError(f"full-size chunk: pathwise reverse kernel off by {rev_rel:.2e}")
    if not same_bits:
        raise RuntimeError("full-size chunk: two launches of the reverse kernel differ")
    turns = b5b_in_turns(rev_args, depth)
    if not (turns["err_of_largest"] <= REV_RTOL_OF_LARGEST and turns["same_bits_twice"]
            and turns["first_warp_ends_at_every_depth"]):
        raise RuntimeError(f"full-size chunk: the reverse kernel on rays in turns: {turns}")

    # rows of the stash a ray entered, bounce by bounce: the data-dependent
    # work of both kernels
    entered = ((k[4][:, 2] & (cw.PW_HIT | cw.PW_LIT)) != 0).sum(dim=1).tolist()
    table_bytes = 4 * sum(t.numel() for t in (tb.pt, tb.st, tb.vt, tb.lt))
    stash_rows = (cw.PW_STASH_F_ROWS + cw.PW_STASH_I_ROWS) * depth
    fwd_bytes = (8 + 10 + 3 + stash_rows) * 4 * n + table_bytes
    per_bounce = (tb.n_planar * FLOPS_PLANAR + tb.n_sphere * FLOPS_SPHERE
                  + tb.n_vol * FLOPS_VOLUME + FLOPS_SHADE)
    fwd_bound = (fwd_bytes / PEAK_BYTES_PER_S * 1e3,
                 float(sum(entered)) * per_bounce / PEAK_FP32_FLOPS * 1e3)
    n_acc = 9 * n_tex + 2 * n_mat
    block_rays = cw.pathwise_rev_block_rays(cw.PW_STASH_F_ROWS, n_acc)
    rev_bytes = ((stash_rows + 3 + 3 + 1) * 4 * n
                 + 4 * n_acc * -(-n // block_rays)
                 + 4 * (tb.vt.numel() + tb.lt.numel()))
    rev_bound = (rev_bytes / PEAK_BYTES_PER_S * 1e3,
                 float(sum(entered)) * (FLOPS_REVERSE_PATHWISE / PEAK_FP32_FLOPS
                                        + INT_OPS_REVERSE_PATHWISE / PEAK_INT32_OPS)
                 * 1e3)
    emit("pathwise_kernel_timing", scene="cornell-glossy", rays_per_launch=n,
         depth=depth, rows_entered_by_bounce=entered,
         entered_share=sum(entered) / (n * depth),
         grad_fwd_bit_equal_plain_full_chunk=bit_equal,
         grad_fwd_ms=fwd_ms, grad_fwd_ms_rounds=fwd_rounds,
         grad_fwd_plain_ms=plain_fwd_ms,
         grad_fwd_bytes_counted=fwd_bytes, grad_fwd_bound_bytes_ms=fwd_bound[0],
         grad_fwd_bound_ops_ms=fwd_bound[1],
         grad_fwd_roofline_share=max(fwd_bound) / fwd_ms,
         grad_fwd_mismatch_share_full_chunk=mismatch,
         grad_rev_ms=rev_ms, grad_rev_ms_rounds=rev_rounds,
         grad_rev_plain_ms=plain_rev_ms,
         grad_rev_bytes_counted=rev_bytes, grad_rev_bound_bytes_ms=rev_bound[0],
         grad_rev_bound_ops_ms=rev_bound[1],
         grad_rev_roofline_share=max(rev_bound) / rev_ms,
         grad_rev_err_of_largest_full_chunk=rev_rel,
         grad_rev_two_launches_same_bits=same_bits,
         grad_rev_lengths_in_turn_full_chunk=turns,
         grad_rev_lane_sums=cw.pathwise_rev_lane_sums(n_acc), grad_rev_accumulators=n_acc)

    entry = functools.partial(kernel_entry, n)
    return (
        entry("wavefront_grad_fwd_pathwise",
              "go_raytracing_tpu_torch/csrc/wavefront.cu",
              "go_raytracing_tpu/ops/pallas_wavefront.py:2087 "
              "(_call_grad_fwd, pathwise=True)",
              launches[0], fwd_ms, plain_fwd_ms, fwd_bound,
              [fwd_err] + [c[1] for c in small_checks])
        | {"mismatch_share": max([mismatch] + [c[0] for c in small_checks])},
        entry("wavefront_grad_rev_pathwise",
              "go_raytracing_tpu_torch/csrc/wavefront_grad_pathwise.cu",
              "go_raytracing_tpu/ops/pallas_wavefront.py:2162 "
              "(_call_grad_rev, pathwise=True)",
              launches[1], rev_ms, plain_rev_ms, rev_bound,
              [rev_err] + [c[2] for c in small_checks])
        | {"routes_checked": sorted({"lane" if c[3] else "warp" for c in small_checks})},
    )


def intersect_counts():
    return {"planar_closest": ck.LAUNCHES_PLANAR,
            "sphere_closest": ck.LAUNCHES_SPHERE,
            "planar_closest_attrs": ck.LAUNCHES_PLANAR_ATTRS,
            "sphere_closest_attrs": ck.LAUNCHES_SPHERE_ATTRS}


def reset_intersect_counts():
    ck.LAUNCHES_PLANAR = ck.LAUNCHES_SPHERE = 0
    ck.LAUNCHES_PLANAR_ATTRS = ck.LAUNCHES_SPHERE_ATTRS = 0


def intersect_scene(device):
    """The mixed scene and a triangle and a circle: all four planar kinds,
    spheres (one moving), every material kind, a checker texture."""
    b = grt.SceneBuilder()
    floor = b.lambertian(b.checker(0.7, (0.2, 0.2, 0.2), (0.9, 0.9, 0.9)))
    b.plane((0, 0, 0), (0, 1, 0), floor)
    b.sphere((0, 1, -1), 0.8, b.metal((0.9, 0.8, 0.5), 0.2))
    b.sphere((-1.8, 0.8, 0), 0.7, b.dielectric(1.5))
    b.moving_sphere((1.8, 0.5, 0.5), (2.2, 0.9, 0.5), 0.4,
                    b.lambertian((0.2, 0.5, 0.8)))
    b.quad((1.0, 0.2, 0.8), (1.2, 0, 0), (0, 1.2, 0), b.lambertian((0.7, 0.2, 0.2)))
    b.triangle((-3, 0.1, -2), (-1, 0.1, -3), (-2, 2.5, -2.5), floor)
    b.circle((2.5, 1.5, -2), (-0.3, 0.2, 1), 1.0, b.metal((0.8, 0.8, 0.9), 0.0))
    b.add_light(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((6, 6, 6))))
    cam = Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4,
                 max_depth=4, look_from=(0, 2, 5), look_at=(0, 0.8, 0),
                 background=(0.1, 0.1, 0.2), vfov=45.0)
    return b.build(device=device), cam


def intersect_tables(scene):
    """(sphere geometry, sphere constants, planar geometry, planar
    constants) of a scene, None where it has no such primitive."""
    n_s, n_p = int(scene.spheres.radius.shape[0]), int(scene.planar.d.shape[0])
    return (
        ck.sphere_table(scene.spheres) if n_s else None,
        ck._material_consts(scene.materials, scene.textures, scene.spheres.mat)
        if n_s else None,
        ck.planar_table(scene.planar) if n_p else None,
        ck._material_consts(scene.materials, scene.textures, scene.planar.mat)
        if n_p else None)


def intersect_calls(scene, o, d, tm, t_max_s, t_max_p, t_min=cw.EPS_HIT):
    """name -> (kernel call, plain call, table elements, ray rows in) for each
    of the four kernels this scene has primitives for."""
    sgeo, scon, pgeo, pcon = intersect_tables(scene)
    extra = ck.CHECKER_EXTRA if scene.has_checker else 0
    ol, dl, t_min = list(o), list(d), float(np.float32(t_min))
    calls = {}
    if pgeo is not None:
        n_attr = ck.PLANAR_ATTRS + extra
        calls["planar_closest"] = (
            lambda: ck.planar_closest_table(pgeo, o, d, t_max_p, t_min=t_min),
            lambda: ck._planar_closest_plain(pgeo, ol, dl, t_max_p, t_min),
            pgeo.numel(), 7)
        calls["planar_closest_attrs"] = (
            lambda: ck.planar_closest_attrs_table(pgeo, pcon, o, d, t_max_p,
                                                  t_min=t_min, n_attr=n_attr),
            lambda: ck._planar_closest_attrs_plain(pgeo, pcon, ol, dl, t_max_p,
                                                   t_min, n_attr),
            pgeo.numel() + pcon.numel(), 7)
    if sgeo is not None:
        n_attr = ck.SPHERE_ATTRS + extra
        calls["sphere_closest"] = (
            lambda: ck.sphere_closest_table(sgeo, o, d, tm, t_max_s, t_min=t_min),
            lambda: ck._sphere_closest_plain(sgeo, ol, dl, tm, t_max_s, t_min),
            sgeo.numel(), 8)
        calls["sphere_closest_attrs"] = (
            lambda: ck.sphere_closest_attrs_table(sgeo, scon, o, d, tm, t_max_s,
                                                  t_min=t_min, n_attr=n_attr),
            lambda: ck._sphere_closest_attrs_plain(sgeo, scon, ol, dl, tm, t_max_s,
                                                   t_min, n_attr),
            sgeo.numel() + scon.numel(), 8)
    return calls


def intersect_mismatch(k, p):
    """Kernel outputs against the plain version's: (share of rays on which
    hit, index, t or any attribute row differs, largest absolute error of t
    and the attributes on rays that hit in both)."""
    bad = (k[0] != p[0]) | (k[1] != p[1]) | (k[2] != p[2])
    both = k[2] & p[2]
    err = (k[0] - p[0]).abs()[both].max() if bool(both.any()) else k[0].new_zeros(())
    if len(k) == 4:
        bad |= (k[3] != p[3]).any(dim=0)
        if bool(both.any()):
            err = torch.maximum(err, (k[3] - p[3]).abs()[:, both].max())
    return float(bad.float().mean()), float(err)


def dead_layouts(n, device):
    """name -> mask of the rays that come in dead (t_max = -1): a third,
    25, 50 and 75 % spread evenly and in contiguous runs of 1,024, all."""
    i = torch.arange(n, device=device)
    masks = {"minus_one_on_a_third": i % 3 == 0, "dead_all": i >= 0}
    for share in (1, 2, 3):
        masks[f"dead_{25 * share}_spread"] = (i % 4) < share
        masks[f"dead_{25 * share}_runs"] = ((i // 1024) % 4) < share
    return masks


def planar_bit_gate(kernel, share, name, where):
    """The planar kernels must equal their plain versions bit for bit (no
    share of rays may differ); the sphere kernels keep the share gate."""
    bad = share > 0.0 if kernel.startswith("planar") else share >= MAX_MISMATCH_SHARE
    if bad:
        raise RuntimeError(f"{name}, {where}: {kernel} differs from its plain version "
                           f"on {share:.4%} of rays")


def compare_intersect(scene, o, d, tm, name):
    """The four kernels against their plain versions on one set of rays, with
    t_max of BIG, of half the nearest hit's distance, and of -1 on the rays
    of each of ``dead_layouts``; and with t_min = 0 and t_max BIG, the planar
    kernels' route without the sign gate.  Returns {kernel: (worst mismatch
    share, worst error)}."""
    n = tm.shape[0]
    big = torch.full_like(tm, ck.BIG)
    dead = dead_layouts(n, tm.device)
    first = {k: v[0]() for k, v in intersect_calls(scene, o, d, tm, big, big).items()}

    def t_max_for(kernel, kind):
        if kind in ("big", "t_min_zero"):
            return big
        if kind in dead:
            return torch.where(dead[kind], -1.0, big)
        t, _, hit = first[kernel][:3]
        return torch.where(hit, t * 0.5, big)

    worst = {}
    fields = {}
    for kind in ("big", "halved", "t_min_zero", *dead):
        tmax_s = t_max_for("sphere_closest", kind) if "sphere_closest" in first else big
        tmax_p = t_max_for("planar_closest", kind) if "planar_closest" in first else big
        t_min = 0.0 if kind == "t_min_zero" else cw.EPS_HIT
        for kernel, (run, plain, _, _) in intersect_calls(
                scene, o, d, tm, tmax_s, tmax_p, t_min).items():
            k = run()
            torch.cuda.synchronize()
            p = plain()
            share, err = intersect_mismatch(k, p)
            if not torch.isfinite(k[0]).all():
                raise RuntimeError(f"{name}: {kernel} returned a t that is not finite")
            if kind == "halved" and bool(k[2][first[kernel][2]].any()):
                raise RuntimeError(f"{name}: {kernel} hit beyond its t_max")
            if kind in dead and bool(k[2][dead[kind]].any()):
                raise RuntimeError(f"{name}: {kernel} hit on a ray with t_max = -1")
            fields[f"{kernel}_{kind}"] = dict(
                mismatch_share=share, max_abs_err=err,
                hit_share=float(k[2].float().mean()))
            w = worst.get(kernel, (0.0, 0.0))
            worst[kernel] = (max(w[0], share), max(w[1], err))
    emit("intersect_kernels_vs_plain", scene=name, rays=n,
         n_planar=int(scene.planar.d.shape[0]),
         n_spheres=int(scene.spheres.radius.shape[0]),
         checker=scene.has_checker, planar_routes_checked=["gated", "ungated"],
         **fields)
    for kernel, (share, _) in worst.items():
        planar_bit_gate(kernel, share, name, "its sets")
    return worst


def scattered_rays(cam, n, seed, device):
    """Half camera rays, half rays from random points in random directions,
    each with a random time: what the sweeps see after the first bounce."""
    o, d, _, _ = chunk_rays(cam, n, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = torch.rand((7, n), device=device, generator=gen)
    second = torch.arange(n, device=device) >= n // 2
    o = V3(*(torch.where(second, (rnd[i] - 0.5) * 6.0, c) for i, c in enumerate(o)))
    d = V3(*(torch.where(second, rnd[3 + i] - 0.5, c) for i, c in enumerate(d)))
    return (V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)),
            rnd[6].contiguous())


def image_share_outside(a, b):
    """Share of pixel channels of ``a`` outside rtol/atol of ``b``."""
    return 1.0 - float(torch.isclose(a, b, rtol=IMAGE_RTOL, atol=IMAGE_ATOL)
                       .float().mean())


def timed_renders(fn, rounds):
    """``rounds`` renders, each timed by CUDA events, with the launch counts
    of the last (set to 0 just before it, read just after).  Returns (ms of
    each round, the last image, its counts, its stats)."""
    taken = []
    for _ in range(rounds):
        stats = grt.RenderStats()
        reset_intersect_counts()
        cw.LAUNCHES = 0
        ms, img = cuda_ms(lambda: fn(stats))
        counts = intersect_counts()
        taken.append(ms)
    return taken, img, counts, stats, cw.LAUNCHES


def standard_main_path(scene, cam, mega_img, mega_ms):
    """The Cornell job through the standard integrator's fast route, held
    against the megakernel's picture of the same seed."""
    n_rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    grt.render_image(scene, cam, seed=0, mega_mode="off")   # warm-up
    rounds, img, counts, stats, mega_launches = timed_renders(
        lambda st: grt.render_image(scene, cam, seed=0, mega_mode="off", stats=st), 3)
    ms = median(rounds)
    share = image_share_outside(img, mega_img)
    emit("standard_main_path", scene="cornell", width=cam.image_width,
         height=cam.image_height, spp=cam.samples_per_pixel, depth=cam.max_depth,
         camera_rays=n_rays, chunks=stats.chunks, route="fast", launches=counts,
         launches_megakernel=mega_launches, render_ms_rounds=rounds,
         render_ms_median=ms, camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
         megakernel_render_ms=mega_ms,
         megakernel_camera_mrays_per_s=n_rays / (mega_ms * 1e-3) / 1e6,
         pixel_share_outside_tolerance=share,
         max_abs_diff=float((img - mega_img).abs().max()),
         image_mean=float(img.mean()), rtol=IMAGE_RTOL, atol=IMAGE_ATOL)
    if not torch.isfinite(img).all():
        raise RuntimeError("standard integrator: image is not finite")
    per_chunk = cam.max_depth * stats.chunks
    if mega_launches != 0 or not (
            0 < counts["planar_closest_attrs"] <= per_chunk
            and 0 < counts["planar_closest"] <= per_chunk
            and counts["sphere_closest"] == counts["sphere_closest_attrs"] == 0):
        raise RuntimeError(f"standard integrator: launches {counts} for "
                           f"{stats.chunks} chunks, megakernel {mega_launches}")
    if share >= MAX_PIXEL_SHARE_OUTSIDE:
        raise RuntimeError(f"standard integrator: {share:.4%} of pixel channels "
                           "differ from the megakernel's picture")
    return counts, ms, stats.chunks


def fog_room_scene(device):
    """A scene the megakernel cannot take: the Cornell room with a round fog
    and a pyramid fog, a checker floor, a metal and a glass sphere."""
    b = grt.SceneBuilder()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    checker = b.lambertian(b.checker(60.0, (0.2, 0.3, 0.1), (0.9, 0.9, 0.8)))
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.add_light(b.quad((213, 554, 227), (130, 0, 0), (0, 0, 105),
                       b.diffuse_light((15, 15, 15))))
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), checker)
    b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)
    b.sphere((400, 90, 190), 90, b.metal((0.8, 0.6, 0.2), 0.15))
    b.sphere((170, 80, 140), 80, b.dielectric(1.5))
    b.volume_sphere((278, 330, 300), 130, 0.004, (0.85, 0.9, 0.95))
    b.volume_pyramid((150, 0, 400), 220, 300, 0.006, (0.9, 0.7, 0.6))
    cam = Camera(image_width=600, aspect_ratio=1.0, samples_per_pixel=100,
                 max_depth=5, look_from=(278, 278, -800), look_at=(278, 278, 0),
                 vfov=40.0, background=(0.0, 0.0, 0.0))
    return b.build(device=device), cam


def standard_outside_gate(device, width=600, spp=100, random_spp=25):
    """The fog room at 600x600, 100 spp, depth 5 through ``render_image`` left
    to itself (fast route), its two routes against each other on one chunk's
    worth of samples, and ``random`` with ``mega_mode="off"`` against its
    megakernel render.  Returns the launch counts of the fog room's render."""
    scene, cam = fog_room_scene(device)
    cam = dataclasses.replace(cam, image_width=width, samples_per_pixel=spp)
    n_rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    chose = wavefront.choose_mega_mode(scene, cam, n_rays, False)
    if cw.applicable(scene) or chose != "off":
        raise RuntimeError(f"the fog room must be outside the gate, mode {chose!r}")
    rounds, img, counts, stats, mega_launches = timed_renders(
        lambda st: grt.render_image(scene, cam, seed=0, stats=st), 2)
    # one chunk of the fast route, and the same samples on the gather route
    one = min(renderer.pick_chunk_size(scene)
              // (cam.image_width * cam.image_height), spp)
    chunk = one * cam.image_width * cam.image_height
    fast_ms, fast = cuda_ms(lambda: grt.render_image(
        scene, cam, spp=one, seed=0, chunk=chunk, mega_mode="off"))
    reset_intersect_counts()
    with torch.no_grad():
        gather_ms, gather = cuda_ms(lambda: grt.render_image(
            scene, cam, spp=one, seed=0, chunk=chunk, differentiable=True))
    gather_counts = intersect_counts()
    share = image_share_outside(fast, gather)
    mean = float(img.mean())
    emit("standard_outside_gate", scene="fog_room", width=cam.image_width,
         height=cam.image_height, spp=cam.samples_per_pixel, depth=cam.max_depth,
         camera_rays=n_rays, chunks=stats.chunks, chose_mega_mode=chose,
         launches=counts, render_ms_rounds=rounds,
         camera_mrays_per_s=n_rays / (min(rounds) * 1e-3) / 1e6,
         image_mean=mean, one_chunk_spp=one, one_chunk_rays=chunk,
         fast_route_ms_one_chunk=fast_ms, gather_route_ms_one_chunk=gather_ms,
         gather_route_launches=gather_counts,
         routes_pixel_share_outside_tolerance=share,
         routes_max_abs_diff=float((fast - gather).abs().max()))
    if not torch.isfinite(img).all() or not 0.02 < mean < 0.98:
        raise RuntimeError(f"fog room: image mean {mean}")
    if mega_launches != 0 or min(counts.values()) < 1:
        raise RuntimeError(f"fog room: launches {counts}, megakernel {mega_launches}")
    if (gather_counts["planar_closest_attrs"] or gather_counts["sphere_closest_attrs"]
            or gather_counts["planar_closest"] != 2 * cam.max_depth
            or gather_counts["sphere_closest"] != 2 * cam.max_depth):
        raise RuntimeError(f"fog room, gather route: launches {gather_counts}")
    if share >= MAX_PIXEL_SHARE_OUTSIDE:
        raise RuntimeError(f"fog room: the two routes differ on {share:.4%} of "
                           "pixel channels")

    r_scene, r_cam = grt.load_scene("random")
    r_cam = dataclasses.replace(r_cam, image_width=width, aspect_ratio=16 / 9,
                                samples_per_pixel=random_spp, max_depth=10)
    n_r = r_cam.image_width * r_cam.image_height * r_cam.samples_per_pixel
    mega_ms, mega_img = cuda_ms(lambda: grt.render_image(r_scene, r_cam, seed=0))
    r_rounds, r_img, r_counts, r_stats, _ = timed_renders(
        lambda st: grt.render_image(r_scene, r_cam, seed=0, mega_mode="off",
                                    stats=st), 2)
    r_share = image_share_outside(r_img, mega_img)
    emit("standard_random", scene="random", width=width,
         height=r_cam.image_height, spp=random_spp, depth=10, camera_rays=n_r, chunks=r_stats.chunks,
         n_spheres=int(r_scene.spheres.radius.shape[0]),
         n_planar=int(r_scene.planar.d.shape[0]), launches=r_counts,
         render_ms_rounds=r_rounds,
         camera_mrays_per_s=n_r / (min(r_rounds) * 1e-3) / 1e6,
         megakernel_render_ms=mega_ms,
         pixel_share_outside_tolerance=r_share,
         max_abs_diff=float((r_img - mega_img).abs().max()))
    if r_counts["sphere_closest_attrs"] < 1 or not torch.isfinite(r_img).all():
        raise RuntimeError(f"random: launches {r_counts}")
    if r_share >= MAX_PIXEL_SHARE_OUTSIDE:
        raise RuntimeError(f"random: {r_share:.4%} of pixel channels differ from "
                           "the megakernel's picture")
    return counts


def standard_autograd(name, scene, cam):
    """``torch.autograd`` through ``render(differentiable=True)`` (gather
    route: the closest-hit kernels under a recorded graph) against
    ``render_grad`` (the gradient kernels) for the same pixel-MSE loss: two
    independent routes to the colour gradients.  fuzz and ior are not
    compared: the closest-hit kernels hand autograd a hit distance without
    a gradient, so its fuzz and ior gradients lack the terms that reach
    later hits through that distance; ``render_grad``'s are the exact ones.
    It runs twice: the two backward passes must give the same bits (every
    table row is gathered by ``take_rows``, whose backward pass is the
    row-sum kernel).  Returns whether they did."""
    spp = cam.samples_per_pixel
    target = grt.render(scene, cam, seed=1) / spp * 0.8
    loss_k, g_k = grt.render_grad(scene, cam, target, seed=0)
    runs = []
    for _ in range(2):
        params = {k: v.clone().requires_grad_()
                  for k, v in grt.trainable_params(scene).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_intersect_counts()
        cr.LAUNCHES_ROW_SUMS = 0
        stats = grt.RenderStats()

        def run():
            fb = grt.render(grt.apply_params(scene, params), cam, seed=0,
                            differentiable=True, stats=stats)
            loss = torch.mean((fb / spp - target) ** 2)
            loss.backward()
            return loss.detach()

        ms, loss = cuda_ms(run)
        runs.append((ms, params, cr.LAUNCHES_ROW_SUMS))
    counts = intersect_counts()
    peak = torch.cuda.max_memory_allocated()
    same_bits = all(torch.equal(runs[0][1][k].grad, runs[1][1][k].grad)
                    for k in params if params[k].grad is not None)
    ms = runs[0][0]
    big = float(g_k["color"].abs().max())
    diff = float((params["color"].grad - g_k["color"]).abs().max()) / big
    loss_diff = abs(float(loss) - float(loss_k)) / float(loss_k)
    finite = all(bool(torch.isfinite(p.grad).all()) for p in params.values()
                 if p.grad is not None)
    emit("standard_autograd", scene=name, width=cam.image_width,
         height=cam.image_height, spp=spp, depth=cam.max_depth,
         camera_rays=cam.image_width * cam.image_height * spp,
         chunks=stats.chunks, launches=counts, forward_backward_ms=ms,
         forward_backward_ms_second_run=runs[1][0], row_sums_launches=runs[1][2],
         gradients_same_bits_in_both_runs=same_bits,
         loss=float(loss), loss_rel_diff_to_render_grad=loss_diff,
         color_grad_diff_of_largest=diff, largest_color_grad=big,
         all_gradients_finite=finite, max_memory_allocated=peak,
         fuzz_and_ior="not compared: the kernels' hit distance carries no gradient")
    if not finite:
        raise RuntimeError(f"{name}: a gradient through autograd is not finite")
    if counts["planar_closest_attrs"] or counts["sphere_closest_attrs"] \
            or counts["planar_closest"] != 2 * cam.max_depth * stats.chunks:
        raise RuntimeError(f"{name}: launches {counts} for {stats.chunks} chunks")
    if loss_diff > 1e-4 or not diff <= AUTOGRAD_RTOL_OF_LARGEST:
        raise RuntimeError(f"{name}: autograd against render_grad: loss off by "
                           f"{loss_diff}, colour gradients by {diff}")
    if runs[1][2] < 1:
        raise RuntimeError(f"{name}: the backward pass launched no row-sum kernel")
    return same_bits


def intersect_kernel_timing(cases, launches, small_checks):
    """The four kernels alone at their main paths' chunks, all rays with
    t_max = BIG, beside their bounds, and against their plain versions at
    that size.  ``cases``: (scene name, scene, o, d, tm).  Returns the four
    entries of the ``kernels`` line."""
    sources = {
        "planar_closest": ("175 (planar_closest)", FLOPS_PLANAR),
        "sphere_closest": ("270 (sphere_closest)", FLOPS_SPHERE),
        "planar_closest_attrs": ("480 (_run_attr_kernel, planar_closest_attrs)",
                                 FLOPS_PLANAR),
        "sphere_closest_attrs": ("480 (_run_attr_kernel, sphere_closest_attrs)",
                                 FLOPS_SPHERE),
    }
    entries = {}
    for scene_name, scene, o, d, tm, wanted in cases:
        n = tm.shape[0]
        big = torch.full_like(tm, ck.BIG)
        for kernel, (run, plain, table_elems, rows_in) in intersect_calls(
                scene, o, d, tm, big, big).items():
            if kernel not in wanted:
                continue
            run()
            rounds, k = rounds_ms(run)
            ms = median(rounds)
            plain_ms, p = cuda_ms(plain)
            share, err = intersect_mismatch(k, p)
            planar_bit_gate(kernel, share, scene_name, "full chunk")
            n_prims = (scene.planar.d if kernel.startswith("planar")
                       else scene.spheres.radius).shape[0]
            out_bytes = sum(t.numel() * t.element_size() for t in k)
            moved = rows_in * 4 * n + out_bytes + 4 * table_elems
            flops = float(n) * n_prims * sources[kernel][1]
            bound = (moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3)
            emit("intersect_kernel_timing", kernel=kernel, scene=scene_name,
                 rays_per_launch=n, primitives=int(n_prims),
                 n_attr=int(k[3].shape[0]) if len(k) == 4 else 0,
                 ms=ms, ms_rounds=rounds, plain_ms=plain_ms, bytes_counted=moved,
                 flops_counted=flops, bound_bytes_ms=bound[0], bound_ops_ms=bound[1],
                 roofline_share=max(bound) / ms, hit_share=float(k[2].float().mean()),
                 mismatch_share_full_chunk=share, max_abs_err_full_chunk=err,
                 previous_design_ms_perf_md=PREVIOUS_DESIGN_MS.get(kernel))
            small = [c[kernel] for c in small_checks if kernel in c]
            entries[kernel] = kernel_entry(
                n, kernel, "go_raytracing_tpu_torch/csrc/intersect.cu",
                "go_raytracing_tpu/ops/pallas_intersect.py:" + sources[kernel][0],
                launches[kernel], ms, plain_ms, bound,
                [err] + [c[1] for c in small]) | {
                    "mismatch_share": max([share] + [c[0] for c in small]),
                    "primitives": int(n_prims), "scene": scene_name}
            del k, p
    return [entries[k] for k in sources]


def capture_planar_launches(scene, cam, spp, chunk):
    """The planar kernels' launches of one chunk of ``cam``'s job on the
    standard integrator's fast route, in the order made: (kernel name,
    geometry table, constants table or None, o, d, t_max, t_min, n_attr or
    None), the inputs as the wrappers hand them to the kernels (cloned).  The
    wrappers are wrapped for that one render and restored after."""
    got = []
    orig = (ck._planar_closest_cuda, ck._planar_closest_attrs_cuda)

    def keep(kernel, geo, con, o, d, t_max, t_min, n_attr):
        got.append((kernel, geo, con, [c.clone() for c in o], [c.clone() for c in d],
                    t_max.clone(), t_min, n_attr))

    def closest(geo, o, d, t_max, t_min):
        keep("planar_closest", geo, None, o, d, t_max, t_min, None)
        return orig[0](geo, o, d, t_max, t_min)

    def attrs(geo, con, o, d, t_max, t_min, n_attr):
        keep("planar_closest_attrs", geo, con, o, d, t_max, t_min, n_attr)
        return orig[1](geo, con, o, d, t_max, t_min, n_attr)

    ck._planar_closest_cuda, ck._planar_closest_attrs_cuda = closest, attrs
    try:
        grt.render_image(scene, cam, spp=spp, seed=0, chunk=chunk, mega_mode="off")
    finally:
        ck._planar_closest_cuda, ck._planar_closest_attrs_cuda = orig
    return got


def planar_launch_calls(launch):
    """(kernel call, plain call) of a captured launch."""
    kernel, geo, con, o, d, t_max, t_min, n_attr = launch
    if kernel == "planar_closest":
        return (lambda: ck._planar_closest_cuda(geo, o, d, t_max, t_min),
                lambda: ck._planar_closest_plain(geo, o, d, t_max, t_min))
    return (lambda: ck._planar_closest_attrs_cuda(geo, con, o, d, t_max, t_min, n_attr),
            lambda: ck._planar_closest_attrs_plain(geo, con, o, d, t_max, t_min, n_attr))


def planar_launch_bound(launch):
    """(bytes bound ms, operations bound ms) of a captured launch: a live ray
    (t_max >= t_min) reads its 7 rows, a dead one its t_max alone, every ray
    writes t, idx, hit and the attribute rows; live rays x primitives x
    FLOPS_PLANAR operations."""
    kernel, geo, con, _, _, t_max, t_min, n_attr = launch
    n = t_max.shape[0]
    live = int((ck._clamp_t_max(t_max) >= t_min).sum())
    moved = (7 * 4 * live + 4 * (n - live) + (4 + 4 + 1 + 4 * (n_attr or 0)) * n
             + 4 * (geo.numel() + (con.numel() if con is not None else 0)))
    flops = float(live) * geo.shape[1] * FLOPS_PLANAR
    return live, (moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3)


def planar_path_timing(scene, cam):
    """B7a and B8p on the launches the main path really makes: one chunk of
    the Cornell job (``cam``) on the standard integrator's fast route, each
    launch's inputs captured, then each launch timed alone (median of 3
    rounds of 5), held to its plain version bit for bit, beside its bound
    (a dead ray counted at its t_max and its outputs) and its share of live
    rays; in its phase line the sums by kernel beside the previous design's
    (PERF.md section 6).  Returns {kernel: the sums of the measured times and
    the bounds, and the live shares, for its entry of the ``kernels`` line}."""
    n_virt = cam.image_width * cam.image_height
    spp = min(renderer.pick_chunk_size(scene) // n_virt, cam.samples_per_pixel)
    launches = capture_planar_launches(scene, cam, spp, spp * n_virt)
    rows, out = [], {}
    for k, launch in enumerate(launches):
        run, plain = planar_launch_calls(launch)
        run()
        rounds, got = rounds_ms(run)
        ms = median(rounds)
        share, err = intersect_mismatch(got, plain())
        planar_bit_gate(launch[0], share, "cornell chunk", f"launch {k}")
        live, bound = planar_launch_bound(launch)
        n = int(launch[5].shape[0])
        rows.append(dict(launch=k, kernel=launch[0], rays=n, live=live, live_share=live / n,
                         t_min=launch[6], n_attr=launch[7], ms=ms, ms_rounds=rounds,
                         bound_ms=max(bound), roofline_share=max(bound) / ms,
                         mismatch_share=share, max_abs_err=err))
        f = out.setdefault(launch[0], dict(path_ms_sum=0.0, path_bound_ms_sum=0.0,
                                           path_live_shares=[], path_max_abs_err=0.0))
        f["path_ms_sum"] += ms
        f["path_bound_ms_sum"] += max(bound)
        f["path_live_shares"].append(live / n)
        f["path_max_abs_err"] = max(f["path_max_abs_err"], err)
        del got
    for kernel, f in out.items():
        f["path_roofline_share"] = f["path_bound_ms_sum"] / f["path_ms_sum"]
    emit("planar_path_timing", scene="cornell", chunk_rays=spp * n_virt, launches=rows,
         sums={k: {"launches": len(f["path_live_shares"]), "ms": f["path_ms_sum"],
                   "bound_ms": f["path_bound_ms_sum"],
                   "previous_design_ms_perf_md": PREVIOUS_DESIGN_MS[k + "_path"]}
               for k, f in out.items()})
    if set(out) != {"planar_closest", "planar_closest_attrs"}:
        raise RuntimeError(f"cornell chunk: planar launches {sorted(out)}")
    return out


def device_rows(prof):
    """(kernel name, device ms, launches) of a profile, longest first."""
    rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower()]
    if not rows:
        rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
                for e in prof.key_averages()
                if getattr(e, "self_device_time_total", 0.0) > 0]
    return sorted(rows, key=lambda r: -r[1])


def profile_standard_chunk(scene, cam):
    """Device time by kernel over one chunk of the Cornell job on the fast
    route, from ``torch.profiler``, beside the same render's time without the
    profiler (which slows the host many times over): the device's busy share
    is the kernels' summed time over that."""
    from torch.profiler import ProfilerActivity, profile

    n_virt = cam.image_width * cam.image_height
    one = renderer.pick_chunk_size(scene) // n_virt
    grt.render(scene, cam, spp=one, seed=0, mega_mode="off")
    plain_ms, _ = cuda_ms(lambda: grt.render(scene, cam, spp=one, seed=0, mega_mode="off"))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grt.render(scene, cam, spp=one, seed=0, mega_mode="off")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if "planar_kernel" in r[0] or "sphere_kernel" in r[0])
    int64 = [r for r in rows if "<long" in r[0] or " long" in r[0]]   # the PCG3D hash
    emit("standard_profile", scene="cornell", rays=one * n_virt, spp=one,
         render_ms_without_profiler=plain_ms,
         wall_ms_under_profiler=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / plain_ms,
         device_idle_share=1.0 - device_ms / plain_ms,
         device_kernel_launches=sum(r[2] for r in rows),
         closest_hit_kernels_ms=ours,
         int64_kernels_ms=sum(r[1] for r in int64),
         int64_kernel_launches=sum(r[2] for r in int64),
         top=[dict(name=r[0][:80], ms=r[1], calls=r[2]) for r in rows[:12]])


# ---- instanced triangle meshes: cornell-lucy through the two mesh kernels ----

MESH_KERNELS = {"mesh_sweep": "sweep", "mesh_stream": "stream"}


def mesh_counts():
    return {"mesh_sweep": cm.LAUNCHES_SWEEP, "mesh_stream": cm.LAUNCHES_STREAM}


def reset_mesh_counts():
    cm.LAUNCHES_SWEEP = cm.LAUNCHES_STREAM = 0


def lucy_scene(detail, device, width=600, spp=25, depth=5):
    """``cornell-lucy`` with ``mesh_detail=detail``, 10 instances, at the JAX
    package's bench size (600x600, 25 spp, depth 5)."""
    scene, cam = grt.load_scene("cornell-lucy", mesh_detail=detail, device=device)
    return scene, dataclasses.replace(cam, image_width=width, aspect_ratio=1.0,
                                      samples_per_pixel=spp, max_depth=depth)


def lucy_chunk(scene, cam, device):
    """The render's first chunk (as ``render`` sizes it): camera rays and
    their stream ids."""
    _, _, n_virt = renderer.ray_layout(cam.image_width, cam.image_height,
                                       renderer.scene_tiled(scene))
    chunk = min(renderer.pick_chunk_size(scene),
                -(-n_virt * cam.samples_per_pixel // 1024) * 1024)
    chunk = min(chunk // n_virt, cam.samples_per_pixel) * n_virt
    cam2, o, d, tm, ids, _, _ = renderer._chunk_rays(
        scene, cam, 0, 0, spp=cam.samples_per_pixel, chunk=chunk,
        max_depth=cam.max_depth, device=device)
    return cam2, o, d, tm, ids


def mesh_mixed_rays(n, seed, device):
    """Two thirds camera rays aimed at the ten statues (unnormalized
    directions), a third from random points in the room in random
    directions."""
    from go_raytracing_tpu_torch.scenes.builders import LUCY_POSITIONS

    gen = torch.Generator(device=device).manual_seed(seed)
    n_cam = 2 * n // 3
    centres = torch.tensor([[p[0], 120.0, p[2]] for p, _ in LUCY_POSITIONS], device=device)
    pick = torch.randint(0, len(LUCY_POSITIONS), (n_cam,), device=device, generator=gen)
    spread = torch.tensor([70.0, 110.0, 45.0], device=device)
    o_cam = torch.tensor([278.0, 278.0, -800.0], device=device) \
        + torch.randn((n_cam, 3), device=device, generator=gen) * 5
    d_cam = centres[pick] + torch.randn((n_cam, 3), device=device, generator=gen) * spread - o_cam
    lo = torch.tensor([20.0, 1.0, 20.0], device=device)
    hi = torch.tensor([535.0, 400.0, 535.0], device=device)
    o_box = lo + torch.rand((n - n_cam, 3), device=device, generator=gen) * (hi - lo)
    d_box = torch.randn((n - n_cam, 3), device=device, generator=gen)
    o, d = torch.cat([o_cam, o_box]), torch.cat([d_cam, d_box])
    return (V3(*(o[:, i].contiguous() for i in range(3))),
            V3(*(d[:, i].contiguous() for i in range(3))))


def first_bounce(scene, cam, device):
    """The render's first chunk of camera rays and the rays that leave their
    hits (the standard integrator's bounce 0 on the whole chunk): (camera o,
    camera d, next path state)."""
    cam2, o, d, tm, ids = lucy_chunk(scene, cam, device)
    r = tm.shape[0]
    state = wavefront.PathState(
        o, d, V3.full((r,), (1.0, 1.0, 1.0), device=device), V3.zeros((r,), device=device),
        torch.ones(r, dtype=torch.bool, device=device),
        torch.ones(r, dtype=torch.bool, device=device),
        V3.zeros((r,), device=device), V3.zeros((r,), device=device),
        torch.zeros(r, dtype=torch.bool, device=device),
        torch.zeros(r, dtype=torch.bool, device=device))
    with torch.no_grad():
        nxt = wavefront.bounce_step(scene, cam2, state, tm, ids, 0, 0, fast=False)
    return o, d, nxt


def mesh_chunk_rays(scene, cam, n, seed, device):
    """``n`` rays drawn from the render's first chunk: half camera rays, half
    the first-bounce rays that leave their hits."""
    o, d, nxt = first_bounce(scene, cam, device)
    r = o.x.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    cam_pick = torch.randint(0, r, (n // 2,), device=device, generator=gen)
    alive = torch.nonzero(nxt.alive).squeeze(1)
    bounce_pick = alive[torch.randint(0, alive.numel(), (n - n // 2,), device=device,
                                      generator=gen)]
    o_ = V3(*(torch.cat([a[cam_pick], b[bounce_pick]]).contiguous()
              for a, b in zip(o, nxt.o)))
    d_ = V3(*(torch.cat([a[cam_pick], b[bounce_pick]]).contiguous()
              for a, b in zip(d, nxt.d)))
    return o_, d_


def mesh_mismatch(k, p, any_hit):
    """Shares of rays on which hit, tri, inst and the bits of t differ, and
    the largest |t difference| on rays that hit in both (any-hit mode: hit
    only)."""
    both = k[3] & p[3]
    out = {"hit": float((k[3] != p[3]).float().mean())}
    if not any_hit:
        out.update(tri=float((k[1] != p[1]).float().mean()),
                   inst=float((k[2] != p[2]).float().mean()),
                   t_bits=float((k[0].view(torch.int32) != p[0].view(torch.int32))
                                .float().mean()))
        out["max_abs_dt"] = (float((k[0] - p[0]).abs()[both].max())
                             if bool(both.any()) else 0.0)
    out["any"] = max(v for key, v in out.items() if key != "max_abs_dt")
    return out


def compare_mesh(name, proto, kernel, rays, rays_name):
    """One kernel against its plain version on one set of rays, closest-hit
    and any-hit, with t_max BIG, cut at a random 0.5 to 1.5 of the hit
    distance, and -1 on a third of the rays.  Returns (worst mismatch
    share, worst |dt|)."""
    o, d = rays
    kind = MESH_KERNELS[kernel]
    fn = cm.intersect_mesh_kernel if kind == "sweep" else cm.intersect_mesh_stream
    n = o.x.shape[0]
    big = torch.full((n,), ck.BIG, device=o.x.device)
    t0, _, _, h0, _ = fn(proto, o, d, cw.EPS_HIT, big)
    gen = torch.Generator(device=o.x.device).manual_seed(13)
    scale = 0.5 + torch.rand(n, device=o.x.device, generator=gen)
    third = torch.arange(n, device=o.x.device) % 3 == 0
    kinds = {"big": big, "cut": torch.where(h0, t0 * scale, big),
             "minus_one_on_a_third": torch.where(third, -1.0, big)}
    fields, worst, worst_dt = {}, 0.0, 0.0
    for any_hit in (False, True):
        for tname, t_max in kinds.items():
            k = fn(proto, o, d, cw.EPS_HIT, t_max, any_hit=any_hit)
            torch.cuda.synchronize()
            p_ms, p = cuda_ms(lambda: cm.plain(kind, proto, o, d, cw.EPS_HIT, t_max,
                                               any_hit=any_hit))
            mm = mesh_mismatch(k, p, any_hit)
            if tname == "minus_one_on_a_third" and bool(k[3][third].any()):
                raise RuntimeError(f"{name}: {kernel} hit on a ray with t_max = -1")
            if k[4] != 0 or not torch.isfinite(k[0]).all():
                raise RuntimeError(f"{name}: {kernel} overflow {k[4]} or t not finite")
            fields[f"{'any' if any_hit else 'closest'}_{tname}"] = dict(
                mm, hit_share=float(k[3].float().mean()), plain_ms=p_ms)
            worst = max(worst, mm["any"])
            worst_dt = max(worst_dt, mm.get("max_abs_dt", 0.0))
    emit("mesh_kernels_vs_plain", kernel=kernel, mesh=name, rays=rays_name,
         n_rays=n, triangles=proto.n_tris, instances=proto.n_instances, **fields)
    if worst >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"{name}: {kernel} differs from its plain version on "
                           f"{worst:.4%} of rays ({rays_name})")
    return worst, worst_dt


def crop_rays(cam, x0, y0, size, seed, device):
    """Camera rays of sample 0 of the pixels [x0, x0 + size) x [y0, y0 + size)
    with the stream ids the full render gives them (tiled layout)."""
    tiles_x = -(-cam.image_width // renderer.BUCKET)
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + size, device=device),
                            torch.arange(x0, x0 + size, device=device), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    tile = (py // renderer.BUCKET) * tiles_x + px // renderer.BUCKET
    ids = tile * renderer.BUCKET ** 2 + (py % renderer.BUCKET) * renderer.BUCKET \
        + px % renderer.BUCKET
    o, d, tm = generate_rays(cam, px, py, ids, seed)
    return o, d, tm, ids


def mesh_crop_check(scene, cpu_scene, cam, name, x0=284, y0=405, size=32):
    """A 32x32-pixel crop at 1 spp traced on the card (the kernels) and on
    the CPU (the plain versions), same rays and streams: the share of
    tonemapped pixel channels outside rtol 1e-3 / atol 2e-3."""
    imgs = []
    for sc in (scene, cpu_scene):
        o, d, tm, ids = crop_rays(cam, x0, y0, size, 0, sc.device)
        rad = wavefront.trace(sc, cam, o, d, tm, ids, 0)
        imgs.append(grt.film.tonemap(rad.rows().reshape(size, size, 3), 1).cpu())
        if not imgs[1:]:
            hit = wavefront._mesh_intersect(sc.meshes[0], o, d, cw.EPS_HIT,
                                            torch.full_like(tm, ck.BIG))[3]
            mesh_share = float(hit.float().mean())
    share = image_share_outside(imgs[0], imgs[1])
    return dict(crop=[x0, y0, size], crop_mesh_hit_share=mesh_share,
                crop_share_outside_tolerance=share,
                crop_max_abs_diff=float((imgs[0] - imgs[1]).abs().max()),
                crop_mean=float(imgs[0].mean())), share


def mesh_main_path(phase, detail, kernel, device, rounds=3):
    """``cornell-lucy`` at ``mesh_detail=detail`` through ``render_image`` on
    the card (the standard integrator's gather route): median of ``rounds``
    renders after a warm-up, the launches of the last, and the crop against
    the plain versions on the CPU.  Returns (launches, chunks, scene, cam)."""
    scene, cam = lucy_scene(detail, device)
    proto = scene.meshes[0]
    n_rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    grt.render_image(scene, cam, seed=0, device=device)  # warm-up
    taken = []
    for _ in range(rounds):
        stats = grt.RenderStats()
        reset_mesh_counts()
        reset_intersect_counts()
        cw.LAUNCHES = 0
        ms, img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0, stats=stats,
                                                   device=device))
        counts, ix = mesh_counts(), intersect_counts()
        taken.append(ms)
    ms = median(taken)
    mean = float(img.mean())
    cpu_scene, _ = lucy_scene(detail, "cpu")
    crop, share = mesh_crop_check(scene, cpu_scene, cam, phase)
    emit(phase, scene="cornell-lucy", mesh_detail=list(detail),
         triangles=proto.n_tris, instances=proto.n_instances, kernel=kernel,
         width=cam.image_width, height=cam.image_height, spp=cam.samples_per_pixel,
         depth=cam.max_depth, camera_rays=n_rays, chunks=stats.chunks,
         launches=counts, closest_hit_launches=ix, megakernel_launches=cw.LAUNCHES,
         mesh_overflow=stats.mesh_overflow, render_ms_rounds=taken,
         render_ms_median=ms, camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
         image_mean=mean, image_finite=bool(torch.isfinite(img).all()), **crop)
    other = "mesh_stream" if kernel == "mesh_sweep" else "mesh_sweep"
    if counts[kernel] < 1 or counts[other] != 0 or cw.LAUNCHES != 0:
        raise RuntimeError(f"{phase}: launches {counts}, megakernel {cw.LAUNCHES}")
    if stats.mesh_overflow != 0:
        raise RuntimeError(f"{phase}: mesh_overflow {stats.mesh_overflow}")
    if not torch.isfinite(img).all() or not mean > 0.01:
        raise RuntimeError(f"{phase}: image mean {mean}")
    if crop["crop_mesh_hit_share"] < 0.1:
        raise RuntimeError(f"{phase}: the crop shows too little of a statue")
    if share >= MAX_PIXEL_SHARE_OUTSIDE:
        raise RuntimeError(f"{phase}: {share:.4%} of the crop's pixel channels differ "
                           "from the plain versions' on the CPU")
    return counts[kernel], stats.chunks, scene, cam


def mesh_autograd(device):
    """``torch.autograd`` through ``render(differentiable=True)`` on
    ``cornell-lucy`` (48, 40) at 64x64, 4 spp, depth 3: the statue's colour
    gets a finite, non-zero gradient, and no gradient is NaN."""
    scene, cam = lucy_scene((48, 40), device, width=64, spp=4, depth=3)
    params = {k: v.clone().requires_grad_()
              for k, v in grt.trainable_params(scene).items()}
    reset_mesh_counts()
    target = torch.full((64, 64, 3), 0.3, device=device)

    def run():
        fb = grt.render(grt.apply_params(scene, params), cam, seed=0,
                        differentiable=True, device=device)
        loss = torch.mean((fb / cam.samples_per_pixel - target) ** 2)
        loss.backward()
        return loss.detach()

    ms, loss = cuda_ms(run)
    statue_tex = int(scene.materials.tex[int(scene.meshes[0].inst_mat[0])])
    g = params["color"].grad[statue_tex]
    finite = all(bool(torch.isfinite(p.grad).all()) for p in params.values()
                 if p.grad is not None)
    emit("mesh_autograd", scene="cornell-lucy", mesh_detail=[48, 40], width=64,
         height=64, spp=4, depth=3, launches=mesh_counts(), forward_backward_ms=ms,
         loss=float(loss), statue_texture=statue_tex, statue_color_grad=g.tolist(),
         all_gradients_finite=finite)
    if not finite or not bool((g.abs() > 0).all()) or cm.LAUNCHES_SWEEP < 1:
        raise RuntimeError(f"mesh autograd: statue colour gradient {g.tolist()}, "
                           f"finite {finite}, launches {mesh_counts()}")


def sorted_like_the_integrator(proto, o, d, t_max=None):
    """Rays as ``_mesh_intersect`` hands them to a kernel: those that reach
    no instance with t_max = -1, sorted by the key.  ``t_max`` (default BIG)
    is -1 on rays that are not alive."""
    big = torch.full_like(o.x, ck.BIG)
    t_max = big if t_max is None else t_max
    reach, key = wavefront._mesh_sort_key(proto, o, d, cw.EPS_HIT, t_max)
    t_max = torch.where(reach, t_max, -1.0)
    order = torch.argsort(key, stable=True)
    return (V3(*(c[order].contiguous() for c in o)),
            V3(*(c[order].contiguous() for c in d)), t_max[order].contiguous(),
            float(reach.float().mean()))


def mesh_timing_case(kind, proto, o, d, t_max, any_hit):
    """One mesh kernel alone on one set of rays (as the integrator hands them
    over): its time, and its plain version's on 16,384 of the rays (512 runs
    of 32, a warp's rays, spread over the set) with the (ray, instance)
    pairs, box and triangle tests they need, scaled to the set, and the
    bound those make; the sweep's outputs also against the plain version's
    on the whole set, to equality (t, tri, inst and hit, any hit too).
    Returns (fields, mismatch on the sample)."""
    fn = cm.intersect_mesh_kernel if kind == "sweep" else cm.intersect_mesh_stream
    dev = t_max.device
    n = t_max.shape[0]
    fn(proto, o, d, cw.EPS_HIT, t_max, any_hit=any_hit)
    rounds, k = rounds_ms(lambda: fn(proto, o, d, cw.EPS_HIT, t_max, any_hit=any_hit),
                          rounds=3, repeats=3)
    ms = median(rounds)
    whole = {}
    if kind == "sweep":
        p = cm.plain(kind, proto, o, d, cw.EPS_HIT, t_max, any_hit=any_hit)
        whole = {"whole_set_equal": all(bool(torch.equal(a, b)) for a, b in zip(k[:4], p[:4]))}
        del p
        if not whole["whole_set_equal"]:
            raise RuntimeError(f"sweep: the kernel's outputs on {n} rays (any hit "
                               f"{any_hit}) are not the plain version's")
    runs = torch.linspace(0, n // 32 - 1, 512, device=dev).long()
    pick = (runs[:, None] * 32 + torch.arange(32, device=dev)).reshape(-1)
    so, sd = V3(*(c[pick] for c in o)), V3(*(c[pick] for c in d))
    counts = {}
    plain_ms, p = cuda_ms(lambda: cm.plain(kind, proto, so, sd, cw.EPS_HIT, t_max[pick],
                                           any_hit=any_hit, counts=counts))
    mm = mesh_mismatch(tuple(a[pick] if torch.is_tensor(a) else a for a in k), p, any_hit)
    scale = n / 16384
    tri_ops = (counts.get("tri_tests", 0) * FLOPS_MOLLER_TRUMBORE if kind == "sweep"
               else counts.get("tri_tests", 0) * FLOPS_BW_PLANE
               + counts.get("tri_t_pass", 0) * FLOPS_BW_UV)
    flops = scale * (counts.get("local_rays", 0) * FLOPS_MESH_LOCAL_RAY
                     + counts.get("box_tests", 0) * FLOPS_BOX_TEST + tri_ops)
    tables = ((proto.k_tri, proto.k_leafbox, proto.k_subtilebox, proto.k_tilebox,
               proto.k_coarsebox) if kind == "sweep"
              else (proto.s_tri, proto.s_tilebox, proto.s_segbox))
    table_bytes = sum(t.numel() * 4 for t in tables) + proto.inst_w2l.numel() * 4
    n_live = int((t_max > cw.EPS_HIT).sum())
    moved = (n_live * MESH_RAYS_IN + (n - n_live) * MESH_DEAD_IN + n * MESH_BYTES_OUT
             + table_bytes)
    bound = (moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3)
    if mm["any"] >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"{kind}: a sample of {n} rays differs from the plain "
                           f"version on {mm['any']:.4%} of rays")
    return dict(
        rays_per_launch=n, any_hit=any_hit, live_rays=n_live,
        hit_share=float(k[3].float().mean()), ms=ms, ms_rounds=rounds,
        plain_ms=plain_ms, plain_rays=16384,
        local_rays_per_ray=counts.get("local_rays", 0) / 16384,
        box_tests_per_ray=counts.get("box_tests", 0) / 16384,
        tri_tests_per_ray=counts.get("tri_tests", 0) / 16384,
        tri_t_pass_per_ray=counts.get("tri_t_pass", 0) / 16384,
        **({"sweep_pairs_per_ray": counts.get("sweep_pairs", 0) / 16384,
            "sweep_rounds_per_warp": counts.get("sweep_rounds", 0) / 512,
            "sweep_warp_tiles_per_warp": counts.get("sweep_warp_tiles", 0) / 512,
            "sweep_walk_tiles_per_warp": counts.get("sweep_walk_tiles", 0) / 512}
           if kind == "sweep" else {}), **whole,
        bytes_counted=moved, table_bytes=table_bytes, flops_counted=flops,
        bound_bytes_ms=bound[0], bound_ops_ms=bound[1], bound_ms=max(bound),
        roofline_share=max(bound) / ms, sample_mismatch=mm), mm


def mesh_kernel_timing(cases, checks, regs):
    """Each mesh kernel alone at its main path's first-bounce chunk (camera
    rays, sorted and filtered as the integrator does), beside its bound, and
    its plain version's time on 16,384 of those rays; also in its any-hit
    instantiation on the same rays and, closest hit (the sweep: and any
    hit), on the rays that leave the chunk's first hits (sorted as the
    integrator sorts them): a render's launches are closest-hit and shadow
    calls over five bounces.  ``cases``: kernel -> (scene, cam, launches per render,
    renders' chunks); ``regs``: kernel -> registers, spills, resident warps.
    Returns the kernels' entries of the ``kernels`` line."""
    entries = []
    for kernel, (scene, cam, launches, chunks) in cases.items():
        kind = MESH_KERNELS[kernel]
        proto = scene.meshes[0]
        o_dev = scene.device
        _, o, d, _, _ = lucy_chunk(scene, cam, o_dev)
        o, d, t_max, reach = sorted_like_the_integrator(proto, o, d)
        shapes = {"camera": (o, d, t_max, False), "camera_any_hit": (o, d, t_max, True)}
        _, _, nxt = first_bounce(scene, cam, o_dev)
        bo, bd, bt, b_reach = sorted_like_the_integrator(
            proto, nxt.o, nxt.d, torch.where(nxt.alive, ck.BIG, -1.0))
        shapes["bounce_1"] = (bo, bd, bt, False)
        if kind == "sweep":
            shapes["bounce_1_any_hit"] = (bo, bd, bt, True)
        del nxt
        timed = {}
        for shape, (o_, d_, t_, any_hit) in shapes.items():
            fields, mm = mesh_timing_case(kind, proto, o_, d_, t_, any_hit)
            timed[shape] = (fields, mm)
            emit("mesh_kernel_timing", kernel=kernel, rays=shape,
                 triangles=proto.n_tris, instances=proto.n_instances,
                 reach_share=b_reach if shape.startswith("bounce_1") else reach,
                 launches_per_render=launches, render_chunks=chunks,
                 counted="(ray, instance) pairs, box and triangle tests of the plain "
                         "version on 16,384 of the rays, scaled to the set: x 42 a "
                         "pair, 25 a box, 55 a Moller-Trumbore test (sweep) or 17 a "
                         "Baldwin-Weber plane test + 24 a triangle whose t passes "
                         "(stream; any hit: up to the first slot with a hit); bytes: "
                         "28 in a live ray, 4 a dead one, 13 out, the tables once",
                 **regs[kernel], **fields)
        cam_fields = timed["camera"][0]
        line = ("312 (_call of intersect_mesh_kernel)" if kind == "sweep"
                else "791 (_call of intersect_mesh_stream)")
        src = "pallas_mesh.py" if kind == "sweep" else "pallas_mesh_stream.py"
        small = checks[kernel]
        extra = {f"{shape}_{key}": f[key] for shape, (f, _) in timed.items()
                 if shape != "camera"
                 for key in ("ms", "bound_ms", "roofline_share", "box_tests_per_ray",
                             "tri_tests_per_ray", "rays_per_launch")}
        entries.append(kernel_entry(
            cam_fields["rays_per_launch"], kernel, "go_raytracing_tpu_torch/csrc/mesh.cu",
            f"go_raytracing_tpu/ops/{src}:{line}", launches, cam_fields["ms"],
            cam_fields["plain_ms"],
            (cam_fields["bound_bytes_ms"], cam_fields["bound_ops_ms"]),
            [mm.get("max_abs_dt", 0.0) for _, mm in timed.values()]
            + [c[1] for c in small]) | {
                "mismatch_share": max([mm["any"] for _, mm in timed.values()]
                                      + [c[0] for c in small]),
                "plain_rays": 16384, "triangles": proto.n_tris,
                "instances": proto.n_instances, "scene": "cornell-lucy",
                "box_tests_per_ray": cam_fields["box_tests_per_ray"],
                "tri_tests_per_ray": cam_fields["tri_tests_per_ray"],
                **regs[kernel], **extra})
        del o, d, t_max, shapes, timed
    return entries


def mesh_phases(dev, regs):
    """Every mesh phase: both kernels against their plain versions, the
    main path (112,128 triangles x 10, mesh_stream), the small path (3,744 x
    10, mesh_sweep), autograd, and the two kernels alone.  Returns their
    entries of the ``kernels`` line."""
    main_scene, main_cam = lucy_scene((256, 220), dev)
    small_scene, small_cam = lucy_scene((48, 40), dev)
    checks = {}
    for kernel, scene, cam in (("mesh_sweep", small_scene, small_cam),
                               ("mesh_stream", main_scene, main_cam)):
        proto = scene.meshes[0]
        checks[kernel] = [
            compare_mesh("lucy_%d" % proto.n_tris, proto, kernel,
                         mesh_mixed_rays(16384, 17, dev), "mixed"),
            compare_mesh("lucy_%d" % proto.n_tris, proto, kernel,
                         mesh_chunk_rays(scene, cam, 16384, 19, dev),
                         "chunk_camera_and_first_bounce")]
    del main_scene, small_scene
    stream_launches, stream_chunks, main_scene, main_cam = mesh_main_path(
        "mesh_main_path", (256, 220), "mesh_stream", dev)
    sweep_launches, sweep_chunks, small_scene, small_cam = mesh_main_path(
        "mesh_small_path", (48, 40), "mesh_sweep", dev)
    mesh_autograd(dev)
    blocks, threads, smem = cm.sweep_occupancy(small_scene.meshes[0])
    regs["mesh_sweep"] = regs["mesh_sweep"] | {
        "resident_warps_per_sm": blocks * threads // 32, "shared_bytes_per_block": smem}
    return mesh_kernel_timing(
        {"mesh_sweep": (small_scene, small_cam, sweep_launches, sweep_chunks),
         "mesh_stream": (main_scene, main_cam, stream_launches, stream_chunks)},
        checks, regs)


# ---- the replay tier: the record kernel (B6), render_grad of scenes outside
# both gradient kernel tiers, and the row sums of take_rows' backward -------

# A decision written by the record kernel: 4 bytes of index, 1 of kind and
# blocked bits.
RECORD_BYTES_PER_DECISION = 5
MIN_RECORD_SHARE = 0.999


def reset_replay_counts():
    cw.LAUNCHES = cw.LAUNCHES_RECORD = 0
    cr.LAUNCHES_ROW_SUMS = 0
    reset_intersect_counts()
    reset_mesh_counts()


def replay_counts():
    return {"wavefront_fwd": cw.LAUNCHES, "wavefront_record": cw.LAUNCHES_RECORD,
            "row_sums": cr.LAUNCHES_ROW_SUMS, **intersect_counts(), **mesh_counts()}


def compare_record(name, scene, cam, o, d, tm, ids, seed):
    """The record kernel on one ray set: its radiance and flags against the
    forward kernel's (same bits), its record against its plain version's
    (every ray-bounce), each field against the standard integrator's record
    (``MIN_RECORD_SHARE``: ties may break otherwise between the sweeps).
    Returns (decision mismatch share, largest radiance difference to the
    plain version)."""
    tb = cw.build_tables(scene)
    sid = cw.stream_to_i32(ids)
    args = (tb, o, d, tm, sid, seed, cam.max_depth)
    k_out, k_flags, code, idx = cw.wavefront_record(*args)
    f_out, f_flags = cw.wavefront_fwd(*args)
    p_out, p_flags, p_code, p_idx = cw._wavefront_record_plain(*args)
    torch.cuda.synchronize()
    bits = bool(torch.equal(k_out, f_out) and torch.equal(k_flags, f_flags))
    dec_mismatch = float(((code != p_code) | (idx != p_idx)).float().mean())
    rad_err = float((k_out - p_out).abs().max())
    flags_equal = bool(torch.equal(k_flags, p_flags))
    which, widx, blk_a, _ = cw.unpack_record(code, idx)
    _, dec = wavefront.trace(scene, cam, o, d, tm, ids, seed, mega_mode="off",
                             record=True)
    shares = {f: float((a == getattr(dec, f)).float().mean())
              for f, a in (("which", which), ("idx", widx), ("blk_a", blk_a))}
    emit("record_kernel_vs_plain", scene=name, rays=int(tm.shape[0]),
         depth=cam.max_depth, radiance_and_flags_bits_equal_forward_kernel=bits,
         decision_mismatch_share_vs_plain=dec_mismatch,
         max_abs_err_radiance_vs_plain=rad_err, flags_equal_plain=flags_equal,
         share_equal_standard_record=shares,
         hit_share=float((which != 0).float().mean()),
         blocked_share=float(blk_a.float().mean()))
    if not bits:
        raise RuntimeError(f"{name}: the record kernel's radiance is not the forward kernel's")
    if dec_mismatch != 0.0 or rad_err >= ATOL or not flags_equal:
        raise RuntimeError(f"{name}: record kernel against its plain version: "
                           f"decisions {dec_mismatch}, radiance {rad_err}")
    if min(shares.values()) < MIN_RECORD_SHARE:
        raise RuntimeError(f"{name}: record kernel against the standard record: {shares}")
    return dec_mismatch, rad_err


def replay_chunk_rays(scene, cam):
    """The first chunk of ``render_grad``'s replay tier for this job: its
    rays, stream ids and size."""
    kchunk, _, _, _ = gradmod._chunking(
        scene, cam, cam.samples_per_pixel, None,
        renderer.pick_chunk_size(scene, differentiable=True))
    cam2, o, d, tm, ids, _, _ = renderer._chunk_rays(
        scene, cam, 0, 0, spp=cam.samples_per_pixel, chunk=kchunk,
        max_depth=cam.max_depth, device=scene.device)
    return (cam2, V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)),
            tm.contiguous(), cw.stream_to_i32(ids))


def table_bytes_of(tb):
    """Bytes of the scalar tables a tracing launch reads, with the culled
    sweep's segment and group tables where the tables have them."""
    tables = [tb.pt, tb.st, tb.vt, tb.lt]
    if tb.n_seg > 0:
        tables += [tb.seg_order, tb.seg_start, tb.seg_box, tb.grp_start, tb.grp_box]
    return sum(t.numel() * t.element_size() for t in tables)


def sweep_flops(tb, ray_bounces, counts, marble_hits=0.0):
    """Counted float operations of ``ray_bounces`` entered ray-bounces with
    the culled sweep's tests ``counts`` (``cw.culled_sweep_counts``; empty:
    the brute sweep), and those of the brute sweep: (culled, brute).  The
    culled sweep's box tests (both levels) x FLOPS_BOX_TEST and sphere tests
    x FLOPS_SPHERE stand in place of every sphere's FLOPS_SPHERE; marble
    hits add FLOPS_MARBLE each."""
    rest = tb.n_planar * FLOPS_PLANAR + tb.n_vol * FLOPS_VOLUME + FLOPS_SHADE
    brute = ray_bounces * (rest + tb.n_sphere * FLOPS_SPHERE) + marble_hits * FLOPS_MARBLE
    if not counts:
        return brute, brute
    culled = (ray_bounces * rest + marble_hits * FLOPS_MARBLE
              + (counts["closest_group_box_tests"] + counts["closest_box_tests"]) * FLOPS_BOX_TEST
              + counts["closest_sphere_tests"] * FLOPS_SPHERE)
    return culled, brute


def record_kernel_timing(cases, launches, checks, regs):
    """The record kernel alone at ``render_grad``'s record chunk of
    ``random`` (600x337, 25 spp, depth 10) and at the Cornell render's chunk,
    beside the forward kernel on the same rays and its bounds; its plain
    version timed on ``random``'s chunk, and its culled sphere sweep's
    mirror run on the whole chunk (``cw.culled_sweep_counts``: the same
    record, and the group box, segment box and sphere tests it needs).  Two
    bounds: the brute sweep's (every sphere a ray-bounce, as before the
    culled sweep), and the culled sweep's (``sweep_flops``).  ``cases``:
    (name, scene, cam, rays).  Returns its entry of the ``kernels`` line
    (``random``'s chunk)."""
    entry = None
    for name, scene, cam, (o, d, tm, sid) in cases:
        tb = cw.build_tables(scene)
        depth = cam.max_depth
        n = tm.shape[0]
        args = (tb, o, d, tm, sid, 0, depth)
        cw.wavefront_record(*args)
        rec_rounds, k = rounds_ms(lambda: cw.wavefront_record(*args), rounds=3, repeats=3)
        fwd_rounds, _ = rounds_ms(lambda: cw.wavefront_fwd(*args), rounds=3, repeats=3)
        ms = median(rec_rounds)
        entering = [n]
        for b in range(1, depth):
            _, f = cw.wavefront_fwd(tb, o, d, tm, sid, 0, b)
            entering.append(int(((f & cw.FLAG_ALIVE) != 0).sum()))
        counts = {}
        if tb.n_seg > 0:
            mirror, counts = cw.culled_sweep_counts(cw._wavefront_record_plain, *args)
            if not all(bool(torch.equal(a, b)) for a, b in zip(mirror, k)):
                raise RuntimeError(f"{name}: the culled sweep's mirror gives another record "
                                   "than the kernel")
            del mirror
        flops, flops_brute = sweep_flops(tb, float(sum(entering)), counts)
        moved = 18 * 4 * n + table_bytes_of(tb) + depth * n * RECORD_BYTES_PER_DECISION
        bound = (moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3)
        bound_brute = max(bound[0], flops_brute / PEAK_FP32_FLOPS * 1e3)
        fields = {}
        if entry is None:
            plain_ms, p = cuda_ms(lambda: cw._wavefront_record_plain(*args))
            mismatch = float(((k[2] != p[2]) | (k[3] != p[3])).float().mean())
            err = float((k[0] - p[0]).abs().max())
            del p
            if mismatch != 0.0 or err != 0.0:
                raise RuntimeError(f"{name}: full chunk: {mismatch:.4%} of decisions "
                                   f"differ from the plain version's, radiance by {err}")
            fields = dict(plain_ms=plain_ms, decision_mismatch_share_full_chunk=mismatch,
                          max_abs_err_full_chunk=err)
            entry = kernel_entry(
                n, "wavefront_record", "go_raytracing_tpu_torch/csrc/wavefront.cu",
                "go_raytracing_tpu/ops/pallas_wavefront.py:1822 (_call(rec_dec=True))",
                launches, ms, plain_ms, bound, [err] + [c[1] for c in checks]) | {
                    "mismatch_share": max([mismatch] + [c[0] for c in checks]),
                    "scene": name, "depth": depth, "registers": regs[0],
                    "spill_bytes": regs[1], "bound_ms_brute_sweep": bound_brute,
                    "forward_ms_same_rays": median(fwd_rounds)}
        ray_bounces = float(sum(entering))
        emit("record_kernel_timing", scene=name, rays_per_launch=n, depth=depth,
             record_ms=ms, record_ms_rounds=rec_rounds, forward_ms=median(fwd_rounds),
             forward_ms_rounds=fwd_rounds, record_over_forward=ms / median(fwd_rounds),
             rays_entering_bounce=entering, spheres=tb.n_sphere, segments=tb.n_seg,
             sweep_counts=counts,
             group_box_tests_per_ray_bounce=(
                 counts.get("closest_group_box_tests", 0) / ray_bounces),
             box_tests_per_ray_bounce=counts.get("closest_box_tests", 0) / ray_bounces,
             sphere_tests_per_ray_bounce=(counts["closest_sphere_tests"] / ray_bounces
                                          if counts else float(tb.n_sphere)),
             warp_sphere_tests_per_ray_bounce=(
                 counts["closest_warp_sphere_tests"] / ray_bounces if counts
                 else float(tb.n_sphere)),
             bytes_counted=moved, decision_bytes=depth * n * RECORD_BYTES_PER_DECISION,
             flops_counted=flops, flops_counted_brute_sweep=flops_brute,
             bound_bytes_ms=bound[0], bound_ops_ms=bound[1],
             bound_ops_ms_brute_sweep=flops_brute / PEAK_FP32_FLOPS * 1e3,
             roofline_share=max(bound) / ms, roofline_share_brute_sweep=bound_brute / ms,
             registers=regs[0], spill_bytes=regs[1], **fields)
        del o, d, tm, sid, k
    return entry


def culled_sweep_sets(dev):
    """The culled sphere sweep of B6, B1 and B11 against their plain versions
    (the brute sweep) on the sets of tests/test_torch_cuda.py
    (``CULL_CASES``): rays aimed at segment and group boxes' corners and
    edges and along the axes, duplicated spheres swept in either order,
    moving spheres, a ground sphere, shadow rays, 63 / 64 / 65 spheres; at
    each set's ray count and at 33 rays (the tests take 1 and 31 too).  B6
    at depth 3: code, index, radiance and flags the same bits, and the
    radiance B1's; B1 at depth 3: rows and flags the same bits; B11: both
    launches of an explicit split at depth 6 (bounces [0, SPLIT_AT), the
    survivors sorted, then the rest), all 19 outputs the same bits."""
    out = {}
    for name in th.CULL_CASES:
        _, tb, o, d, tm, ids = th.cull_case(grt, cw, name, dev)
        sid = cw.stream_to_i32(ids)
        res = {"record": [], "fwd": [], "resume": []}
        for n in (tm.shape[0], 33):
            rays = (V3(*(c[:n].contiguous() for c in o)), V3(*(c[:n].contiguous() for c in d)),
                    tm[:n].contiguous(), sid[:n].contiguous())
            args = (tb, *rays, 5, 3)
            k = cw.wavefront_record(*args)
            p = cw._wavefront_record_plain(*args)
            f = cw.wavefront_fwd(*args)
            pf = cw._wavefront_fwd_plain(*args)
            res["record"].append(all(bool(torch.equal(a, b)) for a, b in zip(k, p))
                                 and bool(torch.equal(k[0], f[0]) and torch.equal(k[1], f[1])))
            res["fwd"].append(all(bool(torch.equal(a, b)) for a, b in zip(f, pf)))
            flat = cw._start_state(*rays)
            k1 = cw.wavefront_resume(tb, flat, 5, 0, cw.SPLIT_AT)
            p1 = cw._wavefront_resume_plain(tb, flat, 5, 0, cw.SPLIT_AT)
            flat2, _ = cw._phase_state_sort(cw._resumed_state(flat, k1),
                                            (k1[9] & cw.FLAG_ALIVE) != 0)
            k2 = cw.wavefront_resume(tb, flat2, 5, cw.SPLIT_AT, 6)
            p2 = cw._wavefront_resume_plain(tb, flat2, 5, cw.SPLIT_AT, 6)
            res["resume"].append(all(bool(torch.equal(a, b))
                                     for a, b in zip(k1 + k2, p1 + p2)))
        out[name] = {"segments": tb.n_seg, "groups": tb.n_grp, "rays": int(tm.shape[0]),
                     "equal": res,
                     "sphere_hit_share": float(((k[2] & cw.DEC_KIND_MASK) == 1).float().mean())}
    emit("culled_sweep_sets", sets=out)
    bad = {k: v for k, v in out.items() if not all(all(r) for r in v["equal"].values())}
    if bad:
        raise RuntimeError(f"B6, B1 or B11 (culled sweep) against its plain version: {bad}")


def forward_random_timing(scene, cam, launches, regs):
    """B1 alone at ``random``'s render chunk (600x337, 25 spp, depth 10:
    4,066,304 rays, the bench's shape): its rows and flags against its plain
    version (the brute sweep) bit for bit, both timed, the culled sweep's
    mirror on the whole chunk (the same bits, and the group box, segment box
    and sphere tests it needs), the culled and the brute sweep's bounds,
    registers, spills and resident warps.  ``launches``: B1's launches in
    the render of that job.  Returns the fields for B1's entry of the
    ``kernels`` line."""
    tb = cw.build_tables(scene)
    rays = render_chunk(scene, cam)
    n, depth = rays[2].shape[0], cam.max_depth
    args = (tb, *rays, 0, depth)
    cw.wavefront_fwd(*args)
    taken, k = rounds_ms(lambda: cw.wavefront_fwd(*args), rounds=3, repeats=3)
    plain_ms, p = cuda_ms(lambda: cw._wavefront_fwd_plain(*args))
    equal = all(bool(torch.equal(a, b)) for a, b in zip(k, p))
    del p
    mirror, counts = cw.culled_sweep_counts(cw._wavefront_fwd_plain, *args)
    mirror_equal = all(bool(torch.equal(a, b)) for a, b in zip(k, mirror))
    del mirror
    entering = [n]
    for b in range(1, depth):
        _, f = cw.wavefront_fwd(tb, *rays, 0, b)
        entering.append(int(((f & cw.FLAG_ALIVE) != 0).sum()))
    ray_bounces = float(sum(entering))
    flops, flops_brute = sweep_flops(tb, ray_bounces, counts)
    moved = 18 * 4 * n + table_bytes_of(tb)
    bound = (moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3)
    bound_brute = max(bound[0], flops_brute / PEAK_FP32_FLOPS * 1e3)
    ms = median(taken)
    warps = resident(cw.tracing_occupancy("fwd", tb.n_seg > 0, smem_of_tables(tb)))
    emit("forward_random_timing", scene="random", rays_per_launch=n, depth=depth,
         launches_render=launches, ms=ms, ms_rounds=taken, plain_ms=plain_ms,
         rows_and_flags_bit_equal_plain=equal, mirror_bit_equal_kernel=mirror_equal,
         rays_entering_bounce=entering, spheres=tb.n_sphere, segments=tb.n_seg,
         groups=tb.n_grp, sweep_counts=counts,
         group_box_tests_per_ray_bounce=counts["closest_group_box_tests"] / ray_bounces,
         box_tests_per_ray_bounce=counts["closest_box_tests"] / ray_bounces,
         sphere_tests_per_ray_bounce=counts["closest_sphere_tests"] / ray_bounces,
         warp_box_tests_per_ray_bounce=counts["closest_warp_box_tests"] / ray_bounces,
         warp_sphere_tests_per_ray_bounce=counts["closest_warp_sphere_tests"] / ray_bounces,
         bytes_counted=moved, flops_counted=flops, flops_counted_brute_sweep=flops_brute,
         bound_bytes_ms=bound[0], bound_ops_ms=bound[1], bound_ms_brute_sweep=bound_brute,
         roofline_share=max(bound) / ms, roofline_share_brute_sweep=bound_brute / ms,
         registers=regs[0], spill_bytes=regs[1], resident_warps_per_sm=warps)
    if not (equal and mirror_equal):
        raise RuntimeError(f"random: B1 on the full chunk against its plain version: "
                           f"equal {equal}, mirror equal {mirror_equal}")
    return {"ms_random": ms, "rays_per_launch_random": n, "launches_random": launches,
            "plain_ms_random": plain_ms, "bound_ms_random": max(bound),
            "bound_by_random": "bytes" if bound[0] >= bound[1] else "operations",
            "bound_ms_random_brute_sweep": bound_brute,
            "mismatch_share_random_full_chunk": 0.0, "max_abs_err_random_full_chunk": 0.0,
            "registers_random": regs[0], "spill_bytes_random": regs[1],
            "resident_warps_per_sm_random": warps}


def render_chunk(scene, cam):
    """The rays of the first chunk of a render of ``cam``'s job, as
    ``render_image`` makes them (the scene's ray layout): (o, d, tm,
    stream)."""
    _, _, n_virt = renderer.ray_layout(cam.image_width, cam.image_height,
                                       renderer.scene_tiled(scene))
    n = min(renderer.pick_chunk_size(scene) // n_virt, cam.samples_per_pixel) * n_virt
    _, o, d, tm, ids, _, _ = renderer._chunk_rays(
        scene, cam, 0, 0, spp=cam.samples_per_pixel, chunk=n, max_depth=cam.max_depth,
        device=scene.device)
    return (V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)),
            tm.contiguous(), cw.stream_to_i32(ids))


def b5b_marble_lanes(dev):
    """B5b with marble against its plain version on stashes whose marble
    rows are set by warp (tests/test_torch_cuda.py): warps of 0, 1 and 32
    marble lanes at depth 1, 5 and 50, marble at each ray's first and last
    bounce at depth 50, on 2 x 2,048 + 37 rays: each key within 1e-4 of its
    largest entry, the same bits on two launches."""
    scene = th.build_noise_glossy(grt, device=dev)
    out = {}
    for depth, pattern in ((1, "warps"), (5, "warps"), (50, "warps"), (50, "ends")):
        cam = dataclasses.replace(Camera(**th.NOISE_GLOSSY_CAM), image_width=64,
                                  max_depth=depth)
        n = 2 * 2048 + 37
        ids = torch.arange(n, dtype=torch.int64, device=dev)
        o, d, tm = generate_rays(cam, ids % 64, (ids // 64) % cam.image_height, ids, 3)
        sid = cw.stream_to_i32(ids)
        tb = cw.build_tables(scene)
        k = cw.wavefront_grad_fwd(tb, o, d, tm, sid, 3, depth, cw.miss_config(cam),
                                  pathwise=True)
        si = th.marble_lane_stash(k[4], pattern, cw.PW_MARBLE)
        lanes = ((si[0, 2] & cw.PW_MARBLE) != 0)[: n // 32 * 32].reshape(-1, 32).sum(dim=1)
        g3 = torch.rand((3, n), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0)) * 1e-3
        rev = (tb, k[3], si, g3, k[2], sid, 3, bool(cam.use_sky_gradient),
               int(scene.textures.color.shape[0]), int(scene.materials.kind.shape[0]))
        gk, gk2 = cw.wavefront_grad_rev_pathwise(*rev), cw.wavefront_grad_rev_pathwise(*rev)
        gp = cw._wavefront_grad_rev_pathwise_plain(*rev)
        _, rel = pathwise_rev_err(gk, gp)
        out[f"{pattern}_depth{depth}"] = {
            "marble_rows": int(((si[:, 2] & cw.PW_MARBLE) != 0).sum()),
            "warps_by_marble_lanes_at_bounce_0": {
                str(v): int((lanes == v).sum()) for v in (0, 1, 32)},
            "err_of_largest": rel,
            "same_bits": all(bool(torch.equal(a, b)) for a, b in zip(gk, gk2))}
    emit("b5b_marble_lanes", rays=n, cases=out)
    if not all(v["err_of_largest"] <= REV_RTOL_OF_LARGEST and v["same_bits"]
               for v in out.values()):
        raise RuntimeError(f"B5b with marble against its plain version: {out}")
    return max(v["err_of_largest"] for v in out.values())


def replay_main_path(phase, name, scene, cam, rounds):
    """``render_grad`` of a scene on the replay tier at full size: one
    warm-up, then ``rounds`` timed calls, the launch counts of the last (set
    to 0 just before it, read just after), the loss against the loss of
    ``render``'s picture, every gradient finite; all calls' gradients must
    have the same bits.  Returns (counts, chunks, bits equal)."""
    spp = cam.samples_per_pixel
    n_rays = cam.image_width * cam.image_height * spp
    if gradmod.grad_tier(scene, cam.max_depth) != "replay":
        raise RuntimeError(f"{phase}: {name} is not on the replay tier")
    target = torch.full((cam.image_height, cam.image_width, 3), 0.25, device=scene.device)
    grt.render_grad(scene, cam, target, seed=0)   # warm-up
    taken, results = [], []
    for _ in range(rounds):
        stats = grt.RenderStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_replay_counts()
        ms, (loss, grads) = cuda_ms(lambda: grt.render_grad(scene, cam, target, seed=0,
                                                            stats=stats))
        counts = replay_counts()
        peak = torch.cuda.max_memory_allocated()
        taken.append(ms)
        results.append((float(loss), grads))
    same_bits = all(r[0] == results[0][0]
                    and all(torch.equal(r[1][k], results[0][1][k]) for k in r[1])
                    for r in results[1:])
    fb = grt.render(scene, cam, seed=0)
    render_loss = float(torch.mean((fb / spp - target) ** 2))
    loss_rel = abs(results[-1][0] - render_loss) / render_loss
    finite = all(bool(torch.isfinite(v).all()) for v in grads.values())
    dec_bytes = n_rays * gradmod.dec_bytes_per_ray(scene, cam.max_depth)
    ms = median(taken)
    emit(phase, scene=name, width=cam.image_width, height=cam.image_height, spp=spp,
         depth=cam.max_depth, camera_rays=n_rays, tier="replay",
         records_kept=dec_bytes <= gradmod.DEC_BUDGET, decision_bytes=dec_bytes,
         chunks=stats.chunks, launches=counts, fwd_bwd_ms_rounds=taken,
         fwd_bwd_ms_median=ms, fwd_bwd_camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
         max_memory_allocated=peak, loss=results[-1][0], render_loss=render_loss,
         loss_rel_diff_to_render=loss_rel, all_gradients_finite=finite,
         gradients_same_bits_every_call=same_bits,
         largest_gradient={k: float(v.abs().max()) for k, v in grads.items()})
    if not finite or loss_rel > 1e-5:
        raise RuntimeError(f"{phase}: loss off the render's by {loss_rel}, finite {finite}")
    if counts["row_sums"] < 1:
        raise RuntimeError(f"{phase}: the replay launched no row-sum kernel")
    return counts, stats.chunks, same_bits


def profile_replay_chunk(scene, cam):
    """The first chunk of ``random``'s replay tier: pass A (the record)
    and pass B (the replay under autograd, forward and backward) timed
    without the profiler, then pass B under ``torch.profiler``: the device's
    busy share and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    kchunk, _, _, n_virt = gradmod._chunking(
        scene, cam, cam.samples_per_pixel, None,
        renderer.pick_chunk_size(scene, differentiable=True))
    g_virt = torch.full((n_virt, 3), 1e-6, device=scene.device)
    args = dict(spp=cam.samples_per_pixel, chunk=kchunk, max_depth=cam.max_depth)
    _, dec = gradmod._record_fwd(scene, cam, 0, 0, keep=True, **args)
    record_ms, (_, dec) = cuda_ms(
        lambda: gradmod._record_fwd(scene, cam, 0, 0, keep=True, **args))
    gradmod._replay_rev(scene, cam, g_virt, 0, 0, dec, **args)
    replay_ms, _ = cuda_ms(lambda: gradmod._replay_rev(scene, cam, g_virt, 0, 0, dec, **args))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gradmod._replay_rev(scene, cam, g_virt, 0, 0, dec, **args)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    row_sums = [r for r in rows if "row_sums_kernel" in r[0]]
    emit("replay_profile", scene="random", rays=kchunk, depth=cam.max_depth,
         record_ms=record_ms, replay_ms_without_profiler=replay_ms,
         replay_device_ms=device_ms, replay_device_busy_share=device_ms / replay_ms,
         replay_device_idle_share=1.0 - device_ms / replay_ms,
         replay_device_kernel_launches=sum(r[2] for r in rows),
         row_sums_ms=sum(r[1] for r in row_sums),
         row_sums_launches=sum(r[2] for r in row_sums),
         top=[dict(name=r[0][:80], ms=r[1], calls=r[2]) for r in rows[:12]])


def replay_check(name, scene, cpu_scene, cam):
    """``render_grad`` at a small size on the card against the same call on
    the CPU through the plain versions (every key within 2e-3 of its largest
    entry), colour gradients against ``torch.autograd`` through
    ``render(differentiable=True)`` (2e-3), and ``dec_budget=0`` (records made
    again in pass B) against records kept (the same bits)."""
    spp = cam.samples_per_pixel
    target = torch.full((cam.image_height, cam.image_width, 3), 0.25)
    reset_replay_counts()
    loss, g = grt.render_grad(scene, cam, target.cuda(), seed=1)
    counts = replay_counts()
    loss0, g0 = grt.render_grad(scene, cam, target.cuda(), seed=1, dec_budget=0)
    ref_loss, ref = grt.render_grad(cpu_scene, cam, target, seed=1, device="cpu")
    cpu_diff = {k: float((g[k].cpu() - ref[k]).abs().max())
                / max(float(ref[k].abs().max()), 1e-12) for k in ref}
    params = {k: v.clone().requires_grad_() for k, v in grt.trainable_params(scene).items()}
    fb = grt.render(grt.apply_params(scene, params), cam, seed=1, differentiable=True)
    torch.mean((fb / spp - target.cuda()) ** 2).backward()
    big = max(float(g["color"].abs().max()), 1e-12)
    autograd_diff = float((params["color"].grad - g["color"]).abs().max()) / big
    over_budget_same = (float(loss0) == float(loss)
                        and all(torch.equal(g0[k], g[k]) for k in g))
    loss_cpu_rel = abs(float(loss) - float(ref_loss)) / float(ref_loss)
    emit("replay_check", scene=name, width=cam.image_width, height=cam.image_height,
         spp=spp, depth=cam.max_depth, loss=float(loss), loss_cpu=float(ref_loss),
         loss_rel_diff_cpu=loss_cpu_rel, grad_diff_of_largest_vs_cpu=cpu_diff,
         color_grad_diff_of_largest_vs_autograd=autograd_diff,
         over_budget_same_bits=over_budget_same, launches=counts)
    recorder = "mesh_sweep" if scene.meshes else "wavefront_record"
    if counts[recorder] < 1:
        raise RuntimeError(f"replay_check {name}: launches {counts}")
    if max(cpu_diff.values()) > AUTOGRAD_RTOL_OF_LARGEST or loss_cpu_rel > 1e-4:
        raise RuntimeError(f"replay_check {name}: card against CPU {cpu_diff}, "
                           f"loss {loss_cpu_rel}")
    if autograd_diff > AUTOGRAD_RTOL_OF_LARGEST or not over_budget_same:
        raise RuntimeError(f"replay_check {name}: autograd {autograd_diff}, "
                           f"over budget same {over_budget_same}")


def row_sums_check():
    """The row-sum kernel (take_rows' backward pass; not a port of a TPU
    kernel) against its plain version at the shapes of the Cornell autograd
    check (1,622,400 rows, 5 textures x 3 channels) and of ``random``'s
    textures (364 x 3), and twice on the same input (the same bits).
    Returns its phase line's fields."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for n_rows, cols in ((5, 3), (364, 3), (364, 1)):
        n = 1622400
        idx = torch.randint(0, n_rows, (n,), device="cuda", generator=gen)
        g = torch.randn((n, cols), device="cuda", generator=gen)
        k1 = cr.row_sums(g, idx, n_rows)
        rounds, k2 = rounds_ms(lambda: cr.row_sums(g, idx, n_rows), rounds=3, repeats=5)
        plain_ms, p = cuda_ms(lambda: cr._row_sums_plain(g, idx, n_rows))
        err = float((k1 - p).abs().max()) / float(p.abs().max())
        same = bool(torch.equal(k1, k2))
        bound_ms = (n * (8 + 4 * cols) + 4 * n_rows * cols) / PEAK_BYTES_PER_S * 1e3
        out[f"{n_rows}x{cols}"] = dict(rows=n, ms=median(rounds), ms_rounds=rounds,
                                       plain_ms=plain_ms, err_of_largest=err,
                                       same_bits=same, bound_ms=bound_ms)
        if err > REV_RTOL_OF_LARGEST or not same:
            raise RuntimeError(f"row_sums {n_rows}x{cols}: off by {err}, same bits {same}")
    return out


# -----------------------------------------------------------------------------
# Environments (ROADMAP A15): hdri-test and hdri-test-nee
# -----------------------------------------------------------------------------

# The sun of the synthetic sky: texels within this many of its centre, at
# about SUN_GAIN times the map's mean radiance.
SUN_RADIUS, SUN_GAIN = 4, 100.0
# A depth past the JAX package's two-phase cap of 16 at which B4 is also held
# to its plain version (the fused tier serves env + light scenes to depth 50).
DEEP_DEPTH = 20
# Fused kernel (B4): float32 operations of the HDRI NEE block in the forward
# (the sample's cosine, pdfs, weight, contribution: about 25) and in the
# reverse (recompute and partials: about 45), per ray-bounce that samples
# the environment.
FLOPS_HDRI_NEE = 25 + 45


def synthetic_sky(seed=7, h=512, w=1024):
    """An [h, w, 3] equirect environment from a fixed numpy seed, at the
    resolution of a "1k" map (the reference's asset is not in the
    repository): a smooth sky gradient over a darker ground, a little
    seeded noise, and a small sun."""
    rng = np.random.default_rng(seed)
    v = (np.arange(h) + 0.5) / h
    elev = (0.5 - v) * np.pi
    up = np.clip(np.sin(elev), 0.0, 1.0)[:, None, None]
    horizon = np.array([1.0, 0.92, 0.82], np.float32)
    zenith = np.array([0.25, 0.45, 1.0], np.float32)
    ground = np.array([0.30, 0.26, 0.22], np.float32)
    sky = horizon * (1.0 - up) + zenith * up
    data = np.where((elev > 0)[:, None, None], sky, ground).astype(np.float32)
    data = np.broadcast_to(data, (h, w, 3)) * rng.uniform(0.95, 1.05, (h, w, 1))
    data = data.astype(np.float32)
    cy, cx = h // 4, (3 * w) // 8
    yy, xx = np.mgrid[0:h, 0:w]
    sun = (yy - cy) ** 2 + (xx - cx) ** 2 <= SUN_RADIUS ** 2
    data[sun] = SUN_GAIN * float(data.mean()) * np.array([1.0, 0.95, 0.85], np.float32)
    return data, int(sun.sum())


def hdri_scene(device, nee, env):
    """``scenes/builders.hdri_test_scene``'s geometry and camera under the
    synthetic sky, at the JAX bench's size (800x450, 25 spp, depth 10);
    ``nee`` adds the quad light of the JAX package's environment + NEE
    gradient test (emission 9), so lambertian hits sample both."""
    b = grt.SceneBuilder()
    cam = builders.hdri_test_objects(b).set_quality(25, 10)
    if nee:
        q = b.quad((-1.5, 6, -1.5), (3, 0, 0), (0, 0, 3), b.diffuse_light((9, 9, 9)))
        b.add_light(q)
    b.set_environment(env, 0.0)
    return b.build(device=device), cam


def env_counts():
    return {"wavefront_fwd": cw.LAUNCHES, "wavefront_record": cw.LAUNCHES_RECORD,
            "wavefront_grad_fwd_pathwise": cw.LAUNCHES_GRAD_FWD_PATHWISE,
            "wavefront_grad_rev_pathwise": cw.LAUNCHES_GRAD_REV_PATHWISE,
            "wavefront_grad_fused": cw.LAUNCHES_GRAD_FUSED,
            "sorted_segment_sums": cr.LAUNCHES_SEGMENT_SUMS,
            **intersect_counts()}


def reset_env_counts():
    cw.LAUNCHES = cw.LAUNCHES_RECORD = 0
    cw.LAUNCHES_GRAD_FWD_PATHWISE = cw.LAUNCHES_GRAD_REV_PATHWISE = 0
    cw.LAUNCHES_GRAD_FUSED = cr.LAUNCHES_SEGMENT_SUMS = 0
    reset_intersect_counts()


def env_main_path(phase, name, scene, cam, out_dir):
    """The forward at full size through ``render_image``: by the megakernel
    (B1; with HDRI NEE rows when the scene has a light) and by the standard
    integrator, pictures held to each other as the Cornell phases hold
    theirs.  Returns the megakernel run's counts."""
    n_rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    grt.render_image(scene, cam, seed=0)   # warm-up
    stats = grt.RenderStats()
    reset_env_counts()
    ms, img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0, stats=stats))
    counts = env_counts()
    std_stats = grt.RenderStats()
    reset_env_counts()
    std_ms, std_img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0, mega_mode="off",
                                                       stats=std_stats))
    std_counts = env_counts()
    share = image_share_outside(std_img, img)
    mean = float(img.mean())
    png = pathlib.Path(out_dir) / f"chip_smoke_{name}.png"
    grt.film.write_png(str(png), grt.film.to_uint8(img))
    emit(phase, scene=name, width=cam.image_width, height=cam.image_height,
         spp=cam.samples_per_pixel, depth=cam.max_depth, camera_rays=n_rays,
         hdri_nee=cw.uses_hdri_nee(scene), chunks=stats.chunks, launches=counts,
         render_ms_cuda_events=ms, camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
         standard_render_ms=std_ms, standard_launches=std_counts,
         standard_camera_mrays_per_s=n_rays / (std_ms * 1e-3) / 1e6,
         pixel_share_outside_tolerance=share, image_mean=mean, png=str(png))
    if not torch.isfinite(img).all() or not 0.02 < mean < 0.98:
        raise RuntimeError(f"{name}: image mean {mean}")
    if counts["wavefront_fwd"] != stats.chunks or std_counts["wavefront_fwd"] != 0 \
            or std_counts["sphere_closest_attrs"] < 1:
        raise RuntimeError(f"{name}: launches {counts}, standard {std_counts}")
    if share >= MAX_PIXEL_SHARE_OUTSIDE:
        raise RuntimeError(f"{name}: {share:.4%} of pixel channels differ between "
                           "the megakernel and the standard integrator")
    return counts


def env_fwd_bwd(phase, name, scene, cam, tier):
    """``render_grad`` at full size on the tier the scene takes (pathwise
    two-phase without a light, the fused kernel with one), twice: the loss
    equals that of ``render``'s picture (rtol 1e-5), every gradient is
    finite, ``env_data`` among them, and the two calls' gradients have the
    same bits.  Returns (the second call's counts, its chunks, its ms)."""
    spp = cam.samples_per_pixel
    n_rays = cam.image_width * cam.image_height * spp
    fb = grt.render(scene, cam, seed=0)
    target = fb / spp * 0.8
    loss_ref = float(torch.mean((fb / spp - target) ** 2))
    del fb
    if gradmod.grad_tier(scene, cam.max_depth) != tier:
        raise RuntimeError(f"{name}: tier {gradmod.grad_tier(scene, cam.max_depth)}")
    first_loss, first = grt.render_grad(scene, cam, target, seed=0)   # also the warm-up
    stats = grt.RenderStats()
    reset_env_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, (loss, grads) = cuda_ms(lambda: grt.render_grad(scene, cam, target, seed=0,
                                                        stats=stats))
    counts = env_counts()
    peak = torch.cuda.max_memory_allocated()
    nch = stats.chunks
    if tier == "pathwise":
        want = {"wavefront_fwd": 0, "wavefront_grad_fwd_pathwise": nch,
                "wavefront_grad_rev_pathwise": nch, "wavefront_grad_fused": 0}
    else:   # pass A renders, pass B takes the miss records, then the fused kernel
        want = {"wavefront_fwd": 2 * nch, "wavefront_grad_fwd_pathwise": 0,
                "wavefront_grad_rev_pathwise": 0, "wavefront_grad_fused": nch}
    if any(counts[k] != v for k, v in want.items()) or counts["sorted_segment_sums"] < 1:
        raise RuntimeError(f"{name}: launches {counts} for {nch} chunks")
    loss_f = float(loss)
    if not loss_f == loss_f or abs(loss_f - loss_ref) > 1e-5 * loss_ref:
        raise RuntimeError(f"{name}: loss {loss_f} against {loss_ref} from render()")
    for key, g in grads.items():
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: gradient {key} is not finite")
    for key in ("color", "fuzz", "ior", "env_data"):
        if float(grads[key].abs().max()) == 0.0:
            raise RuntimeError(f"{name}: gradient {key} is zero")
    same = {k: bool(torch.equal(grads[k], first[k])) for k in grads}
    same["loss"] = float(first_loss) == loss_f
    env = grads["env_data"]
    emit(phase, scene=name, width=cam.image_width, height=cam.image_height, spp=spp,
         depth=cam.max_depth, camera_rays=n_rays, tier=tier, chunks=nch,
         launches=counts, render_grad_ms_cuda_events=ms,
         fwd_bwd_camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6, loss=loss_f,
         loss_from_render=loss_ref, same_bits_two_calls=same,
         fuzz_grad=grads["fuzz"].tolist(), ior_grad=grads["ior"].tolist(),
         env_data_grad_abs_sum=float(env.abs().sum()),
         env_data_texels_nonzero=int((env.abs().amax(dim=2) > 0).sum()),
         stash_bytes_per_ray=(gradmod.stash_bytes_per_ray(cam.max_depth, True, True)
                              if tier == "pathwise" else None),
         max_memory_allocated=peak)
    if not all(same.values()):
        raise RuntimeError(f"{name}: two render_grad calls differ: {same}")
    return counts, nch, ms


def b4_against_plain(nee, cam, tb, rays, seed, depth, g3):
    """B4 (the fused kernel) against its plain version on ``rays`` at
    ``depth``, with the HDRI rows and the miss rows its pass B gives it:
    radiance the forward kernel's bits plus the miss term and the plain
    version's bits, the sums' and the eout rows' error over their largest
    entry, the same bits on two launches, the plain version's time."""
    o, d, tm, sid = rays
    rows = cw.hdri_rows_for(nee, sid, seed, depth)
    k_out, k_flags = cw.wavefront_fwd(tb, o, d, tm, sid, seed, depth, rows)
    mc, lmd, _ = cw._env_miss_terms(nee, cam, cw._env_carry(nee, k_out, k_flags), g3,
                                    want_lmd=True)
    fused = (tb, o, d, tm, sid, seed, depth, g3, (cw.MISS_STREAM, (0.0, 0.0, 0.0)),
             torch.cat([mc, lmd]).contiguous(), rows, int(nee.textures.color.shape[0]),
             int(nee.materials.kind.shape[0]))
    k = cw.wavefront_grad_fused(*fused)
    k2 = cw.wavefront_grad_fused(*fused)
    plain_ms, p = cuda_ms(lambda: cw._wavefront_grad_fused_plain(*fused))
    want_rad = torch.stack([k_out[c] + k_out[6 + c] * mc[c] for c in range(3)])
    eout_largest = float(p[4].abs().max())
    return dict(
        rays=int(tm.shape[0]), depth=depth,
        radiance_is_b1s_plus_miss=bool(torch.equal(k[0], want_rad)),
        radiance_is_plains=bool(torch.equal(k[0], p[0])),
        err_of_largest=max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                           for a, b in zip(k[1:4], p[1:4])),
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(k[1:4], p[1:4])),
        eout_largest=eout_largest,
        eout_err_of_largest=float((k[4] - p[4]).abs().max()) / max(eout_largest, 1e-30),
        same_bits=all(bool(torch.equal(a, b)) for a, b in zip(k, k2)),
        plain_ms=plain_ms)


def env_small_checks(hdri, nee, cam, dev, n=16384, seed=12):
    """The kernels of the environment paths against their plain versions on
    ``n`` camera rays: B1 and B6 with the HDRI rows (equality expected),
    B5b with the environment's miss rows, B4 (sums within 1e-4 of each key's
    largest entry, radiance the forward's bits plus the miss term, the same
    bits on two launches), and B4 against ``torch.autograd`` through the
    standard integrator on a 32x32 crop.  Returns their fields."""
    out = {}
    depth = cam.max_depth
    # camera rays of n pixels drawn across the frame (its first rows are sky)
    w, h = cam.image_width, cam.image_height
    gen = torch.Generator(device=dev).manual_seed(seed)
    pix = torch.randperm(w * h, device=dev, generator=gen)[:n].sort().values
    o, d, tm = generate_rays(cam, pix % w, pix // w, pix, seed)
    o, d = V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d))
    tm, sid = tm.contiguous(), cw.stream_to_i32(pix)
    tb = cw.build_tables(nee)
    rows = cw.hdri_rows_for(nee, sid, seed, depth)
    args = (tb, o, d, tm, sid, seed, depth)
    k_out, k_flags = cw.wavefront_fwd(*args, rows)
    p_out, p_flags = cw._wavefront_fwd_plain(*args, rows)
    good = (k_out == p_out).all(dim=0) & (k_flags == p_flags)
    out["b1_hdri_mismatch_share"] = 1.0 - float(good.float().mean())
    out["b1_hdri_max_abs_err"] = float((k_out - p_out).abs().max())
    r_out, r_flags, code, idx = cw.wavefront_record(*args, rows)
    _, _, p_code, p_idx = cw._wavefront_record_plain(*args, rows)
    out["b6_hdri_radiance_is_b1s"] = bool(torch.equal(r_out, k_out))
    out["b6_hdri_record_mismatch_share"] = 1.0 - float(
        ((code == p_code) & (idx == p_idx)).float().mean())
    out["b6_hdri_blocked_share"] = float(((code & cw.DEC_BLK_H) != 0).float().mean())
    if out["b1_hdri_mismatch_share"] != 0.0 or not out["b6_hdri_radiance_is_b1s"] \
            or out["b6_hdri_record_mismatch_share"] > 0.0:
        raise RuntimeError(f"B1 / B6 with HDRI rows against their plain versions: {out}")

    g3 = torch.rand((3, n), device=dev, generator=gen) * 1e-3
    n_tex = int(nee.textures.color.shape[0])
    n_mat = int(nee.materials.kind.shape[0])
    # B5b, the environment's miss rows (hdri-test: no light)
    _, carry = cw.grad_fwd_stash(hdri, cam, o, d, tm, sid, seed, pathwise=True)
    mc, lmd, _ = cw._env_miss_terms(hdri, cam, carry[3], g3, want_lmd=True)
    rev = (cw.build_tables(hdri), carry[1], carry[2], g3, mc, sid, seed, cw.MISS_STREAM,
           int(hdri.textures.color.shape[0]), int(hdri.materials.kind.shape[0]), lmd)
    gk = cw.wavefront_grad_rev_pathwise(*rev)
    gk2 = cw.wavefront_grad_rev_pathwise(*rev)
    gp = cw._wavefront_grad_rev_pathwise_plain(*rev)
    out["b5b_stream_err_of_largest"] = pathwise_rev_err(gk, gp)[1]
    out["b5b_stream_max_abs_err"] = pathwise_rev_err(gk, gp)[0]
    out["b5b_stream_same_bits"] = all(bool(torch.equal(a, b)) for a, b in zip(gk, gk2))
    if not out["b5b_stream_err_of_largest"] <= REV_RTOL_OF_LARGEST \
            or not out["b5b_stream_same_bits"]:
        raise RuntimeError(f"B5b with the environment's miss rows: {out}")
    del carry

    # B4 (hdri-test-nee) at the main path's depth, and on a quarter of the
    # rays at DEEP_DEPTH (its stash array holds FUSED_MAX_DEPTH bounces)
    b4 = b4_against_plain(nee, cam, tb, (o, d, tm, sid), seed, depth, g3)
    out.update({f"b4_{k}": v for k, v in b4.items()})
    q = n // 4
    deep = b4_against_plain(nee, cam, tb, (V3(*(c[:q] for c in o)), V3(*(c[:q] for c in d)),
                                           tm[:q], sid[:q]),
                            seed, DEEP_DEPTH, g3[:, :q].contiguous())
    out.update({f"b4_depth{DEEP_DEPTH}_{k}": v for k, v in deep.items()})
    for f in (b4, deep):
        if not (f["radiance_is_b1s_plus_miss"] and f["radiance_is_plains"]
                and f["err_of_largest"] <= REV_RTOL_OF_LARGEST and f["eout_largest"] > 0.0
                and f["eout_err_of_largest"] <= REV_RTOL_OF_LARGEST and f["same_bits"]):
            raise RuntimeError(f"B4 against its plain version: {out}")

    # B4 against torch.autograd through the standard integrator, 32x32 crop
    size, x0, y0 = 32, 400, 260
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + size, device=dev),
                            torch.arange(x0, x0 + size, device=dev), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    ids = py * cam.image_width + px
    co, cd, ctm = generate_rays(cam, px, py, ids, seed)
    co, cd = V3(*(c.contiguous() for c in co)), V3(*(c.contiguous() for c in cd))
    g3c = torch.rand((3, size * size), device=dev, generator=gen) * 1e-3
    _, gf = cw.grad_megakernel(nee, cam, co, cd, ctm.contiguous(), ids, seed, g3c)
    params = {kk: v.detach().clone().requires_grad_()
              for kk, v in grt.trainable_params(nee).items()}
    keys = ("color", "even_color", "odd_color", "env_data")
    with torch.enable_grad():
        rad = wavefront.trace(grt.apply_params(nee, params), cam, co, cd, ctm, ids, seed,
                              differentiable=True)
        inner = sum((rad[c] * g3c[c]).sum() for c in range(3))
        ga = torch.autograd.grad(inner, [params[kk] for kk in keys])
    out["b4_vs_autograd_err_of_largest"] = {
        kk: float((gf[kk] - a).abs().max()) / max(float(a.abs().max()), 1e-30)
        for kk, a in zip(keys, ga)}
    if max(out["b4_vs_autograd_err_of_largest"].values()) > AUTOGRAD_RTOL_OF_LARGEST:
        raise RuntimeError(f"B4 against autograd on a 32x32 crop: {out}")
    return out


def env_kernel_timing(hdri, nee, cam, chunks, launches, small):
    """B4, B1 with and without the HDRI rows and B5b with the miss rows,
    each alone at its main path's chunk (one launch after a warm-up each
    round), beside its bound.  Returns B4's entry of the ``kernels`` line
    and the fields of the others."""
    dev = nee.device
    depth = cam.max_depth
    n_all = cam.image_width * cam.image_height * cam.samples_per_pixel
    n = n_all // chunks["env_nee"]
    _, o, d, tm, ids, _, _ = renderer._chunk_rays(nee, cam, 0, 0, spp=cam.samples_per_pixel,
                                                  chunk=n, max_depth=depth, device=dev)
    o, d, tm = V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)), tm.contiguous()
    sid = cw.stream_to_i32(ids)
    tb = cw.build_tables(nee)
    # the parts of the fused tier's pass B (grad_megakernel), one at a time
    rows_ms, (rows, texels) = cuda_ms(lambda: cw.hdri_rows_for(nee, sid, 0, depth,
                                                               texel_ids=True))
    args = (tb, o, d, tm, sid, 0, depth)
    cw.wavefront_fwd(*args, rows)
    b1h_rounds, (f_out, f_flags) = rounds_ms(lambda: cw.wavefront_fwd(*args, rows),
                                             rounds=3, repeats=2)
    b1_rounds, _ = rounds_ms(lambda: cw.wavefront_fwd(*args), rounds=3, repeats=2)
    entering = [n]
    for k in range(1, depth):
        _, f = cw.wavefront_fwd(*args[:-1], k)
        entering.append(int(((f & cw.FLAG_ALIVE) != 0).sum()))
    # B1 and B4 read a bounce's HDRI rows only where a lambertian hit sampled
    # the lights (PW_USE_MIS); the pathwise stash forward marks those
    # ray-bounces (the HDRI sample alters no path, so its stash needs no rows)
    _, _, _, _, s_i = cw.wavefront_grad_fwd(*args, (cw.MISS_STREAM, (0.0, 0.0, 0.0)),
                                           pathwise=True)
    mis_bounces = int(((s_i[:, 2] & cw.PW_USE_MIS) != 0).sum())
    del s_i
    gen = torch.Generator(device=dev).manual_seed(0)
    g3 = torch.rand((3, n), device=dev, generator=gen) * 1e-6
    terms_ms, (mc, lmd, _) = cuda_ms(lambda: cw._env_miss_terms(
        nee, cam, cw._env_carry(nee, f_out, f_flags), g3, want_lmd=True))
    del f_out, f_flags
    n_tex = int(nee.textures.color.shape[0])
    n_mat = int(nee.materials.kind.shape[0])
    fused = (tb, o, d, tm, sid, 0, depth, g3, (cw.MISS_STREAM, (0.0, 0.0, 0.0)),
             torch.cat([mc, lmd]).contiguous(), rows, n_tex, n_mat)
    cw.wavefront_grad_fused(*fused)
    b4_rounds, k = rounds_ms(lambda: cw.wavefront_grad_fused(*fused), rounds=3, repeats=2)
    b4_ms = median(b4_rounds)
    h, w = nee.env.data.shape[:2]
    texel_sum_ms, _ = cuda_ms(lambda: segsum.cols_segment_sum(
        texels.reshape(-1), [k[4][:, c].reshape(-1) for c in range(3)], h * w))
    del fused, mc, lmd, rows, texels, k

    table_bytes = 4 * sum(t.numel() for t in (tb.pt, tb.st, tb.vt, tb.lt))
    per_bounce = (tb.n_planar * FLOPS_PLANAR + tb.n_sphere * FLOPS_SPHERE
                  + tb.n_vol * FLOPS_VOLUME + FLOPS_SHADE)
    entered = float(sum(entering))
    hdri_bytes = cw.HDRI_ROWS * 4 * mis_bounces
    b1h_bytes = 18 * 4 * n + hdri_bytes + table_bytes
    b1h_bound = (b1h_bytes / PEAK_BYTES_PER_S * 1e3,
                 (entered * per_bounce + mis_bounces * FLOPS_HDRI_NEE)
                 / PEAK_FP32_FLOPS * 1e3)
    block_rays = _build.load("wavefront_grad_fused").lib.wavefront_grad_fused_block_rays()
    n_acc = 9 * n_tex + 2 * n_mat
    # in: rays (8), cotangent (3), environment rows (6), HDRI rows (7 a
    # sampling bounce); out: radiance (3), eout (3 a bounce, all written),
    # one partial row a block
    b4_bytes = ((8 + 3 + 6 + 3 + 3 * depth) * 4 * n + hdri_bytes
                + 4 * n_acc * -(-n // block_rays) + table_bytes)
    b4_bound = (b4_bytes / PEAK_BYTES_PER_S * 1e3,
                (entered * ((per_bounce + FLOPS_REVERSE_PATHWISE) / PEAK_FP32_FLOPS
                            + INT_OPS_REVERSE_PATHWISE / PEAK_INT32_OPS)
                 + mis_bounces * FLOPS_HDRI_NEE / PEAK_FP32_FLOPS) * 1e3)

    # B5b with the environment's miss rows, at hdri-test's chunk
    n_h = n_all // chunks["hdri"]
    _, o, d, tm, ids, _, _ = renderer._chunk_rays(hdri, cam, 0, 0, spp=cam.samples_per_pixel,
                                                  chunk=n_h, max_depth=depth, device=dev)
    o, d, tm = V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)), tm.contiguous()
    sid = cw.stream_to_i32(ids)
    _, carry = cw.grad_fwd_stash(hdri, cam, o, d, tm, sid, 0, pathwise=True)
    g3 = torch.rand((3, n_h), device=dev, generator=gen) * 1e-6
    mc, lmd, _ = cw._env_miss_terms(hdri, cam, carry[3], g3, want_lmd=True)
    rev = (cw.build_tables(hdri), carry[1], carry[2], g3, mc, sid, 0, cw.MISS_STREAM,
           int(hdri.textures.color.shape[0]), int(hdri.materials.kind.shape[0]), lmd)
    first = cw.wavefront_grad_rev_pathwise(*rev)
    b5b_rounds, gk = rounds_ms(lambda: cw.wavefront_grad_rev_pathwise(*rev), rounds=3,
                               repeats=2)
    b5b_same_bits = all(bool(torch.equal(x, y)) for x, y in zip(first, gk))
    b5b_err, b5b_rel = pathwise_rev_err(gk, cw._wavefront_grad_rev_pathwise_plain(*rev))
    del rev, carry, mc, lmd, g3, first, gk
    if not (b5b_rel <= REV_RTOL_OF_LARGEST and b5b_same_bits):
        raise RuntimeError(f"hdri-test chunk: B5b with the environment's rows off by "
                           f"{b5b_rel:.2e} of the plain version, same bits {b5b_same_bits}")

    emit("env_kernel_timing", rays_per_launch=n, depth=depth,
         rays_entering_bounce=entering, hdri_sampling_ray_bounces=mis_bounces,
         entered_share=entered / (n * depth),
         fused_pass_b_parts_ms=dict(hdri_rows_and_texel_ids=rows_ms,
                                    miss_terms=terms_ms, b4=b4_ms,
                                    texel_sums=texel_sum_ms),
         b4_ms=b4_ms, b4_ms_rounds=b4_rounds, b4_plain_ms_16384_rays=small["b4_plain_ms"],
         b4_bytes_counted=b4_bytes, b4_bound_bytes_ms=b4_bound[0],
         b4_bound_ops_ms=b4_bound[1], b4_roofline_share=max(b4_bound) / b4_ms,
         b1_hdri_ms=median(b1h_rounds), b1_hdri_ms_rounds=b1h_rounds,
         b1_no_hdri_ms=median(b1_rounds), b1_no_hdri_ms_rounds=b1_rounds,
         b1_hdri_bound_bytes_ms=b1h_bound[0], b1_hdri_bound_ops_ms=b1h_bound[1],
         b5b_stream_rays_per_launch=n_h, b5b_stream_ms=median(b5b_rounds),
         b5b_stream_ms_rounds=b5b_rounds, b5b_stream_max_abs_err=b5b_err,
         b5b_stream_err_of_largest=b5b_rel, b5b_stream_two_launches_same_bits=b5b_same_bits,
         small_checks=small)
    entry = kernel_entry(n, "wavefront_grad_fused",
                         "go_raytracing_tpu_torch/csrc/wavefront_grad_fused.cu",
                         "go_raytracing_tpu/ops/pallas_wavefront.py:2005 (_call_grad, "
                         "pathwise=True, use_hdri=True, miss_cfg=('stream',))",
                         launches, b4_ms, small["b4_plain_ms"], b4_bound,
                         [small["b4_max_abs_err"]])
    entry["plain_rays"] = 16384
    return entry, dict(hdri_rays_per_launch=n, hdri_ms=median(b1h_rounds),
                       no_hdri_ms_same_rays=median(b1_rounds),
                       hdri_bound_ms=max(b1h_bound)), dict(
        stream_rays_per_launch=n_h, stream_ms=median(b5b_rounds), stream_max_abs_err=b5b_err)


def env_phases(dev, out_dir):
    """hdri-test and hdri-test-nee, forward and fwd+bwd at the JAX bench's
    size, and the environment kernels alone.  Returns (B4's ``kernels``
    entry, fields for B1's entry, fields for B5b's entry, launches)."""
    env, sun_texels = synthetic_sky()
    emit("env_map", height=env.shape[0], width=env.shape[1], seed=7,
         sun_texels=sun_texels, mean=float(env.mean()), max=float(env.max()))
    hdri, cam = hdri_scene(dev, False, env)
    nee, _ = hdri_scene(dev, True, env)
    small = env_small_checks(hdri, nee, cam, dev)
    main_h = env_main_path("hdri_main_path", "hdri-test", hdri, cam, out_dir)
    fb_h, ch_h, _ = env_fwd_bwd("hdri_fwd_bwd", "hdri-test", hdri, cam, "pathwise")
    main_n = env_main_path("env_nee_main_path", "hdri-test-nee", nee, cam, out_dir)
    fb_n, ch_n, _ = env_fwd_bwd("env_nee_fwd_bwd", "hdri-test-nee", nee, cam, "fused")
    b4_entry, b1_fields, b5b_fields = env_kernel_timing(
        hdri, nee, cam, {"hdri": ch_h, "env_nee": ch_n}, fb_n["wavefront_grad_fused"], small)
    b1_fields["launches_env_paths"] = {
        "hdri_main_path": main_h["wavefront_fwd"], "env_nee_main_path": main_n["wavefront_fwd"],
        "env_nee_fwd_bwd": fb_n["wavefront_fwd"]}
    b1_fields["max_abs_err_hdri"] = small["b1_hdri_max_abs_err"]
    b5b_fields["launches_hdri_fwd_bwd"] = fb_h["wavefront_grad_rev_pathwise"]
    b5b_fields["stream_err_of_largest"] = small["b5b_stream_err_of_largest"]
    return b4_entry, b1_fields, b5b_fields, fb_h


# ---- marble textures and the resumable kernel (B11) --------------------------

# Operations of one marble evaluation (csrc/wavefront_common.cuh: marble),
# counted from the code.  A lattice corner: the PCG3D hash (3 multiply-adds,
# 3 products added, 3 xor-shifts, 3 products added: 24 integer operations),
# its cube sample (3 x shift, convert, 2 multiplies, subtract: 15), the
# normalization (3 squares, 2 adds, max, sqrt, divide, 3 multiplies: 11),
# the offset dot product (3 subtracts, 3 multiplies, 2 adds: 8) and its
# weight and sum (3 subtracts, 3 multiplies, add: 7).  An octave: 8 corners,
# the floors, fractions and conversions (9) and the octave's scaling (5).
# The marble: 7 octaves, the scale and the sine (about 30).
INT_OPS_MARBLE = 7 * 8 * 24
FLOPS_MARBLE = 7 * (8 * (15 + 11 + 8 + 7) + 14) + 30
# The resumable kernel moves 21 rows of 4 bytes in and 19 out a ray.
RESUME_BYTES_PER_RAY = (21 + 19) * 4
PERLIN_BENCH = dict(width=400, spp=25, depth=10)        # bench.py:58
RANDOM_CUT_SPP = 25                                      # random's own: 500


def marble_scene(device):
    """A marble floor and sphere beside a solid sphere under a quad light
    and the sky gradient: the noise + solid scene whose colour and emission
    gradients the product tier takes (perlin's own are zero by structure)."""
    b = grt.SceneBuilder()
    perl = b.lambertian(b.noise(4.0))
    b.plane((0, 0, 0), (0, 1, 0), perl)
    b.sphere((0, 1, 0), 1.0, perl)
    b.sphere((2.1, 0.8, 0.4), 0.8, b.lambertian((0.7, 0.3, 0.2)))
    q = b.quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3), b.diffuse_light((6, 6, 6)))
    b.add_light(q)
    cam = Camera(image_width=64, aspect_ratio=1.0, samples_per_pixel=4, max_depth=5,
                 look_from=(0, 2.5, 7), look_at=(0, 0.8, 0), vfov=45.0,
                 use_sky_gradient=True)
    return b.build(device=device), cam


def resume_counts():
    return {"wavefront_fwd": cw.LAUNCHES, "wavefront_resume": cw.LAUNCHES_RESUME,
            "wavefront_record": cw.LAUNCHES_RECORD,
            "wavefront_grad_fwd": cw.LAUNCHES_GRAD_FWD,
            "wavefront_grad_rev": cw.LAUNCHES_GRAD_REV, **intersect_counts()}


def reset_resume_counts():
    cw.LAUNCHES = cw.LAUNCHES_RESUME = cw.LAUNCHES_RECORD = 0
    cw.LAUNCHES_GRAD_FWD = cw.LAUNCHES_GRAD_REV = 0
    reset_intersect_counts()


def rows_of(res):
    """A tuple of [R] tensors (float32, or int32 by their bits) -> one
    [len, R] float32 tensor."""
    return torch.stack([a if a.dtype == torch.float32 else a.view(torch.float32)
                        for a in res])


def per_ray(k, p):
    """(share of rays outside rtol / atol 1e-3 on any row, share of rays not
    bit for bit equal, largest absolute difference) of two [rows, R]
    tensors whose flag rows compare by their bits."""
    differ = (k.view(torch.int32) != p.view(torch.int32)).any(dim=0)
    outside = ~torch.isclose(k, p, rtol=RTOL, atol=ATOL).all(dim=0)
    return (float(outside.float().mean()), float(differ.float().mean()),
            float((k - p).abs().max()))


def noise_small_checks(dev):
    """B1, B6 and B2 with marble against their plain versions and B1 on
    16,384 perlin camera rays at depth 10.  Returns (mismatch share, max
    abs err) of B1."""
    scene, cam0 = grt.load_scene("perlin", device=dev)
    cam = dataclasses.replace(cam0, image_width=128, samples_per_pixel=2, max_depth=10)
    o, d, tm, sid = chunk_rays(cam, 16384, 14, dev)
    args = (cw.build_tables(scene), o, d, tm, sid, 14, cam.max_depth)
    k_rows, k_flags = cw.wavefront_fwd(*args)
    p_rows, p_flags = cw._wavefront_fwd_plain(*args)
    k, p = torch.cat([k_rows, k_flags.view(torch.float32)[None]]), \
        torch.cat([p_rows, p_flags.view(torch.float32)[None]])
    outside, differ, err = per_ray(k, p)
    r_rows, r_flags, code, idx = cw.wavefront_record(*args)
    _, _, p_code, p_idx = cw._wavefront_record_plain(*args)
    record_same = torch.equal(r_rows, k_rows) and torch.equal(r_flags, k_flags)
    record_plain = torch.equal(code, p_code) and torch.equal(idx, p_idx)
    g = cw.wavefront_grad_fwd(*args, cw.miss_config(cam))
    grad_same = torch.equal(g[0], k_rows) and torch.equal(g[1], k_flags)
    grad_plain = all(torch.equal(a, b) for a, b in zip(
        g, cw._wavefront_grad_fwd_plain(*args, cw.miss_config(cam))))
    hits = int(((code & cw.DEC_KIND_MASK) != 0).sum())
    emit("noise_kernels_vs_plain", scene="perlin", rays=16384, depth=cam.max_depth,
         b1_mismatch_share=outside, b1_share_not_bit_equal=differ, b1_max_abs_err=err,
         marble_hits=hits, b6_radiance_equals_b1=record_same,
         b6_record_equals_plain=record_plain, b2_radiance_equals_b1=grad_same,
         b2_bit_equal_plain=grad_plain,
         rtol=RTOL, atol=ATOL)
    if differ != 0.0 or not torch.isfinite(k_rows).all() or hits * 10 < tm.shape[0]:
        raise RuntimeError(f"perlin: B1 ({cw.brute_route(args[0])}) {differ:.4%} of rays not "
                           f"its plain version's bits, {hits} hits")
    if not (record_same and record_plain and grad_same and grad_plain):
        raise RuntimeError("perlin: B6 or B2 differs from B1 or from its plain version")
    return outside, err


def resume_small_checks(cases):
    """B11 against its plain version on 16,384 rays: both launches of an
    explicit split (bounces [0, SPLIT_AT), the survivors sorted, then the
    rest), all 19 outputs (bit for bit where the sweep is culled:
    ``random``); and the split's outputs against one B1 launch, bit for
    bit.  ``cases``: (name, scene, cam).  Returns (worst mismatch
    share, largest abs err)."""
    worst = (0.0, 0.0)
    for name, scene, cam in cases:
        o, d, tm, sid = chunk_rays(cam, 16384, 15, scene.device)
        tb = cw.build_tables(scene)
        depth, k_at = cam.max_depth, cw.SPLIT_AT

        def rows(st, b0, b1):
            return (cw.hdri_rows_for(scene, st, 15, b1, b_start=b0)
                    if cw.uses_hdri_nee(scene) else None)

        flat = cw._start_state(o, d, tm, sid)
        h1 = rows(flat[7], 0, k_at)
        k1 = cw.wavefront_resume(tb, flat, 15, 0, k_at, h1)
        p1 = cw._wavefront_resume_plain(tb, flat, 15, 0, k_at, h1)
        flat2, _ = cw._phase_state_sort(cw._resumed_state(flat, k1),
                                        (k1[9] & cw.FLAG_ALIVE) != 0)
        h2 = rows(flat2[7], k_at, depth)
        k2 = cw.wavefront_resume(tb, flat2, 15, k_at, depth, h2)
        p2 = cw._wavefront_resume_plain(tb, flat2, 15, k_at, depth, h2)
        c1, c2 = per_ray(rows_of(k1), rows_of(p1)), per_ray(rows_of(k2), rows_of(p2))
        single = cw.trace_megakernel(scene, cam, o, d, tm, sid, 15)
        split = cw.trace_megakernel(scene, cam, o, d, tm, sid, 15, split=True)
        same = all(torch.equal(torch.stack(list(a)) if isinstance(a, tuple) else a,
                               torch.stack(list(b)) if isinstance(b, tuple) else b)
                   for a, b in zip(single, split))
        alive = int(((k1[9] & cw.FLAG_ALIVE) != 0).sum())
        emit("resume_kernel_vs_plain", scene=name, rays=16384, depth=depth,
             split_at=k_at, hdri_nee=cw.uses_hdri_nee(scene), route=cw.brute_route(tb),
         alive_after_phase_1=alive,
             phase_1_mismatch_share=c1[0], phase_1_share_not_bit_equal=c1[1],
             phase_1_max_abs_err=c1[2], phase_2_mismatch_share=c2[0],
             phase_2_share_not_bit_equal=c2[1], phase_2_max_abs_err=c2[2],
             split_equals_single_launch=same)
        if max(c1[0], c2[0]) >= MAX_MISMATCH_SHARE or not same or alive < 1:
            raise RuntimeError(f"{name}: B11 against its plain version {c1}, {c2}, "
                               f"split equals one launch: {same}, alive {alive}")
        if c1[1] or c2[1]:   # every route of B11 gives its plain version's bits
            raise RuntimeError(f"{name}: B11 ({cw.brute_route(tb)}) differs from its plain "
                               f"version's bits: {c1}, {c2}")
        worst = (max(worst[0], c1[0], c2[0]), max(worst[1], c1[2], c2[2]))
    return worst


def noise_main_path(dev, out_dir):
    """perlin at the JAX bench's size (bench.py:58: 400x225, 25 spp, depth
    10; one phase at this depth) by the megakernel and by the standard
    integrator, pictures held to each other.  Returns B1's launches."""
    scene, cam0 = grt.load_scene("perlin", device=dev)
    cam = dataclasses.replace(cam0, image_width=PERLIN_BENCH["width"],
                              samples_per_pixel=PERLIN_BENCH["spp"],
                              max_depth=PERLIN_BENCH["depth"])
    n_rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    grt.render_image(scene, cam, seed=0)   # warm-up
    stats = grt.RenderStats()
    reset_resume_counts()
    ms, img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0, stats=stats))
    counts = resume_counts()
    std_stats = grt.RenderStats()
    reset_resume_counts()
    std_ms, std_img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0,
                                                       mega_mode="off", stats=std_stats))
    std_counts = resume_counts()
    share = image_share_outside(std_img, img)
    mean = float(img.mean())
    png = pathlib.Path(out_dir) / "chip_smoke_perlin.png"
    grt.film.write_png(str(png), grt.film.to_uint8(img))
    emit("noise_main_path", scene="perlin", width=cam.image_width,
         height=cam.image_height, spp=cam.samples_per_pixel, depth=cam.max_depth,
         camera_rays=n_rays, chunks=stats.chunks, launches=counts,
         render_ms_cuda_events=ms, camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
         standard_render_ms=std_ms, standard_launches=std_counts,
         standard_camera_mrays_per_s=n_rays / (std_ms * 1e-3) / 1e6,
         pixel_share_outside_tolerance=share,
         max_abs_diff=float((img - std_img).abs().max()), image_mean=mean, png=str(png))
    if not torch.isfinite(img).all() or not 0.05 < mean < 0.98:
        raise RuntimeError(f"perlin: image mean {mean}")
    if counts["wavefront_fwd"] != stats.chunks or counts["wavefront_resume"] != 0 \
            or std_counts["wavefront_fwd"] != 0 or std_counts["planar_closest"] < 1:
        raise RuntimeError(f"perlin: launches {counts}, standard {std_counts}")
    if share >= MAX_PIXEL_SHARE_OUTSIDE:
        raise RuntimeError(f"perlin: {share:.4%} of pixel channels differ between "
                           "the megakernel and the standard integrator")
    return counts["wavefront_fwd"]


def noise_fwd_bwd(dev):
    """``perlin-fwd-bwd`` (bench.py:225-227: 400x225, 25 spp, depth 10) on
    the product tier, twice: the loss is that of ``render``'s picture, the
    gradients are zero by structure (one marble texture, no light) and have
    the same bits twice.  Returns (B2 launches, B3 launches)."""
    scene, cam0 = grt.load_scene("perlin", device=dev)
    cam = dataclasses.replace(cam0, image_width=PERLIN_BENCH["width"],
                              samples_per_pixel=PERLIN_BENCH["spp"],
                              max_depth=PERLIN_BENCH["depth"])
    spp = cam.samples_per_pixel
    n_rays = cam.image_width * cam.image_height * spp
    if gradmod.grad_tier(scene, cam.max_depth) != "product":
        raise RuntimeError(f"perlin: tier {gradmod.grad_tier(scene, cam.max_depth)}")
    fb = grt.render(scene, cam, seed=0)
    target = fb / spp * 0.8
    loss_ref = float(torch.mean((fb / spp - target) ** 2))
    del fb
    first_loss, first = grt.render_grad(scene, cam, target, seed=0)   # also the warm-up
    stats = grt.RenderStats()
    reset_resume_counts()
    ms, (loss, grads) = cuda_ms(lambda: grt.render_grad(scene, cam, target, seed=0,
                                                        stats=stats))
    counts = resume_counts()
    loss_f = float(loss)
    same = all(torch.equal(grads[k], first[k]) for k in grads) and \
        float(first_loss) == loss_f
    zero = all(float(g.abs().max()) == 0.0 for g in grads.values())
    emit("noise_fwd_bwd", scene="perlin", width=cam.image_width,
         height=cam.image_height, spp=spp, depth=cam.max_depth, camera_rays=n_rays,
         tier="product", chunks=stats.chunks, launches=counts,
         render_grad_ms_cuda_events=ms,
         fwd_bwd_camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6, loss=loss_f,
         loss_from_render=loss_ref, gradients_zero_by_structure=zero,
         same_bits_two_calls=same)
    if counts["wavefront_grad_fwd"] != stats.chunks \
            or counts["wavefront_grad_rev"] != stats.chunks or stats.chunks < 1:
        raise RuntimeError(f"perlin fwd+bwd: launches {counts} for {stats.chunks} chunks")
    if not loss_f == loss_f or abs(loss_f - loss_ref) > 1e-5 * loss_ref:
        raise RuntimeError(f"perlin fwd+bwd: loss {loss_f} against {loss_ref}")
    if not (zero and same):
        raise RuntimeError(f"perlin fwd+bwd: zero {zero}, same bits {same}")
    return counts["wavefront_grad_fwd"], counts["wavefront_grad_rev"]


def two_phase_path(phase, name, scene, cam, mode, out_dir, rounds=2):
    """A render at full size by ``mode`` ('split', which ``choose_mega_mode``
    must pick by itself, or 'compact') against ``mega_mode="single"`` on the
    same seed, timed in turns (single, two-phase, two-phase, single, ...)
    after one warm-up of each: the pictures must be the same bits.  The
    launch counts are those of the last two-phase render (set to 0 just
    before it, read just after).  Returns (those counts, chunks)."""
    n_rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    chunk = renderer.pick_chunk_size(scene)
    n_virt = renderer.ray_layout(cam.image_width, cam.image_height,
                                 renderer.scene_tiled(scene))[2]
    chunk = min(chunk // n_virt, cam.samples_per_pixel) * n_virt
    picked = wavefront.choose_mega_mode(scene, cam, chunk, False)
    if mode == "split" and picked != "split":
        raise RuntimeError(f"{name}: choose_mega_mode picked {picked!r} at {chunk} rays")
    two_kw = {} if mode == "split" else {"mega_mode": mode}
    single_img = grt.render_image(scene, cam, seed=0, mega_mode="single")
    grt.render_image(scene, cam, seed=0, **two_kw)
    taken = {"single": [], mode: []}
    for r in range(rounds):
        for which in (("single", mode) if r % 2 == 0 else (mode, "single")):
            kw = {"mega_mode": "single"} if which == "single" else two_kw
            stats = grt.RenderStats()
            reset_resume_counts()
            ms, img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0, stats=stats, **kw))
            counts = resume_counts()
            taken[which].append(ms)
            if which == "single":
                single_img, single_counts = img, counts
            else:
                two_img, two_counts, two_stats = img, counts, stats
    same = torch.equal(two_img, single_img)
    mean = float(two_img.mean())
    png = pathlib.Path(out_dir) / f"chip_smoke_{name}_{mode}.png"
    grt.film.write_png(str(png), grt.film.to_uint8(two_img))
    emit(phase, scene=name, mode=mode, width=cam.image_width, height=cam.image_height,
         spp=cam.samples_per_pixel, depth=cam.max_depth, camera_rays=n_rays,
         chunks=two_stats.chunks, rays_per_chunk=chunk, launches=two_counts,
         launches_single=single_counts, render_ms_rounds=taken,
         render_ms_median={k: median(v) for k, v in taken.items()},
         camera_mrays_per_s={k: n_rays / (median(v) * 1e-3) / 1e6
                             for k, v in taken.items()},
         pictures_bit_equal=same, image_mean=mean, png=str(png))
    nch = two_stats.chunks
    if two_counts["wavefront_resume"] != 2 * nch or two_counts["wavefront_fwd"] != 0 \
            or single_counts["wavefront_fwd"] != nch or single_counts["wavefront_resume"]:
        raise RuntimeError(f"{name}: launches {two_counts}, single {single_counts}")
    if not same or not torch.isfinite(two_img).all() or not 0.02 < mean < 0.98:
        raise RuntimeError(f"{name}: {mode} picture differs from single's "
                           f"(equal {same}, mean {mean})")
    return two_counts, nch


def resume_kernel_timing(name, scene, cam, launches, small, regs):
    """B11 alone at a chunk of a job through 'split' (perlin's own 600x337,
    depth 50; ``random``'s 1200x675, depth 50): phase 1 (bounces [0,
    SPLIT_AT) on the rays in their order) and phase 2 (the rest, on the
    sorted survivors), each timed in rounds beside its plain version and its
    bound; the sort and the gather back; the rays entering each bounce and
    the hits, counted by chaining one-bounce launches (whose result must be
    one launch's, bit for bit).  In a scene with segments (``random``) each
    phase's outputs must be its plain version's bits, and the culled sweep's
    mirror counts each phase's tests on the whole chunk: its bound by
    operations (``sweep_flops``) beside the brute sweep's.  ``regs``: B11's
    (registers, spill bytes).  Returns B11's entry of the ``kernels``
    line."""
    depth, k_at = cam.max_depth, cw.SPLIT_AT
    tb = cw.build_tables(scene)
    o, d, tm, sid = render_chunk(scene, cam)
    n = tm.shape[0]
    flat = cw._start_state(o, d, tm, sid)
    marble = cw._has_noise(tb)

    # entered ray-bounces and hits (perlin: every hit is marble)
    entering, hits = [], []
    st = flat
    for b in range(depth):
        alive = (st[14] & cw.FLAG_ALIVE) != 0
        missed = (st[14] & cw.FLAG_MISSED) != 0
        out = cw.wavefront_resume(tb, st, 0, b, b + 1)
        entering.append(int(alive.sum()))
        hits.append(entering[-1] - int((((out[9] & cw.FLAG_MISSED) != 0) & ~missed).sum()))
        st = cw._resumed_state(st, out)
    one_rows, one_flags = cw.wavefront_fwd(tb, o, d, tm, sid, 0, depth)
    chained = (torch.equal(torch.stack(st[11:14] + st[15:21]), one_rows)
               and torch.equal(st[14], one_flags))
    del one_rows, one_flags, st

    out1 = cw.wavefront_resume(tb, flat, 0, 0, k_at)
    r1, out1 = rounds_ms(lambda: cw.wavefront_resume(tb, flat, 0, 0, k_at),
                         rounds=3, repeats=3)
    alive1 = (out1[9] & cw.FLAG_ALIVE) != 0
    state2 = cw._resumed_state(flat, out1)
    sort_ms, (flat2, back) = cuda_ms(lambda: cw._phase_state_sort(state2, alive1))
    cw.wavefront_resume(tb, flat2, 0, k_at, depth)
    r2, out2 = rounds_ms(lambda: cw.wavefront_resume(tb, flat2, 0, k_at, depth),
                         rounds=3, repeats=3)
    gather_ms, _ = cuda_ms(lambda: cw._packed_gather(out2[0:10], back))
    plain1_ms, p1 = cuda_ms(lambda: cw._wavefront_resume_plain(tb, flat, 0, 0, k_at))
    c1 = per_ray(rows_of(out1), rows_of(p1))
    del p1
    plain2_ms, p2 = cuda_ms(lambda: cw._wavefront_resume_plain(tb, flat2, 0, k_at, depth))
    c2 = per_ray(rows_of(out2), rows_of(p2))
    del p2
    counts1 = counts2 = {}
    mirror_equal = True
    if tb.n_seg > 0:
        m1, counts1 = cw.culled_sweep_counts(cw._wavefront_resume_plain, tb, flat, 0, 0, k_at)
        m2, counts2 = cw.culled_sweep_counts(cw._wavefront_resume_plain, tb, flat2, 0, k_at,
                                             depth)
        mirror_equal = per_ray(rows_of(out1), rows_of(m1))[1] == 0.0 and \
            per_ray(rows_of(out2), rows_of(m2))[1] == 0.0
        del m1, m2

    def bound(b0, b1, counts):
        marble_hits = float(sum(hits[b0:b1])) if marble else 0.0
        flops, flops_brute = sweep_flops(tb, float(sum(entering[b0:b1])), counts, marble_hits)
        int_ops = marble_hits * INT_OPS_MARBLE
        by_bytes = (RESUME_BYTES_PER_RAY * n + table_bytes_of(tb)) / PEAK_BYTES_PER_S * 1e3
        return ((by_bytes, (flops / PEAK_FP32_FLOPS + int_ops / PEAK_INT32_OPS) * 1e3),
                max(by_bytes, (flops_brute / PEAK_FP32_FLOPS + int_ops / PEAK_INT32_OPS) * 1e3))

    (b1, b1_brute), (b2, b2_brute) = bound(0, k_at, counts1), bound(k_at, depth, counts2)
    ms1, ms2 = median(r1), median(r2)
    warps = resident(cw.tracing_occupancy(
        "resume_marble" if cw.brute_route(tb) == "marble" else "resume", tb.n_seg > 0,
        smem_of_tables(tb)))

    def per_ray_bounce(counts, b0, b1):
        rb = float(sum(entering[b0:b1]))
        return {k[len("closest_"):]: v / rb for k, v in counts.items()
                if k.startswith("closest_")}

    emit("resume_kernel_timing", scene=name, rays_per_launch=n, depth=depth,
         route=cw.brute_route(tb), split_at=k_at, phase_1_ms=ms1, phase_1_ms_rounds=r1,
         phase_2_ms=ms2, previous_design_ms_perf_md=(
             [PREVIOUS_DESIGN_MS["wavefront_resume_phase_1"],
              PREVIOUS_DESIGN_MS["wavefront_resume_phase_2"]] if tb.n_seg == 0 else None),
         phase_2_ms_rounds=r2, launches_per_chunk=2, sort_ms=sort_ms,
         gather_back_ms=gather_ms, phase_1_plain_ms=plain1_ms,
         phase_2_plain_ms=plain2_ms, alive_after_phase_1=int(alive1.sum()),
         rays_entering_bounce=entering, hits_by_bounce=hits, marble=marble,
         chained_one_bounce_launches_equal_one_launch=chained,
         segments=tb.n_seg, groups=tb.n_grp, sweep_counts_phase_1=counts1,
         sweep_counts_phase_2=counts2,
         tests_per_ray_bounce_phase_1=per_ray_bounce(counts1, 0, k_at) if counts1 else None,
         tests_per_ray_bounce_phase_2=(per_ray_bounce(counts2, k_at, depth) if counts2
                                       else None),
         mirror_bit_equal_kernel=mirror_equal,
         phase_1_bound_bytes_ms=b1[0], phase_1_bound_ops_ms=b1[1],
         phase_2_bound_bytes_ms=b2[0], phase_2_bound_ops_ms=b2[1],
         phase_1_bound_ms_brute_sweep=b1_brute, phase_2_bound_ms_brute_sweep=b2_brute,
         phase_1_roofline_share=max(b1) / ms1, phase_2_roofline_share=max(b2) / ms2,
         phase_1_mismatch_share=c1[0], phase_1_share_not_bit_equal=c1[1],
         phase_2_mismatch_share=c2[0], phase_2_share_not_bit_equal=c2[1],
         registers=regs[0], spill_bytes=regs[1], resident_warps_per_sm=warps,
         flops_marble=FLOPS_MARBLE, int_ops_marble=INT_OPS_MARBLE)
    if not chained or max(c1[0], c2[0]) >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"B11 at the chunk: chained {chained}, against plain {c1} {c2}")
    if not (c1[1] == 0.0 and c2[1] == 0.0 and mirror_equal):
        raise RuntimeError(f"{name}: B11 ({cw.brute_route(tb)}) differs from its plain "
                           f"version's bits ({c1}, {c2}) or from its mirror ({mirror_equal})")
    # one entry for the kernel: a chunk's two launches, their mean
    bound_pair = ((b1[0] + b2[0]) / 2, (b1[1] + b2[1]) / 2)
    return kernel_entry(
        n, "wavefront_resume", "go_raytracing_tpu_torch/csrc/wavefront.cu",
        "go_raytracing_tpu/ops/pallas_wavefront.py:2514 (_call_resume)",
        launches, (ms1 + ms2) / 2, (plain1_ms + plain2_ms) / 2, bound_pair,
        [c1[2], c2[2], small[1]]) | {
            "mismatch_share": max(c1[0], c2[0], small[0]),
            "ms_phase_1": ms1, "ms_phase_2": ms2, "bound_ms_phase_1": max(b1),
            "bound_ms_phase_2": max(b2), "bound_ms_brute_sweep": (b1_brute + b2_brute) / 2,
            "sort_ms": sort_ms, "gather_back_ms": gather_ms,
            "scene": name, "depth": depth, "registers": regs[0], "spill_bytes": regs[1],
            "resident_warps_per_sm": warps}


def profile_split_chunk(scene, cam):
    """Device time by kernel over one chunk of perlin's own job rendered
    through 'split' (``torch.profiler``), beside the same render's time
    without the profiler: where the split's time goes (ray generation, the
    two B11 launches, the sort and the row gathers of the glue)."""
    from torch.profiler import ProfilerActivity, profile

    n_virt = cam.image_width * cam.image_height
    one = min(renderer.pick_chunk_size(scene) // n_virt, cam.samples_per_pixel)
    grt.render(scene, cam, spp=one, seed=0)
    plain_ms, _ = cuda_ms(lambda: grt.render(scene, cam, spp=one, seed=0))
    single_ms, _ = cuda_ms(lambda: grt.render(scene, cam, spp=one, seed=0,
                                              mega_mode="single"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grt.render(scene, cam, spp=one, seed=0)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)

    def total(*words):
        return sum(r[1] for r in rows if any(w in r[0].lower() for w in words))

    emit("split_profile", scene="perlin", rays=one * n_virt, spp=one,
         render_ms_without_profiler=plain_ms, single_render_ms=single_ms,
         device_ms=device_ms, device_busy_share=device_ms / plain_ms,
         device_idle_share=1.0 - device_ms / plain_ms,
         device_kernel_launches=sum(r[2] for r in rows),
         resume_kernel_ms=total("wavefront_resume", "resume_brute"),
         sort_kernels_ms=total("sort", "radix"),
         gather_and_index_kernels_ms=total("index", "gather", "scatter"),
         copy_and_cat_kernels_ms=total("copy", "cat"),
         top=[dict(name=r[0][:80], ms=r[1], calls=r[2]) for r in rows[:14]])
    if device_ms <= 0.0 or total("wavefront_resume", "resume_brute") <= 0.0:
        raise RuntimeError("split_profile: the profiler saw no B11 launch on the device")


def marble_and_split_phases(dev, out_dir, env, resume_regs, resume_cull_regs):
    """Marble textures (A13) and the resumable kernel (B11): the small
    checks, perlin forward and fwd+bwd at the JAX bench's size, perlin at
    its own depth 50 and ``random`` at its own 1200x675 and depth 50 (spp
    cut) through 'split', ``random`` through 'compact', and B11 alone at a
    chunk of each of the two split jobs.  Returns (B11's entry, fields for
    B1's entry, B2 / B3 launches)."""
    b1_marble = noise_small_checks(dev)
    perlin, p_cam = grt.load_scene("perlin", device=dev)
    smoke, s_cam = grt.load_scene("cornell-smoke", device=dev)
    nee, h_cam = hdri_scene(dev, True, env)
    rnd, r_cam = grt.load_scene("random", device=dev)
    deep_random = dataclasses.replace(r_cam, samples_per_pixel=RANDOM_CUT_SPP)
    small = resume_small_checks([
        ("perlin", perlin, dataclasses.replace(p_cam, image_width=128,
                                               samples_per_pixel=2)),
        ("cornell-smoke", smoke, dataclasses.replace(
            s_cam, image_width=64, aspect_ratio=1.0, samples_per_pixel=4,
            max_depth=DEEP_DEPTH)),
        ("hdri-test-nee", nee, dataclasses.replace(
            h_cam, image_width=128, samples_per_pixel=2, max_depth=DEEP_DEPTH)),
        ("random", rnd, dataclasses.replace(r_cam, image_width=128, samples_per_pixel=2)),
    ])
    del smoke, nee
    b1_noise = noise_main_path(dev, out_dir)
    grad_launches = noise_fwd_bwd(dev)
    split_counts, _ = two_phase_path("split_main_path", "perlin", perlin, p_cam,
                                     "split", out_dir)
    random_counts, _ = two_phase_path("split_random", "random", rnd, deep_random, "split",
                                      out_dir)
    two_phase_path("compact_check", "random", rnd,
                   dataclasses.replace(r_cam, image_width=600, samples_per_pixel=25,
                                       max_depth=10),
                   "compact", out_dir, rounds=1)
    entry = resume_kernel_timing("perlin", perlin, p_cam, split_counts["wavefront_resume"],
                                 small, resume_regs)
    on_random = resume_kernel_timing("random", rnd, deep_random,
                                     random_counts["wavefront_resume"], small, resume_cull_regs)
    del rnd
    entry |= {f"{k}_random": on_random[k] for k in (
        "launches", "ms", "ms_phase_1", "ms_phase_2", "plain_ms", "bound_ms", "bound_by",
        "bound_ms_phase_1", "bound_ms_phase_2", "bound_ms_brute_sweep", "rays_per_launch",
        "registers", "spill_bytes", "resident_warps_per_sm")}
    entry["mismatch_share"] = max(entry["mismatch_share"], on_random["mismatch_share"])
    entry["max_abs_err"] = max(entry["max_abs_err"], on_random["max_abs_err"])
    profile_split_chunk(perlin, p_cam)
    b1_fields = {"mismatch_share_marble": b1_marble[0],
                 "max_abs_err_marble": b1_marble[1],
                 "launches_noise_main_path": b1_noise}
    return entry, b1_fields, grad_launches


# ---- marble behind metal and glass (A13b): B5a, B5b and B4 with dmarble/dp ----

# Operations of dmarble/dp (csrc/wavefront_common.cuh: marble_grad), counted
# from the code as FLOPS_MARBLE is.  A corner: marble's (hash, 24 integer
# operations; cube sample 15, normalization 11, offset dot product 8, weight
# and sum 7) and the gradient's three components (sign-weight product 3,
# weight times the corner's gradient 1, two adds: 6 each).  An octave: 8
# corners, the floors, fractions and conversions (9), the scaling (5) and the
# three gradient sums (9).  The tail: the argument, the sign, the cosine and
# the three components (15), the albedo's summed cotangent and its three
# products (5), the three adds into the hit point's adjoint.
FLOPS_MARBLE_GRAD = 7 * (8 * (15 + 11 + 8 + 7 + 18) + 9 + 5 + 9) + 15 + 5 + 3
INT_OPS_MARBLE_GRAD = INT_OPS_MARBLE
# The scenes' sizes: cornell-glossy's bench size (bench.py:210) and
# hdri-test's (bench.py, the JAX bench's environment cell).
MARBLE_GLOSSY = dict(width=600, aspect=1.0, spp=100, depth=5)
MARBLE_GLOSSY_NEE = dict(width=800, aspect=16 / 9, spp=25, depth=10)
# The replay tier's runs of marble-glossy are cut to this many spp (the tier
# traces 1 to 4 million camera rays a second).
REPLAY_CUT_SPP = 25


def marble_glossy_scene(device, env=None, solid_floor=False):
    """The JAX package's noise + glossy gradient scene
    (tests/test_grad_pathwise.py: ``_mini_noise_glossy``): a marble floor at
    scale 0.4, a back wall, a quad light, a gold sphere with fuzz 0.2, a
    glass sphere with IOR 1.5 and a mirror; camera from (0, 3, 9) toward
    (0, 1.5, 0), vfov 45.  No reference scene puts marble behind metal or
    glass.  ``env``: under that environment with the same quad light (HDRI
    NEE, the fused tier), at hdri-test's size; else at cornell-glossy's.
    ``solid_floor``: a plain lambertian floor in place of the marble (a
    control)."""
    b = grt.SceneBuilder()
    marble = b.lambertian((0.5, 0.45, 0.4) if solid_floor else b.noise(0.4))
    b.quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), marble)
    b.quad((-6, 0, -6), (0, 8, 0), (12, 0, 0), b.lambertian((0.6, 0.65, 0.7)))
    b.add_light(b.quad((-1.5, 7.9, -1.5), (3, 0, 0), (0, 0, 3),
                       b.diffuse_light((13.0, 12.0, 11.0))))
    b.sphere((-1.8, 1.2, 0.0), 1.2, b.metal((0.8, 0.6, 0.2), 0.2))
    b.sphere((0.8, 1.0, 1.2), 1.0, b.dielectric(1.5))
    b.sphere((2.5, 0.8, -1.0), 0.8, b.metal((0.9, 0.9, 0.9), 0.0))
    size = MARBLE_GLOSSY if env is None else MARBLE_GLOSSY_NEE
    if env is not None:
        b.set_environment(env, 0.0)
    cam = Camera(image_width=size["width"], aspect_ratio=size["aspect"],
                 samples_per_pixel=size["spp"], max_depth=size["depth"],
                 look_from=(0, 3, 9), look_at=(0, 1.5, 0), vfov=45.0,
                 background=(0.02, 0.01, 0.03))
    return b.build(device=device), cam


def frame_rays(cam, n, seed, dev):
    """Camera rays of ``n`` pixels drawn across the frame (sorted), sample 0:
    (o, d, tm, stream as int32, ray ids)."""
    w, h = cam.image_width, cam.image_height
    gen = torch.Generator(device=dev).manual_seed(seed)
    pix = torch.randperm(w * h, device=dev, generator=gen)[:n].sort().values
    o, d, tm = generate_rays(cam, pix % w, pix // w, pix, seed)
    o, d = V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d))
    return o, d, tm.contiguous(), cw.stream_to_i32(pix), pix


def replay_grads(scene, cam, rays, seed, g3):
    """The replay tier's gradients of <radiance, g3> on given rays (its pass
    B: the record, then ``torch.autograd`` through the replay)."""
    o, d, tm, ids = rays
    _, dec = wavefront.trace(scene, cam, o, d, tm, ids, seed, record=True)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in grt.trainable_params(scene).items()}
    with torch.enable_grad():
        rad = wavefront.trace(grt.apply_params(scene, params), cam, o, d, tm, ids, seed,
                              decisions=dec)
        inner = sum((rad[c] * g3[c]).sum() for c in range(3))
        got = torch.autograd.grad(inner, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(params.items(), got)}


def err_of_largest(got, ref, keys):
    return {k: float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
            for k in keys}


def marble_small_checks(glossy, cam, nee, nee_cam, env, dev, n=16384, seed=16):
    """B5a, B5b and B4 with marble against their plain versions on ``n``
    camera rays drawn across each frame: B5a's stash rows and mask words and
    its radiance (B1's bits) equal; B5b's and B4's sums within 1e-4 of each
    key's largest entry, the same bits on two launches; and the pathwise and
    fused tiers against the replay tier on those rays, within 2e-3 of each
    key's largest entry: every key of the pathwise tier, the colours and
    texels of the fused tier.  Under the synthetic sky fuzz and IOR reach
    the miss shader through the miss direction, whose derivative jumps at
    texel edges (the sun's above all); the standard integrator's hit points
    round apart from the megakernel's, so a few rays' miss directions land
    across an edge from each other.  The fused tier's fuzz and IOR against
    the replay are printed, beside the same scene's with a solid floor in
    place of the marble (the control: the gap is the sky's, not the
    marble's), as ``env_small_checks`` leaves them out of its comparison
    with autograd.  Returns the fields."""
    out = {}
    o, d, tm, sid, ids = frame_rays(cam, n, seed, dev)
    tb = cw.build_tables(glossy)
    args = (tb, o, d, tm, sid, seed, cam.max_depth, cw.miss_config(cam))
    k = cw.wavefront_grad_fwd(*args, pathwise=True)
    p = cw._wavefront_grad_fwd_plain(*args, pathwise=True)
    b1_rows, b1_flags = cw.wavefront_fwd(*args[:-1])
    mk = k[4][:, 2]
    # equal values (a zero's sign may differ: the kernel writes +0 where the
    # plain version's masked rows give -0 times a flip)
    not_equal = ((k[3] != p[3]).any(dim=1) | (k[4] != p[4]).any(dim=1)).any(dim=0)
    out["b5a_stash_rows"] = int(k[3].shape[1])
    out["b5a_share_of_rays_not_equal"] = float(not_equal.float().mean())
    out["b5a_mismatch_share"], out["b5a_max_abs_err"] = grad_fwd_mismatch(k, p)
    out["b5a_radiance_is_b1s"] = bool(torch.equal(k[0], b1_rows) and torch.equal(k[1], b1_flags))
    out["marble_rows"] = int(((mk & cw.PW_MARBLE) != 0).sum())
    out["entered_rows"] = int(((mk & (cw.PW_HIT | cw.PW_LIT)) != 0).sum())
    if out["b5a_stash_rows"] != cw.PW_STASH_F_ROWS_MARBLE or not out["b5a_radiance_is_b1s"] \
            or out["b5a_share_of_rays_not_equal"] > 0.0 or out["marble_rows"] < n // 10:
        raise RuntimeError(f"B5a with marble against its plain version: {out}")

    gen = torch.Generator(device=dev).manual_seed(seed)
    g3 = torch.rand((3, n), device=dev, generator=gen) * 1e-3
    n_tex, n_mat = int(glossy.textures.color.shape[0]), int(glossy.materials.kind.shape[0])
    rev = (tb, k[3], k[4], g3, k[2], sid, seed, bool(cam.use_sky_gradient), n_tex, n_mat)
    gk, gk2 = cw.wavefront_grad_rev_pathwise(*rev), cw.wavefront_grad_rev_pathwise(*rev)
    gp = cw._wavefront_grad_rev_pathwise_plain(*rev)
    out["b5b_max_abs_err"], out["b5b_err_of_largest"] = pathwise_rev_err(gk, gp)
    out["b5b_same_bits"] = all(bool(torch.equal(a, b)) for a, b in zip(gk, gk2))
    if not out["b5b_err_of_largest"] <= REV_RTOL_OF_LARGEST or not out["b5b_same_bits"]:
        raise RuntimeError(f"B5b with marble against its plain version: {out}")
    tier = cw.grad_rev_stash(glossy, cam, g3, k[2:], pathwise=True, stream=sid, seed=seed)
    rep = replay_grads(glossy, cam, (o, d, tm, ids), seed, g3)
    out["pathwise_vs_replay_err_of_largest"] = err_of_largest(tier, rep, ("color", "fuzz", "ior"))
    del k, p

    o2, d2, tm2, sid2, ids2 = frame_rays(nee_cam, n, seed, dev)
    b4 = b4_against_plain(nee, nee_cam, cw.build_tables(nee), (o2, d2, tm2, sid2), seed,
                          nee_cam.max_depth, g3)
    out.update({f"b4_{kk}": v for kk, v in b4.items()})
    if not (b4["radiance_is_b1s_plus_miss"] and b4["radiance_is_plains"]
            and b4["err_of_largest"] <= REV_RTOL_OF_LARGEST and b4["eout_largest"] > 0.0
            and b4["eout_err_of_largest"] <= REV_RTOL_OF_LARGEST and b4["same_bits"]):
        raise RuntimeError(f"B4 with marble against its plain version: {out}")
    keys = ("color", "fuzz", "ior", "env_data")
    for name, scene in (("", nee), ("_solid_floor", marble_glossy_scene(
            dev, env, solid_floor=True)[0])):
        _, fused = cw.grad_megakernel(scene, nee_cam, o2, d2, tm2, ids2, seed, g3)
        rep2 = replay_grads(scene, nee_cam, (o2, d2, tm2, ids2), seed, g3)
        out[f"fused_vs_replay_err_of_largest{name}"] = err_of_largest(fused, rep2, keys)
    emit("marble_kernels_vs_plain", scene="marble-glossy", scene_nee="marble-glossy-nee",
         rays=n, depth=cam.max_depth, depth_nee=nee_cam.max_depth, **out)
    gated = list(out["pathwise_vs_replay_err_of_largest"].values()) + [
        out["fused_vs_replay_err_of_largest"][k] for k in ("color", "env_data")]
    if max(gated) > AUTOGRAD_RTOL_OF_LARGEST:
        raise RuntimeError(f"the kernel tiers against the replay tier: {out}")
    return out


def marble_fwd_bwd(phase, name, scene, cam, tier, rounds=3, **kw):
    """``render_grad`` at full size on ``tier``: one warm-up, then the
    median of ``rounds`` calls, the launch counts of each call set to 0
    just before it and read just after.  The loss must be that of
    ``render``'s picture (rtol 1e-5), every gradient finite, colour, fuzz
    and ior not zero, every call's gradients the same bits.  Returns
    (counts, chunks, ms, grads, loss, target)."""
    spp = cam.samples_per_pixel
    n_rays = cam.image_width * cam.image_height * spp
    if gradmod.grad_tier(scene, cam.max_depth) != tier:
        raise RuntimeError(f"{name}: tier {gradmod.grad_tier(scene, cam.max_depth)}")
    fb = grt.render(scene, cam, seed=0)
    target = fb / spp * 0.8
    loss_ref = float(torch.mean((fb / spp - target) ** 2))
    del fb
    first_loss, first = grt.render_grad(scene, cam, target, seed=0, **kw)   # warm-up
    free_before = torch.cuda.mem_get_info()[0]
    taken = []
    for _ in range(rounds):
        stats = grt.RenderStats()
        reset_env_counts()
        torch.cuda.reset_peak_memory_stats()
        ms, (loss, grads) = cuda_ms(lambda: grt.render_grad(scene, cam, target, seed=0,
                                                            stats=stats, **kw))
        counts = env_counts()
        taken.append(ms)
        same = all(torch.equal(grads[k], first[k]) for k in grads) \
            and float(loss) == float(first_loss)
        if not same:
            raise RuntimeError(f"{name}: two render_grad calls differ in their bits")
    peak = torch.cuda.max_memory_allocated()
    nch = stats.chunks
    ms = median(taken)
    per_ray = (gradmod.stash_bytes_per_ray(cam.max_depth, True, scene.env is not None, True)
               if tier == "pathwise" else None)
    budget = kw.get("stash_budget")
    if tier == "pathwise":
        # every chunk stashed, or as many as a given budget holds; a chunk
        # without a stash is traced by the forward kernel in pass A
        n_stash = nch if budget is None else min(budget // (n_rays // nch * per_ray), nch)
        want = {"wavefront_fwd": nch - n_stash, "wavefront_grad_fwd_pathwise": nch,
                "wavefront_grad_rev_pathwise": nch, "wavefront_grad_fused": 0}
    else:
        n_stash = 0
        want = {"wavefront_fwd": 2 * nch, "wavefront_grad_fwd_pathwise": 0,
                "wavefront_grad_rev_pathwise": 0, "wavefront_grad_fused": nch}
    loss_f = float(loss)
    emit(phase, scene=name, width=cam.image_width, height=cam.image_height, spp=spp,
         depth=cam.max_depth, camera_rays=n_rays, tier=tier, chunks=nch, n_stash=n_stash,
         stash_budget=budget, launches=counts, render_grad_ms_rounds=taken,
         render_grad_ms_median=ms, fwd_bwd_camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
         loss=loss_f, loss_from_render=loss_ref, stash_bytes_per_ray=per_ray,
         fuzz_grad=grads["fuzz"].tolist(), ior_grad=grads["ior"].tolist(),
         free_memory_before=free_before, max_memory_allocated=peak)
    if any(counts[k] != v for k, v in want.items()) or nch < 1:
        raise RuntimeError(f"{name}: launches {counts}, expected {want} for {nch} chunks")
    if not loss_f == loss_f or abs(loss_f - loss_ref) > 1e-5 * loss_ref:
        raise RuntimeError(f"{name}: loss {loss_f} against {loss_ref} from render()")
    for key, g in grads.items():
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{name}: gradient {key} is not finite")
    for key in ("color", "fuzz", "ior") + (("env_data",) if scene.env is not None else ()):
        if float(grads[key].abs().max()) == 0.0:
            raise RuntimeError(f"{name}: gradient {key} is zero")
    return counts, nch, ms, grads, loss_f, target


def replay_against(phase, name, scene, cam, tier_ms, tier_grads, tier_loss, target):
    """The same job forced through the replay tier (the route the parent
    commit took for marble behind metal or glass), on the same card: one
    warm-up, one timed call; its loss against the kernel tier's and each
    gradient key's difference from it over its largest entry."""
    spp = cam.samples_per_pixel
    n_rays = cam.image_width * cam.image_height * spp
    kw = dict(spp=spp, max_depth=cam.max_depth, seed=0, chunk=None, dec_budget=None)
    gradmod._render_grad_replay(scene, cam, target, stats=None, **kw)
    stats = grt.RenderStats()
    ms, (loss, grads) = cuda_ms(lambda: gradmod._render_grad_replay(
        scene, cam, target, stats=stats, **kw))
    keys = ("color", "fuzz", "ior") + (("env_data",) if scene.env is not None else ())
    emit(phase, scene=name, width=cam.image_width, height=cam.image_height, spp=spp,
         depth=cam.max_depth, camera_rays=n_rays, chunks=stats.chunks,
         render_grad_ms=ms, fwd_bwd_camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
         kernel_tier_ms=tier_ms,
         kernel_tier_camera_mrays_per_s=n_rays / (tier_ms * 1e-3) / 1e6,
         speedup_of_kernel_tier=ms / tier_ms,
         loss_rel_diff=abs(float(loss) - tier_loss) / tier_loss,
         grad_diff_of_largest=err_of_largest(tier_grads, grads, keys))
    return ms


def grad_fwd_marble_instantiation(tb, rays, depth, miss):
    """B5a's instantiation of a scene with marble (``wavefront_kernel<4>``:
    20 stash rows, the marble's turns across the warp compiled in) on
    rays of any scene, through the launcher the wrapper calls (not counted:
    a timing, not the main path).  Returns what ``wavefront_grad_fwd``
    returns."""
    o, d, tm, sid = rays
    r, dev = tm.shape[0], tm.device
    out = torch.empty((9, r), dtype=torch.float32, device=dev)
    flags = torch.empty((r,), dtype=torch.int32, device=dev)
    miss_col = torch.empty((3, r), dtype=torch.float32, device=dev)
    stash_f, stash_i = cw._empty_stash(r, depth, dev, cw.PW_STASH_F_ROWS_MARBLE)
    fn = cw._kernel("wavefront", "wavefront_grad_fwd_pathwise_launch",
                    cw._GRAD_FWD_ARGTYPES)
    mode, bg = miss
    err = fn(*cw._table_and_ray_args(tb, o, d, tm, sid), out.data_ptr(), flags.data_ptr(),
             miss_col.data_ptr(), stash_f.data_ptr(), stash_i.data_ptr(), r, 0, depth,
             int(mode), float(bg[0]), float(bg[1]), float(bg[2]),
             cw.PW_STASH_F_ROWS_MARBLE, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wavefront_grad_fwd_pathwise_launch (20 rows) failed: {err}")
    return out, flags, miss_col, stash_f, stash_i


def instantiation_cost(scene, cam, n):
    """B5a's two instantiations in turns (<2>, <4>, <4>, <2>) at a chunk of
    ``scene``, which has no marble: what the marble's instantiation costs
    where no ray hits marble.  Its outputs and its first 19 stash rows must
    be <2>'s (the 20th holds each winner's texture scale).  Returns (ms <2>,
    ms <4>, share of ray-bounces entered, the rounds)."""
    depth = cam.max_depth
    rays = chunk_rays(cam, n, 0, scene.device)
    tb = cw.build_tables(scene)
    miss = cw.miss_config(cam)
    plain = lambda: cw.wavefront_grad_fwd(tb, *rays, 0, depth, miss, pathwise=True)
    marble = lambda: grad_fwd_marble_instantiation(tb, rays, depth, miss)
    a, b = plain(), marble()
    same = all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) \
        and torch.equal(a[4], b[4]) and torch.equal(a[3], b[3][:, :cw.PW_STASH_F_ROWS])
    entered = float(((a[4][:, 2] & (cw.PW_HIT | cw.PW_LIT)) != 0).sum())
    del a, b
    if not same:
        raise RuntimeError("B5a <4> on rays without marble differs from <2>")
    taken = {"2": [], "4": []}
    for key, fn in (("2", plain), ("4", marble), ("4", marble), ("2", plain)):
        ms, _ = rounds_ms(fn, rounds=2, repeats=2)
        taken[key].extend(ms)
    return median(taken["2"]), median(taken["4"]), entered / (n * depth), taken


def resident(occupancy):
    blocks, threads = occupancy
    return blocks * threads // 32


def smem_of_tables(tb):
    """Shared bytes a tracing launch stages for these tables (0: they stay
    in device memory); the forward, record and resumable kernels', with the
    culled sweep's segments and groups where the tables have them."""
    size = table_bytes_of(tb)
    return size if size <= 48 * 1024 else 0


def marble_kernel_timing(glossy, cam, nee, nee_cam, chunks, launches, small):
    """B5a and B5b at a chunk of marble-glossy's job and B4 at one of
    marble-glossy-nee's, each alone in rounds beside its bound (the stash's
    20th row in the bytes; the marble and its derivative, per marble row,
    in the operations); B5a and B5b beside their plain versions at the
    chunk, B4 beside its plain version's time on the small check's rays.
    Returns the marble fields of the three entries of the ``kernels``
    line."""
    dev = glossy.device
    depth = cam.max_depth
    n = cam.image_width * cam.image_height * cam.samples_per_pixel // chunks["glossy"]
    o, d, tm, sid = chunk_rays(cam, n, 0, dev)
    tb = cw.build_tables(glossy)
    args = (tb, o, d, tm, sid, 0, depth, cw.miss_config(cam))
    cw.wavefront_grad_fwd(*args, pathwise=True)
    fwd_rounds, k = rounds_ms(lambda: cw.wavefront_grad_fwd(*args, pathwise=True),
                              rounds=3, repeats=2)
    plain_fwd_ms, p = cuda_ms(lambda: cw._wavefront_grad_fwd_plain(*args, pathwise=True))
    fwd_mismatch, fwd_err = grad_fwd_mismatch(k, p)
    del p
    mk = k[4][:, 2]
    entered = float(((mk & (cw.PW_HIT | cw.PW_LIT)) != 0).sum())
    marble = float(((mk & cw.PW_MARBLE) != 0).sum())
    gen = torch.Generator(device=dev).manual_seed(0)
    g3 = torch.rand((3, n), device=dev, generator=gen) * 1e-6
    n_tex, n_mat = int(glossy.textures.color.shape[0]), int(glossy.materials.kind.shape[0])
    rev = (tb, k[3], k[4], g3, k[2], sid, 0, bool(cam.use_sky_gradient), n_tex, n_mat)
    cw.wavefront_grad_rev_pathwise(*rev)
    rev_rounds, gk = rounds_ms(lambda: cw.wavefront_grad_rev_pathwise(*rev),
                               rounds=3, repeats=2)
    plain_rev_ms, gp = cuda_ms(lambda: cw._wavefront_grad_rev_pathwise_plain(*rev))
    rev_err, rev_rel = pathwise_rev_err(gk, gp)
    del rev, k, gp
    if fwd_mismatch >= MAX_MISMATCH_SHARE or not rev_rel <= REV_RTOL_OF_LARGEST:
        raise RuntimeError(f"marble-glossy chunk: B5a {fwd_mismatch:.4%} of rays off, "
                           f"B5b off by {rev_rel:.2e}")
    table_bytes = 4 * sum(t.numel() for t in (tb.pt, tb.st, tb.vt, tb.lt))
    per_bounce = (tb.n_planar * FLOPS_PLANAR + tb.n_sphere * FLOPS_SPHERE
                  + tb.n_vol * FLOPS_VOLUME + FLOPS_SHADE)
    stash_rows = (cw.PW_STASH_F_ROWS_MARBLE + cw.PW_STASH_I_ROWS) * depth
    fwd_bound = (((8 + 10 + 3 + stash_rows) * 4 * n + table_bytes) / PEAK_BYTES_PER_S * 1e3,
                 ((entered * per_bounce + marble * FLOPS_MARBLE) / PEAK_FP32_FLOPS
                  + marble * INT_OPS_MARBLE / PEAK_INT32_OPS) * 1e3)
    n_acc = 9 * n_tex + 2 * n_mat
    block_rays = cw.pathwise_rev_block_rays(cw.PW_STASH_F_ROWS_MARBLE, n_acc)
    rev_bound = (((stash_rows + 3 + 3 + 1) * 4 * n + 4 * n_acc * -(-n // block_rays)
                  + 4 * (tb.vt.numel() + tb.lt.numel())) / PEAK_BYTES_PER_S * 1e3,
                 ((entered * FLOPS_REVERSE_PATHWISE + marble * FLOPS_MARBLE_GRAD)
                  / PEAK_FP32_FLOPS
                  + (entered * INT_OPS_REVERSE_PATHWISE + marble * INT_OPS_MARBLE_GRAD)
                  / PEAK_INT32_OPS) * 1e3)
    fwd_ms, rev_ms = median(fwd_rounds), median(rev_rounds)

    # B4 at a chunk of marble-glossy-nee
    n4 = (nee_cam.image_width * nee_cam.image_height * nee_cam.samples_per_pixel
          // chunks["nee"])
    depth4 = nee_cam.max_depth
    _, o, d, tm, ids, _, _ = renderer._chunk_rays(nee, nee_cam, 0, 0,
                                                  spp=nee_cam.samples_per_pixel, chunk=n4,
                                                  max_depth=depth4, device=dev)
    o, d, tm = V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)), tm.contiguous()
    sid = cw.stream_to_i32(ids)
    tb4 = cw.build_tables(nee)
    rows = cw.hdri_rows_for(nee, sid, 0, depth4)
    f_out, f_flags = cw.wavefront_fwd(tb4, o, d, tm, sid, 0, depth4, rows)
    _, _, _, _, s_i = cw.wavefront_grad_fwd(tb4, o, d, tm, sid, 0, depth4,
                                           (cw.MISS_STREAM, (0.0, 0.0, 0.0)), pathwise=True)
    mk4 = s_i[:, 2]
    entered4 = float(((mk4 & (cw.PW_HIT | cw.PW_LIT)) != 0).sum())
    marble4 = float(((mk4 & cw.PW_MARBLE) != 0).sum())
    # the bounces a ray entered: the fused kernel's stash rows and sweep
    entered_by_ray4 = ((mk4 != 0).sum(dim=0)).float()
    mis4 = int(((mk4 & cw.PW_USE_MIS) != 0).sum())
    del s_i
    g3 = torch.rand((3, n4), device=dev, generator=gen) * 1e-6
    mc, lmd, _ = cw._env_miss_terms(nee, nee_cam, cw._env_carry(nee, f_out, f_flags), g3,
                                    want_lmd=True)
    del f_out, f_flags
    n_tex4, n_mat4 = int(nee.textures.color.shape[0]), int(nee.materials.kind.shape[0])
    fused = (tb4, o, d, tm, sid, 0, depth4, g3, (cw.MISS_STREAM, (0.0, 0.0, 0.0)),
             torch.cat([mc, lmd]).contiguous(), rows, n_tex4, n_mat4)
    cw.wavefront_grad_fused(*fused)
    b4_rounds, _ = rounds_ms(lambda: cw.wavefront_grad_fused(*fused), rounds=3, repeats=2)
    b4_ms = median(b4_rounds)
    del fused, mc, lmd, rows
    table_bytes4 = 4 * sum(t.numel() for t in (tb4.pt, tb4.st, tb4.vt, tb4.lt))
    per_bounce4 = (tb4.n_planar * FLOPS_PLANAR + tb4.n_sphere * FLOPS_SPHERE
                   + tb4.n_vol * FLOPS_VOLUME + FLOPS_SHADE)
    block4 = _build.load("wavefront_grad_fused").lib.wavefront_grad_fused_block_rays()
    n_acc4 = 9 * n_tex4 + 2 * n_mat4
    # the marble and its derivative once a marble hit: marble_grad's
    # operations give both (the first design evaluated the value twice)
    b4_bound = (((8 + 3 + 6 + 3 + 3 * depth4) * 4 * n4 + cw.HDRI_ROWS * 4 * mis4
                 + 4 * n_acc4 * -(-n4 // block4) + table_bytes4) / PEAK_BYTES_PER_S * 1e3,
                ((entered4 * (per_bounce4 + FLOPS_REVERSE_PATHWISE)
                  + mis4 * FLOPS_HDRI_NEE + marble4 * FLOPS_MARBLE_GRAD)
                 / PEAK_FP32_FLOPS
                 + (entered4 * INT_OPS_REVERSE_PATHWISE
                    + marble4 * INT_OPS_MARBLE_GRAD) / PEAK_INT32_OPS)
                * 1e3)
    # where the B5a and B4 redesigns act: ray-bounces entered, marble hits a
    # ray, and warps (of consecutive rays) by their deepest path
    warps4 = entered_by_ray4[: n4 // 32 * 32].reshape(-1, 32).max(dim=1).values
    emit("marble_kernel_timing", scene="marble-glossy", rays_per_launch=n, depth=depth,
         entered_rows=entered, marble_rows=marble,
         b5a_entered_share=entered / (n * depth), b5a_marble_hits_per_ray=marble / n,
         b4_entered_share=entered4 / (n4 * depth4), b4_marble_hits_per_ray=marble4 / n4,
         b4_bounces_entered_per_ray=float(entered_by_ray4.mean()),
         b4_warp_deepest_bounces_mean=float(warps4.mean()),
         b5a_ms=fwd_ms, b5a_ms_rounds=fwd_rounds, b5a_plain_ms=plain_fwd_ms,
         b5a_bound_bytes_ms=fwd_bound[0], b5a_bound_ops_ms=fwd_bound[1],
         b5a_roofline_share=max(fwd_bound) / fwd_ms, b5a_mismatch_share=fwd_mismatch,
         b5b_ms=rev_ms, b5b_ms_rounds=rev_rounds, b5b_plain_ms=plain_rev_ms,
         b5b_bound_bytes_ms=rev_bound[0], b5b_bound_ops_ms=rev_bound[1],
         b5b_roofline_share=max(rev_bound) / rev_ms, b5b_err_of_largest=rev_rel,
         scene_nee="marble-glossy-nee", b4_rays_per_launch=n4, b4_depth=depth4,
         b4_entered_rows=entered4, b4_marble_rows=marble4, b4_hdri_sampling_rows=mis4,
         b4_ms=b4_ms, b4_ms_rounds=b4_rounds,
         b4_plain_ms_16384_rays=small["b4_plain_ms"],
         b4_bound_bytes_ms=b4_bound[0], b4_bound_ops_ms=b4_bound[1],
         b4_roofline_share=max(b4_bound) / b4_ms,
         flops_marble_grad=FLOPS_MARBLE_GRAD, int_ops_marble_grad=INT_OPS_MARBLE_GRAD)

    def fields(ms, plain, bound, launches_, err, rays):
        return {"ms_marble": ms, "plain_ms_marble": plain, "bound_ms_marble": max(bound),
                "bound_by_marble": "bytes" if bound[0] >= bound[1] else "operations",
                "launches_marble": launches_, "max_abs_err_marble": err,
                "rays_per_launch_marble": rays}

    return (fields(fwd_ms, plain_fwd_ms, fwd_bound, launches["b5a"],
                   max(fwd_err, small["b5a_max_abs_err"]), n),
            fields(rev_ms, plain_rev_ms, rev_bound, launches["b5b"],
                   max(rev_err, small["b5b_max_abs_err"]), n),
            fields(b4_ms, small["b4_plain_ms"], b4_bound, launches["b4"],
                   small["b4_max_abs_err"], n4) | {"plain_rays_marble": 16384})


def marble_grad_phases(dev, env, regs, glossy_plain, record_scene, product_scene):
    """Marble behind metal and glass on the kernel tiers (A13b): the small
    checks, ``marble-glossy`` (600x600, 100 spp, depth 5) fwd+bwd on the
    pathwise tier all stashed and over budget, ``marble-glossy-nee``
    (800x450, 25 spp, depth 10) on the fused tier, each beside the same job
    through the replay tier, and the three kernels alone; then the
    redesigned kernels' registers, spills and resident warps (B4, B5a and
    B5b, both instantiations each, and B6 at ``record_scene``'s tables) and
    B5a's marble instantiation on ``glossy_plain``'s chunk (cornell-glossy:
    no marble); B2 at ``product_scene``'s tables, and its marble
    instantiation at perlin's.  Returns the marble fields
    of B5a's, B5b's and B4's entries, and the resident warps of B2, B5a <2>,
    B4 <19>, B5b <19> and B6."""
    glossy, cam = marble_glossy_scene(dev)
    nee, nee_cam = marble_glossy_scene(dev, env)
    small = marble_small_checks(glossy, cam, nee, nee_cam, env, dev)
    counts, nch, ms, grads, loss, _ = marble_fwd_bwd(
        "marble_glossy_fwd_bwd", "marble-glossy", glossy, cam, "pathwise")
    per_ray = gradmod.stash_bytes_per_ray(cam.max_depth, True, False, True)
    budget = 2 * (cam.image_width * cam.image_height * cam.samples_per_pixel // nch
                  * per_ray) + 1
    _, _, _, grads2, loss2, _ = marble_fwd_bwd(
        "marble_glossy_fwd_bwd_over_budget", "marble-glossy", glossy, cam, "pathwise",
        rounds=1, stash_budget=budget)
    diff = err_of_largest(grads2, grads, ("color", "fuzz", "ior"))
    if abs(loss2 - loss) > 1e-6 * loss or max(diff.values()) > 1e-5:
        raise RuntimeError(f"marble-glossy over budget: loss {loss2} against {loss}, {diff}")
    cut = dataclasses.replace(cam, samples_per_pixel=REPLAY_CUT_SPP)
    _, _, cut_ms, cut_grads, cut_loss, cut_target = marble_fwd_bwd(
        "marble_glossy_fwd_bwd_25spp", "marble-glossy", glossy, cut, "pathwise")
    replay_against("marble_glossy_replay_tier", "marble-glossy", glossy, cut, cut_ms,
                   cut_grads, cut_loss, cut_target)
    n_counts, n_nch, n_ms, n_grads, n_loss, n_target = marble_fwd_bwd(
        "marble_glossy_nee_fwd_bwd", "marble-glossy-nee", nee, nee_cam, "fused")
    replay_against("marble_glossy_nee_replay_tier", "marble-glossy-nee", nee, nee_cam,
                   n_ms, n_grads, n_loss, n_target)
    b5a, b5b, b4 = marble_kernel_timing(
        glossy, cam, nee, nee_cam, {"glossy": nch, "nee": n_nch},
        {"b5a": counts["wavefront_grad_fwd_pathwise"],
         "b5b": counts["wavefront_grad_rev_pathwise"],
         "b4": n_counts["wavefront_grad_fused"]}, small)
    b5a["registers_marble"], b5a["spill_bytes_marble"] = regs["b5a"]
    b5b["registers_marble"], b5b["spill_bytes_marble"] = regs["b5b"]
    b4["registers_marble"], b4["spill_bytes_marble"] = regs["b4"]

    g_scene, g_cam = glossy_plain
    n = g_cam.image_width * g_cam.image_height * g_cam.samples_per_pixel // nch
    ms2, ms4, share, taken = instantiation_cost(g_scene, g_cam, n)
    hdri_nee, _ = hdri_scene(dev, True, env)
    warps = _build.load("wavefront_grad_fused").lib.wavefront_grad_fused_block_rays() // 32

    def fused_smem(scene):
        tb = cw.build_tables(scene)
        n_acc = 9 * int(scene.textures.color.shape[0]) + 2 * int(scene.materials.kind.shape[0])
        acc, tables = 4 * warps * n_acc, smem_of_tables(tb)
        return acc + (tables if 0 < tables and acc + tables <= 48 * 1024 else 0)

    def rev_occupancy(marble, scene):
        n_acc = 9 * int(scene.textures.color.shape[0]) + 2 * int(scene.materials.kind.shape[0])
        return cw.pathwise_rev_occupancy(marble, n_acc)

    many = th.build_many_textures(grt, device=dev)
    occ = {"b5b_19": rev_occupancy(False, g_scene), "b5b_19_warp_sums": rev_occupancy(
        False, many), "b5b_20": rev_occupancy(True, glossy)}
    stats = {
        "b5b_19": (regs["b5b_19"], resident(occ["b5b_19"][:2])),
        "b5b_19_warp_sums": (regs["b5b_19_warp"], resident(occ["b5b_19_warp_sums"][:2])),
        "b5b_20": (regs["b5b"], resident(occ["b5b_20"][:2])),
        "b2": (regs["b2"], resident(cw.tracing_occupancy("grad_fwd", False, smem_of_tables(
            cw.build_tables(product_scene))))),
        "b2_marble": (regs["b2_marble"], resident(cw.tracing_occupancy(
            "grad_fwd_marble", False, smem_of_tables(cw.build_tables(
                grt.load_scene("perlin", device=dev)[0]))))),
        "b6": (regs["b6"], resident(cw.tracing_occupancy("record", True, smem_of_tables(
            cw.build_tables(record_scene))))),
        "b5a_2": (regs["b5a_2"], resident(cw.pathwise_occupancy(
            False, smem_of_tables(cw.build_tables(g_scene))))),
        "b5a_4": (regs["b5a"], resident(cw.pathwise_occupancy(
            True, smem_of_tables(cw.build_tables(glossy))))),
        "b4_19": (regs["b4_19"], resident(cw.fused_occupancy(False, fused_smem(hdri_nee)))),
        "b4_22": (regs["b4"], resident(cw.fused_occupancy(True, fused_smem(nee))))}
    emit("redesigned_kernels",
         note="registers and spill bytes from the build; resident warps an SM at the "
              "shared memory of the timed launches (B2 at cornell, its marble instantiation "
              "at perlin, B5a <2> and B5b <19> at "
              "cornell-glossy, "
              "<4> and <20> at marble-glossy, B4 <19> at hdri-test-nee, <22> at "
              "marble-glossy-nee, B6 at random; B5b <19>'s warp sums at a scene of 418 "
              "accumulators); shared bytes a block of B5b",
         **{k: {"registers": r[0], "spill_bytes": r[1], "resident_warps_per_sm": w}
            | ({"shared_bytes_per_block": occ[k][2], "threads_per_block": occ[k][1]}
               if k in occ else {})
            for k, (r, w) in stats.items()},
         instantiation_scene="cornell-glossy", instantiation_rays=n,
         instantiation_entered_share=share, b5a_2_ms=ms2, b5a_4_ms_no_marble_hits=ms4,
         instantiation_ms_rounds=taken)
    b5a["resident_warps_per_sm_marble"] = stats["b5a_4"][1]
    b5a["ms_marble_instantiation_cornell_glossy"] = ms4
    b5a["ms_plain_instantiation_cornell_glossy"] = ms2
    b4["resident_warps_per_sm_marble"] = stats["b4_22"][1]
    b5b["resident_warps_per_sm_marble"] = stats["b5b_20"][1]
    b5b["shared_bytes_per_block"] = occ["b5b_19"][2]
    b5b["resident_warps_per_sm_warp_sums"] = stats["b5b_19_warp_sums"][1]
    b5b["shared_bytes_per_block_warp_sums"] = occ["b5b_19_warp_sums"][2]
    return (b5a, b5b, b4, {k: stats[k][1] for k in ("b2", "b2_marble", "b5a_2", "b4_19",
                                                    "b5b_19", "b6")})


# ---- the tile-sweep probe of the mesh stream (scripts/stream_micro.py) --------

PROBE_BLOCKS, PROBE_SWEEPS = 512, 512        # scripts/stream_micro.py's defaults


# ---- image textures (ROADMAP A16): earth, and a picture in the Cornell box ------

EARTH_BENCH = dict(image_width=400, samples_per_pixel=25, max_depth=10)   # bench.py:59, :228-231
ATLAS_SEED = 11


def synthetic_atlas(seed=ATLAS_SEED, h=512, w=1024):
    """An [h, w, 3] image texture at the size of the earth scene's
    ``earthmap.jpg`` (1024x512), from a fixed numpy seed (the reference's
    asset is not in the repository): seas and land from a few seeded waves
    over longitude and latitude, ice toward the poles, a little seeded
    noise, texels in [0, 1] as ``io/images.load_ldr`` gives them."""
    rng = np.random.default_rng(seed)
    lat = (np.arange(h) + 0.5) / h * np.pi
    lon = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    field = np.zeros((h, w))
    for _ in range(6):
        a, b = rng.integers(1, 6, 2)
        pa, pb = rng.uniform(0.0, 2.0 * np.pi, 2)
        field += np.sin(a * lon[None, :] + pa) * np.sin(b * lat[:, None] + pb)
    sea = np.array([0.08, 0.22, 0.55])
    land = np.array([0.35, 0.55, 0.22])
    data = np.where((field > 0.4)[..., None], land, sea)
    data[np.abs(lat - np.pi / 2) > 1.25] = (0.92, 0.94, 0.96)
    data = data * rng.uniform(0.9, 1.1, (h, w, 1))
    return np.clip(data, 0.0, 1.0).astype(np.float32)


def image_counts():
    return {"wavefront_fwd": cw.LAUNCHES, "wavefront_record": cw.LAUNCHES_RECORD,
            "wavefront_grad_fwd": cw.LAUNCHES_GRAD_FWD,
            "wavefront_grad_rev": cw.LAUNCHES_GRAD_REV,
            "sorted_segment_sums": cr.LAUNCHES_SEGMENT_SUMS,
            "row_sums": cr.LAUNCHES_ROW_SUMS, **intersect_counts()}


def reset_image_counts():
    cw.LAUNCHES = cw.LAUNCHES_RECORD = 0
    cw.LAUNCHES_GRAD_FWD = cw.LAUNCHES_GRAD_REV = 0
    cr.LAUNCHES_SEGMENT_SUMS = cr.LAUNCHES_ROW_SUMS = 0
    reset_intersect_counts()


def image_main_path(dev, atlas, out_dir):
    """The JAX bench's ``earth`` (400x225, 25 spp, depth 10) forward under
    the synthetic atlas through ``render_image``: the 'image' route (B1 on
    the white scene, then the sphere closest-hit kernel B7b and one gather a
    camera ray), three rounds, held to the standard integrator's picture of
    the same seed; the primary factor and B1 on the white scene alone at
    the render's chunk; then the scene's own camera (800x450, 100 spp,
    depth 50) once on the same route.  Returns (the scene, the bench
    camera, the last round's counts, the own camera's counts)."""
    scene, own_cam = builders.earth_scene(dev, image=atlas)
    cam = dataclasses.replace(own_cam, **EARTH_BENCH)
    w, h, spp = cam.image_width, cam.image_height, cam.samples_per_pixel
    n_rays = w * h * spp
    route = wavefront.choose_mega_mode(scene, cam, n_rays, False)
    if route != "image" or not wavefront.image_prefactor_ok(scene):
        raise RuntimeError(f"image_main_path: route {route}")
    grt.render_image(scene, cam, seed=0)   # warm-up
    taken = []
    for _ in range(3):
        stats = grt.RenderStats()
        reset_image_counts()
        ms, img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0, stats=stats))
        counts = image_counts()
        taken.append(ms)
    nch = stats.chunks
    want = {"wavefront_fwd": nch, "sphere_closest": nch, "planar_closest": 0,
            "planar_closest_attrs": 0, "sphere_closest_attrs": 0}
    if any(counts[k] != v for k, v in want.items()):
        raise RuntimeError(f"image_main_path: launches {counts} for {nch} chunks")
    grt.render_image(scene, cam, seed=0, mega_mode="off")   # warm-up
    std_stats = grt.RenderStats()
    reset_image_counts()
    std_ms, std_img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0, mega_mode="off",
                                                       stats=std_stats))
    std_counts = image_counts()
    share = image_share_outside(std_img, img)
    mean = float(img.mean())
    png = pathlib.Path(out_dir) / "chip_smoke_earth.png"
    grt.film.write_png(str(png), grt.film.to_uint8(img))
    # the parts of one chunk: B1 on the white scene, the primary factor
    # (B7b and the gather), B7b alone
    n_virt = w * h
    chunk = min(renderer.pick_chunk_size(scene) // n_virt, spp) * n_virt
    cam2, o, d, tm, stream, _, _ = renderer._chunk_rays(
        scene, cam, 0, 0, spp=spp, chunk=chunk, max_depth=cam.max_depth, device=dev)
    o, d, tm = V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)), \
        tm.contiguous()
    tb_white = cw.build_tables(wavefront._strip_image(scene))
    sid = cw.stream_to_i32(stream)
    b1_rounds, _ = rounds_ms(lambda: cw.wavefront_fwd(tb_white, o, d, tm, sid, 0,
                                                      cam.max_depth))
    factor_rounds, factor = rounds_ms(lambda: wavefront._primary_image_factor(scene, o, d, tm))
    t_max = torch.full_like(tm, cw.BIG)
    b7b_rounds, (_, _, hit) = rounds_ms(lambda: ck.sphere_closest(
        scene.spheres, o, d, tm, t_max, t_min=cw.EPS_HIT))
    hit_share = float(hit.float().mean())
    del o, d, tm, stream, sid, factor, t_max, hit
    # the scene's own camera, once
    own_n = own_cam.image_width * own_cam.image_height * own_cam.samples_per_pixel
    own_route = wavefront.choose_mega_mode(scene, own_cam, own_n, False)
    own_stats = grt.RenderStats()
    reset_image_counts()
    own_ms, own_img = cuda_ms(lambda: grt.render_image(scene, own_cam, seed=0,
                                                       stats=own_stats))
    own_counts = image_counts()
    own_mean = float(own_img.mean())
    ms = median(taken)
    emit("image_main_path", scene="earth", atlas=f"synthetic {atlas.shape[1]}x"
         f"{atlas.shape[0]}, seed {ATLAS_SEED}", width=w, height=h, spp=spp,
         depth=cam.max_depth, camera_rays=n_rays, route=route, chunks=nch,
         rays_per_chunk=chunk, launches=counts, render_ms_rounds=taken,
         render_ms_median=ms, camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
         b1_launches=counts["wavefront_fwd"], b1_white_ms_one_chunk=median(b1_rounds),
         primary_factor_ms_one_chunk=median(factor_rounds),
         primary_factor_ms_render=median(factor_rounds) * nch,
         sphere_closest_ms_one_chunk=median(b7b_rounds), primary_hit_share=hit_share,
         standard_render_ms=std_ms, standard_launches=std_counts,
         standard_camera_mrays_per_s=n_rays / (std_ms * 1e-3) / 1e6,
         pixel_share_outside_tolerance=share, rtol=IMAGE_RTOL, atol=IMAGE_ATOL,
         image_mean=mean, png=str(png),
         own_camera=dict(width=own_cam.image_width, height=own_cam.image_height,
                         spp=own_cam.samples_per_pixel, depth=own_cam.max_depth,
                         camera_rays=own_n, route=own_route, chunks=own_stats.chunks,
                         launches=own_counts, render_ms=own_ms,
                         camera_mrays_per_s=own_n / (own_ms * 1e-3) / 1e6,
                         image_mean=own_mean))
    if not torch.isfinite(img).all() or not 0.05 < mean < 0.95:
        raise RuntimeError(f"image_main_path: image mean {mean}")
    if std_counts["wavefront_fwd"] != 0 or std_counts["sphere_closest"] < 1:
        raise RuntimeError(f"image_main_path: standard integrator launches {std_counts}")
    if share >= MAX_PIXEL_SHARE_OUTSIDE:
        raise RuntimeError(f"image_main_path: {share:.4%} of pixel channels differ "
                           "between the 'image' route and the standard integrator")
    if own_route != "image" or own_counts["wavefront_fwd"] != own_stats.chunks \
            or own_counts["sphere_closest"] != own_stats.chunks:
        raise RuntimeError(f"image_main_path: own camera on {own_route}, launches "
                           f"{own_counts} for {own_stats.chunks} chunks")
    if not torch.isfinite(own_img).all() or not 0.05 < own_mean < 0.95:
        raise RuntimeError(f"image_main_path: own camera's image mean {own_mean}")
    return scene, cam, counts, own_counts


def image_fwd_bwd(scene, cam):
    """The JAX bench's ``earth-fwd-bwd`` (400x225, 25 spp, depth 10, pixel
    MSE against 0.8 x the render) through ``render_grad`` on the image tier
    (B2 and B3 on the white scene, the sphere kernel and the per-texel sums
    for the atlas): twice, the gradients' bits equal; the loss that of
    ``render``'s picture (rtol 1e-5); the over-budget route (``stash_budget=0``)
    the same loss and gradients (rtol 1e-5); and the replay tier on the same
    job within 2e-3 of each gradient's largest entry.  Returns (the timed
    call's counts, its chunks)."""
    spp, depth = cam.samples_per_pixel, cam.max_depth
    n_rays = cam.image_width * cam.image_height * spp
    tier = gradmod.grad_tier(scene, depth)
    if tier != "image":
        raise RuntimeError(f"image_fwd_bwd: tier {tier}")
    fb = grt.render(scene, cam, seed=0)
    target = fb / spp * 0.8
    loss_ref = float(torch.mean((fb / spp - target) ** 2))
    del fb
    first_loss, first = grt.render_grad(scene, cam, target, seed=0)   # also the warm-up
    stats = grt.RenderStats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_image_counts()
    ms, (loss, grads) = cuda_ms(lambda: grt.render_grad(scene, cam, target, seed=0,
                                                        stats=stats))
    counts = image_counts()
    peak = torch.cuda.max_memory_allocated()
    nch = stats.chunks
    n_stash = nch - counts["wavefront_fwd"]
    kchunk = gradmod._chunking(scene, cam, spp, None, renderer.pick_chunk_size(scene))[0]
    per_ray = gradmod.stash_bytes_per_ray(depth, image=True)
    want = {"wavefront_fwd": 0, "wavefront_grad_fwd": nch, "wavefront_grad_rev": nch,
            "sphere_closest": nch, "sorted_segment_sums": nch}
    if any(counts[k] != v for k, v in want.items()):
        raise RuntimeError(f"image_fwd_bwd: launches {counts} for {nch} chunks")
    loss_f = float(loss)
    if not loss_f == loss_f or abs(loss_f - loss_ref) > 1e-5 * loss_ref:
        raise RuntimeError(f"image_fwd_bwd: loss {loss_f} against {loss_ref} from render()")
    for key, g in grads.items():
        if not torch.isfinite(g).all():
            raise RuntimeError(f"image_fwd_bwd: gradient {key} is not finite")
    if float(grads["atlas"].abs().max()) == 0.0:
        raise RuntimeError("image_fwd_bwd: the atlas gradient is zero")
    same = {k: bool(torch.equal(grads[k], first[k])) for k in grads}
    same["loss"] = float(first_loss) == loss_f
    # the over-budget route: every chunk traced again in pass B
    reset_image_counts()
    ob_ms, (ob_loss, ob_grads) = cuda_ms(lambda: grt.render_grad(
        scene, cam, target, seed=0, stash_budget=0))
    ob_counts = image_counts()
    ob_err = {k: float((ob_grads[k] - grads[k]).abs().max())
              / max(float(grads[k].abs().max()), 1e-30) for k in grads}
    # the replay tier on the same job (the standard integrator records it)
    reset_image_counts()
    r_stats = grt.RenderStats()
    r_ms, (r_loss, r_grads) = cuda_ms(lambda: gradmod._render_grad_replay(
        scene, cam, target, spp=spp, max_depth=depth, seed=0, chunk=None, stats=r_stats,
        dec_budget=None))
    r_counts = image_counts()
    r_err = {k: float((r_grads[k] - grads[k]).abs().max())
             / max(float(r_grads[k].abs().max()), 1e-30) for k in grads}
    atlas = grads["atlas"]
    emit("image_fwd_bwd", scene="earth", width=cam.image_width, height=cam.image_height,
         spp=spp, depth=depth, camera_rays=n_rays, tier=tier, chunks=nch,
         rays_per_chunk=kchunk, launches=counts, render_grad_ms_cuda_events=ms,
         fwd_bwd_camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6, loss=loss_f,
         loss_from_render=loss_ref, n_stash=n_stash, stash_bytes_per_ray=per_ray,
         stash_bytes=n_stash * kchunk * per_ray, max_memory_allocated=peak,
         same_bits_two_calls=same,
         atlas_grad_abs_sum=float(atlas.abs().sum()),
         atlas_texels_nonzero=int((atlas.abs().amax(dim=-1) > 0).sum()),
         over_budget=dict(render_grad_ms=ob_ms, loss=float(ob_loss), launches=ob_counts,
                          grad_diff_of_largest=ob_err),
         replay=dict(render_grad_ms=r_ms, chunks=r_stats.chunks, loss=float(r_loss),
                     launches=r_counts, grad_diff_of_largest=r_err,
                     fwd_bwd_camera_mrays_per_s=n_rays / (r_ms * 1e-3) / 1e6))
    if not all(same.values()):
        raise RuntimeError(f"image_fwd_bwd: two render_grad calls differ: {same}")
    if abs(float(ob_loss) - loss_f) > 1e-5 * loss_f or max(ob_err.values()) > 1e-5 \
            or ob_counts["wavefront_fwd"] != nch or ob_counts["wavefront_grad_fwd"] != nch:
        raise RuntimeError(f"image_fwd_bwd: over budget, loss {float(ob_loss)} against "
                           f"{loss_f}, gradients off by {ob_err}, launches {ob_counts}")
    if abs(float(r_loss) - loss_f) > 1e-4 * loss_f or max(r_err.values()) > AUTOGRAD_RTOL_OF_LARGEST:
        raise RuntimeError(f"image_fwd_bwd: against the replay tier, loss {float(r_loss)} "
                           f"against {loss_f}, gradients off by {r_err}")
    return counts, nch


def image_standard(dev, atlas):
    """The Cornell box with the synthetic atlas as a picture on its back
    wall (``tests/test_torch_helpers.build_cornell_image``; outside the
    megakernel's gate and the image tier's) at Cornell's size (600x338, 100
    spp, depth 5) through the standard integrator's gather route: its
    picture, one chunk under ``torch.profiler`` (the device's busy share);
    then at 8 spp ``loss.backward()`` through ``render(differentiable=True)``
    twice and the replay tier twice, each pair with the same bits, the two
    routes' atlas gradients within 2e-3 of the largest entry.  Returns (the
    forward's counts, its chunks)."""
    from torch.profiler import ProfilerActivity, profile

    scene = th.build_cornell_image(grt, atlas, device=dev)
    cam = Camera(**{**th.CORNELL_IMAGE_CAM, "image_width": 600,
                    "aspect_ratio": 600 / 338, "samples_per_pixel": 100, "max_depth": 5})
    n_rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    route = wavefront.choose_mega_mode(scene, cam, n_rays, False)
    tier = gradmod.grad_tier(scene, cam.max_depth)
    if route != "off" or tier != "replay":
        raise RuntimeError(f"image_standard: route {route}, tier {tier}")
    grt.render_image(scene, cam, seed=0)   # warm-up
    taken, img, counts, stats, mega_launches = timed_renders(
        lambda st: grt.render_image(scene, cam, seed=0, stats=st), 2)
    mean = float(img.mean())
    per_chunk = cam.max_depth * stats.chunks
    if mega_launches != 0 or not (0 < counts["planar_closest"] <= 2 * per_chunk) \
            or counts["planar_closest_attrs"] != 0:
        raise RuntimeError(f"image_standard: launches {counts}, megakernel {mega_launches}")
    if not torch.isfinite(img).all() or not 0.02 < mean < 0.98:
        raise RuntimeError(f"image_standard: image mean {mean}")
    n_virt = cam.image_width * cam.image_height
    one = renderer.pick_chunk_size(scene) // n_virt
    plain_ms, _ = cuda_ms(lambda: grt.render(scene, cam, spp=one, seed=0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grt.render(scene, cam, spp=one, seed=0)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    # autograd and the replay tier at 8 spp
    a_cam = dataclasses.replace(cam, samples_per_pixel=8)
    target = grt.render(scene, a_cam, seed=1) / 8 * 0.8
    runs = []
    for _ in range(2):
        params = {k: v.clone().requires_grad_()
                  for k, v in grt.trainable_params(scene).items()}

        def run():
            fb = grt.render(grt.apply_params(scene, params), a_cam, seed=0,
                            differentiable=True)
            loss = torch.mean((fb / 8 - target) ** 2)
            loss.backward()
            return loss.detach()

        a_ms, a_loss = cuda_ms(run)
        runs.append((a_ms, params["atlas"].grad, float(a_loss)))
    reps = []
    for _ in range(2):
        r_stats = grt.RenderStats()
        reset_image_counts()
        r_ms, (r_loss, r_grads) = cuda_ms(lambda: grt.render_grad(scene, a_cam, target,
                                                                  seed=0, stats=r_stats))
        reps.append((r_ms, r_grads, float(r_loss), image_counts()))
    auto_bits = torch.equal(runs[0][1], runs[1][1])
    replay_bits = all(torch.equal(reps[0][1][k], reps[1][1][k]) for k in reps[0][1])
    big = float(reps[0][1]["atlas"].abs().max())
    diff = float((runs[0][1] - reps[0][1]["atlas"]).abs().max()) / max(big, 1e-30)
    ms = median(taken)
    emit("image_standard", scene="cornell-image", atlas=f"synthetic {atlas.shape[1]}x"
         f"{atlas.shape[0]}, seed {ATLAS_SEED}", width=cam.image_width,
         height=cam.image_height, spp=cam.samples_per_pixel, depth=cam.max_depth,
         camera_rays=n_rays, route=route, chunks=stats.chunks, launches=counts,
         render_ms_rounds=taken, render_ms_median=ms,
         camera_mrays_per_s=n_rays / (ms * 1e-3) / 1e6, image_mean=mean,
         profile=dict(rays=one * n_virt, render_ms_without_profiler=plain_ms,
                      device_ms=device_ms, device_busy_share=device_ms / plain_ms,
                      device_kernel_launches=sum(r[2] for r in rows),
                      top=[dict(name=r[0][:80], ms=r[1], calls=r[2]) for r in rows[:8]]),
         autograd=dict(spp=8, forward_backward_ms=[r[0] for r in runs],
                       loss=runs[0][2], atlas_same_bits=auto_bits,
                       atlas_texels_nonzero=int((runs[0][1].abs().amax(dim=-1) > 0).sum())),
         replay=dict(spp=8, render_grad_ms=[r[0] for r in reps], chunks=r_stats.chunks,
                     loss=reps[0][2], launches=reps[1][3], gradients_same_bits=replay_bits,
                     atlas_diff_to_autograd_of_largest=diff, largest_atlas_grad=big))
    if not (auto_bits and replay_bits):
        raise RuntimeError(f"image_standard: bits differ between runs: autograd "
                           f"{auto_bits}, replay {replay_bits}")
    if big == 0.0 or not torch.isfinite(runs[0][1]).all() or diff > AUTOGRAD_RTOL_OF_LARGEST \
            or abs(runs[0][2] - reps[0][2]) > 1e-4 * reps[0][2]:
        raise RuntimeError(f"image_standard: autograd against the replay tier: atlas off "
                           f"by {diff} of {big}, loss {runs[0][2]} against {reps[0][2]}")
    return counts, stats.chunks


def image_phases(dev, out_dir):
    """Image textures: ``earth`` forward and fwd+bwd at the JAX bench's size,
    the Cornell box with a picture.  Returns launches for the kernels line."""
    atlas = synthetic_atlas()
    emit("atlas", height=atlas.shape[0], width=atlas.shape[1], seed=ATLAS_SEED,
         mean=float(atlas.mean()), min=float(atlas.min()), max=float(atlas.max()))
    scene, cam, main, own = image_main_path(dev, atlas, out_dir)
    fwd_bwd, _ = image_fwd_bwd(scene, cam)
    std, _ = image_standard(dev, atlas)
    return {"wavefront_fwd": {"image_main_path": main["wavefront_fwd"],
                              "image_main_path_own_camera": own["wavefront_fwd"]},
            "wavefront_grad_fwd": {"image_fwd_bwd": fwd_bwd["wavefront_grad_fwd"]},
            "wavefront_grad_rev": {"image_fwd_bwd": fwd_bwd["wavefront_grad_rev"]},
            "sphere_closest": {"image_main_path": main["sphere_closest"],
                               "image_fwd_bwd": fwd_bwd["sphere_closest"]},
            "sphere_closest_attrs": {"image_main_path": main["sphere_closest_attrs"],
                                     "image_fwd_bwd": fwd_bwd["sphere_closest_attrs"]},
            "planar_closest": {"image_standard": std["planar_closest"]},
            "planar_closest_attrs": {"image_standard": std["planar_closest_attrs"]}}


def probe_phase(regs):
    """The probe's five variants: each against its plain version at 8
    blocks and at the defaults (t and id equal), then the CLI's own run
    (``stream_micro.run``, every variant at the defaults: one warm-up and
    three launches each) with its launches counted, and each variant's time
    beside its bound (55 float32 operations a test, 1,024 tests a block and
    sweep; the bytes: the rays, the tile rows the variant reads, the
    outputs; sweeponly: one test an output, then a compare and a select a
    sweep) and its plain version's.  Returns the probe's entry of the
    ``kernels`` line."""
    checks = {}
    for n_blocks in (8, PROBE_BLOCKS):
        rays, tri = sm.probe_inputs(n_blocks, "cuda")
        for variant in sm.VARIANTS:
            t, ids = sm.stream_micro(rays, tri, PROBE_SWEEPS, variant)
            plain_ms, (pt, pids) = cuda_ms(
                lambda: sm._stream_micro_plain(rays, tri, PROBE_SWEEPS, variant))
            equal = bool(torch.equal(t, pt) and torch.equal(ids, pids))
            checks[(n_blocks, variant)] = dict(
                equal=equal, hits=int((ids >= 0).sum()), plain_ms=plain_ms,
                max_abs_err=float(torch.where(t < 1e38, (t - pt).abs(), 0.0).max()))
            if not equal:
                raise RuntimeError(f"probe {variant} at {n_blocks} blocks differs from "
                                   "its plain version")
    sm.LAUNCHES = 0
    res = sm.run(PROBE_BLOCKS, PROBE_SWEEPS, "cuda")
    launches = sm.LAUNCHES
    variants = {}
    outputs = PROBE_BLOCKS * sm.GROUP * sm.LANES
    for variant, r in res.items():
        roll, dyn_tri, _ = sm.VARIANTS[variant]
        # sweeponly tests one ray against one triangle again and again: the
        # function needs that test once an output, then a compare and a
        # select a sweep (what the compiler makes of the loop-invariant test)
        per_output = r["sweeps"] // PROBE_BLOCKS
        ops = (float(outputs) * per_output * FLOPS_MOLLER_TRUMBORE if dyn_tri or roll
               else float(outputs) * (FLOPS_MOLLER_TRUMBORE + 2 * (per_output - 1)))
        moved = (PROBE_BLOCKS * sm.RAY_ROWS * sm.GROUP * sm.LANES * 4
                 + (sm.N_TILES if dyn_tri else 1) * 9 * sm.TILE * 4 + outputs * 8)
        bound = (moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3)
        variants[variant] = dict(
            ms=r["ms"], ns_per_sweep=r["ns_per_sweep"], sweeps=r["sweeps"],
            plain_ms=checks[(PROBE_BLOCKS, variant)]["plain_ms"],
            bound_ms=max(bound), bound_bytes_ms=bound[0], bound_ops_ms=bound[1],
            bound_by="bytes" if bound[0] >= bound[1] else "operations",
            roofline_share=max(bound) / r["ms"],
            hits=checks[(PROBE_BLOCKS, variant)]["hits"],
            registers=regs[variant][0], spill_bytes=regs[variant][1])
    emit("probe_stream_micro", blocks=PROBE_BLOCKS, sweeps=PROBE_SWEEPS,
         launches=launches, variants=variants,
         equal_to_plain={f"{v}@{b}": c["equal"] for (b, v), c in checks.items()})
    if launches != 4 * len(sm.VARIANTS):
        raise RuntimeError(f"probe: {launches} launches, expected {4 * len(sm.VARIANTS)}")
    full = variants["full"]
    return {"name": "stream_micro", "route": "cuda",
            "source": "go_raytracing_tpu_torch/csrc/stream_micro.cu",
            "replaces": "scripts/stream_micro.py:126 (pl.pallas_call in run)",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "ms": full["ms"], "ms_per_launch": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": None, "entry_variant": "full", "blocks": PROBE_BLOCKS,
            "sweeps": PROBE_SWEEPS, "variants": variants}


def resident_warps():
    """Warps an SM holds at once of ``mesh_stream`` and of the sphere kernels
    ({False: closest hit, True: any hit / with the attributes}), from the
    registers and shared memory of the build, and ``mesh_stream``'s shared
    bytes a block."""
    stream = {a: cm.stream_occupancy(a) for a in (False, True)}
    sphere = {a: ck.sphere_occupancy(a) for a in (False, True)}
    return ({a: b * t // 32 for a, (b, t, _) in stream.items()},
            {a: b * t // 32 for a, (b, t) in sphere.items()}, stream[False][2])


def all_rays(scene, cam):
    """Every camera ray of ``cam``'s job as one chunk (hdri-test's 9,000,000,
    as ``env_kernel_timing`` times B1 with the HDRI rows): (o, d, tm,
    stream)."""
    n = cam.image_width * cam.image_height * cam.samples_per_pixel
    _, o, d, tm, ids, _, _ = renderer._chunk_rays(
        scene, cam, 0, 0, spp=cam.samples_per_pixel, chunk=n, max_depth=cam.max_depth,
        device=scene.device)
    return (V3(*(c.contiguous() for c in o)), V3(*(c.contiguous() for c in d)),
            tm.contiguous(), cw.stream_to_i32(ids))


def brute_forward_timing(dev, env):
    """B1 below 64 spheres alone, by depth (1, 2, ... bounces) and on the
    same rays in stable order of path length, beside the render's order: at
    Cornell's chunk (600x338, 100 spp, depth 5) and at ``hdri-test-nee``'s
    9,000,000 rays (800x450, 25 spp, depth 10, its HDRI rows taken along), the route
    without marble; at perlin's forward chunk (400x225, 25 spp, depth 10),
    the route with marble.  Every launch's outputs are held to the plain
    version's bits (in path-length order: the render order's outputs taken
    in that order; by depth on Cornell and perlin).  Returns fields for
    B1's entry of the ``kernels`` line."""
    cornell, c0 = grt.load_scene("cornell", device=dev)
    ccam = dataclasses.replace(c0, image_width=600, aspect_ratio=600 / 338,
                               samples_per_pixel=100, max_depth=5)
    n = min(renderer.pick_chunk_size(cornell) // (600 * 338), 100) * 600 * 338
    nee, hcam = hdri_scene(dev, True, env)
    perlin, p0 = grt.load_scene("perlin", device=dev)
    pcam = dataclasses.replace(p0, image_width=PERLIN_BENCH["width"],
                               samples_per_pixel=PERLIN_BENCH["spp"],
                               max_depth=PERLIN_BENCH["depth"])
    fields = {}
    for name, scene, cam, rays, by_depth in (
            ("cornell", cornell, ccam, lambda: chunk_rays(ccam, n, 0, dev), True),
            ("hdri_test_nee", nee, hcam, lambda: all_rays(nee, hcam), False),
            ("perlin", perlin, pcam, lambda: render_chunk(perlin, pcam), True)):
        tb = cw.build_tables(scene)
        depth = cam.max_depth
        o, d, tm, sid = rays()
        rows = cw.hdri_rows_for(scene, sid, 0, depth) if cw.uses_hdri_nee(scene) else None

        def launch(k, o=o, d=d, tm=tm, sid=sid, rows=rows):
            return cw.wavefront_fwd(tb, o, d, tm, sid, 0, k,
                                    None if rows is None else rows[:k * cw.HDRI_ROWS])

        def plain_equal(k, out):
            p = cw._wavefront_fwd_plain(tb, o, d, tm, sid, 0, k,
                                        None if rows is None else rows[:k * cw.HDRI_ROWS])
            return all(bool(torch.equal(a, b)) for a, b in zip(out, p))

        launch(depth)
        render_rounds, out = rounds_ms(lambda: launch(depth), rounds=3, repeats=3)
        equal = plain_equal(depth, out)
        length = torch.ones_like(tm, dtype=torch.int64)
        ms_by_depth = []
        for k in range(1, depth + 1):
            ms, f = rounds_ms(lambda k=k: launch(k), rounds=3, repeats=2)
            ms_by_depth.append(median(ms))
            if by_depth:
                equal = equal and plain_equal(k, f)
            if k < depth:
                length += (f[1] & cw.FLAG_ALIVE) != 0
        order = torch.argsort(length, stable=True)
        o2, d2 = V3(*(c[order].contiguous() for c in o)), V3(*(c[order].contiguous() for c in d))
        tm2, sid2 = tm[order].contiguous(), sid[order].contiguous()
        rows2 = None if rows is None else rows[:, order].contiguous()
        len_rounds, out2 = rounds_ms(lambda: launch(depth, o2, d2, tm2, sid2, rows2),
                                     rounds=3, repeats=3)
        equal = equal and torch.equal(out2[0], out[0][:, order]) \
            and torch.equal(out2[1], out[1][order])
        route = cw.brute_route(tb)
        fields[name] = dict(
            route=route, rays=int(tm.shape[0]), depth=depth, hdri_rows=rows is not None,
            ms=median(render_rounds), ms_rounds=render_rounds, ms_by_depth=ms_by_depth,
            ms_path_length_order=median(len_rounds), ms_path_length_order_rounds=len_rounds,
            rays_by_path_length=torch.bincount(length, minlength=depth + 1).tolist(),
            bit_equal_plain=equal, resident_warps_per_sm=resident(cw.tracing_occupancy(
                "fwd_marble" if route == "marble" else "fwd", False, smem_of_tables(tb))))
        del o, d, tm, sid, rows, o2, d2, tm2, sid2, rows2, out, out2
        if not equal:
            raise RuntimeError(f"B1 ({route}) at {name}'s chunk differs from its plain "
                               f"version's bits")
    emit("b1_brute_timing", previous_design_ms_perf_md=PREVIOUS_DESIGN_MS["wavefront_fwd"],
         **fields)
    return {f"brute_{k}": {"route": v["route"], "ms": v["ms"], "ms_rounds": v["ms_rounds"],
                           "ms_by_depth": v["ms_by_depth"],
                           "ms_path_length_order": v["ms_path_length_order"]}
            for k, v in fields.items()}


def brute_routes(regs, dev):
    """The brute instantiations of B1 and B11 (``regs``: name -> (registers,
    spill bytes)), each with the warps an SM holds at once and the shared
    bytes a block takes at the tables of the scene that launches it in
    ``chip_smoke.py``'s timing (Cornell without marble, perlin with)."""
    tables = {False: cw.build_tables(grt.load_scene("cornell", device=dev)[0]),
              True: cw.build_tables(grt.load_scene("perlin", device=dev)[0])}
    out = {}
    for name, (r, spill) in regs.items():
        marble = name.endswith("marble")
        kernel = ("fwd" if name.startswith("b1") else "resume") + ("_marble" if marble else "")
        smem = smem_of_tables(tables[marble])
        out[name] = {"registers": r, "spill_bytes": spill, "scene": "perlin" if marble else
                     "cornell", "resident_warps_per_sm": resident(
                         cw.tracing_occupancy(kernel, False, smem)),
                     "shared_bytes_per_block": smem}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=str(_build.BUILD_DIR),
                    help="where the rendered PNG goes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device: this check runs on a GPU only")
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(0)
    name_and_limit = smi("name,power.limit")
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    emit("device", nvidia_smi=name_and_limit, name=props.name,
         sm_count=props.multi_processor_count, max_sm_clock_mhz=sm_clock_mhz,
         fp32_flops_from_properties=props.multi_processor_count * 128 * 2
         * sm_clock_mhz * 1e6,
         memory_gb=props.total_memory / 1e9, torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    (built, built_fma, built_grad, built_pw, built_ix, built_mesh,
     built_rows, built_fused, built_probe) = _build.load_all(
        [("wavefront", False), ("wavefront", True), ("wavefront_grad", False),
         ("wavefront_grad_pathwise", False), ("intersect", False), ("mesh", False),
         ("row_sums", False), ("wavefront_grad_fused", False), ("stream_micro", False)])

    def kernel_stats(lib, tag):
        (stats,) = [v for name, v in lib.kernels.items() if tag in name]
        return stats

    # forward_brute_kernel is the forward below 64 spheres (B1_BRUTE_TAG, and
    # B1_MARBLE_TAG in a scene with marble), wavefront_kernel<0, true> its
    # culled instantiation (64 spheres and more), <1, false> the
    # product-chain gradient forward, <3, true> the culled record, <2, false>
    # the pathwise gradient forward
    fwd_regs, fwd_spill = kernel_stats(built, B1_BRUTE_TAG)
    fwd_marble = kernel_stats(built, B1_MARBLE_TAG)
    fwd_cull_regs = kernel_stats(built, "wavefront_kernelILi0ELb1E")
    rec_regs = kernel_stats(built, "wavefront_kernelILi3ELb1E")
    rows_regs = kernel_stats(built_rows, "row_sums_kernel")
    gfwd_regs, gfwd_spill = kernel_stats(built, B2_TAG)
    gfwd_marble = kernel_stats(built, B2_MARBLE_TAG)
    pfwd_regs, pfwd_spill = kernel_stats(built, "wavefront_kernelILi2ELb0E")
    # <4>: the pathwise gradient forward of a scene with marble (20 rows)
    pfwd_marble = kernel_stats(built, "wavefront_kernelILi4ELb0E")
    grev_regs, grev_spill = kernel_stats(built_grad, "wavefront_grad_rev_kernel")
    # the pathwise reverse kernel: <19> a stash of 19 float rows a bounce,
    # <20> of a scene with marble (dmarble/dp compiled in); the fused
    # kernel: <19>, and <22> in a scene with marble (dmarble/dp stashed)
    # <19> without marble: the tiles, a column of sums a lane (and, above
    # the accumulators that fit, the design it shares with <20>, a row a warp)
    prev_regs, prev_spill = kernel_stats(built_pw, B5B_LANE_TAG)
    prev_warp = kernel_stats(built_pw, B5B_WARP_TAG)
    prev_marble = kernel_stats(built_pw, "wavefront_grad_rev_pathwise_kernelILi20E")
    fused_regs = kernel_stats(built_fused, "wavefront_grad_fused_kernelILi19E")
    fused_marble = kernel_stats(built_fused, "wavefront_grad_fused_kernelILi22E")
    unchanged = {tag: kernel_stats(built_fused if "grad_fused" in tag
                                   else built_ix if "sphere_kernel" in tag else built, tag)
                 for tag in UNCHANGED_KERNELS}
    # stream_micro_kernel<roll, dynamic tile, bit scan>: the probe's variants
    probe_regs = {v: kernel_stats(built_probe, "stream_micro_kernelILb{}ELb{}ELb{}E".format(
        *(int(f) for f in flags))) for v, flags in sm.VARIANTS.items()}
    resume_brute = kernel_stats(built, B11_BRUTE_TAG)
    resume_regs = kernel_stats(built, B11_MARBLE_TAG)   # perlin's split: marble
    resume_cull_regs = kernel_stats(built, "wavefront_resume_kernelILb1E")
    seg_regs = kernel_stats(built_rows, "sorted_segment_sums_kernel")
    # the planar kernels' gated instantiations (PLANAR_TAGS) and sphere_kernel
    # <false> / <true>: closest hit alone, and with the winner's attributes
    ix_stats = {name: kernel_stats(built_ix, tag) for name, tag in (
        *PLANAR_TAGS.items(),
        ("sphere_closest", "sphere_kernelILb0E"),
        ("sphere_closest_attrs", "sphere_kernelILb1E"))}
    planar_all = {re.search(r"planar_kernelI\w*?E(?=EEv)", n).group(0): v
                  for n, v in built_ix.kernels.items() if "planar_kernel" in n}
    # mesh_sweep_kernel<false> / <true> and mesh_stream_kernel<false> / <true>:
    # closest hit and any hit
    mesh_stats = {name: kernel_stats(built_mesh, tag) for name, tag in (
        ("mesh_sweep", "mesh_sweep_kernelILb0E"),
        ("mesh_sweep_any_hit", "mesh_sweep_kernelILb1E"),
        ("mesh_stream", "mesh_stream_kernelILb0E"),
        ("mesh_stream_any_hit", "mesh_stream_kernelILb1E"))}
    stream_warps, sphere_warps, stream_smem = resident_warps()
    routes = brute_routes({"b1_brute": (fwd_regs, fwd_spill), "b1_brute_marble": fwd_marble,
                           "b11_brute": resume_brute, "b11_brute_marble": resume_regs}, dev)
    emit("build", seconds=time.perf_counter() - t0, kernels=16,
         kernels_note="fifteen ports of TPU kernels (the probe of the mesh stream "
                      "among them) and the row-sum kernel of take_rows' backward "
                      "pass (not a port; its file also holds the sorted segment "
                      "sums of the environment's texels)",
         nvcc_seconds=[b.build_seconds for b in (built, built_fma, built_grad, built_pw,
                                                 built_ix, built_mesh, built_rows,
                                                 built_fused, built_probe)],
         libraries=[built.path.name, built_grad.path.name, built_pw.path.name,
                    built_ix.path.name, built_mesh.path.name, built_rows.path.name,
                    built_fused.path.name, built_probe.path.name],
         fused_registers=fused_regs[0], fused_spill_bytes=fused_regs[1],
         fused_marble_registers=fused_marble[0], fused_marble_spill_bytes=fused_marble[1],
         grad_fwd_pathwise_marble_registers=pfwd_marble[0],
         grad_fwd_pathwise_marble_spill_bytes=pfwd_marble[1],
         grad_rev_pathwise_marble_registers=prev_marble[0],
         grad_rev_pathwise_marble_spill_bytes=prev_marble[1],
         grad_rev_pathwise_warp_sums_registers=prev_warp[0],
         grad_rev_pathwise_warp_sums_spill_bytes=prev_warp[1],
         probe_registers={k: v[0] for k, v in probe_regs.items()},
         probe_spill_bytes={k: v[1] for k, v in probe_regs.items()},
         resume_registers=resume_regs[0], resume_spill_bytes=resume_regs[1],
         resume_culled_registers=resume_cull_regs[0],
         resume_culled_spill_bytes=resume_cull_regs[1],
         culled_registers=fwd_cull_regs[0], culled_spill_bytes=fwd_cull_regs[1],
         segment_sums_registers=seg_regs[0], segment_sums_spill_bytes=seg_regs[1],
         record_registers=rec_regs[0], record_spill_bytes=rec_regs[1],
         row_sums_registers=rows_regs[0], row_sums_spill_bytes=rows_regs[1],
         intersect_registers={k: v[0] for k, v in ix_stats.items()},
         intersect_spill_bytes={k: v[1] for k, v in ix_stats.items()},
         planar_registers_and_spills_every_instantiation=planar_all,
         mesh_registers={k: v[0] for k, v in mesh_stats.items()},
         mesh_spill_bytes={k: v[1] for k, v in mesh_stats.items()},
         mesh_stream_resident_warps_per_sm=stream_warps[False],
         mesh_stream_any_hit_resident_warps_per_sm=stream_warps[True],
         mesh_stream_shared_bytes_per_block=stream_smem,
         sphere_resident_warps_per_sm=sphere_warps[False],
         sphere_attrs_resident_warps_per_sm=sphere_warps[True],
         registers=fwd_regs, spill_bytes=fwd_spill,
         registers_with_fma=kernel_stats(built_fma, B1_BRUTE_TAG)[0],
         brute_routes=routes,
         grad_fwd_registers=gfwd_regs, grad_fwd_spill_bytes=gfwd_spill,
         grad_rev_registers=grev_regs, grad_rev_spill_bytes=grev_spill,
         grad_fwd_pathwise_registers=pfwd_regs,
         grad_fwd_pathwise_spill_bytes=pfwd_spill,
         grad_rev_pathwise_registers=prev_regs,
         grad_rev_pathwise_spill_bytes=prev_spill,
         unchanged_kernels={tag: {"registers": v[0], "spill_bytes": v[1],
                                  "perf_md": UNCHANGED_KERNELS[tag]}
                            for tag, v in unchanged.items()},
         ptxas=[l for b in (built, built_grad, built_pw, built_ix, built_mesh, built_rows,
                           built_fused, built_probe)
                for l in b.log.splitlines()
                if "ptxas info" in l and ("Used" in l or "spill" in l)])
    moved = {tag: v for tag, v in unchanged.items() if v != UNCHANGED_KERNELS[tag]}
    if moved:
        raise RuntimeError(f"kernels that must not change report other registers or "
                           f"spills than PERF.md's: {moved}")

    # ---- kernel against plain version -----------------------------------------
    m_scene, m_cam = mixed_scene(dev)
    mismatch_mixed, err_mixed = compare(m_scene, m_cam, 2, "mixed")
    scene, cam0 = grt.load_scene("cornell")
    c_cam = dataclasses.replace(cam0, image_width=64, aspect_ratio=1.0,
                                samples_per_pixel=4, max_depth=5)
    mismatch_cornell, err_cornell = compare(scene, c_cam, 3, "cornell")
    # ~700 spheres: 64 KB of tables, which the kernel then reads from device
    # memory instead of shared memory (the other scenes fit in shared memory)
    r_scene, r_cam = grt.load_scene("random", grid=(-14, 14, -14, 14))
    r_cam = dataclasses.replace(r_cam, image_width=64, aspect_ratio=1.0,
                                samples_per_pixel=1, max_depth=4)
    mismatch_random, err_random = compare(r_scene, r_cam, 4, "random_700_spheres")

    # ---- the gradient kernels against plain versions and autograd -----------------
    grad_checks = [compare_grad(scene, c_cam, 3, "cornell")]
    s_scene, s_cam = grt.load_scene("cornell-smoke")
    s_cam = dataclasses.replace(s_cam, image_width=64, aspect_ratio=1.0,
                                samples_per_pixel=4, max_depth=5)
    grad_checks.append(compare_grad(s_scene, s_cam, 5, "cornell-smoke"))
    grad_checks.append(compare_grad(*checker_sky_scene(dev), 6, "checker_sky"))
    # marble (no gradient of its own: its winners take the null slot) beside a
    # solid sphere and a light, against autograd
    grad_checks.append(compare_grad(*marble_scene(dev), 13, "marble_solid"))

    # ---- the pathwise gradient kernels against their plain versions ----------------
    g_scene, g_cam0 = grt.load_scene("cornell-glossy")
    g_small = dataclasses.replace(g_cam0, image_width=64, aspect_ratio=1.0,
                                  samples_per_pixel=4, max_depth=5)
    pw_checks = [compare_pathwise(g_scene, g_small, 7, "cornell-glossy"),
                 compare_pathwise(*glossy_sky_scene(dev), 8, "glossy_sky_volume"),
                 compare_pathwise(m_scene, m_cam, 9, "mixed"),
                 # more accumulators than B5b <19> sums a column a lane: its warp sums
                 compare_pathwise(th.build_many_textures(grt, device=dev), dataclasses.replace(
                     Camera(**th.MANY_TEXTURES_CAM), image_width=64), 10, "many_textures")]
    if {c[3] for c in pw_checks} != {True, False}:
        raise RuntimeError("B5b <19>'s two routes did not both run in the pathwise checks")
    b5b_lanes_err = b5b_marble_lanes(dev)

    # ---- the closest-hit kernels against their plain versions ----------------------
    ix_scene, ix_cam = intersect_scene(dev)
    ix_checks = [compare_intersect(ix_scene, *scattered_rays(ix_cam, 16384, 11, dev),
                                   "mixed_four_planar_kinds")]

    # ---- the record kernel against B1, its plain version, the standard record --
    rec_checks = []
    for name, sc, cm_, seed in (("mixed", m_scene, m_cam, 2), ("cornell", scene, c_cam, 3)):
        o, d, tm, sid = chunk_rays(cm_, 16384, seed, dev)
        rec_checks.append(compare_record(name, sc, cm_, o, d, tm, sid.long(), seed))
    rr_scene, rr_cam = grt.load_scene("random")
    rr_cam = dataclasses.replace(rr_cam, image_width=600, aspect_ratio=16 / 9,
                                 samples_per_pixel=25, max_depth=10)
    rr_cam2, o, d, tm, ids, _, _ = renderer._chunk_rays(
        rr_scene, rr_cam, 0, 4, spp=25, chunk=16384, max_depth=10, device=dev)
    rec_checks.append(compare_record(
        "random_camera_rays", rr_scene, rr_cam2, V3(*(c.contiguous() for c in o)),
        V3(*(c.contiguous() for c in d)), tm.contiguous(), ids, 4))
    del o, d, tm, ids
    culled_sweep_sets(dev)

    # ---- main path at full size ------------------------------------------------
    cam = dataclasses.replace(cam0, image_width=600, aspect_ratio=600 / 338,
                              samples_per_pixel=100, max_depth=5)
    n_camera_rays = cam.image_width * cam.image_height * cam.samples_per_pixel
    grt.render_image(scene, cam, seed=0)  # warm-up
    stats = grt.RenderStats()
    cw.LAUNCHES = 0
    t0 = time.perf_counter()
    render_ms, img = cuda_ms(lambda: grt.render_image(scene, cam, seed=0, stats=stats))
    wall = time.perf_counter() - t0
    launches = cw.LAUNCHES
    if launches != stats.chunks or launches < 1:
        raise RuntimeError(f"{launches} kernel launches for {stats.chunks} chunks")
    h, w = cam.image_height, cam.image_width
    if img.device.type != "cuda" or tuple(img.shape) != (h, w, 3):
        raise RuntimeError(f"image {tuple(img.shape)} on {img.device}")
    if not torch.isfinite(img).all():
        raise RuntimeError("image is not finite")
    mean = float(img.mean())
    left = img[:, : w // 3].mean(dim=(0, 1)).tolist()
    right = img[:, -(w // 3):].mean(dim=(0, 1)).tolist()
    if not 0.05 < mean < 0.95:
        raise RuntimeError(f"image mean {mean} outside (0.05, 0.95)")
    if not (left[1] > left[0] and right[0] > right[1]):
        raise RuntimeError(f"walls: left third {left}, right third {right}: "
                           "expected a green left and a red right wall")
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    png = out_dir / "chip_smoke_cornell.png"
    grt.film.write_png(str(png), grt.film.to_uint8(img))
    emit("main_path", scene="cornell", width=w, height=h, spp=100, depth=5,
         camera_rays=n_camera_rays, chunks=stats.chunks, launches=launches,
         render_ms_cuda_events=render_ms, wall_seconds=wall,
         camera_mrays_per_s=n_camera_rays / (render_ms * 1e-3) / 1e6,
         image_mean=mean, left_third_rgb=left, right_third_rgb=right,
         png=str(png))

    # ---- the kernel alone, at the main path's shapes ---------------------------
    n_virt = w * h
    chunk = min(renderer.pick_chunk_size(scene) // n_virt, 100) * n_virt
    tb = cw.build_tables(scene)
    gen_ms, (o, d, tm, sid) = cuda_ms(lambda: chunk_rays(cam, chunk, 0, dev))
    kargs = (tb, o, d, tm, sid, 0, cam.max_depth)
    cw.wavefront_fwd(*kargs)
    kernel_ms, (k_rows, k_flags) = cuda_ms(lambda: cw.wavefront_fwd(*kargs), repeats=5)
    fma_ms, _ = cuda_ms(lambda: cw._wavefront_fwd_cuda(*kargs, fmad=True), repeats=5)
    kernel_ms2, _ = cuda_ms(lambda: cw.wavefront_fwd(*kargs), repeats=5)
    plain_ms, (p_rows, p_flags) = cuda_ms(lambda: cw._wavefront_fwd_plain(*kargs))
    # B1 brute is held to its plain version bit for bit on the whole chunk
    good = (k_rows == p_rows).all(dim=0) & (k_flags == p_flags)
    mismatch_full = 1.0 - float(good.float().mean())
    max_err_full = float((k_rows - p_rows).abs().max())
    if mismatch_full != 0.0:
        raise RuntimeError(f"full-size chunk: {mismatch_full:.4%} of rays differ in their bits")
    del p_rows, p_flags, k_rows, k_flags

    # rays entering bounce k = rays still alive after k bounces (depth-k launch)
    entering = [chunk]
    for k in range(1, cam.max_depth):
        _, f = cw.wavefront_fwd(tb, o, d, tm, sid, 0, k)
        entering.append(int(((f & cw.FLAG_ALIVE) != 0).sum()))
    per_bounce = (tb.n_planar * FLOPS_PLANAR + tb.n_sphere * FLOPS_SPHERE
                  + tb.n_vol * FLOPS_VOLUME + FLOPS_SHADE)
    flops = float(sum(entering)) * per_bounce
    table_bytes = 4 * sum(t.numel() for t in (tb.pt, tb.st, tb.vt, tb.lt))
    moved = 18 * 4 * chunk + table_bytes
    bound_bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    emit("kernel_timing", rays_per_launch=chunk, kernel_ms=kernel_ms,
         kernel_ms_second_round=kernel_ms2, kernel_ms_with_fma=fma_ms,
         plain_ms=plain_ms, generate_rays_ms=gen_ms,
         kernel_share_of_render=kernel_ms * launches / render_ms,
         rays_entering_bounce=entering, flops_counted=flops, bytes_counted=moved,
         bound_bytes_ms=bound_bytes_ms, bound_ops_ms=bound_ops_ms,
         roofline_share=bound_ms / kernel_ms,
         kernel_mrays_per_s=chunk / (kernel_ms * 1e-3) / 1e6,
         mismatch_share_full_chunk=mismatch_full)

    # ---- the other ported scenes of the JAX package's bench, for the record ----
    other_launches = {}
    for name, width, aspect, spp, depth in (("simple", 400, 16 / 9, 10, 10),
                                            ("random", 600, 16 / 9, 25, 10),
                                            ("cornell-smoke", 600, 1.0, 25, 5)):
        sc, cm = grt.load_scene(name)
        cm = dataclasses.replace(cm, image_width=width, aspect_ratio=aspect,
                                 samples_per_pixel=spp, max_depth=depth)
        grt.render_image(sc, cm, seed=0)
        st = grt.RenderStats()
        cw.LAUNCHES = 0
        ms, im = cuda_ms(lambda: grt.render_image(sc, cm, seed=0, stats=st))
        other_launches[name] = cw.LAUNCHES
        if not torch.isfinite(im).all() or not 0.02 < float(im.mean()) < 0.98:
            raise RuntimeError(f"{name}: image mean {float(im.mean())}")
        if other_launches[name] != st.chunks:
            raise RuntimeError(f"{name}: {other_launches[name]} B1 launches for "
                               f"{st.chunks} chunks")
        n = cm.image_width * cm.image_height * spp
        emit("other_scene", scene=name, width=width, height=cm.image_height,
             spp=spp, depth=depth, camera_rays=n, chunks=st.chunks,
             launches=other_launches[name],
             tiled=renderer.scene_tiled(sc), render_ms_cuda_events=ms,
             camera_mrays_per_s=n / (ms * 1e-3) / 1e6, image_mean=float(im.mean()))

    # ---- the gradient main path, and its two kernels alone ------------------------
    grad_launches = grad_main_path(scene, cam)
    grad_entries = grad_kernel_timing(scene, (o, d, tm, sid), cam, entering,
                                      grad_launches, grad_checks)
    del o, d, tm, sid

    # ---- the pathwise main path (cornell-glossy), and its two kernels alone ------
    g_cam = dataclasses.replace(g_cam0, image_width=600, aspect_ratio=1.0,
                                samples_per_pixel=100, max_depth=5)
    pw_launches = pathwise_main_path(g_scene, g_cam)
    pw_entries = pathwise_kernel_timing(g_scene, g_cam, pw_launches, pw_checks)

    o, d, tm, sid = chunk_rays(cam, chunk, 0, dev)
    kargs = (tb, o, d, tm, sid, 0, cam.max_depth)
    kernel_ms3, _ = cuda_ms(lambda: cw.wavefront_fwd(*kargs), repeats=5)
    fwd_rounds = [kernel_ms, kernel_ms2, kernel_ms3]
    emit("forward_kernel_again", kernel_ms=kernel_ms3, rounds=fwd_rounds,
         median_ms=median(fwd_rounds))

    del o, d, tm, sid

    # ---- the standard integrator: main path, outside the gate, autograd ---------
    std_counts, std_ms, std_chunks = standard_main_path(scene, cam, img, render_ms)
    fog_counts = standard_outside_gate(dev)
    a_cam = dataclasses.replace(cam, samples_per_pixel=8)
    autograd_bits = [standard_autograd("cornell", scene, a_cam),
                     standard_autograd("cornell-glossy", g_scene, dataclasses.replace(
                         g_cam0, image_width=600, aspect_ratio=600 / 338,
                         samples_per_pixel=8, max_depth=5))]

    # ---- the four closest-hit kernels alone, at their main paths' chunks ---------
    o, d, tm, _ = chunk_rays(cam, chunk, 0, dev)
    r_scene, r_cam = grt.load_scene("random")
    r_cam = dataclasses.replace(r_cam, image_width=600, aspect_ratio=16 / 9,
                                samples_per_pixel=25, max_depth=10)
    _, _, r_virt = renderer.ray_layout(r_cam.image_width, r_cam.image_height,
                                       renderer.scene_tiled(r_scene))
    r_chunk = min(renderer.pick_chunk_size(r_scene) // r_virt, 25) * r_virt
    _, ro, rd, rtm, _, _, _ = renderer._chunk_rays(
        r_scene, r_cam, 0, 0, spp=25, chunk=r_chunk, max_depth=10, device=dev)
    ix_entries = intersect_kernel_timing(
        [("cornell", scene, o, d, tm, ("planar_closest", "planar_closest_attrs")),
         ("random", r_scene, V3(*(c.contiguous() for c in ro)),
          V3(*(c.contiguous() for c in rd)), rtm.contiguous(),
          ("sphere_closest", "sphere_closest_attrs"))],
        {"planar_closest": std_counts["planar_closest"],
         "planar_closest_attrs": std_counts["planar_closest_attrs"],
         "sphere_closest": fog_counts["sphere_closest"],
         "sphere_closest_attrs": fog_counts["sphere_closest_attrs"]},
        ix_checks)
    del o, d, tm, ro, rd, rtm
    path = planar_path_timing(scene, cam)
    for e in ix_entries:
        e["registers"], e["spill_bytes"] = ix_stats[e["name"]]
        if e["name"].startswith("sphere"):
            e["resident_warps_per_sm"] = sphere_warps[e["name"].endswith("attrs")]
        else:
            blocks, threads = ck.planar_occupancy(e["name"].endswith("attrs"))
            e["resident_warps_per_sm"] = blocks * threads // 32
            e.update(path[e["name"]])
    by_name = {e["name"]: e for e in ix_entries}
    kernels_ms = (by_name["planar_closest_attrs"]["ms"] * std_counts["planar_closest_attrs"]
                  + by_name["planar_closest"]["ms"] * std_counts["planar_closest"])
    path_ms = std_chunks * sum(f["path_ms_sum"] for f in path.values())
    emit("standard_split", scene="cornell", chunks=std_chunks,
         render_ms_median=std_ms, closest_hit_kernels_ms_at_full_chunk=kernels_ms,
         kernels_share_of_render_at_most=kernels_ms / std_ms,
         closest_hit_kernels_ms_on_the_path_launches=path_ms,
         kernels_share_of_render=path_ms / std_ms,
         note="at_full_chunk: every launch timed as one with every ray alive; "
              "on_the_path_launches: one chunk's own launches (planar_path_timing) "
              "times the chunks")
    profile_standard_chunk(scene, cam)

    # ---- instanced meshes: cornell-lucy through mesh_sweep and mesh_stream ------
    mesh_entries = mesh_phases(dev, {
        "mesh_sweep": {"registers": mesh_stats["mesh_sweep"][0],
                       "spill_bytes": mesh_stats["mesh_sweep"][1],
                       "any_hit_registers": mesh_stats["mesh_sweep_any_hit"][0],
                       "any_hit_spill_bytes": mesh_stats["mesh_sweep_any_hit"][1]},
        "mesh_stream": {"registers": mesh_stats["mesh_stream"][0],
                        "spill_bytes": mesh_stats["mesh_stream"][1],
                        "any_hit_registers": mesh_stats["mesh_stream_any_hit"][0],
                        "any_hit_spill_bytes": mesh_stats["mesh_stream_any_hit"][1],
                        "resident_warps_per_sm": stream_warps[False]}})

    # ---- the replay tier: random and cornell-lucy at full size -----------------
    rr_counts, rr_chunks, rr_bits = replay_main_path(
        "replay_random_fwd_bwd", "random", rr_scene, rr_cam, rounds=3)
    if rr_counts["wavefront_record"] != rr_chunks or rr_counts["wavefront_fwd"] != 0:
        raise RuntimeError(f"replay_random_fwd_bwd: launches {rr_counts} for "
                           f"{rr_chunks} chunks")
    profile_replay_chunk(rr_scene, rr_cam)
    lucy, lucy_cam = lucy_scene((256, 220), dev)
    lu_counts, lu_chunks, lu_bits = replay_main_path(
        "replay_lucy_fwd_bwd", "cornell-lucy", lucy, lucy_cam, rounds=2)
    if lu_counts["mesh_stream"] < 1 or lu_counts["planar_closest"] < 1 \
            or lu_counts["wavefront_record"] != 0:
        raise RuntimeError(f"replay_lucy_fwd_bwd: launches {lu_counts}")
    del lucy
    rc_cam, ro, rd, rtm, rsid = replay_chunk_rays(rr_scene, rr_cam)
    rec_entry = record_kernel_timing(
        [("random", rr_scene, rc_cam, (ro, rd, rtm, rsid)),
         ("cornell", scene, cam, chunk_rays(cam, chunk, 0, dev))],
        rr_counts["wavefront_record"], rec_checks, rec_regs)
    del ro, rd, rtm, rsid
    # the card's speed: three kernels that keep their design beside the
    # times PERF.md section 6 gives them
    grad_by_name = {e["name"]: e for e in grad_entries}
    yard = {name: (ms, CARD_YARDSTICK[name]) for name, ms in (
        ("sphere_closest", by_name["sphere_closest"]["ms"]),
        ("wavefront_grad_rev", grad_by_name["wavefront_grad_rev"]["ms"]),
        ("wavefront_record", rec_entry["ms"]))}
    emit("card_yardstick", note="ms of three kernels at the shapes of PERF.md "
         "section 6, beside the times recorded there",
         **{name: {"ms": ms, "perf_md_ms": ref, "ratio": ms / ref}
            for name, (ms, ref) in yard.items()})
    b1_random = forward_random_timing(rr_scene, rr_cam, other_launches["random"],
                                      fwd_cull_regs)
    small = dict(image_width=32, aspect_ratio=1.0, samples_per_pixel=2, max_depth=3)
    for name, make in (("cornell-lucy", lambda dv: lucy_scene((48, 40), dv)[0]),
                       ("random", lambda dv: grt.load_scene("random", device=dv)[0])):
        sc = make(dev)
        sc_cam = dataclasses.replace(grt.load_scene(name, device="cpu")[1], **small)
        replay_check(name, sc, make("cpu"), sc_cam)
    rows = row_sums_check()
    emit("row_sums_kernel", name="row_sums", route="cuda",
         source="go_raytracing_tpu_torch/csrc/row_sums.cu", replaces=None,
         note="take_rows' backward pass in a fixed order (ROADMAP C7); not a port "
              "of a TPU kernel, so not in the kernels line",
         launches_replay_random=rr_counts["row_sums"],
         launches_replay_lucy=lu_counts["row_sums"], registers=rows_regs[0],
         spill_bytes=rows_regs[1], shapes=rows)
    # ---- environments: hdri-test and hdri-test-nee at the JAX bench's size ------
    b4_entry, b1_env, b5b_env, _ = env_phases(dev, out_dir)

    # ---- marble textures and the resumable kernel: perlin, split, compact --------
    b11_entry, b1_marble, (b2_noise, b3_noise) = marble_and_split_phases(
        dev, out_dir, synthetic_sky()[0], resume_regs, resume_cull_regs)
    # B11's entry is perlin's (its marble instantiation); without marble:
    b11_entry["registers_no_marble"], b11_entry["spill_bytes_no_marble"] = resume_brute
    grad_entries[0]["launches_noise_fwd_bwd"] = b2_noise
    grad_entries[1]["launches_noise_fwd_bwd"] = b3_noise

    # ---- B1 below 64 spheres alone: by depth, in path-length order, each route --
    b1_brute = brute_forward_timing(dev, synthetic_sky()[0])

    # ---- marble behind metal and glass: the pathwise and fused tiers ----------
    b5a_marble, b5b_marble, b4_marble, warps = marble_grad_phases(
        dev, synthetic_sky()[0], {"b5a": pfwd_marble, "b5b": prev_marble,
                                  "b4": fused_marble, "b5a_2": (pfwd_regs, pfwd_spill),
                                  "b4_19": fused_regs, "b5b_19": (prev_regs, prev_spill),
                                  "b5b_19_warp": prev_warp, "b2": (gfwd_regs, gfwd_spill),
                                  "b2_marble": gfwd_marble, "b6": rec_regs},
        (g_scene, g_cam), rr_scene, scene)
    b4_entry["registers"], b4_entry["spill_bytes"] = fused_regs
    b4_entry["resident_warps_per_sm"] = warps["b4_19"]
    pw_entries[0]["registers"], pw_entries[0]["spill_bytes"] = pfwd_regs, pfwd_spill
    pw_entries[0]["resident_warps_per_sm"] = warps["b5a_2"]
    pw_entries[1]["registers"], pw_entries[1]["spill_bytes"] = prev_regs, prev_spill
    pw_entries[1]["registers_warp_sums"], pw_entries[1]["spill_bytes_warp_sums"] = prev_warp
    pw_entries[1]["resident_warps_per_sm"] = warps["b5b_19"]
    pw_entries[1]["err_of_largest_marble_lanes"] = b5b_lanes_err
    rec_entry["resident_warps_per_sm"] = warps["b6"]
    grad_entries[0]["registers"], grad_entries[0]["spill_bytes"] = gfwd_regs, gfwd_spill
    grad_entries[0]["resident_warps_per_sm"] = warps["b2"]
    grad_entries[0]["registers_marble"], grad_entries[0]["spill_bytes_marble"] = gfwd_marble
    grad_entries[0]["resident_warps_per_sm_marble"] = warps["b2_marble"]
    grad_entries[1]["registers"], grad_entries[1]["spill_bytes"] = grev_regs, grev_spill
    grad_entries[1]["resident_warps_per_sm"] = resident(cw.grad_rev_occupancy(
        9 * int(scene.textures.color.shape[0])))

    # ---- image textures: earth forward and fwd+bwd, a picture in the Cornell box --
    image_launches = image_phases(dev, out_dir)
    for e in (*grad_entries, *ix_entries):
        if e["name"] in image_launches:
            e["launches_image_paths"] = image_launches[e["name"]]

    # ---- the tile-sweep probe of the mesh stream --------------------------------
    probe_entry = probe_phase(probe_regs)

    emit("grad_bit_stable", autograd_same_bits=autograd_bits,
         replay_render_grad_same_bits={"random": rr_bits, "cornell-lucy": lu_bits})
    if not (all(autograd_bits) and rr_bits and lu_bits):
        raise RuntimeError("gradients differ in their bits from run to run")

    # B1's time at Cornell's chunk: the median of its early rounds and of
    # b1_brute_timing's, so that a spell of a slow host (which stalls the
    # launches of one round) does not set it
    fwd_all_rounds = fwd_rounds + b1_brute["brute_cornell"]["ms_rounds"]
    print(json.dumps({"kernels": [{
        "name": "wavefront_fwd",
        "route": "cuda",
        "source": "go_raytracing_tpu_torch/csrc/wavefront.cu",
        "replaces": "go_raytracing_tpu/ops/pallas_wavefront.py:1822 (_call)",
        "launches": launches,
        "max_abs_err": max(err_mixed, err_cornell, err_random, max_err_full),
        "mismatch_share": max(mismatch_mixed, mismatch_cornell, mismatch_random,
                              mismatch_full),
        "ms": median(fwd_all_rounds),
        "ms_per_launch": median(fwd_all_rounds),
        "ms_rounds": fwd_all_rounds,
        "rays_per_launch": chunk,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
        "registers": fwd_regs,
        "spill_bytes": fwd_spill,
        **b1_env,
        **b1_marble,
        **b1_random,
        **b1_brute,
        "launches_image_paths": image_launches["wavefront_fwd"],
        "registers_marble": fwd_marble[0],
        "spill_bytes_marble": fwd_marble[1],
    }, rec_entry, *grad_entries, pw_entries[0] | b5a_marble,
        pw_entries[1] | b5b_env | b5b_marble, *ix_entries, *mesh_entries,
        b4_entry | b4_marble, b11_entry, probe_entry]}), flush=True)
    print(name_and_limit, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
