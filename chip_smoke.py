#!/usr/bin/env python3
"""GPU smoke check of the PyTorch/CUDA port (go_raytracing_tpu_torch).

    python3 chip_smoke.py [--out-dir DIR]

Needs one NVIDIA GPU and ``nvcc``.  It builds the eleven CUDA kernels from
the sources in this checkout (the forward megakernel, the stash-writing
gradient forward and the reverse sweep of the product-chain tier, the
same two of the pathwise tier, the four closest-hit kernels of the
standard integrator, and the two mesh kernels), holds each against its plain
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
through ``render(differentiable=True)`` held against ``render_grad``, and
the four kernels alone.  Then meshes: both mesh kernels against their plain
versions (``mesh_kernels_vs_plain``), ``cornell-lucy`` at the JAX package's
bench size (600x600, 25 spp, depth 5, 112,128 triangles x 10 instances)
through ``render_image`` with a crop held against the plain versions on the
CPU (``mesh_main_path``, ``mesh_stream``), the same at the scene's default
3,744 triangles (``mesh_small_path``, ``mesh_sweep``), autograd through a
mesh scene (``mesh_autograd``) and the two kernels alone
(``mesh_kernel_timing``).  The earlier phases run at the sizes they always
had.  It prints one JSON line per phase.
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
compared and timed beside it, for the record only.

The gradient forward is the same bounce loop, so its radiance, flags, miss
colour and stash are held to the same per-ray gate.  The reverse kernel adds
float32 terms in a fixed tree (warp butterfly, warps of a block, blocks),
its plain version adds the same float32 terms in float64: they agree to
1e-4 of the largest entry of the result.  Against ``torch.autograd`` through
the plain forward (other formulas for the same derivative) the gate is 2e-3
of the largest entry of each colour table, the tolerance of the JAX
package's own test of its gradient kernel.

The pathwise gradient forward is held to the same per-ray gate (19 + 3 stash
rows) and its radiance must be the forward kernel's bit for bit.  The
pathwise reverse kernel is held against its plain version on the kernel's
own stash: each key of the gradients dict (three colour tables, fuzz, ior)
within 1e-4 of the key's largest entry; and two launches on one stash must
give the same bits.  Autograd is no oracle of this tier (behind a fuzzy
metal a colour's gradient also flows through positions): the plain version
is held against the JAX kernel, and that against ``jax.grad``, by the tests.

The closest-hit kernels are held to equality: hit, index, t and every
attribute row of a ray are the plain version's bits, or the ray counts as a
mismatch (gate 0.5 % of rays, 0.0 expected).  The standard integrator's
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
"""

import argparse
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import time

import torch

import go_raytracing_tpu_torch as grt
from go_raytracing_tpu_torch.camera import Camera, generate_rays
from go_raytracing_tpu_torch.integrator import wavefront
from go_raytracing_tpu_torch.core.vec3 import V3
from go_raytracing_tpu_torch.ops import _build
from go_raytracing_tpu_torch.ops import cuda_intersect as ck
from go_raytracing_tpu_torch.ops import cuda_mesh as cm
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as gradmod
from go_raytracing_tpu_torch.render import renderer

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
#     and the compare                                                   = 25
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
    k_mean = float(final_radiance(scene, cam, k_rows, k_flags).mean())
    p_mean = float(final_radiance(scene, cam, p_rows, p_flags).mean())
    rel = abs(k_mean - p_mean) / max(abs(p_mean), 1e-12)
    emit("kernel_vs_plain", scene=name, rays=n, depth=cam.max_depth,
         mismatch_share=mismatch, mismatch_share_with_fma=mismatch_fma,
         max_abs_err_agreeing_rays=max_err, mean_kernel=k_mean,
         mean_plain=p_mean, mean_rel_diff=rel, rtol=RTOL, atol=ATOL)
    if not torch.isfinite(k_rows).all():
        raise RuntimeError(f"{name}: kernel output is not finite")
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"{name}: {mismatch:.4%} of rays disagree with the plain version")
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
         fwd_max_abs_err_agreeing_rays=fwd_err,
         radiance_equals_forward_kernel=same_as_fwd,
         rev_max_abs_err=rev_err, rev_err_of_largest=rev_rel,
         autograd_err_of_largest=auto_rel, share_of_rays_clamped=clamped,
         largest_gradient=float(gp.abs().max()))
    if not torch.isfinite(k[0]).all() or not torch.isfinite(k[3]).all():
        raise RuntimeError(f"{name}: gradient forward output is not finite")
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"{name}: {mismatch:.4%} of rays' stash rows disagree")
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
    del p
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"full-size chunk: {mismatch:.4%} of rays' stash rows disagree")

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
         fwd_max_abs_err_agreeing_rays=fwd_err,
         radiance_equals_forward_kernel=same_as_fwd,
         rev_max_abs_err=rev_err, rev_err_of_largest=rev_rel,
         rev_two_launches_same_bits=same_bits,
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
    if not same_as_fwd:
        raise RuntimeError(f"{name}: pathwise forward's radiance is not the forward's")
    if not rev_rel <= REV_RTOL_OF_LARGEST:
        raise RuntimeError(f"{name}: pathwise reverse kernel off by {rev_rel:.2e}")
    if not same_bits:
        raise RuntimeError(f"{name}: two launches of the reverse kernel differ")
    if float(gk[1].abs().max()) == 0.0 or float(gk[2].abs().max()) == 0.0:
        raise RuntimeError(f"{name}: no fuzz or no ior gradient")
    return mismatch, fwd_err, rev_err


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
    del p
    if mismatch >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"full-size chunk: {mismatch:.4%} of rays' pathwise "
                           "stash rows disagree")
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
    block_rays = _build.load(
        "wavefront_grad_pathwise").lib.wavefront_grad_rev_pathwise_block_rays()
    n_acc = 9 * n_tex + 2 * n_mat
    rev_bytes = ((stash_rows + 3 + 3 + 1) * 4 * n
                 + 4 * n_acc * -(-n // block_rays)
                 + 4 * (tb.vt.numel() + tb.lt.numel()))
    rev_bound = (rev_bytes / PEAK_BYTES_PER_S * 1e3,
                 float(sum(entered)) * (FLOPS_REVERSE_PATHWISE / PEAK_FP32_FLOPS
                                        + INT_OPS_REVERSE_PATHWISE / PEAK_INT32_OPS)
                 * 1e3)
    emit("pathwise_kernel_timing", scene="cornell-glossy", rays_per_launch=n,
         depth=depth, rows_entered_by_bounce=entered,
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
         grad_rev_two_launches_same_bits=same_bits)

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
              [rev_err] + [c[2] for c in small_checks]),
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


def intersect_calls(scene, o, d, tm, t_max_s, t_max_p):
    """name -> (kernel call, plain call, table elements, ray rows in) for each
    of the four kernels this scene has primitives for."""
    sgeo, scon, pgeo, pcon = intersect_tables(scene)
    extra = ck.CHECKER_EXTRA if scene.has_checker else 0
    ol, dl, t_min = list(o), list(d), cw.EPS_HIT
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


def compare_intersect(scene, o, d, tm, name):
    """The four kernels against their plain versions on one set of rays, with
    t_max of BIG, of half the nearest hit's distance, and of -1 on a third of
    the rays.  Returns {kernel: (worst mismatch share, worst error)}."""
    n = tm.shape[0]
    big = torch.full_like(tm, ck.BIG)
    third = torch.arange(n, device=tm.device) % 3 == 0
    first = {k: v[0]() for k, v in intersect_calls(scene, o, d, tm, big, big).items()}

    def t_max_for(kernel, kind):
        if kind == "big":
            return big
        if kind == "minus_one_on_a_third":
            return torch.where(third, -1.0, big)
        t, _, hit = first[kernel][:3]
        return torch.where(hit, t * 0.5, big)

    worst = {}
    fields = {}
    for kind in ("big", "halved", "minus_one_on_a_third"):
        tmax_s = t_max_for("sphere_closest", kind) if "sphere_closest" in first else big
        tmax_p = t_max_for("planar_closest", kind) if "planar_closest" in first else big
        for kernel, (run, plain, _, _) in intersect_calls(
                scene, o, d, tm, tmax_s, tmax_p).items():
            k = run()
            torch.cuda.synchronize()
            p = plain()
            share, err = intersect_mismatch(k, p)
            if not torch.isfinite(k[0]).all():
                raise RuntimeError(f"{name}: {kernel} returned a t that is not finite")
            if kind == "halved" and bool(k[2][first[kernel][2]].any()):
                raise RuntimeError(f"{name}: {kernel} hit beyond its t_max")
            if kind == "minus_one_on_a_third" and bool(k[2][third].any()):
                raise RuntimeError(f"{name}: {kernel} hit on a ray with t_max = -1")
            fields[f"{kernel}_{kind}"] = dict(
                mismatch_share=share, max_abs_err=err,
                hit_share=float(k[2].float().mean()))
            w = worst.get(kernel, (0.0, 0.0))
            worst[kernel] = (max(w[0], share), max(w[1], err))
    emit("intersect_kernels_vs_plain", scene=name, rays=n,
         n_planar=int(scene.planar.d.shape[0]),
         n_spheres=int(scene.spheres.radius.shape[0]),
         checker=scene.has_checker, **fields)
    for kernel, (share, _) in worst.items():
        if share >= MAX_MISMATCH_SHARE:
            raise RuntimeError(f"{name}: {kernel} differs from its plain version "
                               f"on {share:.4%} of rays")
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
    later hits through that distance; ``render_grad``'s are the exact ones."""
    spp = cam.samples_per_pixel
    target = grt.render(scene, cam, seed=1) / spp * 0.8
    loss_k, g_k = grt.render_grad(scene, cam, target, seed=0)
    params = {k: v.clone().requires_grad_()
              for k, v in grt.trainable_params(scene).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_intersect_counts()
    stats = grt.RenderStats()

    def run():
        fb = grt.render(grt.apply_params(scene, params), cam, seed=0,
                        differentiable=True, stats=stats)
        loss = torch.mean((fb / spp - target) ** 2)
        loss.backward()
        return loss.detach()

    ms, loss = cuda_ms(run)
    counts = intersect_counts()
    peak = torch.cuda.max_memory_allocated()
    big = float(g_k["color"].abs().max())
    diff = float((params["color"].grad - g_k["color"]).abs().max()) / big
    loss_diff = abs(float(loss) - float(loss_k)) / float(loss_k)
    finite = all(bool(torch.isfinite(p.grad).all()) for p in params.values()
                 if p.grad is not None)
    emit("standard_autograd", scene=name, width=cam.image_width,
         height=cam.image_height, spp=spp, depth=cam.max_depth,
         camera_rays=cam.image_width * cam.image_height * spp,
         chunks=stats.chunks, launches=counts, forward_backward_ms=ms,
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
            if share >= MAX_MISMATCH_SHARE:
                raise RuntimeError(f"{scene_name}, full chunk: {kernel} differs "
                                   f"from its plain version on {share:.4%} of rays")
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
                 mismatch_share_full_chunk=share, max_abs_err_full_chunk=err)
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


def profile_standard_chunk(scene, cam):
    """Device time by kernel over one chunk of the Cornell job on the fast
    route, from ``torch.profiler``, beside the same render's time without the
    profiler (which slows the host many times over): the device's busy share
    is the kernels' summed time over that.  For the record only: a profiler
    that does not work on this machine is reported and fails nothing."""
    n_virt = cam.image_width * cam.image_height
    one = renderer.pick_chunk_size(scene) // n_virt
    try:
        from torch.profiler import ProfilerActivity, profile

        grt.render(scene, cam, spp=one, seed=0, mega_mode="off")
        plain_ms, _ = cuda_ms(
            lambda: grt.render(scene, cam, spp=one, seed=0, mega_mode="off"))
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            grt.render(scene, cam, spp=one, seed=0, mega_mode="off")
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
                for e in prof.key_averages()
                if getattr(e, "device_type", None) is not None
                and "cuda" in str(e.device_type).lower()]
        if not rows:
            rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
                    for e in prof.key_averages()
                    if getattr(e, "self_device_time_total", 0.0) > 0]
        rows.sort(key=lambda r: -r[1])
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
    except Exception as exc:  # the profiler is optional on this machine
        emit("standard_profile", error=repr(exc)[:300])


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


def mesh_chunk_rays(scene, cam, n, seed, device):
    """``n`` rays drawn from the render's first chunk: half camera rays, half
    the first-bounce rays that leave their hits (the standard integrator's
    bounce 0 on the whole chunk)."""
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


def sorted_like_the_integrator(proto, o, d):
    """The chunk's rays as ``_mesh_intersect`` hands them to a kernel at
    the first bounce: unreaching rays with t_max = -1, sorted by the key."""
    big = torch.full_like(o.x, ck.BIG)
    reach, key = wavefront._mesh_sort_key(proto, o, d, cw.EPS_HIT, big)
    t_max = torch.where(reach, big, -1.0)
    order = torch.argsort(key, stable=True)
    return (V3(*(c[order].contiguous() for c in o)),
            V3(*(c[order].contiguous() for c in d)), t_max[order].contiguous(),
            float(reach.float().mean()))


def mesh_kernel_timing(cases, checks):
    """Each mesh kernel alone at its main path's first-bounce chunk (camera
    rays, sorted and filtered as the integrator does), beside its bound, and
    its plain version's time on 16,384 of those rays.  ``cases``: kernel ->
    (scene, cam, launches per render, renders' chunks).  Returns the
    kernels' entries of the ``kernels`` line."""
    entries = []
    for kernel, (scene, cam, launches, chunks) in cases.items():
        kind = MESH_KERNELS[kernel]
        proto = scene.meshes[0]
        fn = cm.intersect_mesh_kernel if kind == "sweep" else cm.intersect_mesh_stream
        o_dev = scene.device
        _, o, d, _, _ = lucy_chunk(scene, cam, o_dev)
        o, d, t_max, reach = sorted_like_the_integrator(proto, o, d)
        n = t_max.shape[0]
        fn(proto, o, d, cw.EPS_HIT, t_max)
        rounds, k = rounds_ms(lambda: fn(proto, o, d, cw.EPS_HIT, t_max), rounds=3,
                              repeats=3)
        ms = median(rounds)
        # a sample of 16,384 of the chunk's rays: the plain version's time,
        # its box and triangle tests (scaled to the chunk), and one more
        # comparison
        gen = torch.Generator(device=o_dev).manual_seed(21)
        pick = torch.randint(0, n, (16384,), device=o_dev, generator=gen)
        so, sd = V3(*(c[pick] for c in o)), V3(*(c[pick] for c in d))
        counts = {}
        plain_ms, p = cuda_ms(lambda: cm.plain(kind, proto, so, sd, cw.EPS_HIT,
                                               t_max[pick], counts=counts))
        mm = mesh_mismatch(tuple(a[pick] if torch.is_tensor(a) else a for a in k), p,
                           False)
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
        emit("mesh_kernel_timing", kernel=kernel, triangles=proto.n_tris,
             instances=proto.n_instances, rays_per_launch=n, reach_share=reach,
             hit_share=float(k[3].float().mean()), ms=ms, ms_rounds=rounds,
             launches_per_render=launches, render_chunks=chunks,
             plain_ms=plain_ms, plain_rays=16384,
             plain_note="the plain version timed on 16,384 of the chunk's rays",
             live_rays=n_live,
             local_rays_per_ray=counts.get("local_rays", 0) / 16384,
             box_tests_per_ray=counts.get("box_tests", 0) / 16384,
             tri_tests_per_ray=counts.get("tri_tests", 0) / 16384,
             tri_t_pass_per_ray=counts.get("tri_t_pass", 0) / 16384,
             counted="(ray, instance) pairs, box and triangle tests of the plain "
                     "version on 16,384 of the chunk's rays, scaled to the chunk: "
                     "x 42 a pair, 25 a box, 55 a Moller-Trumbore test (sweep) or "
                     "17 a Baldwin-Weber plane test + 24 a triangle whose t passes "
                     "(stream); bytes: 28 in a live ray, 4 a dead one, 13 out, "
                     "the tables once",
             bytes_counted=moved, table_bytes=table_bytes, flops_counted=flops,
             bound_bytes_ms=bound[0], bound_ops_ms=bound[1],
             roofline_share=max(bound) / ms, sample_mismatch=mm)
        if mm["any"] >= MAX_MISMATCH_SHARE:
            raise RuntimeError(f"{kernel}: the chunk's sample differs from the plain "
                               f"version on {mm['any']:.4%} of rays")
        line = ("312 (_call of intersect_mesh_kernel)" if kind == "sweep"
                else "791 (_call of intersect_mesh_stream)")
        src = "pallas_mesh.py" if kind == "sweep" else "pallas_mesh_stream.py"
        small = checks[kernel]
        entries.append(kernel_entry(
            n, kernel, "go_raytracing_tpu_torch/csrc/mesh.cu",
            f"go_raytracing_tpu/ops/{src}:{line}", launches, ms, plain_ms, bound,
            [mm.get("max_abs_dt", 0.0)] + [c[1] for c in small]) | {
                "mismatch_share": max([mm["any"]] + [c[0] for c in small]),
                "plain_rays": 16384, "triangles": proto.n_tris,
                "instances": proto.n_instances, "scene": "cornell-lucy"})
        del o, d, t_max, k, p
    return entries


def mesh_phases(dev):
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
    return mesh_kernel_timing(
        {"mesh_sweep": (small_scene, small_cam, sweep_launches, sweep_chunks),
         "mesh_stream": (main_scene, main_cam, stream_launches, stream_chunks)},
        checks)


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
    built, built_fma, built_grad, built_pw, built_ix, built_mesh = _build.load_all(
        [("wavefront", False), ("wavefront", True), ("wavefront_grad", False),
         ("wavefront_grad_pathwise", False), ("intersect", False), ("mesh", False)])

    def kernel_stats(lib, tag):
        (stats,) = [v for name, v in lib.kernels.items() if tag in name]
        return stats

    # wavefront_kernel<0> is the forward, <1> the product-chain gradient
    # forward, <2> the pathwise gradient forward
    fwd_regs, fwd_spill = kernel_stats(built, "wavefront_kernelILi0E")
    gfwd_regs, gfwd_spill = kernel_stats(built, "wavefront_kernelILi1E")
    pfwd_regs, pfwd_spill = kernel_stats(built, "wavefront_kernelILi2E")
    grev_regs, grev_spill = kernel_stats(built_grad, "wavefront_grad_rev_kernel")
    prev_regs, prev_spill = kernel_stats(built_pw, "wavefront_grad_rev_pathwise_kernel")
    # planar_kernel<false> / <true> and sphere_kernel<false> / <true>: closest
    # hit alone, and with the winner's attributes
    ix_stats = {name: kernel_stats(built_ix, tag) for name, tag in (
        ("planar_closest", "planar_kernelILb0E"),
        ("planar_closest_attrs", "planar_kernelILb1E"),
        ("sphere_closest", "sphere_kernelILb0E"),
        ("sphere_closest_attrs", "sphere_kernelILb1E"))}
    # mesh_sweep_kernel<false> / <true> and mesh_stream_kernel<false> / <true>:
    # closest hit and any hit
    mesh_stats = {name: kernel_stats(built_mesh, tag) for name, tag in (
        ("mesh_sweep", "mesh_sweep_kernelILb0E"),
        ("mesh_sweep_any_hit", "mesh_sweep_kernelILb1E"),
        ("mesh_stream", "mesh_stream_kernelILb0E"),
        ("mesh_stream_any_hit", "mesh_stream_kernelILb1E"))}
    emit("build", seconds=time.perf_counter() - t0, kernels=11,
         nvcc_seconds=[b.build_seconds for b in (built, built_fma, built_grad, built_pw,
                                                 built_ix, built_mesh)],
         libraries=[built.path.name, built_grad.path.name, built_pw.path.name,
                    built_ix.path.name, built_mesh.path.name],
         intersect_registers={k: v[0] for k, v in ix_stats.items()},
         intersect_spill_bytes={k: v[1] for k, v in ix_stats.items()},
         mesh_registers={k: v[0] for k, v in mesh_stats.items()},
         mesh_spill_bytes={k: v[1] for k, v in mesh_stats.items()},
         registers=fwd_regs, spill_bytes=fwd_spill,
         registers_with_fma=kernel_stats(built_fma, "wavefront_kernelILi0E")[0],
         grad_fwd_registers=gfwd_regs, grad_fwd_spill_bytes=gfwd_spill,
         grad_rev_registers=grev_regs, grad_rev_spill_bytes=grev_spill,
         grad_fwd_pathwise_registers=pfwd_regs,
         grad_fwd_pathwise_spill_bytes=pfwd_spill,
         grad_rev_pathwise_registers=prev_regs,
         grad_rev_pathwise_spill_bytes=prev_spill,
         ptxas=[l for b in (built, built_grad, built_pw, built_ix, built_mesh)
                for l in b.log.splitlines()
                if "ptxas info" in l and ("Used" in l or "spill" in l)])

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

    # ---- the pathwise gradient kernels against their plain versions ----------------
    g_scene, g_cam0 = grt.load_scene("cornell-glossy")
    g_small = dataclasses.replace(g_cam0, image_width=64, aspect_ratio=1.0,
                                  samples_per_pixel=4, max_depth=5)
    pw_checks = [compare_pathwise(g_scene, g_small, 7, "cornell-glossy"),
                 compare_pathwise(*glossy_sky_scene(dev), 8, "glossy_sky_volume"),
                 compare_pathwise(m_scene, m_cam, 9, "mixed")]

    # ---- the closest-hit kernels against their plain versions ----------------------
    ix_scene, ix_cam = intersect_scene(dev)
    ix_checks = [compare_intersect(ix_scene, *scattered_rays(ix_cam, 16384, 11, dev),
                                   "mixed_four_planar_kinds")]

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
    good = (torch.isclose(k_rows, p_rows, rtol=RTOL, atol=ATOL).all(dim=0)
            & (k_flags == p_flags))
    mismatch_full = 1.0 - float(good.float().mean())
    max_err_full = float((k_rows - p_rows).abs().max(dim=0).values[good].max())
    if mismatch_full >= MAX_MISMATCH_SHARE:
        raise RuntimeError(f"full-size chunk: {mismatch_full:.4%} of rays disagree")
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
    for name, width, aspect, spp, depth in (("simple", 400, 16 / 9, 10, 10),
                                            ("random", 600, 16 / 9, 25, 10),
                                            ("cornell-smoke", 600, 1.0, 25, 5)):
        sc, cm = grt.load_scene(name)
        cm = dataclasses.replace(cm, image_width=width, aspect_ratio=aspect,
                                 samples_per_pixel=spp, max_depth=depth)
        grt.render_image(sc, cm, seed=0)
        st = grt.RenderStats()
        ms, im = cuda_ms(lambda: grt.render_image(sc, cm, seed=0, stats=st))
        if not torch.isfinite(im).all() or not 0.02 < float(im.mean()) < 0.98:
            raise RuntimeError(f"{name}: image mean {float(im.mean())}")
        n = cm.image_width * cm.image_height * spp
        emit("other_scene", scene=name, width=width, height=cm.image_height,
             spp=spp, depth=depth, camera_rays=n, chunks=st.chunks,
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
    standard_autograd("cornell", scene, a_cam)
    standard_autograd("cornell-glossy", g_scene, dataclasses.replace(
        g_cam0, image_width=600, aspect_ratio=600 / 338, samples_per_pixel=8,
        max_depth=5))

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
    by_name = {e["name"]: e for e in ix_entries}
    kernels_ms = (by_name["planar_closest_attrs"]["ms"] * std_counts["planar_closest_attrs"]
                  + by_name["planar_closest"]["ms"] * std_counts["planar_closest"])
    emit("standard_split", scene="cornell", chunks=std_chunks,
         render_ms_median=std_ms, closest_hit_kernels_ms_at_full_chunk=kernels_ms,
         kernels_share_of_render_at_most=kernels_ms / std_ms,
         note="kernel times are those of a launch with every ray alive; later "
              "bounces and shadow launches sweep fewer rays")
    profile_standard_chunk(scene, cam)

    # ---- instanced meshes: cornell-lucy through mesh_sweep and mesh_stream ------
    mesh_entries = mesh_phases(dev)

    print(json.dumps({"kernels": [{
        "name": "wavefront_fwd",
        "route": "cuda",
        "source": "go_raytracing_tpu_torch/csrc/wavefront.cu",
        "replaces": "go_raytracing_tpu/ops/pallas_wavefront.py:1822 (_call)",
        "launches": launches,
        "max_abs_err": max(err_mixed, err_cornell, err_random, max_err_full),
        "mismatch_share": max(mismatch_mixed, mismatch_cornell, mismatch_random,
                              mismatch_full),
        "ms": median(fwd_rounds),
        "ms_per_launch": median(fwd_rounds),
        "rays_per_launch": chunk,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
    }, *grad_entries, *pw_entries, *ix_entries, *mesh_entries]}), flush=True)
    print(name_and_limit, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
