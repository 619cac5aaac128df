#!/usr/bin/env python3
"""GPU smoke check of the PyTorch/CUDA port (go_raytracing_tpu_torch).

    python3 chip_smoke.py [--out-dir DIR]

Needs one NVIDIA GPU and ``nvcc``.  It builds the five CUDA kernels from
the sources in this checkout (the forward megakernel, the stash-writing
gradient forward and the reverse sweep of the product-chain tier, and the
same two of the pathwise tier), holds each against its plain
PyTorch version on the GPU, renders the Cornell box at full size (600x338,
100 spp, depth 5) through the public entry points, checks the image, times
the forward kernel at the render's own shapes beside its roofline bound,
times three more scenes for the record, then takes the loss and the
gradients of the same Cornell job through ``render_grad`` (everything
stashed, and once more with a stash budget of two chunks), checks them, and
times the two gradient kernels alone.  Then the pathwise tier: the loss and
the gradients (fuzz and IOR among them) of ``cornell-glossy`` at 600x600,
100 spp, depth 5 through ``render_grad`` on both routes, and its two
kernels alone.  It prints one JSON line per phase.
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
from go_raytracing_tpu_torch.ops import _build
from go_raytracing_tpu_torch.ops import cuda_wavefront as cw
from go_raytracing_tpu_torch.render import grad as gradmod
from go_raytracing_tpu_torch.render import renderer

RTOL = ATOL = 1e-3
MAX_MISMATCH_SHARE = 0.005
MAX_MEAN_REL_DIFF = 0.01
REV_RTOL_OF_LARGEST = 1e-4
AUTOGRAD_RTOL_OF_LARGEST = 2e-3

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
    built, built_fma, built_grad, built_pw = _build.load_all(
        [("wavefront", False), ("wavefront", True), ("wavefront_grad", False),
         ("wavefront_grad_pathwise", False)])

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
    emit("build", seconds=time.perf_counter() - t0, kernels=5,
         nvcc_seconds=[b.build_seconds
                       for b in (built, built_fma, built_grad, built_pw)],
         libraries=[built.path.name, built_grad.path.name, built_pw.path.name],
         registers=fwd_regs, spill_bytes=fwd_spill,
         registers_with_fma=kernel_stats(built_fma, "wavefront_kernelILi0E")[0],
         grad_fwd_registers=gfwd_regs, grad_fwd_spill_bytes=gfwd_spill,
         grad_rev_registers=grev_regs, grad_rev_spill_bytes=grev_spill,
         grad_fwd_pathwise_registers=pfwd_regs,
         grad_fwd_pathwise_spill_bytes=pfwd_spill,
         grad_rev_pathwise_registers=prev_regs,
         grad_rev_pathwise_spill_bytes=prev_spill,
         ptxas=[l for b in (built, built_grad, built_pw) for l in b.log.splitlines()
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
    }, *grad_entries, *pw_entries]}), flush=True)
    print(name_and_limit, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
