#!/usr/bin/env python3
"""GPU smoke check of the PyTorch/CUDA port (go_raytracing_tpu_torch).

    python3 chip_smoke.py [--out-dir DIR]

Needs one NVIDIA GPU and ``nvcc``.  It builds the CUDA kernel from the
sources in this checkout, holds it against its plain PyTorch version on
the GPU, renders the Cornell box at full size (600x338, 100 spp, depth 5)
through the public entry points, checks the image, times the kernel at the
render's own shapes beside its roofline bound, times three more scenes for
the record, and prints one JSON line per phase.  The last line is
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
"""

import argparse
import dataclasses
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
from go_raytracing_tpu_torch.render import renderer

RTOL = ATOL = 1e-3
MAX_MISMATCH_SHARE = 0.005
MAX_MEAN_REL_DIFF = 0.01

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
    built = _build.load("wavefront")
    built_fma = _build.load("wavefront", fmad=True)
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=built.build_seconds,
         library=built.path.name,
         registers=built.registers, spill_bytes=built.spill_bytes,
         registers_with_fma=built_fma.registers,
         ptxas=[l for l in built.log.splitlines() if "ptxas info" in l and
                ("Used" in l or "spill" in l)])

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
    del p_rows, p_flags

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

    print(json.dumps({"kernels": [{
        "name": "wavefront_fwd",
        "route": "cuda",
        "source": "go_raytracing_tpu_torch/csrc/wavefront.cu",
        "replaces": "go_raytracing_tpu/ops/pallas_wavefront.py:1822 (_call)",
        "launches": launches,
        "max_abs_err": max(err_mixed, err_cornell, err_random, max_err_full),
        "mismatch_share": max(mismatch_mixed, mismatch_cornell, mismatch_random,
                              mismatch_full),
        "ms": kernel_ms,
        "ms_per_launch": kernel_ms,
        "rays_per_launch": chunk,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(name_and_limit, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
