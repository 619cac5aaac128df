"""Command-line renderer.

Usage:
    python -m go_raytracing_tpu_torch.utils.cli [-scene hdri-test] [-spp 100]
        [-width 600] [-depth 5] [-out image.png] [-progressive]
        [-interactive] [-interactive-port 8265] [-profile-dir DIR]
        [-mem-stats] [-seed 0] [-device {cuda,cpu}]

Same ``-scene`` registry, aliases and default (``hdri-test``, whose HDRI
asset must be present, else ``FileNotFoundError``) and the same flags as
the JAX package's CLI, at each scene's own settings unless flags say
otherwise (``-scene perlin``: 600x337, 100 spp, depth 50, so its chunks
take the megakernel's 'split' mode).  ``-interactive`` serves a live view
over HTTP (``render/display.LiveDisplay``) that refines sample slice by
sample slice; the final image is the one-shot render's bits.
``-profile-dir`` writes a ``torch.profiler`` trace there, ``-mem-stats``
prints the device and host memory report.  The render runs on the GPU
unless ``-device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="PyTorch/CUDA path tracer")
    ap.add_argument("-scene", default="hdri-test", help="scene name (the JAX CLI's default)")
    ap.add_argument("-spp", type=int, default=None)
    ap.add_argument("-width", type=int, default=None)
    ap.add_argument("-depth", type=int, default=None)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-out", default="image.png")
    ap.add_argument("-progressive", action="store_true",
                    help="preview/refine/final passes")
    ap.add_argument("-interactive", action="store_true",
                    help="serve a live-refining view over HTTP; the final "
                         "image is the one-shot render's bits")
    ap.add_argument("-interactive-port", type=int, default=8265)
    ap.add_argument("-profile-dir", default=None,
                    help="write a torch.profiler trace here")
    ap.add_argument("-mem-stats", action="store_true",
                    help="print the device / host memory report")
    ap.add_argument("-device", default=None, choices=["cuda", "cpu"],
                    help="where to render (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    import go_raytracing_tpu_torch as grt
    from go_raytracing_tpu_torch.utils.profiler import Profiler, memory_report

    scene, cam = grt.load_scene(args.scene, device=args.device)
    if args.width:
        cam = dataclasses.replace(cam, image_width=args.width)
    if args.spp:
        cam = dataclasses.replace(cam, samples_per_pixel=args.spp)
    if args.depth:
        cam = dataclasses.replace(cam, max_depth=args.depth)

    print(
        f"Rendering '{args.scene}' on {scene.device}: "
        f"{cam.image_width}x{cam.image_height} "
        f"@ {cam.samples_per_pixel} spp, depth {cam.max_depth}"
    )

    disp = None
    if args.interactive:
        from go_raytracing_tpu_torch.render.display import LiveDisplay

        disp = LiveDisplay(port=args.interactive_port)
        print(f"Live view: {disp.url}")

    prof = Profiler(trace_dir=args.profile_dir, device=args.device)
    stats = grt.RenderStats()
    spp = cam.samples_per_pixel
    n_pixels = cam.image_width * cam.image_height
    prof.start()
    t0 = time.perf_counter()
    try:
        if args.progressive:
            img = None
            for name, img in grt.render_progressive(scene, cam, seed=args.seed,
                                                    device=args.device):
                print(f"  pass '{name}' done @ {time.perf_counter() - t0:.1f}s")
                if disp is not None:
                    disp.update(img, pass_name=name, done_spp=spp, total_spp=spp)
        elif disp is not None:
            # sample-sliced refinement: the renderer adds samples one at a
            # time in order, so the slices sum to the one-shot render's bits
            accum, done, step = None, 0, 1
            while done < spp:
                n = min(step, spp - done)
                accum = grt.render(scene, cam, spp=n, sample_offset=done,
                                   accum=accum, seed=args.seed, stats=stats,
                                   device=args.device)
                done += n
                step = min(step * 2, max(spp // 8, 1))
                el = time.perf_counter() - t0
                disp.update(grt.film.tonemap(accum, done), pass_name="refining",
                            done_spp=done, total_spp=spp,
                            mrays=done * n_pixels / el / 1e6)
            img = grt.film.tonemap(accum, spp)
        else:
            img = grt.render_image(scene, cam, seed=args.seed, stats=stats,
                                   device=args.device)
            print(f"  {stats.rays_traced} camera rays in {stats.chunks} chunks, "
                  f"{stats.rays_per_second / 1e6:.2f} Mrays/s")
    finally:
        prof.stop()
    wall = time.perf_counter() - t0
    if disp is not None:
        disp.update(img, pass_name="final", done_spp=spp, total_spp=spp,
                    mrays=n_pixels * spp / wall / 1e6)

    prof.counters.add_launch(n_pixels, spp, cam.max_depth, 1 if scene.n_lights else 0)
    print(prof.report(wall))
    if args.mem_stats:
        print(memory_report(args.device))

    grt.film.write_png(args.out, grt.film.to_uint8(img))
    print(f"Done in {wall:.2f}s. Image written to {args.out}")
    if disp is not None:
        if sys.stdin.isatty():
            try:
                input(f"Serving final frame at {disp.url} - Enter to exit. ")
            except EOFError:
                pass
        disp.close()
    return img


if __name__ == "__main__":
    main()
