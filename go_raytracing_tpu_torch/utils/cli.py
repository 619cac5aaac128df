"""Command-line renderer.

Usage:
    python -m go_raytracing_tpu_torch.utils.cli -scene cornell [-spp 100]
        [-width 600] [-depth 5] [-out image.png] [-progressive]
        [-seed 0] [-device {cuda,cpu}]

Same ``-scene`` registry and aliases as the JAX package's CLI, at each
scene's own settings unless flags say otherwise (``-scene perlin``: 600x337,
100 spp, depth 50, so its chunks take the megakernel's 'split' mode).  The
render runs on the GPU unless ``-device cpu`` is given.  ``-interactive``,
``-profile-dir`` and ``-mem-stats`` are not ported yet (ROADMAP.md A20).
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="PyTorch/CUDA path tracer")
    ap.add_argument("-scene", default="cornell", help="scene name")
    ap.add_argument("-spp", type=int, default=None)
    ap.add_argument("-width", type=int, default=None)
    ap.add_argument("-depth", type=int, default=None)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-out", default="image.png")
    ap.add_argument("-progressive", action="store_true",
                    help="preview/refine/final passes")
    ap.add_argument("-device", default=None, choices=["cuda", "cpu"],
                    help="where to render (default: cuda; fails without one)")
    args = ap.parse_args(argv)

    import go_raytracing_tpu_torch as grt

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

    stats = grt.RenderStats()
    t0 = time.perf_counter()
    if args.progressive:
        img = None
        for name, img in grt.render_progressive(scene, cam, seed=args.seed,
                                                device=args.device):
            print(f"  pass '{name}' done @ {time.perf_counter() - t0:.1f}s")
    else:
        img = grt.render_image(scene, cam, seed=args.seed, stats=stats,
                               device=args.device)
        print(f"  {stats.rays_traced} camera rays in {stats.chunks} chunks, "
              f"{stats.rays_per_second / 1e6:.2f} Mrays/s")
    wall = time.perf_counter() - t0

    grt.film.write_png(args.out, grt.film.to_uint8(img))
    print(f"Done in {wall:.2f}s. Image written to {args.out}")


if __name__ == "__main__":
    main()
