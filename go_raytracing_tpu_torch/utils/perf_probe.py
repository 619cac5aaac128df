"""Perf probe: the integrator's pieces timed one by one, the JAX package's
module of the same name in PyTorch.

Run: ``python -m go_raytracing_tpu_torch.utils.perf_probe [--rays N]
[--device cpu]`` (on the GPU unless ``--device cpu``).

Times the standard integrator's stages on Cornell's camera rays (closest
hit, the hit record, the material's scatter, NEE toward the quad light),
the whole trace at depth 1 and 5 (the megakernel), and the layout tax of
[R, 3] rows against [3, R] columns and three [R] vectors.  On the GPU each
time comes from CUDA events around a run of calls after warm-up calls
(``microbench.timeit``), on the CPU from the host clock.  Returns the
times in seconds by stage.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from .device import resolve_device
from .microbench import timeit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n = args.rays
    dev = resolve_device(args.device)

    import go_raytracing_tpu_torch as grt
    from go_raytracing_tpu_torch.camera import generate_rays
    from go_raytracing_tpu_torch.core.vec3 import V3
    from go_raytracing_tpu_torch.integrator import wavefront
    from go_raytracing_tpu_torch.materials import tables as mats

    print(f"device={dev} rays={n}")
    times = {}

    def probe(name, fn, *a, warmup=2, iters=10):
        dt, out = timeit(fn, *a, device=dev, warmup=warmup, iters=iters)
        times[name] = dt
        rate = f"  ({n / dt / 1e6:7.1f} Mrays/s)" if name.startswith(("closest", "trace")) else ""
        print(f"{name:17s}: {dt * 1e3:8.2f} ms{rate}")
        return out

    scene, cam = grt.load_scene("cornell", device=dev)
    stream = torch.arange(n, dtype=torch.int64, device=dev)
    px, py = stream % 600, (stream // 600) % 600
    o, d, tm = generate_rays(cam, px, py, stream, 0)
    tmax = torch.full((n,), 3e38, device=dev)

    t, which, idx, aux, _ = probe("closest_hit", wavefront.closest_hit, scene, o, d, tm,
                                  1e-3, tmax, 0, stream, 0)
    p, nrm, front, uu, vv, mat = probe("extract_record", wavefront.extract_record, scene,
                                       o, d, tm, t, which, idx, aux)
    sc = probe("scatter", lambda: mats.scatter(scene.materials, scene.textures, mat, d, nrm,
                                               front, uu, vv, p, 0, stream, 0,
                                               **scene.tex_flags))
    probe("area_light NEE", lambda: wavefront.sample_area_light(
        scene, cam, p, nrm, d, sc.attenuation, mat, 0, stream, 0))
    for depth in (1, 5):
        cam2 = dataclasses.replace(cam, max_depth=depth)
        probe(f"trace depth={depth}", wavefront.trace, scene, cam2, o, d, tm, stream, 0,
              warmup=1, iters=3)

    a3 = torch.ones((n, 3), device=dev)
    probe("[R,3] fma+dot", lambda a, b: torch.sum(a * b + a, dim=-1), a3, a3.clone())
    at = torch.ones((3, n), device=dev)
    probe("[3,R] fma+dot", lambda a, b: torch.sum(a * b + a, dim=0), at, at.clone())
    av, bv = V3(*torch.ones((3, n), device=dev)), V3(*torch.ones((3, n), device=dev))
    probe("[R]x3 fma+dot", lambda a, b: (a.x * b.x + a.x + a.y * b.y + a.y
                                         + a.z * b.z + a.z), av, bv)
    return times


if __name__ == "__main__":
    main()
