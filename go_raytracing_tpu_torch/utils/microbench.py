"""Micro-benchmarks after the reference's rt/benchmark_test.go, the JAX
package's module of the same name in PyTorch.

Run: ``python -m go_raytracing_tpu_torch.utils.microbench [--rays N]
[--tris N] [--device cpu]`` (on the GPU unless ``--device cpu``).

Reference parity (rt/benchmark_test.go):
  - BenchmarkRayAABBIntersection (:82-95)  -> bench_aabb_slab
  - BenchmarkVec3Operations (:98-125)      -> bench_vec_ops
  - BenchmarkBVHConstruction (:128-146)    -> bench_bvh_build (mesh proto)
  - BenchmarkBVHTraversal (:194-235)       -> bench_sphere_field / bench_mesh
  - QuickBenchmark (:164-191)              -> bench_quick_cornell
Each prints its name, the rate and the time of one call: on the GPU from
CUDA events around a run of calls after a warm-up call, on the CPU from
the host clock.  Each returns its seconds a call.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..core.vec3 import V3
from .device import resolve_device


def timeit(fn, *args, device, warmup=1, iters=5):
    """(seconds a call, last output) of ``fn(*args)`` on ``device``."""
    for _ in range(warmup):
        out = fn(*args)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters, out


def _normal(rng, shape, device, scale=1.0):
    return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                           device=device)


def bench_vec_ops(n, device):
    from ..core import vec

    rng = np.random.default_rng(0)
    a, b = _normal(rng, (n, 3), device), _normal(rng, (n, 3), device)
    out = {}
    for name, fn in [("add", lambda x, y: x + y), ("dot", vec.dot),
                     ("cross", vec.cross), ("normalize", lambda x, y: vec.unit(x))]:
        dt, _ = timeit(fn, a, b, device=device)
        print(f"vec3/{name:10s}: {n / dt / 1e6:10.1f} Mops/s  ({dt*1e3:.3f} ms)")
        out[name] = dt
    return out


def bench_aabb_slab(n, device):
    from ..ops import cuda_mesh

    rng = np.random.default_rng(0)
    o = _normal(rng, (3, n), device, 2.0)
    d = _normal(rng, (3, n), device)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, 1e-9, d)
    box = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    near = torch.full((n,), 1e-3, device=device)
    far = torch.full((n,), 1e9, device=device)
    dt, _ = timeit(lambda: cuda_mesh._slab(box, o, inv, near, far)[0], device=device)
    print(f"aabb_slab      : {n / dt / 1e6:10.1f} Mrays/s  ({dt*1e3:.3f} ms)")
    return dt


def bench_sphere_field(n_rays, device, n_spheres=1000):
    """1000-sphere closest hit (BenchmarkBVHTraversal's shape), the
    standard integrator's sphere kernel."""
    from ..geometry.scene import SceneBuilder
    from ..ops import cuda_intersect

    rng = np.random.default_rng(0)
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    for _ in range(n_spheres):
        b.sphere(tuple(rng.uniform(-50, 50, 3)), float(rng.uniform(0.5, 2.0)), m)
    scene = b.build(device=device)
    o = V3(*torch.as_tensor(rng.uniform(-60, 60, (3, n_rays)), dtype=torch.float32,
                            device=device))
    d = V3(*_normal(rng, (3, n_rays), device))
    tm = torch.zeros(n_rays, device=device)
    tmax = torch.full((n_rays,), 1e9, device=device)
    dt, _ = timeit(cuda_intersect.sphere_closest, scene.spheres, o, d, tm, tmax,
                   device=device)
    print(f"sphere_field({n_spheres:4d}): {n_rays / dt / 1e6:8.1f} Mrays/s  ({dt*1e3:.3f} ms)")
    return dt


def bench_bvh_build(n_tris, device):
    from ..geometry import mesh_bvh
    from ..io import obj as obj_mod

    seg = max(int(np.sqrt(n_tris / 2)), 8)
    verts, tris = obj_mod.lucy_standin(seg, seg + 1)
    t0 = time.perf_counter()
    proto = mesh_bvh.build_proto(verts, tris, [(np.eye(4), 0)], device)
    dt = time.perf_counter() - t0
    print(f"bvh_build({len(tris):7d} tris): {dt:.2f} s  depth={proto.depth}")
    return proto


def bench_mesh(n_rays, proto, device):
    from ..integrator import wavefront

    rng = np.random.default_rng(0)
    o = np.zeros((3, n_rays))
    o[1], o[2] = 800.0, 2000.0
    targets = np.stack([rng.uniform(-400, 400, n_rays), rng.uniform(0, 1500, n_rays),
                        np.zeros(n_rays)])
    d = V3(*torch.as_tensor(targets - o, dtype=torch.float32, device=device))
    o = V3(*torch.as_tensor(o, dtype=torch.float32, device=device))
    tmax = torch.full((n_rays,), 1e9, device=device)
    dt, out = timeit(wavefront._mesh_intersect, proto, o, d, 1e-3, tmax, device=device)
    hits = int(out[3].sum())
    print(f"mesh_traverse  : {n_rays / dt / 1e6:10.2f} Mrays/s  ({dt*1e3:.3f} ms, {hits} hits)")
    return dt


def bench_quick_cornell(device, width=160, spp=1, depth=3):
    """QuickBenchmark: a small Cornell render's camera rays a second
    (rt/benchmark_test.go:164-191)."""
    import go_raytracing_tpu_torch as grt

    scene, cam = grt.load_scene("cornell", device=device)
    cam = dataclasses.replace(cam, image_width=width, aspect_ratio=16.0 / 9.0,
                              samples_per_pixel=spp, max_depth=depth)
    dt, _ = timeit(lambda s: grt.render(scene, cam, spp=spp, seed=s, device=device), 1,
                   device=device, iters=1)
    n = cam.image_width * cam.image_height * spp
    print(f"quick_cornell  : {n / dt / 1e6:10.2f} Mrays/s  ({dt*1e3:.1f} ms)")
    return dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 18)
    ap.add_argument("--tris", type=int, default=40_000)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    bench_vec_ops(args.rays, dev)
    bench_aabb_slab(args.rays, dev)
    bench_sphere_field(args.rays, dev)
    proto = bench_bvh_build(args.tris, dev)
    bench_mesh(args.rays, proto, dev)
    bench_quick_cornell(dev)


if __name__ == "__main__":
    main()
