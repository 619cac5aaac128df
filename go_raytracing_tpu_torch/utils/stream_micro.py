"""Tile-sweep probe: the cost of one Moller-Trumbore sweep of the mesh tile
stream (B10) alone, in five variants.

Counterpart of the JAX package's ``scripts/stream_micro.py``.  A probe block
is [7, 8, 128] rays (origin, direction, t_cap); the 64 tiles are
[64, 16, 128] (v0, e1, e2 in rows 0-8, one triangle a lane).  Every output
(row, lane) keeps the running closest hit over ``n_sweeps`` sweeps: sweep
``slot`` tests triangle ``lane`` of tile ``tid`` against a ray (strict <,
t >= 1e-3, t < t_cap) and records ``(tid * 128 + lane) << 5``.

    variant    ray tested                         tile          loop
    sweeponly  its own                            0             dense
    fori+tri   its own                            slot % 64     dense
    fori+roll  ray slot % 128 of its row, to all  slot % 64     dense
    while      its own                            slot % 64     bit scan
    full       as fori+roll                       slot % 64     bit scan

The bit scan visits the slots of 32-bit words with every bit set, lowest
bit first: the slots of the dense loop in the same order, but only
32 * (n_sweeps // 32) of them.

``stream_micro`` launches the kernel of ``csrc/stream_micro.cu`` (built at
first use by ``ops/_build.py``) for CUDA tensors, or raises; CPU tensors
run the plain version ``_stream_micro_plain``, and only because they lie on
the CPU.

    python -m go_raytracing_tpu_torch.utils.stream_micro [--sweeps 512]
        [--blocks 512] [--device {cuda,cpu}]

times each variant on the card (one warm-up, then the mean of three
launches by CUDA events) and prints ms and ns a sweep (a sweep: one probe
block against one tile, 1,024 tests).  The inputs are the JAX script's:
normal draws of ``numpy.random.default_rng(0)``.
"""

from __future__ import annotations

import argparse
import ctypes
import time

import numpy as np
import torch

from .device import resolve_device

GROUP, LANES, TRI_ROWS, TILE, N_TILES, RAY_ROWS = 8, 128, 16, 128, 64, 7
BIG = 3.0e38
# variant -> (ray of the row broadcast, tile chosen by slot, bit scan)
VARIANTS = {
    "sweeponly": (False, False, False),
    "fori+tri": (False, True, False),
    "fori+roll": (True, True, False),
    "while": (False, True, True),
    "full": (True, True, True),
}
LAUNCHES = 0   # kernel launches (CUDA tensors only)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def probe_inputs(n_blocks: int, device="cpu"):
    """(rays [n_blocks, 7, 8, 128], tri [64, 16, 128]) float32: the JAX
    script's inputs, normal draws of ``default_rng(0)`` in its order."""
    rng = np.random.default_rng(0)
    rays = rng.normal(size=(n_blocks, RAY_ROWS, GROUP, LANES)).astype(np.float32)
    tri = rng.normal(size=(N_TILES, TRI_ROWS, TILE)).astype(np.float32)
    return (torch.from_numpy(rays).to(device), torch.from_numpy(tri).to(device))


def slots(n_sweeps: int, variant: str):
    """The slots a variant sweeps, in order."""
    return range(32 * (n_sweeps // 32) if VARIANTS[variant][2] else n_sweeps)


def _candidates(rays, tri, slot: int, variant: str):
    """One sweep of the plain version: (t [n_blocks, 8, 128], whether the
    test passes, the id it records), before the compare with the best so
    far; the kernel's operations in its order."""
    roll, dyn_tri, _ = VARIANTS[variant]
    if roll:
        g = slot % LANES
        ray = [rays[:, c, :, g:g + 1] for c in range(RAY_ROWS)]   # [B, 8, 1]
    else:
        ray = [rays[:, c] for c in range(RAY_ROWS)]
    o, d, cap = ray[0:3], ray[3:6], ray[6]
    tid = slot % N_TILES if dyn_tri else 0
    v0, e1, e2 = tri[tid, 0:3], tri[tid, 3:6], tri[tid, 6:9]
    hx = d[1] * e2[2] - d[2] * e2[1]
    hy = d[2] * e2[0] - d[0] * e2[2]
    hz = d[0] * e2[1] - d[1] * e2[0]
    a = e1[0] * hx + e1[1] * hy + e1[2] * hz
    par = torch.abs(a) < 1e-8
    f = 1.0 / torch.where(par, 1.0, a)
    sx, sy, sz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = f * (d[0] * qx + d[1] * qy + d[2] * qz)
    tc = f * (e2[0] * qx + e2[1] * qy + e2[2] * qz)
    ok = (~par & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (tc >= 1e-3) & (tc < cap))
    lane = torch.arange(LANES, dtype=torch.int32, device=rays.device)
    return tc, ok, (tid * TILE + lane) << 5


def _stream_micro_plain(rays, tri, n_sweeps: int, variant: str):
    """Plain version: every output at once ([n_blocks, 8, 128] tensors),
    the sweeps in slot order."""
    best_t = torch.full(rays.shape[:1] + (GROUP, LANES), BIG, dtype=torch.float32,
                        device=rays.device)
    best_id = torch.full_like(best_t, -1, dtype=torch.int32)
    for slot in slots(n_sweeps, variant):
        tc, ok, pid = _candidates(rays, tri, slot, variant)
        ok = ok & (tc < best_t)
        best_t = torch.where(ok, tc, best_t)
        best_id = torch.where(ok, pid, best_id)
    return best_t, best_id


def _check(rays, tri, n_sweeps: int, variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {sorted(VARIANTS)}")
    if rays.dim() != 4 or tuple(rays.shape[1:]) != (RAY_ROWS, GROUP, LANES) \
            or rays.shape[0] < 1:
        raise ValueError(f"rays must be [n_blocks, 7, 8, 128], got {tuple(rays.shape)}")
    if tuple(tri.shape) != (N_TILES, TRI_ROWS, TILE):
        raise ValueError(f"tri must be [64, 16, 128], got {tuple(tri.shape)}")
    if rays.dtype != torch.float32 or tri.dtype != torch.float32 \
            or rays.device != tri.device:
        raise ValueError("rays and tri must be float32 tensors on one device")
    if n_sweeps < 0:
        raise ValueError("n_sweeps must not be negative")


def _stream_micro_cuda(rays, tri, n_sweeps: int, variant: str):
    """Launch the kernel on PyTorch's current stream; does not synchronize."""
    global LAUNCHES
    from ..ops import _build

    fn = _build.load("stream_micro").lib.stream_micro_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    rays, tri = rays.contiguous(), tri.contiguous()
    t = torch.empty(rays.shape[:1] + (GROUP, LANES), dtype=torch.float32,
                    device=rays.device)
    ids = torch.empty_like(t, dtype=torch.int32)
    with torch.cuda.device(rays.device):
        err = fn(rays.data_ptr(), tri.data_ptr(), t.data_ptr(), ids.data_ptr(),
                 rays.shape[0], n_sweeps, list(VARIANTS).index(variant),
                 torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_micro kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, ids


def stream_micro(rays, tri, n_sweeps: int, variant: str):
    """The probe's outputs (t [n_blocks, 8, 128] f32, id [n_blocks, 8, 128]
    i32) for one variant.  CUDA tensors launch the kernel (or raise); CPU
    tensors run the plain version."""
    _check(rays, tri, n_sweeps, variant)
    impl = _stream_micro_cuda if rays.is_cuda else _stream_micro_plain
    return impl(rays, tri, n_sweeps, variant)


def time_variant(rays, tri, n_sweeps: int, variant: str, repeats: int = 3):
    """Mean ms of ``repeats`` calls after one warm-up (CUDA events on the
    card, the host clock on the CPU), and the last call's outputs."""
    out = stream_micro(rays, tri, n_sweeps, variant)
    if rays.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start.record()
        for _ in range(repeats):
            out = stream_micro(rays, tri, n_sweeps, variant)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / repeats, out
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = stream_micro(rays, tri, n_sweeps, variant)
    return (time.perf_counter() - t0) / repeats * 1e3, out


def run(n_blocks: int = 512, n_sweeps: int = 512, device=None, repeats: int = 3):
    """Every variant at the given size: {variant: dict(ms, ns_per_sweep,
    sweeps)}, a sweep being one probe block against one tile."""
    rays, tri = probe_inputs(n_blocks, resolve_device(device))
    out = {}
    for variant in VARIANTS:
        ms, _ = time_variant(rays, tri, n_sweeps, variant, repeats)
        n = n_blocks * len(slots(n_sweeps, variant))
        out[variant] = dict(ms=ms, ns_per_sweep=ms * 1e6 / max(n, 1), sweeps=n)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="tile-sweep probe of the mesh stream")
    ap.add_argument("--sweeps", type=int, default=512)
    ap.add_argument("--blocks", type=int, default=512)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where to run (default: cuda; fails without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    for variant, r in run(args.blocks, args.sweeps, dev).items():
        print(f"{variant:10s} {r['ms']:8.3f} ms  {r['ns_per_sweep']:8.2f} ns/sweep")


if __name__ == "__main__":
    main()
