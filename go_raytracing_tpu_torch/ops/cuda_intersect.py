"""Closest-hit kernels of the standard integrator.

Counterpart of the JAX package's ``ops/pallas_intersect.py``: per ray the
nearest hit over all planar primitives (``planar_closest``) or over all
moving spheres at the ray's time (``sphere_closest``), and the variants
that also hand out the winner's geometry and its denormalized material
constants (``planar_closest_attrs``, ``sphere_closest_attrs``), so that
the non-differentiable render needs no table lookup per ray afterwards.

Each wrapper launches its CUDA kernel (``csrc/intersect.cu``, built at
first use by ``ops/_build.py``) when the rays lie on a GPU, or raises; for
rays on the CPU it runs the plain PyTorch version beside it, and only
because they lie there.  There is no fallback from one to the other, and no
switch that turns the kernels off.  The plain versions sweep primitive by
primitive on ``[R]`` tensors with the kernels' own arithmetic, so on one
GPU the two agree on every ray; the tests use them and the GPU check holds
the kernels against them.

The kernels see numbers, not graphs: inputs are detached, and ``t``, the
winner and the attributes carry no gradient.  The differentiable route of
``integrator/wavefront`` takes only (t, idx, hit) from here and rebuilds
the hit record from the tables by indexing.

Interval rules: planes accept ``t_min < t < t_max``, the other planar kinds
``t_min <= t <= t_max``, spheres ``t_min < root < t_max`` for the near root
and else the far one.  ``t_max >= BIG`` counts as BIG.  A ray with
``t_max < t_min`` (dead lanes and inactive shadow rays come in with -1)
misses: ``t = BIG``, ``idx = 0``, ``hit = False``, attributes 0.  On an
exact tie the first primitive in table order wins.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.vec3 import V3
from ..geometry import packs

BIG = float(packs.BIG)
EPS_PARALLEL = float(np.float32(1e-8))

SPHERE_ATTRS = 10  # ctx, cty, ctz, rad2, kindpack, fuzz, ior, colr, colg, colb
PLANAR_ATTRS = 12  # nx, ny, nz, alpha, beta, kindpack, fuzz, ior, colr/g/b, kind
CHECKER_EXTRA = 7  # evenr/g/b, oddr/g/b, inv_scale (both layouts)

PLANAR_ROWS = 15   # normal(3) d q(3) vxw(3) wxu(3) rad2 kind
SPHERE_ROWS = 7    # centre(3) velocity(3) rad2
CONST_ROWS = 14    # kindpack fuzz ior col(3) even(3) odd(3) scale tex_id

# Kernel launches made by the wrappers (CUDA tensors only).
LAUNCHES_PLANAR = 0         # planar_closest
LAUNCHES_SPHERE = 0         # sphere_closest
LAUNCHES_PLANAR_ATTRS = 0   # planar_closest_attrs
LAUNCHES_SPHERE_ATTRS = 0   # sphere_closest_attrs


# -----------------------------------------------------------------------------
# Tables
# -----------------------------------------------------------------------------

def planar_table(pack: packs.PlanarPack):
    """[15, N] float32: what the planar sweep reads, one column a primitive."""
    vxw = torch.linalg.cross(pack.v, pack.w, dim=-1)
    wxu = torch.linalg.cross(pack.w, pack.u, dim=-1)
    return torch.stack([
        pack.normal[:, 0], pack.normal[:, 1], pack.normal[:, 2], pack.d,
        pack.q[:, 0], pack.q[:, 1], pack.q[:, 2],
        vxw[:, 0], vxw[:, 1], vxw[:, 2],
        wxu[:, 0], wxu[:, 1], wxu[:, 2],
        pack.radius * pack.radius, pack.kind.to(torch.float32),
    ]).detach().contiguous()


def sphere_table(pack: packs.SpherePack):
    """[7, N] float32: what the sphere sweep reads."""
    return torch.stack([
        pack.center[:, 0], pack.center[:, 1], pack.center[:, 2],
        pack.velocity[:, 0], pack.velocity[:, 1], pack.velocity[:, 2],
        pack.radius * pack.radius,
    ]).detach().contiguous()


def _material_consts(materials, textures, prim_mat):
    """[14, N] float32: each primitive's material and texture constants,
    joined once per table so that no ray looks them up.  Row 0 is
    ``kindpack = mat_kind * 8 + tex_kind`` (both below 8), carried as a
    float like the other rows."""
    mat = prim_mat.long()
    kind = materials.kind[mat]
    tex = materials.tex[mat].long()
    texkind = textures.kind[tex]
    scale = torch.where(texkind == 1, textures.inv_scale[tex],
                        textures.noise_scale[tex])
    return torch.stack([
        (kind * 8 + texkind).to(torch.float32),
        materials.fuzz[mat], materials.ior[mat],
        textures.color[:, 0][tex], textures.color[:, 1][tex],
        textures.color[:, 2][tex],
        textures.even_color[:, 0][tex], textures.even_color[:, 1][tex],
        textures.even_color[:, 2][tex],
        textures.odd_color[:, 0][tex], textures.odd_color[:, 1][tex],
        textures.odd_color[:, 2][tex],
        scale, tex.to(torch.float32),
    ]).detach().contiguous()


# -----------------------------------------------------------------------------
# Plain PyTorch versions
# -----------------------------------------------------------------------------
# Written to repeat the kernels' arithmetic operation for operation (same
# order of products and sums, primitive by primitive, strict t < t_best), so
# that no [R, N] pair buffer is ever made and ties go to the first index.

def _clamp_t_max(t_max):
    return torch.where(t_max >= BIG, BIG, t_max)


def _planar_sweep_plain(geo, o, d, t_max, t_min):
    """(t_best, idx_best (-1 on a miss), alpha, beta) over the table."""
    r = t_max.shape[0]
    dev = t_max.device
    t_best = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    idx_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    alpha_best = torch.zeros((r,), dtype=torch.float32, device=dev)
    beta_best = torch.zeros((r,), dtype=torch.float32, device=dev)
    kinds = geo[14].tolist()
    for j, kind in enumerate(kinds):
        nx, ny, nz = geo[0, j], geo[1, j], geo[2, j]
        denom = d[0] * nx + d[1] * ny + d[2] * nz
        not_par = torch.abs(denom) >= EPS_PARALLEL
        t = (geo[3, j] - (o[0] * nx + o[1] * ny + o[2] * nz)) / torch.where(
            not_par, denom, 1.0)
        if kind == packs.KIND_PLANE:
            t_ok = (t > t_min) & (t < t_max)
        else:
            t_ok = (t >= t_min) & (t <= t_max)
        rx = o[0] + t * d[0] - geo[4, j]
        ry = o[1] + t * d[1] - geo[5, j]
        rz = o[2] + t * d[2] - geo[6, j]
        alpha = rx * geo[7, j] + ry * geo[8, j] + rz * geo[9, j]
        beta = rx * geo[10, j] + ry * geo[11, j] + rz * geo[12, j]
        if kind == packs.KIND_QUAD:
            interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
        elif kind == packs.KIND_TRI:
            interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (alpha + beta <= 1.0)
        elif kind == packs.KIND_CIRCLE:
            interior = (rx * rx + ry * ry + rz * rz) <= geo[13, j]
        elif kind == packs.KIND_PLANE:
            interior = torch.ones_like(not_par)
        else:
            continue
        upd = not_par & t_ok & interior & (t < t_best)
        t_best = torch.where(upd, t, t_best)
        idx_best = torch.where(upd, j, idx_best)
        alpha_best = torch.where(upd, alpha, alpha_best)
        beta_best = torch.where(upd, beta, beta_best)
    return t_best, idx_best, alpha_best, beta_best


def _sphere_sweep_plain(geo, o, d, tm, t_max, t_min):
    """(t_best, idx_best (-1 on a miss)) over the table."""
    r = t_max.shape[0]
    dev = t_max.device
    t_best = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    idx_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    a_coef = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    inv_a = 1.0 / a_coef
    for j in range(geo.shape[1]):
        ocx = (geo[0, j] + tm * geo[3, j]) - o[0]
        ocy = (geo[1, j] + tm * geo[4, j]) - o[1]
        ocz = (geo[2, j] + tm * geo[5, j]) - o[2]
        h = d[0] * ocx + d[1] * ocy + d[2] * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - geo[6, j]
        disc = h * h - a_coef * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        r0 = (h - sq) * inv_a
        r1 = (h + sq) * inv_a
        ok0 = (r0 > t_min) & (r0 < t_max)
        ok1 = (r1 > t_min) & (r1 < t_max)
        root = torch.where(ok0, r0, r1)
        upd = (disc >= 0.0) & (ok0 | ok1) & (root < t_best)
        t_best = torch.where(upd, root, t_best)
        idx_best = torch.where(upd, j, idx_best)
    return t_best, idx_best


def _finish(t_best, idx_best):
    hit = idx_best >= 0
    return t_best, torch.clamp_min(idx_best, 0), hit


def _planar_closest_plain(geo, o, d, t_max, t_min):
    t_best, idx_best, _, _ = _planar_sweep_plain(geo, o, d, _clamp_t_max(t_max), t_min)
    return _finish(t_best, idx_best)


def _sphere_closest_plain(geo, o, d, tm, t_max, t_min):
    return _finish(*_sphere_sweep_plain(geo, o, d, tm, _clamp_t_max(t_max), t_min))


def _planar_attr_rows(n_attr):
    """Constant-table row of each attribute from 5 on (-1: the planar kind)."""
    return list(range(6)) + [-1] + list(range(6, 6 + n_attr - PLANAR_ATTRS))


def _planar_closest_attrs_plain(geo, con, o, d, t_max, t_min, n_attr):
    t_best, idx_best, alpha, beta = _planar_sweep_plain(
        geo, o, d, _clamp_t_max(t_max), t_min)
    t, idx, hit = _finish(t_best, idx_best)
    col = idx.long()
    rows = [geo[0][col], geo[1][col], geo[2][col], alpha, beta]
    rows += [geo[14][col] if k < 0 else con[k][col]
             for k in _planar_attr_rows(n_attr)]
    attrs = torch.where(hit[None], torch.stack(rows), 0.0)
    return t, idx, hit, attrs


def _sphere_closest_attrs_plain(geo, con, o, d, tm, t_max, t_min, n_attr):
    t, idx, hit = _finish(*_sphere_sweep_plain(
        geo, o, d, tm, _clamp_t_max(t_max), t_min))
    col = idx.long()
    rows = [geo[k][col] + tm * geo[k + 3][col] for k in range(3)]
    rows.append(geo[6][col])
    rows += [con[k][col] for k in range(n_attr - 4)]
    attrs = torch.where(hit[None], torch.stack(rows), 0.0)
    return t, idx, hit, attrs


# -----------------------------------------------------------------------------
# Kernel wrappers
# -----------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_PLANAR_ARGTYPES = [_P, _I] + [_P] * 7 + [_L, _F] + [_P] * 3 + [_P]
_SPHERE_ARGTYPES = [_P, _I] + [_P] * 8 + [_L, _F] + [_P] * 3 + [_P]
_PLANAR_ATTRS_ARGTYPES = [_P, _P, _I] + [_P] * 7 + [_L, _F] + [_P] * 4 + [_I, _P]
_SPHERE_ATTRS_ARGTYPES = [_P, _P, _I] + [_P] * 8 + [_L, _F] + [_P] * 4 + [_I, _P]


def _kernel(function: str, argtypes):
    from . import _build

    fn = getattr(_build.load("intersect").lib, function)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(tables, rays, r):
    """Raise on what the kernels do not take."""
    dev = rays[0].device
    for a in rays:
        if a.device != dev or a.dtype != torch.float32 or a.shape != (r,) \
                or not a.is_contiguous():
            raise ValueError(
                "rays must be contiguous float32 [R] tensors on one CUDA "
                f"device, got {a.dtype} {tuple(a.shape)} on {a.device}")
    n = tables[0][0].shape[1]
    for tab, rows in tables:
        if tab.device != dev or tab.dtype != torch.float32 \
                or tuple(tab.shape) != (rows, n) or not tab.is_contiguous() \
                or n < 1:
            raise ValueError(
                f"expected a contiguous float32 [{rows}, {n}] table on {dev} "
                f"with at least one primitive, got {tab.dtype} "
                f"{tuple(tab.shape)} on {tab.device}")


def _outputs(r, dev, n_attr=None):
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    idx = torch.empty((r,), dtype=torch.int32, device=dev)
    hit = torch.empty((r,), dtype=torch.uint8, device=dev)
    if n_attr is None:
        return t, idx, hit
    return t, idx, hit, torch.empty((n_attr, r), dtype=torch.float32, device=dev)


def _launch(function, argtypes, dev, args):
    fn = _kernel(function, argtypes)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{function} failed: CUDA error {err}")


def planar_occupancy(attrs=False):
    """(blocks an SM holds at once, threads a block) of the gated planar
    kernel, alone or with 12 attribute rows, on the current CUDA device."""
    fn = _kernel("planar_occupancy", [_I] + [ctypes.POINTER(ctypes.c_int)] * 2)
    out = [ctypes.c_int() for _ in range(2)]
    err = fn(int(attrs), *(ctypes.byref(c) for c in out))
    if err != 0:
        raise RuntimeError(f"planar_occupancy failed: CUDA error {err}")
    return tuple(c.value for c in out)


def sphere_occupancy(attrs=False):
    """(blocks an SM holds at once, threads a block) of the sphere kernel
    (``attrs``: the one that writes the winner's attributes) on the current
    CUDA device, from its registers and shared memory."""
    fn = _kernel("sphere_occupancy", [_I] + [ctypes.POINTER(ctypes.c_int)] * 2)
    out = [ctypes.c_int() for _ in range(2)]
    err = fn(int(attrs), *(ctypes.byref(c) for c in out))
    if err != 0:
        raise RuntimeError(f"sphere_occupancy failed: CUDA error {err}")
    return tuple(c.value for c in out)


def _ptrs(*tensors):
    return [a.data_ptr() for a in tensors]


def _planar_closest_cuda(geo, o, d, t_max, t_min):
    """Launch on PyTorch's current stream; does not synchronize."""
    global LAUNCHES_PLANAR
    r = t_max.shape[0]
    _check([(geo, PLANAR_ROWS)], [*o, *d, t_max], r)
    t, idx, hit = _outputs(r, t_max.device)
    if r:
        _launch("planar_closest_launch", _PLANAR_ARGTYPES, t_max.device,
                [geo.data_ptr(), geo.shape[1], *_ptrs(*o, *d, t_max), r,
                 float(t_min), *_ptrs(t, idx, hit)])
        LAUNCHES_PLANAR += 1
    return t, idx, hit.view(torch.bool)


def _sphere_closest_cuda(geo, o, d, tm, t_max, t_min):
    global LAUNCHES_SPHERE
    r = t_max.shape[0]
    _check([(geo, SPHERE_ROWS)], [*o, *d, tm, t_max], r)
    t, idx, hit = _outputs(r, t_max.device)
    if r:
        _launch("sphere_closest_launch", _SPHERE_ARGTYPES, t_max.device,
                [geo.data_ptr(), geo.shape[1], *_ptrs(*o, *d, tm, t_max), r,
                 float(t_min), *_ptrs(t, idx, hit)])
        LAUNCHES_SPHERE += 1
    return t, idx, hit.view(torch.bool)


def _planar_closest_attrs_cuda(geo, con, o, d, t_max, t_min, n_attr):
    global LAUNCHES_PLANAR_ATTRS
    r = t_max.shape[0]
    _check([(geo, PLANAR_ROWS), (con, CONST_ROWS)], [*o, *d, t_max], r)
    t, idx, hit, attrs = _outputs(r, t_max.device, n_attr)
    if r:
        _launch("planar_closest_attrs_launch", _PLANAR_ATTRS_ARGTYPES,
                t_max.device,
                [geo.data_ptr(), con.data_ptr(), geo.shape[1],
                 *_ptrs(*o, *d, t_max), r, float(t_min),
                 *_ptrs(t, idx, hit, attrs), n_attr])
        LAUNCHES_PLANAR_ATTRS += 1
    return t, idx, hit.view(torch.bool), attrs


def _sphere_closest_attrs_cuda(geo, con, o, d, tm, t_max, t_min, n_attr):
    global LAUNCHES_SPHERE_ATTRS
    r = t_max.shape[0]
    _check([(geo, SPHERE_ROWS), (con, CONST_ROWS)], [*o, *d, tm, t_max], r)
    t, idx, hit, attrs = _outputs(r, t_max.device, n_attr)
    if r:
        _launch("sphere_closest_attrs_launch", _SPHERE_ATTRS_ARGTYPES,
                t_max.device,
                [geo.data_ptr(), con.data_ptr(), geo.shape[1],
                 *_ptrs(*o, *d, tm, t_max), r, float(t_min),
                 *_ptrs(t, idx, hit, attrs), n_attr])
        LAUNCHES_SPHERE_ATTRS += 1
    return t, idx, hit.view(torch.bool), attrs


def _rays(*vs):
    """V3s and [R] tensors -> detached contiguous float32 components."""
    out = []
    for v in vs:
        comps = list(v) if isinstance(v, V3) else [v]
        out.append([c.detach().to(torch.float32).contiguous() for c in comps])
    return out


def _check_n_attr(n_attr, base):
    if not base <= n_attr <= base + CHECKER_EXTRA + 1:
        raise ValueError(f"n_attr must lie in [{base}, {base + CHECKER_EXTRA + 1}], "
                         f"got {n_attr}")


def planar_closest_table(geo, o: V3, d: V3, t_max, *, t_min=1e-3):
    """``planar_closest`` on a prepared ``planar_table``."""
    o_, d_, (t_max_,) = _rays(o, d, t_max)
    impl = _planar_closest_cuda if t_max_.is_cuda else _planar_closest_plain
    return impl(geo, o_, d_, t_max_, float(np.float32(t_min)))


def sphere_closest_table(geo, o: V3, d: V3, tm, t_max, *, t_min=1e-3):
    """``sphere_closest`` on a prepared ``sphere_table``."""
    o_, d_, (tm_,), (t_max_,) = _rays(o, d, tm, t_max)
    impl = _sphere_closest_cuda if t_max_.is_cuda else _sphere_closest_plain
    return impl(geo, o_, d_, tm_, t_max_, float(np.float32(t_min)))


def planar_closest_attrs_table(geo, con, o: V3, d: V3, t_max, *, t_min=1e-3,
                               n_attr=PLANAR_ATTRS):
    """``planar_closest_attrs`` on prepared tables."""
    _check_n_attr(n_attr, PLANAR_ATTRS)
    o_, d_, (t_max_,) = _rays(o, d, t_max)
    impl = (_planar_closest_attrs_cuda if t_max_.is_cuda
            else _planar_closest_attrs_plain)
    return impl(geo, con, o_, d_, t_max_, float(np.float32(t_min)), n_attr)


def sphere_closest_attrs_table(geo, con, o: V3, d: V3, tm, t_max, *, t_min=1e-3,
                               n_attr=SPHERE_ATTRS):
    """``sphere_closest_attrs`` on prepared tables."""
    _check_n_attr(n_attr, SPHERE_ATTRS)
    o_, d_, (tm_,), (t_max_,) = _rays(o, d, tm, t_max)
    impl = (_sphere_closest_attrs_cuda if t_max_.is_cuda
            else _sphere_closest_attrs_plain)
    return impl(geo, con, o_, d_, tm_, t_max_, float(np.float32(t_min)), n_attr)


def planar_closest(pack: packs.PlanarPack, o: V3, d: V3, t_max, *, t_min=1e-3):
    """Closest planar hit.  Returns (t [R], idx [R] i32, hit [R] bool).
    CUDA rays launch the kernel (or raise); CPU rays run the plain version.
    The pack must hold at least one primitive."""
    return planar_closest_table(planar_table(pack), o, d, t_max, t_min=t_min)


def sphere_closest(pack: packs.SpherePack, o: V3, d: V3, tm, t_max, *,
                   t_min=1e-3):
    """Closest sphere hit, spheres taken at each ray's time ``tm``.
    Returns (t [R], idx [R] i32, hit [R] bool)."""
    return sphere_closest_table(sphere_table(pack), o, d, tm, t_max, t_min=t_min)


def planar_closest_attrs(pack: packs.PlanarPack, mat_consts, o: V3, d: V3,
                         t_max, *, t_min=1e-3, n_attr=PLANAR_ATTRS):
    """Closest planar hit and the winner's attributes.

    Returns (t, idx, hit, attrs [n_attr, R]) with attrs = nx, ny, nz, alpha,
    beta, kindpack, fuzz, ior, colour r/g/b, planar kind (+ even r/g/b, odd
    r/g/b, scale when n_attr = 19).  ``mat_consts``: ``_material_consts`` of
    the pack's materials."""
    return planar_closest_attrs_table(planar_table(pack), mat_consts, o, d,
                                      t_max, t_min=t_min, n_attr=n_attr)


def sphere_closest_attrs(pack: packs.SpherePack, mat_consts, o: V3, d: V3, tm,
                         t_max, *, t_min=1e-3, n_attr=SPHERE_ATTRS):
    """Closest sphere hit and the winner's attributes.

    Returns (t, idx, hit, attrs [n_attr, R]) with attrs = centre x/y/z at
    the ray's time, radius^2, kindpack, fuzz, ior, colour r/g/b (+ even
    r/g/b, odd r/g/b, scale when n_attr = 17)."""
    return sphere_closest_attrs_table(sphere_table(pack), mat_consts, o, d, tm,
                                      t_max, t_min=t_min, n_attr=n_attr)
