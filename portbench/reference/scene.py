"""A configuration's scene, environment and camera rays, built by the plain
reference from the configuration file alone.

The scene is a list of builder steps (``configs/<name>.json``, key
``scene``).  Ids are given as the program's scene builder gives them, so a
gradient table of the program and of the reference index the same
textures and materials: a colour makes a solid texture, a dielectric makes
a white one, a volume makes its isotropic material.  Every table is packed
again here, from float64 on the host, row for row as the forward kernel
reads it; nothing the program built is read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

KIND_QUAD, KIND_PLANE = 0, 3
MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_LIGHT, MAT_ISOTROPIC = 0, 1, 2, 3, 4
TEX_SOLID, TEX_CHECKER = 0, 1
PT_ROWS, ST_ROWS, VT_ROWS, LT_ROWS = 31, 23, 25, 17
TWO_PI = 2.0 * np.pi


@dataclass
class Tables:
    pt: torch.Tensor
    st: torch.Tensor
    vt: torch.Tensor
    lt: torch.Tensor
    n_planar: int
    n_sphere: int
    n_vol: int
    n_lights: int


@dataclass
class Environment:
    data: torch.Tensor        # [H, W, 3] linear radiance
    rotation: torch.Tensor    # scalar radians, float32
    pdf: torch.Tensor         # [H, W] the density the alias table encodes
    alias_idx: torch.Tensor   # [H * W] i32
    alias_cut: torch.Tensor   # [H * W] f32


@dataclass
class RefScene:
    tables: Tables
    n_tex: int
    n_mat: int
    env: Environment | None
    cam: dict
    tier: str   # the gradient tier the program takes: "product", "pathwise" or "fused"


def _trs(rotation_deg, position):
    """Rotation about x, then y, then z, then translation (the builder's
    order, in its numpy arithmetic; no scale): a 4x4 float64 matrix."""
    rx, ry, rz = (np.deg2rad(a) for a in rotation_deg)

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        m = np.eye(4)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i], m[j, j] = c, c
        m[i, j], m[j, i] = (-s, s) if axis != 1 else (s, -s)
        return m

    t = np.eye(4)
    t[:3, 3] = position
    return t @ rot(2, rz) @ rot(1, ry) @ rot(0, rx)


def build(config: dict, sky, device) -> RefScene:
    """The configuration's scene on ``device``; ``sky`` is its environment
    array ([H, W, 3] float32) or None."""
    tex, mat, planar, spheres, vols, lights = [], [], [], [], [], []
    names = {}

    def solid(color):
        tex.append(dict(kind=TEX_SOLID, color=tuple(color)))
        return len(tex) - 1

    def material(kind, step, fuzz=0.0, ior=1.0):
        t = names[step["texture"]] if "texture" in step else solid(step["color"])
        mat.append((kind, t, fuzz, ior))
        return len(mat) - 1

    for step in config["scene"]:
        op = step["op"]
        if op == "checker":
            tex.append(dict(kind=TEX_CHECKER, even=tuple(step["even"]),
                            odd=tuple(step["odd"]), inv_scale=1.0 / step["scale"]))
            names[step["name"]] = len(tex) - 1
        elif op == "lambertian":
            names[step["name"]] = material(MAT_LAMBERTIAN, step)
        elif op == "metal":
            names[step["name"]] = material(MAT_METAL, step, fuzz=min(float(step["fuzz"]), 1.0))
        elif op == "dielectric":
            mat.append((MAT_DIELECTRIC, solid((1, 1, 1)), 0.0, float(step["ior"])))
            names[step["name"]] = len(mat) - 1
        elif op == "diffuse_light":
            names[step["name"]] = material(MAT_LIGHT, step)
        elif op in ("quad", "box"):
            m = names[step["material"]]
            xf = _trs(step.get("rotation_deg", (0, 0, 0)), step.get("position", (0, 0, 0)))
            if op == "quad":
                if "rotation_deg" in step or "position" in step:
                    raise ValueError("the plain reference moves boxes, not quads")
                faces = [(step["q"], step["u"], step["v"])]
            else:
                a, b = np.asarray(step["a"], np.float64), np.asarray(step["b"], np.float64)
                mn, mx = np.minimum(a, b), np.maximum(a, b)
                dx, dy, dz = np.diag(mx - mn)
                faces = [([mn[0], mn[1], mx[2]], dx, dy), ([mx[0], mn[1], mx[2]], -dz, dy),
                         ([mx[0], mn[1], mn[2]], -dx, dy), ([mn[0], mn[1], mn[2]], dz, dy),
                         ([mn[0], mx[1], mx[2]], dx, -dz), ([mn[0], mn[1], mn[2]], dx, dz)]
            for q, u, v in faces:
                q, u, v = (np.asarray(x, np.float64) for x in (q, u, v))
                if op == "box":
                    q = xf[:3, :3] @ q + xf[:3, 3]
                    u, v = xf[:3, :3] @ u, xf[:3, :3] @ v
                n = np.cross(u, v)
                normal = n / np.linalg.norm(n)
                planar.append((q, u, v, normal, n / (n @ n), float(normal @ q), KIND_QUAD, m))
                if step.get("light"):
                    lights.append(len(planar) - 1)
        elif op == "plane":
            normal = np.asarray(step["normal"], np.float64)
            normal = normal / np.linalg.norm(normal)
            point = np.asarray(step["point"], np.float64)
            z = np.zeros(3)
            planar.append((point, z, z, normal, z, float(normal @ point), KIND_PLANE,
                           names[step["material"]]))
        elif op == "sphere":
            spheres.append((np.asarray(step["center"], np.float64), float(step["radius"]),
                            names[step["material"]]))
        elif op == "volume_box":
            a, b = np.asarray(step["a"], np.float64), np.asarray(step["b"], np.float64)
            mat.append((MAT_ISOTROPIC, solid(step["color"]), 0.0, 1.0))
            vols.append((np.eye(4)[:3, :4], np.minimum(a, b), np.maximum(a, b),
                         -1.0 / float(step["density"]), len(mat) - 1))
        else:
            raise ValueError(f"the plain reference has no builder step {op!r}")

    def f32(rows):
        return torch.tensor(np.asarray(rows, np.float64), dtype=torch.float32, device=device)

    def mat_rows(m):
        kind, t, fuzz, ior = mat[m]
        tx = tex[t]
        scale = tx.get("inv_scale", 1.0) if tx["kind"] == TEX_CHECKER else 1.0
        return ([kind, tx["kind"], fuzz, ior] + list(tx.get("color", (0, 0, 0)))
                + list(tx.get("even", (0, 0, 0))) + list(tx.get("odd", (0, 0, 0)))
                + [scale, t, m])

    def stacked(rows, n_rows):
        if not rows:
            return torch.zeros((n_rows, 1), dtype=torch.float32, device=device)
        return torch.stack(rows, dim=0).contiguous()

    rows = []
    if planar:
        cols = [f32([p[i] for p in planar]) for i in range(6)]   # q u v normal w d
        q, u, v, normal, w, d = cols
        vxw = torch.linalg.cross(v, w, dim=-1)
        wxu = torch.linalg.cross(w, u, dim=-1)
        zero = torch.zeros_like(d)
        consts = f32([[p[6]] + mat_rows(p[7]) for p in planar]).T
        rows = ([normal[:, 0], normal[:, 1], normal[:, 2], d, q[:, 0], q[:, 1], q[:, 2],
                 vxw[:, 0], vxw[:, 1], vxw[:, 2], wxu[:, 0], wxu[:, 1], wxu[:, 2],
                 zero * zero] + list(consts))
    pt = stacked(rows, PT_ROWS)

    rows = []
    if spheres:
        c = f32([s[0] for s in spheres])
        r = f32([s[1] for s in spheres])
        zero = torch.zeros_like(r)
        rows = ([c[:, 0], c[:, 1], c[:, 2], zero, zero, zero, r * r]
                + list(f32([mat_rows(s[2]) for s in spheres]).T))
    st = stacked(rows, ST_ROWS)

    rows = []
    if vols:
        m44 = f32([v[0].reshape(12) for v in vols])
        rows = ([m44[:, i] for i in range(12)]
                + list(f32([list(v[1]) + list(v[2]) + [v[3]] for v in vols]).T)
                + list(f32([[mat[v[4]][0], tex[mat[v[4]][1]]["kind"]]
                            + list(tex[mat[v[4]][1]]["color"]) + [mat[v[4]][1]]
                            for v in vols]).T))
    vt = stacked(rows, VT_ROWS)

    rows = []
    if lights:
        lp = [planar[i] for i in lights]
        rows = list(f32([list(p[0]) + list(p[1]) + list(p[2]) + list(p[3])
                         + [np.linalg.norm(np.cross(p[1], p[2]))] for p in lp]).T)
        rows += list(f32([list(tex[mat[p[7]][1]]["color"]) + [mat[p[7]][1]] for p in lp]).T)
    lt = stacked(rows, LT_ROWS)

    tb = Tables(pt, st, vt, lt, len(planar), len(spheres), len(vols), len(lights))
    env = build_environment(sky, config["environment"].get("rotation_deg", 0.0), device) \
        if sky is not None else None
    cam = dict(config["camera"], **{k: config[k] for k in ("width", "aspect", "spp", "max_depth")})
    return RefScene(tb, len(tex), len(mat), env, cam, config["grad_tier"])


# -----------------------------------------------------------------------------
# The environment: Walker alias table over luminance x sin(theta)
# -----------------------------------------------------------------------------

def _build_alias(weight: np.ndarray):
    h, w = weight.shape
    n = h * w
    p = weight.reshape(-1).astype(np.float64)
    total = p.sum()
    scaled = p * (n / total)
    cut = np.minimum(scaled, 1.0)
    alias = np.arange(n, dtype=np.int64)
    small = scaled < 1.0
    idx_s = np.nonzero(small)[0]
    idx_l = np.nonzero(~small)[0]
    if len(idx_s) and len(idx_l):
        deficit = 1.0 - scaled[idx_s]
        excess = scaled[idx_l] - 1.0
        donor = np.searchsorted(np.cumsum(excess), np.cumsum(deficit) - 1e-12)
        alias[idx_s] = idx_l[np.minimum(donor, len(idx_l) - 1)]
    q = cut.copy()
    np.add.at(q, alias[idx_s], 1.0 - scaled[idx_s])
    q /= n
    return alias.astype(np.int32), cut.astype(np.float32), q.reshape(h, w)


def build_environment(data, rotation_degrees, device) -> Environment:
    data = np.asarray(data, np.float32)
    h = data.shape[0]
    v = (np.arange(h, dtype=np.float64) + 0.5) / h
    sin_theta = np.cos((0.5 - v) * np.pi)
    lum = 0.2126 * data[..., 0] + 0.7152 * data[..., 1] + 0.0722 * data[..., 2]
    weight = np.maximum(lum.astype(np.float64) * sin_theta[:, None], 0.0)
    if not weight.sum() > 0:
        raise ValueError("the environment has no power to sample")
    alias_idx, alias_cut, q = _build_alias(weight)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return Environment(t(data, np.float32), t(np.float32(np.deg2rad(rotation_degrees)), np.float32),
                       t(q, np.float32), t(alias_idx, np.int32), t(alias_cut, np.float32))


def sample_direction(env: Environment, xi1, xi2):
    """Importance-sampled directions: (direction [3], emission of the nearest
    texel [3], solid-angle pdf, flat texel id)."""
    h, w = env.data.shape[:2]
    n = h * w
    cell = torch.clamp_max((xi1 * n).to(torch.int32), n - 1).long()
    keep = xi2 < env.alias_cut[cell]
    chosen = torch.where(keep, cell, env.alias_idx[cell].long())
    y, x = chosen // w, chosen % w
    u = (x.to(torch.float32) + 0.5) / w
    v = (y.to(torch.float32) + 0.5) / h
    uu = u - env.rotation / TWO_PI
    uu = uu - torch.floor(uu)
    phi = (uu - 0.5) * TWO_PI
    theta = (0.5 - v) * np.pi
    ct = torch.cos(theta)
    d = [ct * torch.cos(phi), torch.sin(theta), ct * torch.sin(phi)]
    em = env.data.reshape(h * w, 3)[y * w + x]
    sin_theta = torch.clamp_min(ct, 1e-10)
    p = env.pdf[y, x] * (w * h) / (2.0 * np.pi * np.pi * sin_theta)
    return d, [em[:, 0], em[:, 1], em[:, 2]], torch.clamp_min(p, 1e-10), y * w + x


def unit(d):
    l2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    pos = l2 > 0
    inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, l2, 1.0)), 1.0)
    return [d[0] * inv, d[1] * inv, d[2] * inv]


def miss_footprint(env: Environment, d):
    """(fx, fy, base texel id) of the bilinear miss fetch (horizontal wrap,
    vertical clamp, the top edge's blend collapsed to row 0)."""
    h, w = env.data.shape[:2]
    du = unit(d)
    phi = torch.atan2(du[2], du[0])
    theta = torch.asin(torch.clamp(du[1], -1.0, 1.0))
    u = 0.5 + phi / TWO_PI + env.rotation / TWO_PI
    u = u - torch.floor(u)
    v = 0.5 - theta / np.pi
    px = u * w - 0.5
    py = v * h - 0.5
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    fx = px - x0.to(px.dtype)
    fy = py - y0.to(py.dtype)
    x0w = torch.remainder(x0, w)
    y0c = torch.clamp(y0, 0, h - 1)
    fy = torch.where(y0 < 0, 0.0, fy)
    return fx, fy, y0c * w + x0w


def footprint_texels(env: Environment, base):
    """[12, R]: c00 c10 c01 c11 x rgb of the footprints at ``base``."""
    h, w = env.data.shape[:2]
    data = env.data.reshape(h * w, 3)
    y, x = base // w, base % w
    x1 = (x + 1) % w
    y1 = torch.clamp_max(y + 1, h - 1)
    cols = [data[y * w + x], data[y * w + x1], data[y1 * w + x], data[y1 * w + x1]]
    return torch.cat(cols, dim=1).t()


def blend(q, fx, fy):
    out = []
    for c in range(3):
        c0 = q[c] * (1.0 - fx) + q[3 + c] * fx
        c1 = q[6 + c] * (1.0 - fx) + q[9 + c] * fx
        out.append(c0 * (1.0 - fy) + c1 * fy)
    return out


def miss_texel_grad(env: Environment, d, lam):
    """d<lam, miss colour(d)>/d(texels), [H, W, 3], summed in float64."""
    h, w = env.data.shape[:2]
    fx, fy, base = miss_footprint(env, d)
    weights = [(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy, fx * fy]
    y, x = base // w, base % w
    x1 = (x + 1) % w
    y1 = torch.clamp_max(y + 1, h - 1)
    texels = [y * w + x, y * w + x1, y1 * w + x, y1 * w + x1]
    acc = torch.zeros((h * w, 3), dtype=torch.float64, device=env.data.device)
    for wgt, ids in zip(weights, texels):
        acc.index_add_(0, ids, torch.stack([(wgt * lam[c]).double() for c in range(3)], 1))
    return acc.reshape(h, w, 3)


# -----------------------------------------------------------------------------
# Camera rays (a pinhole camera at rest; each ray's sub-pixel jitter keyed
# on its stream id)
# -----------------------------------------------------------------------------

def image_size(cam: dict):
    w = int(cam["width"])
    return w, max(int(w / (cam["aspect"][0] / cam["aspect"][1])), 1)


def camera_rays(cam: dict, ids, seed):
    """Origin [3], direction [3] (not normalised) and time of the camera
    rays with global ids ``ids`` (id = sample * W * H + pixel)."""
    from . import rng

    if cam.get("defocus_angle", 0.0) != 0.0:
        raise ValueError("the plain reference's camera is a pinhole")
    iw, ih = image_size(cam)
    n_pix = iw * ih
    pix = ids % n_pix
    px, py = pix % iw, pix // iw
    dev = ids.device
    jx, jy, _ = rng.uniform3(seed, ids, 0, rng.JITTER_X)
    ray_time = rng.uniform(seed, ids, 0, rng.RAY_TIME)
    fx = px.to(torch.float32) + (jx - 0.5)
    fy = py.to(torch.float32) + (jy - 0.5)

    look_from = np.asarray(cam["look_from"], np.float64)
    w = look_from - np.asarray(cam["look_at"], np.float64)
    w = w / np.linalg.norm(w)
    u = np.cross(np.asarray(cam["vup"], np.float64), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    focus = float(cam["focus_dist"])
    vp_h = 2.0 * math.tan(math.radians(cam["vfov"]) / 2.0) * focus
    vp_w = vp_h * (iw / ih)
    viewport_u = u * vp_w
    viewport_v = -v * vp_h
    du = viewport_u / iw
    dv = viewport_v / ih
    pixel00 = (look_from - w * focus - viewport_u / 2 - viewport_v / 2) + 0.5 * (du + dv)

    def c32(a):
        return [torch.tensor(float(x), dtype=torch.float32, device=dev)
                for x in np.asarray(a).astype(np.float32)]

    p00, du_, dv_ = c32(pixel00), c32(du), c32(dv)
    origin = [torch.full(fx.shape, float(x), dtype=torch.float32, device=dev)
              for x in look_from.astype(np.float32)]
    sample = [p00[c] + du_[c] * fx + dv_[c] * fy for c in range(3)]
    return origin, [sample[c] - origin[c] for c in range(3)], ray_time
