"""Wavefront path-tracing integrator.

Two ways through ``trace``:

* the megakernel (``mega_mode="single"``): the whole bounce loop in one
  kernel of ``ops/cuda_wavefront``, for scenes inside its gate;
* the standard integrator (``mega_mode="off"``): a Python loop over
  bounces, each bounce a closest-hit sweep through the kernels of
  ``ops/cuda_intersect`` (and, for instanced triangle meshes, of
  ``ops/cuda_mesh``) and plain tensor code for everything else.  It serves
  every scene the megakernel does not take (meshes, round or polyhedral
  fog, more than 1,024 primitives, more than 8 lights) and
  ``differentiable=True``.

Both give the same picture: every random draw is keyed on (seed, stream,
bounce, purpose), and the miss shader runs once after the loop from the
recorded escape direction and throughput.

The standard integrator has two routes of its own.  ``differentiable=False``
takes the *fast route*: the attribute kernels return the winner's geometry
and material constants with the hit, so no table is indexed per ray.
``differentiable=True``, and every scene with a mesh, takes the *gather
route*: the kernels return only (t, index), the hit record is rebuilt by
indexing the scene's tables, and ``torch.autograd`` flows through records,
materials and textures.

A mesh's closest hit goes through one of two kernels by the prototype's
size (``_mesh_intersect``): a reach test per instance root box first sends
the rays that can meet no instance in with ``t_max = -1``, and a batch of
at least ``_MESH_SORT_MIN`` rays is sorted by a coherence key and put back
in its order afterwards, bit for bit as if unsorted.

Per bounce: closest hit over spheres, planar primitives and meshes, then
stochastic volume scattering may preempt the surface hit; a miss records
direction and throughput for the deferred miss shader (an HDRI environment,
the sky gradient or the background); emission counts iff the
allowLightHits bit is set; a lambertian hit samples one uniformly picked
quad light (NEE) with a shadow ray, balance-heuristic MIS, x numLights and
the firefly clamp at 20, and, in a scene with quad lights and an
importance-sampled environment, one direction of the environment the same
way (``sample_hdri_light``); scatter, and continue with allowLightHits =
not (NEE was sampled this bounce).

Replay (the gradient tier of ``render/grad`` for scenes outside the
gradient kernels' gates): ``trace(record=True)`` also returns the discrete
outcome of every bounce's sweeps (``Decisions``: the winner and whether the
shadow ray was blocked), recorded by the megakernel (``mega_mode="single"``)
or by the standard integrator; ``trace(decisions=...)`` then runs the
differentiable gather route without a single closest-hit or shadow sweep:
each bounce takes its winner from the record and recomputes only that
winner's hit distance (``_winner_t``), so ``torch.autograd`` also reaches
the terms through the hit distance.  Random draws, scatter and light
choices are replayed from the rays' counters.

Not ported yet, each raising ``NotImplementedError``: noise (ROADMAP.md
A13) and image textures (A16), and the megakernel modes 'split' /
'compact' (B11) and 'image' (A16).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..camera import Camera
from ..core import rng as rngmod
from ..core import vec
from ..core.vec3 import V3
from ..geometry import packs
from ..geometry.scene import Scene
from ..lights import hdri as hdri_mod
from ..materials import tables as mats
from ..materials import textures as tex
from ..ops import cuda_intersect as ck
from ..ops import cuda_mesh as cm
from ..ops import cuda_wavefront as mega

FIREFLY_CLAMP = 20.0
SHADOW_EPS = 1e-3

HIT_NONE = 0
HIT_SPHERE = 1
HIT_PLANAR = 2
HIT_VOLUME = 3
HIT_MESH_BASE = 4  # + mesh prototype index


class Decisions(NamedTuple):
    """Per-bounce discrete outcomes of the sweeps, recorded by
    ``trace(record=True)`` and replayed by ``trace(decisions=...)``.  All
    [D, R].  A ray that did not enter a bounce alive reads ``HIT_NONE``,
    index 0, instance 0 and not blocked there.  Random draws, scatter and
    light choices are replayed from the counters and not stored.  A field
    that is 0 everywhere (``aux`` without meshes, ``blk_h`` without HDRI
    NEE) is a broadcast view of one zero, so the record holds
    ``decision_bytes`` a ray and bounce."""

    which: torch.Tensor   # u8 HIT_* winner kind (i32 past 255 kinds)
    idx: torch.Tensor     # i32 winner primitive, triangle or volume index
    aux: torch.Tensor     # i32 mesh instance id
    blk_a: torch.Tensor   # bool: the area-light shadow ray was blocked
    blk_h: torch.Tensor   # bool: the HDRI shadow ray was blocked


def _which_dtype(scene: Scene):
    return torch.uint8 if HIT_MESH_BASE + len(scene.meshes) <= 255 else torch.int32


def decision_bytes(scene: Scene) -> int:
    """Bytes ``Decisions`` holds a ray and bounce for this scene: ``which``,
    ``idx``, ``blk_a``, with meshes ``aux`` and with HDRI NEE ``blk_h``."""
    which = torch.empty((), dtype=_which_dtype(scene)).element_size()
    return (which + 4 + 1 + (4 if scene.meshes else 0)
            + (1 if mega.uses_hdri_nee(scene) else 0))


def _zero_rows(depth: int, r: int, dtype, dev):
    """A [depth, r] field that is 0 everywhere, as a view of one element."""
    return torch.zeros((1, 1), dtype=dtype, device=dev).expand(depth, r)


# Extra RNG purpose bases (see core/rng.py for the primary enumeration).
PURPOSE_VOL_MAIN = 64      # + 32 * volume_index
PURPOSE_VOL_SHADOW_AREA = 65
PURPOSE_VOL_SHADOW_HDRI = 66

BIG = float(packs.BIG)
EPS_HIT = float(np.float32(vec.EPS_HIT))


def _volume_uniforms(seed, stream, bounce, base, n_volumes):
    """[R, N] uniforms: one free-flight draw per (ray, volume)."""
    purpose = base + 32 * torch.arange(n_volumes, dtype=torch.int64,
                                       device=stream.device)[None, :]
    u, _, _ = rngmod.uniform3(seed, stream[:, None], bounce, purpose)
    return u


# -----------------------------------------------------------------------------
# Intersection
# -----------------------------------------------------------------------------

class SweepTables(NamedTuple):
    """What the closest-hit kernels read, packed once per ``trace`` call
    (None where the scene has no such primitive; the constant tables only on
    the fast route)."""

    planar: Optional[torch.Tensor]      # [15, N]
    spheres: Optional[torch.Tensor]     # [7, N]
    planar_con: Optional[torch.Tensor]  # [14, N]
    sphere_con: Optional[torch.Tensor]  # [14, N]


def sweep_tables(scene: Scene, with_consts: bool = False) -> SweepTables:
    n_p = int(scene.planar.d.shape[0])
    n_s = int(scene.spheres.radius.shape[0])
    return SweepTables(
        ck.planar_table(scene.planar) if n_p else None,
        ck.sphere_table(scene.spheres) if n_s else None,
        ck._material_consts(scene.materials, scene.textures, scene.planar.mat)
        if n_p and with_consts else None,
        ck._material_consts(scene.materials, scene.textures, scene.spheres.mat)
        if n_s and with_consts else None,
    )


# Sort the rays before a mesh sweep once a batch is large enough for the
# coherence of a warp's rays to matter; smaller batches go in as they are.
_MESH_SORT_MIN = 1 << 16

_KEY_DEAD = 1 << 30
# Sort-key quantization: entry-point cells per axis on the instance's local
# root box, direction levels per axis.
_KEY_CELLS = 8
_KEY_DIRL = 8


def _mesh_sort_key(proto, o: V3, d: V3, t_min, t_max):
    """Reach test and ray-sort key in one pass.

    Per instance, a local-space slab test of the root box (padded by 1e-3)
    finds where the ray segment enters that instance.  ``reach`` is true if
    any instance is entered; the key groups rays by (nearest entered
    instance, local direction on 8 levels an axis, entry cell on an 8^3 grid
    of the local root box), so that the rays of a warp enter the same
    instance in the same region heading the same way.  Dead and unreaching
    lanes get the largest key.  The same arithmetic as the JAX package's, in
    float32."""
    w2l = proto.w2l_host
    lo, hi = proto.root_bbox_min, proto.root_bbox_max
    eps = 1e-3
    ext = torch.clamp_min(hi - lo, 1e-6)
    nc, nd_ = _KEY_CELLS, _KEY_DIRL
    best_t = torch.full_like(t_max, BIG)
    best_key = torch.full(o.x.shape, _KEY_DEAD - 1, dtype=torch.int32,
                          device=o.x.device)
    for ii in range(len(w2l)):
        olc, dlc = [], []
        t_en = torch.full_like(t_max, t_min)
        t_ex = torch.clamp_max(t_max, BIG)
        for i in range(3):
            m0, m1, m2, m3 = w2l[ii][i]
            ol = m0 * o.x + m1 * o.y + m2 * o.z + m3
            dl = m0 * d.x + m1 * d.y + m2 * d.z
            olc.append(ol)
            dlc.append(dl)
            inv = 1.0 / torch.where(torch.abs(dl) < 1e-12,
                                    torch.where(dl < 0, -1e-12, 1e-12), dl)
            ta = (lo[i] - eps - ol) * inv
            tb = (hi[i] + eps - ol) * inv
            t_en = torch.maximum(t_en, torch.minimum(ta, tb))
            t_ex = torch.minimum(t_ex, torch.maximum(ta, tb))
        better = (t_ex >= t_en) & (t_en < best_t)
        dn = torch.rsqrt(dlc[0] * dlc[0] + dlc[1] * dlc[1] + dlc[2] * dlc[2] + 1e-30)
        cell = torch.zeros_like(best_key)
        dirq = torch.zeros_like(best_key)
        for i in range(3):
            p = olc[i] + dlc[i] * t_en
            q = torch.clamp(torch.floor((p - lo[i]) * (nc / ext[i])).to(torch.int32),
                            0, nc - 1)
            cell = cell * nc + q
            dq = torch.clamp(torch.floor((dlc[i] * dn + 1.0) * (nd_ / 2.0)).to(torch.int32),
                             0, nd_ - 1)
            dirq = dirq * nd_ + dq
        key_i = ((ii * nd_ ** 3 + dirq) * nc ** 3 + cell).to(torch.int32)
        best_t = torch.where(better, t_en, best_t)
        best_key = torch.where(better, key_i, best_key)
    reach = best_t < BIG
    key = torch.where(reach & (t_max > 0), best_key, _KEY_DEAD)
    return reach, key


def _mesh_intersect(proto, o: V3, d: V3, t_min, t_max, any_hit=False):
    """Closest (or any) hit over one prototype's instances: the small-mesh
    ladder for a prototype of at most ``cuda_mesh.MAX_KERNEL_TRIS``
    triangles, the tile stream above.  Rays that reach no instance go in
    with ``t_max = -1``; a batch of ``_MESH_SORT_MIN`` rays or more is sorted
    by ``_mesh_sort_key`` and put back by the inverse permutation, so each
    ray's result is the one the unsorted sweep gives.  Returns (t, tri,
    inst, hit, overflow (always 0)); nothing carries a gradient."""
    kern = (cm.intersect_mesh_kernel if cm.kernel_ok(proto)
            else cm.intersect_mesh_stream)
    with torch.no_grad():
        o = V3(*(c.detach() for c in o))
        d = V3(*(c.detach() for c in d))
        t_max = torch.as_tensor(t_max, dtype=torch.float32,
                                device=o.x.device).detach().expand(o.x.shape)
        reach, key = _mesh_sort_key(proto, o, d, t_min, t_max)
        t_max = torch.where(reach, t_max, -1.0)
        if o.x.shape[0] < _MESH_SORT_MIN:
            return kern(proto, o, d, t_min, t_max, any_hit=any_hit)
        order = torch.argsort(key, stable=True)
        t, tri, inst, hit, ovf = kern(proto, o.take(order), d.take(order), t_min,
                                      t_max[order], any_hit=any_hit)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return t[inv], tri[inv], inst[inv], hit[inv], ovf


def _no_hit(r, dev):
    return (torch.full((r,), BIG, device=dev),
            torch.zeros((r,), dtype=torch.int32, device=dev),
            torch.zeros((r,), dtype=torch.bool, device=dev))


def _surface_intersects(scene: Scene, o: V3, d: V3, tm, t_min, t_max,
                        tabs: Optional[SweepTables] = None):
    """Sphere and planar closest hits through the kernels.  Geometry is
    detached: an intersection is control flow, and gradients of shading
    flow through the hit *records*."""
    tabs = sweep_tables(scene) if tabs is None else tabs
    r_, dev = o.x.shape[0], o.x.device
    s = (ck.sphere_closest_table(tabs.spheres, o, d, tm, t_max, t_min=t_min)
         if tabs.spheres is not None else _no_hit(r_, dev))
    p = (ck.planar_closest_table(tabs.planar, o, d, t_max, t_min=t_min)
         if tabs.planar is not None else _no_hit(r_, dev))
    return s, p


def attr_path_ok(scene: Scene, differentiable: bool) -> bool:
    """Can this trace take the fast route (winner attributes from the
    kernels, no table lookup per ray)?  Not a gradient-bearing trace (the
    attributes are detached constants), and no noise, image or mesh (the
    mesh kernels return the winner, not its attributes)."""
    return (
        not differentiable
        and not scene.has_noise
        and not scene.has_image
        and not scene.meshes
    )


def _merge_winners(h_s, t_s, i_s, h_p, t_p, i_p):
    sphere_wins = h_s & (~h_p | (t_s < t_p))
    t_surf = torch.where(sphere_wins, t_s, t_p)
    which = torch.where(
        sphere_wins, HIT_SPHERE, torch.where(h_p, HIT_PLANAR, HIT_NONE)
    ).to(torch.int32)
    idx = torch.where(sphere_wins, i_s, i_p)
    return sphere_wins, t_surf, which, idx, h_s | h_p


def _attr_closest_hit(scene: Scene, o: V3, d: V3, tm, t_min, t_max,
                      seed, stream, bounce, tabs: Optional[SweepTables] = None):
    """Closest hit via the attribute kernels.  Returns (t, which, idx,
    attrs) where attrs is a dict of per-ray winner constants (geometry and
    denormalized material)."""
    tabs = sweep_tables(scene, with_consts=True) if tabs is None else tabs
    r_, dev = o.x.shape[0], o.x.device
    n_extra = ck.CHECKER_EXTRA if scene.has_checker else 0
    o_, d_ = V3(*(c.detach() for c in o)), V3(*(c.detach() for c in d))

    def empty(n_attr):
        return _no_hit(r_, dev) + (torch.zeros((n_attr, r_), device=dev),)

    if tabs.spheres is not None:
        t_s, i_s, h_s, a_s = ck.sphere_closest_attrs_table(
            tabs.spheres, tabs.sphere_con, o_, d_, tm, t_max, t_min=t_min,
            n_attr=ck.SPHERE_ATTRS + n_extra)
    else:
        t_s, i_s, h_s, a_s = empty(ck.SPHERE_ATTRS + n_extra)
    if tabs.planar is not None:
        t_p, i_p, h_p, a_p = ck.planar_closest_attrs_table(
            tabs.planar, tabs.planar_con, o_, d_, t_max, t_min=t_min,
            n_attr=ck.PLANAR_ATTRS + n_extra)
    else:
        t_p, i_p, h_p, a_p = empty(ck.PLANAR_ATTRS + n_extra)

    sphere_wins, t_surf, which, idx, hit_surf = _merge_winners(
        h_s, t_s, i_s, h_p, t_p, i_p)

    def pick(si, pi):
        return torch.where(sphere_wins, a_s[si], a_p[pi])

    attrs = dict(
        # sphere geometry (garbage on planar lanes, masked by `which`)
        center=V3(a_s[0], a_s[1], a_s[2]),
        rad2=a_s[3],
        # planar geometry
        pnormal=V3(a_p[0], a_p[1], a_p[2]),
        alpha=a_p[3],
        beta=a_p[4],
        pkind=a_p[11],
        # material constants (merged)
        kindpack=pick(4, 5),
        fuzz=pick(5, 6),
        ior=pick(6, 7),
        col=V3(pick(7, 8), pick(8, 9), pick(9, 10)),
    )
    if scene.has_checker:
        attrs.update(
            even=V3(pick(10, 12), pick(11, 13), pick(12, 14)),
            odd=V3(pick(13, 15), pick(14, 16), pick(15, 17)),
            scale=pick(16, 18),
        )

    # Volumes: stochastic preemption; the (few) volume materials' constants
    # are put in by one select per volume, and idx then means the volume.
    if scene.n_volumes > 0:
        t_limit = torch.where(hit_surf, t_surf, BIG)
        u_vol = _volume_uniforms(seed, stream, bounce, PURPOSE_VOL_MAIN,
                                 scene.n_volumes)
        with torch.no_grad():
            t_v, i_v, h_v = packs.sample_volumes(scene.volumes, o_, d_, t_min,
                                            t_limit, u_vol)
        vol_wins = h_v & (~hit_surf | (t_v < t_surf))
        t_surf = torch.where(vol_wins, t_v, t_surf)
        which = torch.where(vol_wins, HIT_VOLUME, which).to(torch.int32)
        idx = torch.where(vol_wins, i_v, idx)
        m_pack, t_pack = scene.materials, scene.textures
        for vi in range(scene.n_volumes):
            m = vol_wins & (idx == vi)
            vmat = scene.volumes.mat[vi].long()
            vtex = m_pack.tex[vmat].long()
            kindpack = (m_pack.kind[vmat] * 8 + t_pack.kind[vtex]).to(torch.float32)
            attrs["kindpack"] = torch.where(m, kindpack, attrs["kindpack"])
            attrs["fuzz"] = torch.where(m, m_pack.fuzz[vmat].detach(), attrs["fuzz"])
            attrs["ior"] = torch.where(m, m_pack.ior[vmat].detach(), attrs["ior"])
            vcol = V3.from_rows(t_pack.color[vtex].detach())
            attrs["col"] = V3.select(m, vcol, attrs["col"])

    return t_surf, which, idx, attrs


def _attr_record_and_albedo(scene: Scene, o: V3, d: V3, t, which, attrs):
    """Hit record and albedo from the kernels' attributes (no table
    lookups).  Circle UV is not reconstructed: only image textures read it,
    and they force the gather route."""
    dev = t.device
    p = o.at(d, t)

    # sphere record
    rad = torch.sqrt(torch.clamp_min(attrs["rad2"], 1e-20))
    outward = (p - attrs["center"]) * (1.0 / rad)
    s_front = d.dot(outward) < 0.0
    s_normal = V3.select(s_front, outward, -outward)

    # planar record
    pn = attrs["pnormal"]
    p_front = d.dot(pn) < 0.0
    p_normal = V3.select(p_front, pn, -pn)

    is_sphere = which == HIT_SPHERE
    is_vol = which == HIT_VOLUME
    normal = V3.select(is_sphere, s_normal, p_normal)
    normal = V3.select(is_vol, V3.full(t.shape, (1.0, 0.0, 0.0), device=dev),
                       normal)
    front = torch.where(is_sphere, s_front, p_front) | is_vol

    kindpack = attrs["kindpack"]
    matkind = (kindpack / 8.0).to(torch.int32)
    texkind = kindpack.to(torch.int32) % 8

    albedo = attrs["col"]
    if scene.has_checker:
        inv_scale = attrs["scale"]
        lx = torch.floor(inv_scale * p.x + 1e-4).to(torch.int32)
        ly = torch.floor(inv_scale * p.y + 1e-4).to(torch.int32)
        lz = torch.floor(inv_scale * p.z + 1e-4).to(torch.int32)
        is_even = (lx + ly + lz) % 2 == 0
        checker = V3.select(is_even, attrs["even"], attrs["odd"])
        albedo = V3.select(texkind == tex.TEX_CHECKER, checker, albedo)

    return p, normal, front, matkind, albedo


def closest_hit(scene: Scene, o: V3, d: V3, tm, t_min, t_max, seed, stream,
                bounce, tabs: Optional[SweepTables] = None):
    """Closest surface hit (spheres, planar primitives, meshes), then
    stochastic volume preemption.

    Returns (t [R], which [R] i32, idx [R], aux [R] (the mesh instance id),
    overflow (always 0: the mesh kernels drop nothing)).  The surface ``t``
    comes from the kernels and carries no gradient; a volume's scatter
    distance is differentiable in o and d."""
    (t_s, i_s, h_s), (t_p, i_p, h_p) = _surface_intersects(
        scene, o, d, tm, t_min, t_max, tabs)
    _, t_surf, which, idx, hit_surf = _merge_winners(h_s, t_s, i_s, h_p, t_p, i_p)
    aux = torch.zeros_like(idx)

    for mi, proto in enumerate(scene.meshes):
        t_limit = torch.where(hit_surf, torch.minimum(t_surf, t_max), t_max)
        t_m, tri_m, inst_m, h_m, _ = _mesh_intersect(proto, o, d, t_min, t_limit)
        mesh_wins = h_m & (~hit_surf | (t_m < t_surf))
        t_surf = torch.where(mesh_wins, t_m, t_surf)
        which = torch.where(mesh_wins, HIT_MESH_BASE + mi, which).to(torch.int32)
        idx = torch.where(mesh_wins, tri_m, idx)
        aux = torch.where(mesh_wins, inst_m, aux)
        hit_surf = hit_surf | h_m

    if scene.n_volumes > 0:
        t_limit = torch.where(hit_surf, t_surf, BIG)
        u_vol = _volume_uniforms(seed, stream, bounce, PURPOSE_VOL_MAIN,
                                 scene.n_volumes)
        t_v, i_v, h_v = packs.sample_volumes(scene.volumes, o, d, t_min, t_limit, u_vol)
        vol_wins = h_v & (~hit_surf | (t_v < t_surf))
        t_surf = torch.where(vol_wins, t_v, t_surf)
        which = torch.where(vol_wins, HIT_VOLUME, which).to(torch.int32)
        idx = torch.where(vol_wins, i_v, idx)

    return t_surf, which, idx, aux, 0


def _rows(idx, n):
    """Winner index -> a row index that is valid for a table of n rows.  A
    lane whose winner lies in another table reads some row and is masked
    out by the caller."""
    return torch.clamp_max(idx, n - 1).long()


def _sphere_record(pack: packs.SpherePack, idx, o: V3, d: V3, tm, t):
    """Sphere hit record with the spherical UV."""
    i = _rows(idx, pack.radius.shape[0])
    center = V3.from_rows(pack.center[i]) + V3.from_rows(pack.velocity[i]) * tm
    rad, mat = pack.radius[i], pack.mat[i]
    p = o.at(d, t)
    outward = (p - center) * (1.0 / rad)
    front = d.dot(outward) < 0.0
    normal = V3.select(front, outward, -outward)
    # Grad-safe UV: the derivative of arccos at +-1 is infinite and arctan2
    # at (0, 0) is 0/0; both give NaN in the backward pass for lanes whose
    # (untaken) sphere branch saturates (0 * inf), which would poison every
    # summed gradient.  The guards keep the forward value and let the
    # saturated lanes differentiate a constant.
    xc = torch.clamp(-outward.y, -1.0, 1.0)
    x_in = torch.abs(xc) < 1.0
    theta = torch.where(x_in, torch.arccos(torch.where(x_in, xc, 0.0)),
                        torch.where(xc > 0, 0.0, np.pi))
    az, ax = -outward.z, outward.x
    pole = (az == 0.0) & (ax == 0.0)
    phi = torch.arctan2(torch.where(pole, 0.0, az),
                        torch.where(pole, 1.0, ax)) + np.pi
    uu = phi / (2.0 * np.pi)
    vv = theta / np.pi
    return p, normal, front, uu, vv, mat


def _planar_record(pack: packs.PlanarPack, idx, o: V3, d: V3, t):
    """Planar hit record (quad and triangle barycentrics; circle local
    frame)."""
    i = _rows(idx, pack.d.shape[0])
    q = V3.from_rows(pack.q[i])
    nrm = V3.from_rows(pack.normal[i])
    u_e = V3.from_rows(pack.u[i])
    v_e = V3.from_rows(pack.v[i])
    w = V3.from_rows(pack.w[i])
    rad, kind, mat = pack.radius[i], pack.kind[i], pack.mat[i]

    p = o.at(d, t)
    rel = p - q
    alpha = w.dot(rel.cross(v_e))
    beta = w.dot(u_e.cross(rel))

    # Circle UV: local frame from the normal
    use_x = torch.abs(nrm.y) > 0.9
    ref_axis = V3.select(use_x, V3.from_tuple((1.0, 0.0, 0.0), like=nrm),
                         V3.from_tuple((0.0, 1.0, 0.0), like=nrm))
    cu = ref_axis.cross(nrm).unit()
    cv = nrm.cross(cu)
    safe_rad = torch.where(rad > 0, rad, 1.0)
    circ_u = (rel.dot(cu) / safe_rad + 1.0) * 0.5
    circ_v = (rel.dot(cv) / safe_rad + 1.0) * 0.5

    uu = torch.where(kind == packs.KIND_CIRCLE, circ_u,
                     torch.where(kind == packs.KIND_PLANE, 0.0, alpha))
    vv = torch.where(kind == packs.KIND_CIRCLE, circ_v,
                     torch.where(kind == packs.KIND_PLANE, 0.0, beta))

    front = d.dot(nrm) < 0.0
    normal = V3.select(front, nrm, -nrm)
    return p, normal, front, uu, vv, mat


def _mesh_record(proto, tri, inst, o: V3, d: V3, t):
    """Mesh hit record: two row lookups (the triangle's 9 floats, the
    instance's 21) and Moller-Trumbore's barycentrics in instance-local
    space; the normal is the face normal mapped by the instance's inverse
    transpose.  Same arithmetic as the JAX package's ``_mesh_record``."""
    tri = torch.clamp_min(tri, 0).long()
    inst = torch.clamp_min(inst, 0).long()
    tv = tex.take_rows(torch.cat([proto.tri_v0, proto.tri_e1, proto.tri_e2], dim=1), tri)
    v0 = V3(tv[:, 0], tv[:, 1], tv[:, 2])
    e1 = V3(tv[:, 3], tv[:, 4], tv[:, 5])
    e2 = V3(tv[:, 6], tv[:, 7], tv[:, 8])
    n_inst = proto.n_instances
    iv = tex.take_rows(torch.cat([proto.inst_w2l.reshape(n_inst, 12),
                                  proto.inst_nmat.reshape(n_inst, 9)], dim=1),
                       inst).t()
    o_l = V3(iv[0] * o.x + iv[1] * o.y + iv[2] * o.z + iv[3],
             iv[4] * o.x + iv[5] * o.y + iv[6] * o.z + iv[7],
             iv[8] * o.x + iv[9] * o.y + iv[10] * o.z + iv[11])
    d_l = V3(iv[0] * d.x + iv[1] * d.y + iv[2] * d.z,
             iv[4] * d.x + iv[5] * d.y + iv[6] * d.z,
             iv[8] * d.x + iv[9] * d.y + iv[10] * d.z)

    # Barycentric UV via Moller-Trumbore partials; the record's parallel
    # guard is 1e-12 (the kernel's test is 1e-8)
    h = d_l.cross(e2)
    a = e1.dot(h)
    f = 1.0 / torch.where(torch.abs(a) < 1e-12, 1.0, a)
    s = o_l - v0
    uu = f * s.dot(h)
    q = s.cross(e1)
    vv = f * d_l.dot(q)

    n_local = e1.cross(e2)
    n_world = V3(
        iv[12] * n_local.x + iv[13] * n_local.y + iv[14] * n_local.z,
        iv[15] * n_local.x + iv[16] * n_local.y + iv[17] * n_local.z,
        iv[18] * n_local.x + iv[19] * n_local.y + iv[20] * n_local.z,
    ).unit()
    front = d.dot(n_world) < 0.0
    normal = V3.select(front, n_world, -n_world)
    p = o.at(d, t)
    return p, normal, front, uu, vv, proto.inst_mat[inst]


def extract_record(scene: Scene, o: V3, d: V3, tm, t, which, idx, aux=None):
    """Hit record of the winning primitive per ray, from the scene's
    tables by index (differentiable in o, d and t)."""
    r, dev = o.x.shape[0], o.x.device
    p = o.at(d, t)
    normal = V3.full((r,), (1.0, 0.0, 0.0), device=dev)  # a volume's normal
    front = torch.ones((r,), dtype=torch.bool, device=dev)
    uu = torch.zeros((r,), dtype=o.x.dtype, device=dev)
    vv = torch.zeros((r,), dtype=o.x.dtype, device=dev)
    mat_id = torch.zeros((r,), dtype=torch.int32, device=dev)

    def merge(m, rec):
        nonlocal p, normal, front, uu, vv, mat_id
        rp, rn, rf, ru, rv, rm = rec
        p = V3.select(m, rp, p)
        normal = V3.select(m, rn, normal)
        front = torch.where(m, rf, front)
        uu = torch.where(m, ru, uu)
        vv = torch.where(m, rv, vv)
        mat_id = torch.where(m, rm, mat_id)

    if scene.spheres.radius.shape[0] > 0:
        merge(which == HIT_SPHERE,
              _sphere_record(scene.spheres, idx, o, d, tm, t))
    if scene.planar.d.shape[0] > 0:
        merge(which == HIT_PLANAR, _planar_record(scene.planar, idx, o, d, t))
    for mi, proto in enumerate(scene.meshes):
        merge(which == HIT_MESH_BASE + mi,
              _mesh_record(proto, idx, aux, o, d, t))
    if scene.n_volumes > 0:
        m = which == HIT_VOLUME
        mat_id = torch.where(
            m, scene.volumes.mat[_rows(idx, scene.n_volumes)], mat_id)

    return p, normal, front, uu, vv, mat_id


def _winner_t(scene: Scene, o: V3, d: V3, tm, t_min, which, idx, aux,
              seed, stream, bounce):
    """Differentiable hit distance of a known winner (the replay).  The
    record gave the winner; only its distance is computed again, so the
    backward pass differentiates one primitive a ray and bounce, not a
    sweep.  Gradients flow through o and d (the geometry is not a trainable
    parameter).  The formulas are those of the sweeps: a sphere's stable
    root, the plane solve of a planar primitive, Moller-Trumbore in the
    instance's local space for a mesh (also for prototypes whose kernel
    tests triangles another way: t is the same number), and a volume's free
    flight from where the ray enters it with the same draw.  Every
    ``.detach()`` and clamp floor is the JAX package's."""
    r, dev = o.x.shape[0], o.x.device
    t = torch.full((r,), BIG, dtype=o.x.dtype, device=dev)
    safe_idx = torch.clamp_min(idx, 0)
    take = tex.take_rows

    sp = scene.spheres
    if sp.radius.shape[0] > 0:
        i = _rows(safe_idx, sp.radius.shape[0])
        center = (V3.from_rows(take(sp.center, i))
                  + V3.from_rows(take(sp.velocity, i)) * tm)
        oc = center - o
        a = torch.clamp_min(d.dot(d), 1e-30)
        h = d.dot(oc)
        rad = take(sp.radius, i)
        disc = h * h - a * (oc.dot(oc) - rad * rad)
        pos = disc.detach() > 0.0
        sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
        r0 = (h - sq) / a
        r1 = (h + sq) / a
        t = torch.where(which == HIT_SPHERE,
                        torch.where(r0.detach() > t_min, r0, r1), t)

    pp = scene.planar
    if pp.d.shape[0] > 0:
        i = _rows(safe_idx, pp.d.shape[0])
        nrm = V3.from_rows(take(pp.normal, i))
        denom = nrm.dot(d)
        safe = torch.where(torch.abs(denom.detach()) < vec.EPS_PARALLEL, 1.0, denom)
        t = torch.where(which == HIT_PLANAR, (take(pp.d, i) - nrm.dot(o)) / safe, t)

    for mi, proto in enumerate(scene.meshes):
        i = _rows(safe_idx, proto.tri_v0.shape[0])
        n_inst = proto.inst_w2l.shape[0]
        m = take(proto.inst_w2l.reshape(n_inst, 12),
                 _rows(torch.clamp_min(aux, 0), n_inst)).t()
        ol = V3(m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3],
                m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
                m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11])
        dl = V3(m[0] * d.x + m[1] * d.y + m[2] * d.z,
                m[4] * d.x + m[5] * d.y + m[6] * d.z,
                m[8] * d.x + m[9] * d.y + m[10] * d.z)
        tv = take(torch.cat([proto.tri_v0, proto.tri_e1, proto.tri_e2], dim=1), i)
        v0 = V3(tv[:, 0], tv[:, 1], tv[:, 2])
        e1 = V3(tv[:, 3], tv[:, 4], tv[:, 5])
        e2 = V3(tv[:, 6], tv[:, 7], tv[:, 8])
        av = e1.dot(dl.cross(e2))
        fv = 1.0 / torch.where(torch.abs(av.detach()) < 1e-12, 1.0, av)
        t = torch.where(which == HIT_MESH_BASE + mi,
                        fv * e2.dot((ol - v0).cross(e1)), t)

    if scene.n_volumes > 0:
        vp = scene.volumes
        u_vol = _volume_uniforms(seed, stream, bounce, PURPOSE_VOL_MAIN,
                                 scene.n_volumes)
        t0, _ = packs.volume_interval(vp, o, d)
        ray_len = d.length()
        t_v = torch.zeros((r,), dtype=o.x.dtype, device=dev)
        for vi in range(scene.n_volumes):
            lu = torch.log(torch.clamp_min(u_vol[:, vi], 1e-38))
            tv = (torch.clamp_min(t0[:, vi], t_min)
                  + vp.neg_inv_density[vi] * lu / ray_len)
            t_v = torch.where(safe_idx == vi, tv, t_v)
        t = torch.where(which == HIT_VOLUME, t_v, t)

    return t


def occluded(scene: Scene, o: V3, d: V3, tm, t_min, t_max, seed, stream, bounce,
             purpose_base, active=None, tabs: Optional[SweepTables] = None):
    """Shadow-ray test: anything (surface or stochastic medium) in
    (t_min, t_max)?  Returns (blocked [R] bool, overflow (always 0)).

    ``active`` (optional bool mask): lanes whose answer the caller will
    discard get t_max = -1, and the kernels skip their sweep.  Meshes are
    swept in any-hit mode: a ray's sweep ends at its first hit, and its
    ``t`` then means nothing, only ``hit``."""
    if active is not None:
        t_max = torch.where(active, t_max, -1.0)
    (t_s, _, h_s), (t_p, _, h_p) = _surface_intersects(
        scene, o, d, tm, t_min, t_max, tabs)
    blocked = h_s | h_p
    t_surf = torch.minimum(torch.where(h_s, t_s, BIG),
                           torch.where(h_p, t_p, BIG))
    for proto in scene.meshes:
        _, _, _, h_m, _ = _mesh_intersect(
            proto, o, d, t_min, torch.minimum(t_surf, t_max), any_hit=True)
        blocked = blocked | h_m
        t_surf = torch.where(h_m, t_min, t_surf)
    if scene.n_volumes > 0:
        u_vol = _volume_uniforms(seed, stream, bounce, purpose_base,
                                 scene.n_volumes)
        t_limit = torch.minimum(t_surf, t_max)
        _, _, h_v = packs.sample_volumes(scene.volumes, o, d, t_min, t_limit, u_vol)
        blocked = blocked | h_v
    return blocked, 0


# -----------------------------------------------------------------------------
# NEE / MIS
# -----------------------------------------------------------------------------

def sample_area_light(scene: Scene, cam, p: V3, normal: V3, ray_d: V3,
                      attenuation: V3, mat_id, seed, stream, bounce,
                      mat_attrs=None, active=None,
                      tabs: Optional[SweepTables] = None, blocked=None):
    """NEE toward one uniformly chosen registered quad light.  Returns (V3
    contribution (without the throughput), overflow (always 0), blocked [R]
    bool).  ``blocked``: the shadow sweep's recorded outcome (the replay);
    given, no shadow ray is traced."""
    n_lights = scene.n_lights
    u_pick = rngmod.uniform(seed, stream, bounce, rngmod.LIGHT_PICK)
    li = torch.clamp_max((u_pick * n_lights).to(torch.int32), n_lights - 1).long()

    a_s, b_s = rngmod.uniform2(seed, stream, bounce, rngmod.LIGHT_U)
    lq = V3.from_rows(scene.light_q[li])
    lu = V3.from_rows(scene.light_u[li])
    lv = V3.from_rows(scene.light_v[li])
    lnrm = V3.from_rows(scene.light_normal[li])
    larea, lmat = scene.light_area[li], scene.light_mat[li]

    light_point = lq + lu * a_s + lv * b_s
    to_light = light_point - p
    dist = to_light.length()
    light_dir = to_light.unit()

    cos_theta = normal.dot(light_dir)
    facing = cos_theta > 0.0
    shadow_active = facing if active is None else (facing & active)

    overflow = 0
    if blocked is None:
        blocked, overflow = occluded(
            scene, p, light_dir, torch.zeros_like(dist), SHADOW_EPS,
            dist - SHADOW_EPS, seed, stream, bounce, PURPOSE_VOL_SHADOW_AREA,
            active=shadow_active, tabs=tabs,
        )

    # Emission at (u=0, v=0, light_point)
    emission = mats.emitted(
        scene.materials, scene.textures, lmat,
        torch.zeros_like(dist), torch.zeros_like(dist), light_point,
        **scene.tex_flags,
    )

    cos_light = torch.abs(lnrm.dot(-light_dir))
    grazing = cos_light < 1e-3
    # Grazing lanes are discarded below (ok &= ~grazing), but their pdf
    # must still be finite in the backward pass: a `clamp_min(x, 1e-20)`
    # makes the division's backward compute a/b^2 with b^2 = 1e-40, which
    # underflows float32 to 0 -> inf partial -> 0 * inf = NaN that poisons
    # every summed parameter gradient routed through p (rays that hit the
    # light quad itself sample a coplanar light point: cos_light == 0).
    pl_denom = torch.where(grazing, 1.0, cos_light * larea)
    pdf_light = (dist * dist) / pl_denom

    wi = (-ray_d).unit()
    if mat_attrs is not None:
        pdf_brdf = mats.brdf_pdf_from_attrs(
            mat_attrs[0], mat_attrs[1], wi, light_dir, normal)
    else:
        pdf_brdf = mats.brdf_pdf(scene.materials, mat_id, wi, light_dir, normal)
    # Safe divisions: lanes masked below must not produce inf/NaN in the
    # primal (masked infinities poison the backward pass: 0 * inf).
    # Floor 1e-15 (not 1e-20): the backward of a/b squares the clamped
    # denominator, and (1e-20)^2 underflows float32 (see pl_denom above).
    weight = pdf_light / torch.clamp_min(pdf_light + pdf_brdf, 1e-15)

    scale = cos_theta / torch.clamp_min(pdf_light, 1e-12) * weight * float(n_lights)
    contrib = (emission * attenuation * scale).minimum(FIREFLY_CLAMP)
    ok = facing & ~blocked & ~grazing
    return (V3.select(ok, contrib, V3.zeros(ok.shape, device=ok.device)),
            overflow, blocked)


def sample_hdri_light(scene: Scene, cam, p: V3, normal: V3, ray_d: V3,
                      attenuation: V3, mat_id, seed, stream, bounce,
                      mat_attrs=None, active=None,
                      tabs: Optional[SweepTables] = None, blocked=None):
    """NEE toward the HDRI environment by importance sampling.  Returns (V3
    contribution, overflow (always 0), blocked [R] bool); ``blocked`` as in
    :func:`sample_area_light`."""
    xi1 = rngmod.uniform(seed, stream, bounce, rngmod.HDRI_ROW)
    xi2 = rngmod.uniform(seed, stream, bounce, rngmod.HDRI_COL)
    light_dir, emission, pdf_h = hdri_mod.sample_direction_soa(scene.env, xi1, xi2)

    cos_theta = normal.dot(light_dir)
    facing = cos_theta > 0.0
    shadow_active = facing if active is None else (facing & active)

    overflow = 0
    if blocked is None:
        r = p.x.shape[0]
        blocked, overflow = occluded(
            scene, p, light_dir, torch.zeros((r,), device=p.x.device), SHADOW_EPS,
            torch.full((r,), BIG, device=p.x.device), seed, stream, bounce,
            PURPOSE_VOL_SHADOW_HDRI, active=shadow_active, tabs=tabs,
        )

    wi = (-ray_d).unit()
    if mat_attrs is not None:
        pdf_b = mats.brdf_pdf_from_attrs(
            mat_attrs[0], mat_attrs[1], wi, light_dir, normal)
    else:
        pdf_b = mats.brdf_pdf(scene.materials, mat_id, wi, light_dir, normal)
    # Floor 1e-15: (1e-20)^2 underflows float32 in the division's backward.
    weight = pdf_h / torch.clamp_min(pdf_h + pdf_b, 1e-15)
    scale = cos_theta / torch.clamp_min(pdf_h, 1e-12) * weight
    contrib = (emission * attenuation * scale).minimum(FIREFLY_CLAMP)
    ok = facing & ~blocked
    return (V3.select(ok, contrib, V3.zeros(ok.shape, device=ok.device)),
            overflow, blocked)


def _miss_radiance(scene: Scene, cam: Camera, d: V3, primary) -> V3:
    """Environment / sky gradient / flat background for rays that left the
    scene.

    ``primary``: bool mask, the lane's miss happened on the first segment
    (the reference's phantom-HDRI rule hides the environment from camera
    rays when ``cam.phantom_hdri``)."""
    if scene.env is not None:
        col = hdri_mod.sample_soa(scene.env, d)
        if cam.phantom_hdri:
            col = V3.select(primary, V3.zeros(col.x.shape, device=col.x.device), col)
        return col
    if cam.use_sky_gradient:
        unit_d = d.unit()
        a = 0.5 * (unit_d.y + 1.0)
        return V3(
            (1.0 - a) + a * 0.5,
            (1.0 - a) + a * 0.7,
            (1.0 - a) + a * 1.0,
        )
    return V3.full(d.x.shape, cam.background, d.x.dtype, d.x.device)


def _add_miss(scene, cam, radiance: V3, missed, miss_dir: V3, miss_tp: V3,
              miss_primary) -> V3:
    """The deferred miss shader: once per ray, after the bounce loop."""
    r, dev = missed.shape[0], missed.device
    safe_dir = V3.select(missed, miss_dir,
                         V3.full((r,), (0.0, 0.0, 1.0), device=dev))
    miss_col = _miss_radiance(scene, cam, safe_dir, miss_primary)
    return radiance + V3.select(missed, miss_tp * miss_col,
                                V3.zeros((r,), device=dev))


def choose_mega_mode(scene: Scene, cam, r: int, differentiable: bool) -> str:
    """Dispatch decision: 'off' (the standard integrator) | 'single' (the
    megakernel).

    The JAX package also has 'split', 'compact' (both need the resumable
    kernel, ROADMAP.md B11) and 'image' (ROADMAP.md A16); the port picks
    'single' wherever the kernel applies."""
    if differentiable or not mega.applicable(scene):
        return "off"
    return "single"


class PathState(NamedTuple):
    """What a bounce hands to the next, per ray."""

    o: V3
    d: V3
    throughput: V3
    radiance: V3
    alive: torch.Tensor         # bool
    allow_light: torch.Tensor   # bool: emission counts at the next hit
    miss_dir: V3
    miss_tp: V3
    miss_primary: torch.Tensor  # bool: the miss was on the first segment
    missed: torch.Tensor        # bool


def bounce_step(scene: Scene, cam, state: PathState, tm, stream, seed,
                bounce: int, *, fast: bool,
                tabs: Optional[SweepTables] = None, dec=None,
                rec: Optional[list] = None) -> PathState:
    """One bounce of the standard integrator for the whole wavefront.

    ``dec``: this bounce's recorded (which, idx, aux, blk_a, blk_h) (the
    replay): no sweep runs, the winner's distance comes from ``_winner_t``.
    ``rec``: a list; this bounce's (which, idx, aux or None, blk_a, blk_h)
    is appended to it."""
    (o, d, throughput, radiance, alive, allow_light,
     miss_dir, miss_tp, miss_primary, missed) = state
    dev = alive.device

    aux = None
    dec_blk_a = dec_blk_h = None
    if dec is not None:
        which, idx, aux, dec_blk_a, dec_blk_h = dec
        which = torch.where(alive, which, HIT_NONE)
        t = _winner_t(scene, o, d, tm, EPS_HIT, which, idx, aux, seed, stream,
                      bounce)
    else:
        # Dead lanes get t_max = -1: the kernels skip their sweep.
        t_cap = torch.where(alive, BIG, -1.0)
        if fast:
            t, which, idx, attrs = _attr_closest_hit(
                scene, o, d, tm, EPS_HIT, t_cap, seed, stream, bounce, tabs)
        else:
            t, which, idx, aux, _ = closest_hit(
                scene, o, d, tm, EPS_HIT, t_cap, seed, stream, bounce, tabs)
    hit = (which != HIT_NONE) & alive

    # --- miss: the environment is evaluated once, after the loop -----------
    lit = alive & ~hit
    miss_dir = V3.select(lit, d, miss_dir)
    miss_tp = V3.select(lit, throughput, miss_tp)
    if bounce == 0:
        miss_primary = lit
    missed = missed | lit

    # Miss lanes carry t = BIG; o + BIG*d overflows to inf and would poison
    # the masked math downstream (and its gradients) with NaN.
    t_rec = torch.where(hit, t, 1.0)
    if fast:
        p, normal, front, matkind, albedo = _attr_record_and_albedo(
            scene, o, d, t_rec, which, attrs)
        sc = mats.scatter_from_attrs(
            matkind, attrs["fuzz"], attrs["ior"], albedo,
            d, normal, front, seed, stream, bounce)
        mat_id = None
        mat_attrs = (matkind, attrs["fuzz"])
    else:
        p, normal, front, uu, vv, mat_id = extract_record(
            scene, o, d, tm, t_rec, which, idx, aux)
        sc = mats.scatter(
            scene.materials, scene.textures, mat_id, d, normal, front,
            uu, vv, p, seed, stream, bounce, **scene.tex_flags)
        mat_attrs = None

    zero = V3.zeros(alive.shape, device=dev)

    # --- emission (iff allowLightHits) --------------------------------------
    emit_mask = alive & hit & allow_light
    radiance = radiance + V3.select(emit_mask, throughput * sc.emitted, zero)

    # --- NEE + MIS ------------------------------------------------------------
    use_mis = torch.zeros_like(alive)
    blk_a = blk_h = torch.zeros_like(alive)
    if scene.n_lights > 0:
        use_mis = sc.can_use_nee & alive & hit
        direct, _, blk_a = sample_area_light(
            scene, cam, p, normal, d, sc.attenuation, mat_id,
            seed, stream, bounce, mat_attrs=mat_attrs, active=use_mis,
            tabs=tabs, blocked=dec_blk_a)
        if mega.uses_hdri_nee(scene):
            hdri_direct, _, blk_h = sample_hdri_light(
                scene, cam, p, normal, d, sc.attenuation, mat_id,
                seed, stream, bounce, mat_attrs=mat_attrs, active=use_mis,
                tabs=tabs, blocked=dec_blk_h)
            direct = direct + hdri_direct
        radiance = radiance + V3.select(use_mis, throughput * direct, zero)

    if rec is not None:
        # lanes that did not enter the bounce alive read as no hit (the
        # shadow sweep of a lane that sampled no light found nothing)
        none = torch.zeros_like(idx, dtype=torch.int32)
        rec.append((torch.where(hit, which, HIT_NONE),
                    torch.where(hit, idx, none),
                    None if aux is None else torch.where(hit, aux, none),
                    blk_a, blk_h))

    # --- continue the path ----------------------------------------------------
    alive = alive & hit & sc.scattered
    throughput = V3.select(alive, throughput * sc.attenuation, throughput)
    o = V3.select(alive, p, o)
    d = V3.select(alive, sc.direction, d)
    allow_light = ~use_mis
    return PathState(o, d, throughput, radiance, alive, allow_light,
                     miss_dir, miss_tp, miss_primary, missed)


def _check_standard(scene: Scene):
    """Raise for what the standard integrator does not take yet."""
    if scene.has_noise:
        raise NotImplementedError(
            "marble noise textures are not ported yet (ROADMAP.md A13)")
    if scene.has_image:
        raise NotImplementedError(
            "image textures are not ported yet (ROADMAP.md A16)")


def _stack_decisions(scene: Scene, rows, depth: int, r: int, dev) -> Decisions:
    """Per-bounce record tuples -> ``Decisions``; bounces never run (every
    ray died before them) read as no hit."""
    def stack(k, dtype):
        out = torch.zeros((depth, r), dtype=dtype, device=dev)
        for b, row in enumerate(rows):
            out[b] = row[k]
        return out

    aux = (stack(2, torch.int32) if scene.meshes
           else _zero_rows(depth, r, torch.int32, dev))
    blk_h = (stack(4, torch.bool) if mega.uses_hdri_nee(scene)
             else _zero_rows(depth, r, torch.bool, dev))
    return Decisions(stack(0, _which_dtype(scene)), stack(1, torch.int32), aux,
                     stack(3, torch.bool), blk_h)


def trace(scene: Scene, cam: Camera, o, d, tm, stream, seed, *,
          differentiable: bool = False, mega_mode=None,
          with_stats: bool = False, record: bool = False,
          decisions: Optional[Decisions] = None):
    """Radiance for a ray megabatch, on the device the rays lie on.

    o/d: V3 (or [R,3] tensors, converted); tm/stream [R].  Returns V3, or
    (V3, stats dict) when ``with_stats``; ``stats["mesh_overflow"]`` is
    always 0: the mesh kernels have no slot cap and drop nothing (the JAX
    package's frontier traversal could drop pairs).

    ``mega_mode``: None picks 'single' (the megakernel) for a scene inside
    its gate when ``differentiable`` is false, else 'off' (the standard
    integrator); either can be forced.

    ``differentiable=True`` (standard integrator only) keeps the path
    differentiable by ``torch.autograd`` with respect to the texture
    colours, fuzz and IOR: hit records, materials and textures are indexed
    from the scene's tables.  The closest-hit kernels see detached inputs,
    so a surface hit's distance ``t`` and the winner carry no gradient.
    Colour and emission gradients are exact all the same (they flow through
    the records, not through ``t``); fuzz and IOR gradients lack the terms
    that reach later hits through ``t``; the replay below has them.  All
    ``max_depth`` bounces run; the non-differentiable route stops as soon as
    no ray is alive.

    The replay (``render/grad``'s tier for scenes outside the gradient
    kernels' gates):
      ``record=True`` also returns the ``Decisions`` of the trace, appended
      to what it returns otherwise.  The radiance is that of the same call
      without ``record``.  The megakernel records by its own kernel
      (``mega_mode="single"``), the standard integrator as it goes.
      ``decisions=...`` replays a record differentiably: no closest-hit and
      no shadow sweep runs, each bounce takes its winner from the record and
      recomputes that winner's distance (``_winner_t``), so gradients also
      flow through the hit distance.  Gradients equal those of
      ``differentiable=True`` plus those terms wherever the discrete
      outcomes are stable.
    """
    if record and decisions is not None:
        raise ValueError("record=True and decisions= exclude each other")
    if not isinstance(o, V3):
        o = V3.from_rows(o)
    if not isinstance(d, V3):
        d = V3.from_rows(d)
    r = o.x.shape[0]
    dev = o.x.device

    if decisions is not None:
        differentiable = True
        mega_mode = "off"   # the replay runs no sweep
    if mega_mode is None:
        mega_mode = choose_mega_mode(scene, cam, r, differentiable)
    if mega_mode in ("split", "compact"):
        raise NotImplementedError(
            f"mega_mode {mega_mode!r} needs the resumable megakernel, which "
            "is not ported yet (ROADMAP.md B11)")
    if mega_mode == "image":
        raise NotImplementedError(
            "mega_mode 'image' comes with image textures (ROADMAP.md A16)")
    if mega_mode not in ("off", "single"):
        raise ValueError(f"unknown mega_mode {mega_mode!r}")

    stats = dict(mesh_overflow=0)
    if mega_mode == "single":
        res = mega.trace_megakernel(
            scene, cam, V3(*(c.contiguous() for c in o)),
            V3(*(c.contiguous() for c in d)), tm.contiguous(), stream, seed,
            record=record)
        radiance, miss_dir, miss_tp, flags = res[:4]
        rad = _add_miss(scene, cam, radiance, (flags & mega.FLAG_MISSED) != 0,
                        miss_dir, miss_tp, (flags & mega.FLAG_PRIMARY) != 0)
        out = (rad,) + ((stats,) if with_stats else ())
        if record:
            which, idx, blk_a, blk_h = res[4]
            depth = idx.shape[0]
            if not mega.uses_hdri_nee(scene):
                blk_h = _zero_rows(depth, r, torch.bool, dev)
            out += (Decisions(which, idx, _zero_rows(depth, r, torch.int32, dev),
                              blk_a, blk_h),)
        return out if len(out) > 1 else rad

    _check_standard(scene)
    fast = attr_path_ok(scene, differentiable)
    tabs = sweep_tables(scene, with_consts=fast) if decisions is None else None
    false = torch.zeros((r,), dtype=torch.bool, device=dev)
    true = torch.ones((r,), dtype=torch.bool, device=dev)
    state = PathState(
        o, d,
        V3.full((r,), (1.0, 1.0, 1.0), device=dev),   # throughput
        V3.zeros((r,), device=dev),                   # radiance
        true, true,                                   # alive, allow_light
        V3.zeros((r,), device=dev), V3.zeros((r,), device=dev),
        false, false,                                 # miss_primary, missed
    )
    rows = [] if record else None
    for bounce in range(cam.max_depth):
        # Deep configurations kill most lanes within a few bounces: the
        # render stops when none survive.  A gradient-bearing trace runs
        # every bounce, so that its graph does not depend on the data.
        if not differentiable and bounce > 0 and not bool(state.alive.any()):
            break
        dec = (None if decisions is None
               else tuple(field[bounce] for field in decisions))
        state = bounce_step(scene, cam, state, tm, stream, seed, bounce,
                            fast=fast, tabs=tabs, dec=dec, rec=rows)

    rad = _add_miss(scene, cam, state.radiance, state.missed, state.miss_dir,
                    state.miss_tp, state.miss_primary)
    out = (rad,) + ((stats,) if with_stats else ())
    if record:
        out += (_stack_decisions(scene, rows, cam.max_depth, r, dev),)
    return out if len(out) > 1 else rad
