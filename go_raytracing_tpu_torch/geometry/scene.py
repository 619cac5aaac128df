"""Scene container and host-side scene builder.

A ``SceneBuilder`` accumulates primitives, materials and textures
host-side in numpy, and ``build(device=...)`` freezes them into a
``Scene``: a frozen dataclass of SoA tensor tables on one device.

Transform wrappers are baked in at build time: affine transforms map
planar primitives exactly (transformed vertices span the same surface; the
normal is recomputed from the transformed edges), and spheres support
rigid + uniform-scale transforms.  Volume boundaries keep their transform
as a world->local matrix (oriented-box slab test).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import mesh_bvh, packs
from ..io import assets as assets_mod
from ..io import hdr as hdr_mod
from ..io import images as images_mod
from ..lights import hdri as hdri_mod
from ..materials import tables as mats
from ..materials import textures as tex
from ..utils.device import resolve_device


# -----------------------------------------------------------------------------
# Affine transforms (reference order: Scale -> Rx -> Ry -> Rz -> Translate,
#)
# -----------------------------------------------------------------------------

class Affine:
    """Host-side 3x4 affine transform."""

    def __init__(self, m: Optional[np.ndarray] = None):
        self.m = np.eye(4, dtype=np.float64) if m is None else np.asarray(m, np.float64)

    @staticmethod
    def trs(scale=(1, 1, 1), rotation_deg=(0, 0, 0), position=(0, 0, 0)) -> "Affine":
        """Compose in the reference's order: Scale, then Rx, Ry, Rz, then
        Translate."""
        s = np.diag([scale[0], scale[1], scale[2], 1.0])
        rx, ry, rz = [np.deg2rad(a) for a in rotation_deg]

        def rot_x(a):
            c, si = np.cos(a), np.sin(a)
            return np.array(
                [[1, 0, 0, 0], [0, c, -si, 0], [0, si, c, 0], [0, 0, 0, 1]], np.float64
            )

        def rot_y(a):
            c, si = np.cos(a), np.sin(a)
            return np.array(
                [[c, 0, si, 0], [0, 1, 0, 0], [-si, 0, c, 0], [0, 0, 0, 1]], np.float64
            )

        def rot_z(a):
            c, si = np.cos(a), np.sin(a)
            return np.array(
                [[c, -si, 0, 0], [si, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64
            )

        t = np.eye(4)
        t[:3, 3] = position
        return Affine(t @ rot_z(rz) @ rot_y(ry) @ rot_x(rx) @ s)

    def apply_point(self, p):
        p = np.asarray(p, np.float64)
        return self.m[:3, :3] @ p + self.m[:3, 3]

    def apply_vector(self, v):
        return self.m[:3, :3] @ np.asarray(v, np.float64)

    def inverse(self) -> "Affine":
        return Affine(np.linalg.inv(self.m))

    def compose(self, other: "Affine") -> "Affine":
        return Affine(self.m @ other.m)

    @property
    def linear(self):
        return self.m[:3, :3]

    def is_rigid_uniform(self, tol=1e-9) -> bool:
        l = self.linear
        g = l.T @ l
        s = g[0, 0]
        return bool(np.allclose(g, np.eye(3) * s, atol=tol * max(1.0, s)))



# -----------------------------------------------------------------------------
# Scene
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class Scene:
    spheres: packs.SpherePack
    planar: packs.PlanarPack
    volumes: packs.VolumePack
    materials: mats.MaterialPack
    textures: tex.TexturePack
    # NEE light table (quads registered with SceneBuilder.add_light)
    light_q: torch.Tensor       # [L, 3]
    light_u: torch.Tensor       # [L, 3]
    light_v: torch.Tensor       # [L, 3]
    light_normal: torch.Tensor  # [L, 3]
    light_area: torch.Tensor    # [L]
    light_mat: torch.Tensor     # [L] i32
    # HDRI environment (lights/hdri.py), or None
    env: Optional[hdri_mod.Environment] = None
    # Instanced triangle meshes: one mesh_bvh.MeshProto per prototype
    meshes: tuple = ()
    # --- static metadata ---
    has_noise: bool = False
    has_image: bool = False
    has_checker: bool = False
    env_importance: bool = True

    @property
    def n_lights(self) -> int:
        return int(self.light_area.shape[0])

    @property
    def n_volumes(self) -> int:
        return int(self.volumes.neg_inv_density.shape[0])

    @property
    def device(self) -> torch.device:
        return self.light_area.device

    @property
    def tex_flags(self):
        return dict(has_noise=self.has_noise, has_image=self.has_image)


class SceneBuilder:
    """Accumulates a scene host-side in numpy; ``build(device=...)``
    freezes it into tensors."""

    def __init__(self):
        self._sph: list = []       # (center, velocity, radius, mat)
        self._pla: list = []       # (q, u, v, normal, w, d, radius, kind, mat)
        self._vol: list = []       # (world_to_local 3x4, bmin, bmax, nid, mat, kind, planes)
        self._mat: list = []       # (kind, tex, fuzz, ior)
        self._tex: list = []       # dict per texture
        self._images: list = []    # [H, W, 3] float32 numpy arrays
        self._lights: list = []    # planar indices
        self._protos: list = []    # (verts [V,3] f64, tris [T,3] i64)
        self._instances: list = []  # (proto id, local->world 4x4, mat)
        self._env: Optional[tuple] = None   # (numpy data, rotation_deg)
        self._env_importance = True

    # --- textures ---------------------------------------------------------
    def solid(self, color) -> int:
        self._tex.append(dict(kind=tex.TEX_SOLID, color=tuple(color)))
        return len(self._tex) - 1

    def checker(self, scale, c1, c2) -> int:
        self._tex.append(
            dict(kind=tex.TEX_CHECKER, even=tuple(c1), odd=tuple(c2),
                 inv_scale=1.0 / scale)
        )
        return len(self._tex) - 1

    def noise(self, scale) -> int:
        self._tex.append(dict(kind=tex.TEX_NOISE, noise_scale=float(scale)))
        return len(self._tex) - 1

    def image(self, path_or_array) -> int:
        """An image texture: a path to an LDR image (found by
        ``io/assets.find_asset``, loaded by ``io/images.load_ldr``; a
        missing file raises ``FileNotFoundError``) or an [H, W, 3] array.
        The images of a scene share one atlas, padded to the largest."""
        if isinstance(path_or_array, str):
            path = assets_mod.find_asset(path_or_array, "images")
            arr = images_mod.load_ldr(path)
        else:
            arr = np.asarray(path_or_array, np.float32)
        self._images.append(arr)
        self._tex.append(dict(kind=tex.TEX_IMAGE, image_id=len(self._images) - 1))
        return len(self._tex) - 1

    def _as_tex(self, color_or_tex) -> int:
        if isinstance(color_or_tex, (int, np.integer)):
            return int(color_or_tex)
        return self.solid(color_or_tex)

    # --- materials --------------------------------------------------------
    def lambertian(self, color_or_tex) -> int:
        self._mat.append((mats.MAT_LAMBERTIAN, self._as_tex(color_or_tex), 0.0, 1.0))
        return len(self._mat) - 1

    def metal(self, albedo, fuzz: float) -> int:
        fuzz = min(float(fuzz), 1.0)  # clamp
        self._mat.append((mats.MAT_METAL, self._as_tex(albedo), fuzz, 1.0))
        return len(self._mat) - 1

    def dielectric(self, ior: float) -> int:
        self._mat.append((mats.MAT_DIELECTRIC, self.solid((1, 1, 1)), 0.0, float(ior)))
        return len(self._mat) - 1

    def diffuse_light(self, emit_color_or_tex) -> int:
        self._mat.append((mats.MAT_DIFFUSE_LIGHT, self._as_tex(emit_color_or_tex), 0.0, 1.0))
        return len(self._mat) - 1

    def isotropic(self, color_or_tex) -> int:
        self._mat.append((mats.MAT_ISOTROPIC, self._as_tex(color_or_tex), 0.0, 1.0))
        return len(self._mat) - 1

    # --- geometry ---------------------------------------------------------
    def sphere(self, center, radius, mat: int, transform: Optional[Affine] = None) -> int:
        return self.moving_sphere(center, center, radius, mat, transform)

    def moving_sphere(self, c1, c2, radius, mat: int, transform: Optional[Affine] = None) -> int:
        c1 = np.asarray(c1, np.float64)
        c2 = np.asarray(c2, np.float64)
        radius = max(0.0, float(radius))
        if transform is not None:
            if not transform.is_rigid_uniform():
                raise ValueError("sphere transforms must be rigid + uniform scale")
            s = float(np.cbrt(np.abs(np.linalg.det(transform.linear))))
            c1 = transform.apply_point(c1)
            c2 = transform.apply_point(c2)
            radius *= s
        self._sph.append((c1, c2 - c1, radius, mat))
        return len(self._sph) - 1

    def _planar(self, q, u, v, normal, w, d, radius, kind, mat) -> int:
        self._pla.append((q, u, v, normal, w, d, radius, kind, mat))
        return len(self._pla) - 1

    def quad(self, q, u, v, mat: int, transform: Optional[Affine] = None) -> int:
        q = np.asarray(q, np.float64)
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        if transform is not None:
            q2 = transform.apply_point(q)
            u = transform.apply_vector(u)
            v = transform.apply_vector(v)
            q = q2
        n = np.cross(u, v)
        normal = n / np.linalg.norm(n)
        d = float(normal @ q)
        w = n / (n @ n)  #
        return self._planar(q, u, v, normal, w, d, 0.0, packs.KIND_QUAD, mat)

    def triangle(self, v0, v1, v2, mat: int, transform: Optional[Affine] = None) -> int:
        v0 = np.asarray(v0, np.float64)
        v1 = np.asarray(v1, np.float64)
        v2 = np.asarray(v2, np.float64)
        if transform is not None:
            v0, v1, v2 = (transform.apply_point(p) for p in (v0, v1, v2))
        e1, e2 = v1 - v0, v2 - v0
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n)
        if norm == 0:
            raise ValueError("degenerate triangle")
        normal = n / norm
        d = float(normal @ v0)
        w = n / (n @ n)
        return self._planar(v0, e1, e2, normal, w, d, 0.0, packs.KIND_TRI, mat)

    def circle(self, center, normal, radius, mat: int) -> int:
        center = np.asarray(center, np.float64)
        normal = np.asarray(normal, np.float64)
        normal = normal / np.linalg.norm(normal)
        d = float(normal @ center)
        return self._planar(
            center, np.zeros(3), np.zeros(3), normal, np.zeros(3), d,
            float(radius), packs.KIND_CIRCLE, mat,
        )

    def plane(self, point, normal, mat: int) -> int:
        point = np.asarray(point, np.float64)
        normal = np.asarray(normal, np.float64)
        normal = normal / np.linalg.norm(normal)
        d = float(normal @ point)
        return self._planar(
            point, np.zeros(3), np.zeros(3), normal, np.zeros(3), d,
            0.0, packs.KIND_PLANE, mat,
        )

    def box(self, a, b, mat: int, transform: Optional[Affine] = None) -> list:
        """Axis-aligned box as 6 quads."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0, 0])
        dy = np.array([0, mx[1] - mn[1], 0])
        dz = np.array([0, 0, mx[2] - mn[2]])
        quads = [
            ([mn[0], mn[1], mx[2]], dx, dy),    # front
            ([mx[0], mn[1], mx[2]], -dz, dy),   # right
            ([mx[0], mn[1], mn[2]], -dx, dy),   # back
            ([mn[0], mn[1], mn[2]], dz, dy),    # left
            ([mn[0], mx[1], mx[2]], dx, -dz),   # top
            ([mn[0], mn[1], mn[2]], dx, dz),    # bottom
        ]
        return [self.quad(q, u, v, mat, transform) for q, u, v in quads]

    def pyramid(self, base_center, base_size, height, mat: int,
                transform: Optional[Affine] = None) -> list:
        """Base quad + 4 triangles."""
        c = np.asarray(base_center, np.float64)
        hs = base_size / 2.0
        out = [
            self.quad(
                c + [-hs, 0, -hs], [base_size, 0, 0], [0, 0, base_size], mat, transform
            )
        ]
        apex = c + [0, height, 0]
        corners = [
            c + [hs, 0, -hs], c + [hs, 0, hs], c + [-hs, 0, hs], c + [-hs, 0, -hs]
        ]
        for i in range(4):
            out.append(
                self.triangle(corners[i], corners[(i + 1) % 4], apex, mat, transform)
            )
        return out

    def mesh(self, verts, tris) -> int:
        """Register a triangle-mesh prototype (one BVH, shared by its
        instances); returns its id."""
        self._protos.append((np.asarray(verts, np.float64), np.asarray(tris, np.int64)))
        return len(self._protos) - 1

    def mesh_instance(self, proto_id: int, mat: int,
                      transform: Optional[Affine] = None):
        """Instance a prototype with a local->world transform."""
        l2w = np.eye(4) if transform is None else transform.m
        self._instances.append((proto_id, l2w, mat))

    def volume_box(self, a, b, density, color_or_tex,
                   transform: Optional[Affine] = None) -> int:
        """Constant-density medium in a (possibly transformed) box."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        inv = np.eye(4) if transform is None else transform.inverse().m
        mat = self.isotropic(color_or_tex)
        self._vol.append((inv[:3, :4], mn, mx, -1.0 / float(density), mat,
                          packs.VOL_BOX, None))
        return len(self._vol) - 1

    def volume_sphere(self, center, radius, density, color_or_tex) -> int:
        """Constant-density medium in a sphere.  Baked as a world->local
        affine mapping the sphere to the unit ball (center and radius
        folded into the transform)."""
        c = np.asarray(center, np.float64)
        r = float(radius)
        inv = np.zeros((3, 4))
        inv[0, 0] = inv[1, 1] = inv[2, 2] = 1.0 / r
        inv[:, 3] = -c / r
        mat = self.isotropic(color_or_tex)
        self._vol.append((inv, np.zeros(3), np.zeros(3),
                          -1.0 / float(density), mat, packs.VOL_SPHERE, None))
        return len(self._vol) - 1

    def volume_convex(self, planes, density, color_or_tex,
                      transform: Optional[Affine] = None) -> int:
        """Constant-density medium in an arbitrary convex polyhedron.
        ``planes``: iterable of (normal, d) or 4-vectors; inside = n.x <= d
        for all, in the local frame of ``transform`` (like volume_box's
        a/b)."""
        rows = []
        for p in planes:
            if len(p) == 2:
                nrm, dd = p
                rows.append([*np.asarray(nrm, np.float64), float(dd)])
            else:
                rows.append([float(x) for x in p])
        pl = np.asarray(rows, np.float64).reshape(-1, 4)
        inv = np.eye(4) if transform is None else transform.inverse().m
        mat = self.isotropic(color_or_tex)
        self._vol.append((inv[:3, :4], np.zeros(3), np.zeros(3),
                          -1.0 / float(density), mat, packs.VOL_PLANES, pl))
        return len(self._vol) - 1

    def volume_pyramid(self, base_center, base_size, height, density,
                       color_or_tex,
                       transform: Optional[Affine] = None) -> int:
        """Constant-density medium in the builder's pyramid shape (base
        quad + 4 slanted faces)."""
        c = np.asarray(base_center, np.float64)
        hs = base_size / 2.0
        apex = c + [0.0, height, 0.0]
        corners = [c + [hs, 0, -hs], c + [hs, 0, hs],
                   c + [-hs, 0, hs], c + [-hs, 0, -hs]]
        planes = [((0.0, -1.0, 0.0), -c[1])]  # base: y >= c.y
        for i in range(4):
            a, b = corners[i], corners[(i + 1) % 4]
            nrm = np.cross(b - a, apex - a)
            nrm = nrm / np.linalg.norm(nrm)
            # orient outward (away from the base center + up a bit)
            if np.dot(nrm, (a + b + apex) / 3.0 - (c + [0, height / 3, 0])) < 0:
                nrm = -nrm
            planes.append((tuple(nrm), float(np.dot(nrm, a))))
        return self.volume_convex(planes, density, color_or_tex, transform)

    # --- lights / environment --------------------------------------------
    def add_light(self, planar_index: int):
        """Register a quad as a NEE light (Camera.AddLight)."""
        if self._pla[planar_index][7] != packs.KIND_QUAD:
            raise ValueError("only quads can be NEE lights")
        self._lights.append(planar_index)

    def set_environment(self, path_or_array, rotation_degrees: float = 0.0):
        """An HDRI environment: a path to a Radiance .hdr file (found by
        ``io/assets.find_asset``; a missing file raises
        ``FileNotFoundError``) or an [H, W, 3] array of linear radiance."""
        if isinstance(path_or_array, str):
            path = assets_mod.find_asset(path_or_array, "hdri")
            arr = hdr_mod.load_hdr(path)
        else:
            arr = np.asarray(path_or_array, np.float32)
        self._env = (arr, rotation_degrees)

    def disable_env_importance_sampling(self):
        self._env_importance = False

    # --- freeze -----------------------------------------------------------
    def build(self, device=None) -> Scene:
        """Freeze into tensors on ``device`` (``None`` means "cuda")."""
        dev = resolve_device(device)
        f32, i32 = np.float32, np.int32

        def dv(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        def cols(records, dtypes, shapes):
            """List of tuples -> one tensor per column (empty-safe)."""
            if records:
                return [dv(np.stack([np.asarray(x) for x in col]), dt)
                        for col, dt in zip(zip(*records), dtypes)]
            return [dv(np.zeros((0,) + s), dt) for dt, s in zip(dtypes, shapes)]

        v3, sc = (3,), ()
        spheres = packs.SpherePack(*cols(
            self._sph, (f32, f32, f32, i32), (v3, v3, sc, sc)))
        planar = packs.PlanarPack(*cols(
            self._pla, (f32,) * 7 + (i32, i32), (v3,) * 5 + (sc,) * 4))
        # Half-space rows of the polyhedron media, padded to the longest
        # list with a plane every point satisfies (n = 0, d = 1).
        vplanes = [v[6] for v in self._vol]
        planes_arr = None
        if any(p is not None for p in vplanes):
            kmax = max(len(p) for p in vplanes if p is not None)
            noop = np.array([0.0, 0.0, 0.0, 1.0])
            rows = []
            for p in vplanes:
                p = np.zeros((0, 4)) if p is None else np.asarray(p)
                pad = np.broadcast_to(noop, (kmax - len(p), 4))
                rows.append(np.concatenate([p, pad], axis=0))
            planes_arr = dv(np.stack(rows), f32)
        volumes = packs.VolumePack(*cols(
            [v[:6] for v in self._vol], (f32, f32, f32, f32, i32, i32),
            ((3, 4), v3, v3, sc, sc, sc)), planes=planes_arr)

        if not self._mat:
            self.lambertian((0.5, 0.5, 0.5))  # scenes must have >= 1 material
        materials = mats.MaterialPack(*cols(
            self._mat, (i32, i32, f32, f32), (sc,) * 4))

        t = len(self._tex)
        kind = np.zeros(t, i32)
        color = np.zeros((t, 3), f32)
        even = np.zeros((t, 3), f32)
        odd = np.zeros((t, 3), f32)
        inv_scale = np.zeros(t, f32)
        noise_scale = np.zeros(t, f32)
        image_id = np.zeros(t, i32)
        for i, tx in enumerate(self._tex):
            kind[i] = tx["kind"]
            color[i] = tx.get("color", (0, 0, 0))
            even[i] = tx.get("even", (0, 0, 0))
            odd[i] = tx.get("odd", (0, 0, 0))
            inv_scale[i] = tx.get("inv_scale", 1.0)
            noise_scale[i] = tx.get("noise_scale", 1.0)
            image_id[i] = tx.get("image_id", 0)
        # the marble's value only multiplies white (rt/texture.go:81-85)
        color[kind == tex.TEX_NOISE] = (1.0, 1.0, 1.0)
        # the images in one atlas [I, Hmax, Wmax, 3], each in its top-left
        # corner, and each one's (width, height)
        if self._images:
            hmax = max(im.shape[0] for im in self._images)
            wmax = max(im.shape[1] for im in self._images)
            atlas = np.zeros((len(self._images), hmax, wmax, 3), f32)
            atlas_wh = np.zeros((len(self._images), 2), i32)
            for i, im in enumerate(self._images):
                atlas[i, : im.shape[0], : im.shape[1]] = im
                atlas_wh[i] = (im.shape[1], im.shape[0])
        else:
            atlas = np.zeros((1, 1, 1, 3), f32)
            atlas_wh = np.ones((1, 2), i32)
        textures = tex.TexturePack(
            dv(kind, i32), dv(color, f32), dv(even, f32), dv(odd, f32),
            dv(inv_scale, f32), dv(noise_scale, f32), dv(image_id, i32),
            dv(atlas, f32), dv(atlas_wh, i32),
        )

        n_l = len(self._lights)
        lq = np.zeros((n_l, 3), f32)
        lu = np.zeros((n_l, 3), f32)
        lv = np.zeros((n_l, 3), f32)
        ln = np.zeros((n_l, 3), f32)
        la = np.zeros(n_l, f32)
        lm = np.zeros(n_l, i32)
        for i, pi in enumerate(self._lights):
            q, u, v, nrm, w, d, rad, kind_, m = self._pla[pi]
            lq[i], lu[i], lv[i], ln[i] = q, u, v, nrm
            la[i] = np.linalg.norm(np.cross(u, v))
            lm[i] = m

        # A prototype without instances is left out, as in the JAX package.
        meshes = []
        for pid, (verts, tris) in enumerate(self._protos):
            insts = [(l2w, m) for p, l2w, m in self._instances if p == pid]
            if insts:
                meshes.append(mesh_bvh.build_proto(verts, tris, insts, dev))

        env = None
        if self._env is not None:
            env = hdri_mod.build_environment(self._env[0], self._env[1], device=dev)

        return Scene(
            spheres=spheres,
            planar=planar,
            volumes=volumes,
            materials=materials,
            textures=textures,
            light_q=dv(lq, f32),
            light_u=dv(lu, f32),
            light_v=dv(lv, f32),
            light_normal=dv(ln, f32),
            light_area=dv(la, f32),
            light_mat=dv(lm, i32),
            env=env,
            meshes=tuple(meshes),
            has_noise=bool((kind == tex.TEX_NOISE).any()),
            has_image=bool((kind == tex.TEX_IMAGE).any()),
            has_checker=bool((kind == tex.TEX_CHECKER).any()),
            env_importance=self._env_importance,
        )
