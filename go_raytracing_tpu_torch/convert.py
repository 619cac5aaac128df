"""State carried across from the JAX package.

The JAX package's ``Scene`` and ``Camera`` arrive here as plain Python
containers of numpy arrays, scalars and flags — the caller flattens them
(``np.asarray`` on every leaf, NamedTuples as dicts); nothing of JAX is
imported here.  With this the tests feed both packages the same scene.

Expected tree: a dict with the ``Scene`` field names.  ``spheres``,
``planar``, ``volumes``, ``materials`` and ``textures`` are dicts of the
pack's field names; ``light_*`` are arrays; ``has_noise``, ``has_image``,
``has_checker`` and ``env_importance`` are bools.  ``meshes`` is a list of
dicts of the ``MeshProto`` field names (``geometry/mesh_bvh.proto_from_numpy``).
``env`` is None or a dict of the ``lights/hdri.Environment`` field names
(its tables are taken as given, not rebuilt).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera import Camera
from .geometry import mesh_bvh, packs
from .geometry.scene import Scene
from .lights import hdri as hdri_mod
from .materials import tables as mats
from .materials import textures as tex
from .utils.device import resolve_device


def _pack(cls, fields: dict, dev):
    names = [f.name for f in dataclasses.fields(cls)]
    unknown = set(fields) - set(names)
    if unknown:
        raise KeyError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    vals = {}
    for n in names:
        a = fields.get(n)
        if a is None:
            vals[n] = None
            continue
        a = np.asarray(a)
        dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        vals[n] = torch.from_numpy(np.array(a, dtype)).to(dev)
    return cls(**vals)


def scene_from_numpy(tree: dict, device=None) -> Scene:
    """Dict of numpy arrays and flags -> ``Scene`` on ``device``
    (``None`` means "cuda")."""
    dev = resolve_device(device)
    env = tree.get("env")
    if env is not None:
        env = hdri_mod.environment_from_numpy(env, dev)

    def arr(name, dtype):
        return torch.from_numpy(
            np.array(tree[name], dtype)).to(dev)

    return Scene(
        spheres=_pack(packs.SpherePack, tree["spheres"], dev),
        planar=_pack(packs.PlanarPack, tree["planar"], dev),
        volumes=_pack(packs.VolumePack, tree["volumes"], dev),
        materials=_pack(mats.MaterialPack, tree["materials"], dev),
        textures=_pack(tex.TexturePack, tree["textures"], dev),
        light_q=arr("light_q", np.float32),
        light_u=arr("light_u", np.float32),
        light_v=arr("light_v", np.float32),
        light_normal=arr("light_normal", np.float32),
        light_area=arr("light_area", np.float32),
        light_mat=arr("light_mat", np.int32),
        env=env,
        meshes=tuple(mesh_bvh.proto_from_numpy(m, dev)
                     for m in tree.get("meshes", ())),
        has_noise=bool(tree.get("has_noise", False)),
        has_image=bool(tree.get("has_image", False)),
        has_checker=bool(tree.get("has_checker", False)),
        env_importance=bool(tree.get("env_importance", True)),
    )


def camera_from_dict(fields: dict) -> Camera:
    """``dataclasses.asdict`` of the JAX package's Camera -> ``Camera``."""
    vals = {}
    for f in dataclasses.fields(Camera):
        if f.name in fields:
            v = fields[f.name]
            vals[f.name] = tuple(v) if isinstance(v, (list, tuple, np.ndarray)) else v
    return Camera(**vals)


def params_from_numpy(tree: dict, device=None) -> dict:
    """``trainable_params`` dict of numpy arrays -> dict of float32 tensors
    on ``device`` (``None`` means "cuda"), for ``apply_params``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """Dict of tensors (parameters or their gradients) -> numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
