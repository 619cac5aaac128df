"""Trainable parameters of a scene (inverse rendering).

``trainable_params`` names what ``render/grad.render_grad`` returns
gradients for; ``apply_params`` puts a changed set back into a scene.
The mesh-parallel render and training step of the JAX package's module of
the same name are not ported yet (ROADMAP.md A19).
"""

from __future__ import annotations

import dataclasses

from ..geometry.scene import Scene


def trainable_params(scene: Scene) -> dict:
    """The parameter dict gradients are taken for: material fuzz / IOR,
    texture colours (albedo and emission), texture image maps and, in a
    scene with an environment, its texels (``env_data``).  The values are
    the scene's own tensors, not copies."""
    p = dict(
        fuzz=scene.materials.fuzz,
        ior=scene.materials.ior,
        color=scene.textures.color,
        even_color=scene.textures.even_color,
        odd_color=scene.textures.odd_color,
        atlas=scene.textures.atlas,
    )
    if scene.env is not None:
        p["env_data"] = scene.env.data
    return p


def apply_params(scene: Scene, params: dict) -> Scene:
    """``scene`` with the parameters of ``params`` put in; the environment's
    alias tables stay (they are constants of the sampler)."""
    env = scene.env
    if env is not None and "env_data" in params:
        env = env._replace(data=params["env_data"])
    return dataclasses.replace(
        scene,
        env=env,
        materials=dataclasses.replace(
            scene.materials, fuzz=params["fuzz"], ior=params["ior"]),
        textures=dataclasses.replace(
            scene.textures,
            color=params["color"],
            even_color=params["even_color"],
            odd_color=params["odd_color"],
            atlas=params["atlas"],
        ),
    )
