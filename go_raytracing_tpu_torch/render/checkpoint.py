"""Checkpoint / resume for long renders.

The RNG is counter-based over (pixel, sample), so the accumulation buffer
and the number of samples done determine the rest of a render: a resumed
render continues the same streams (``render``'s ``sample_offset``).  A
render in slices of ``spp_per_checkpoint`` samples is the bits of one
``render`` whose chunks are that many samples (``chunk = spp_per_checkpoint
* n_virt``): each slice adds its chunk's sums to the buffer as such a
render does.

The files are the JAX package's (``go_raytracing_tpu/render/checkpoint.py``):
an ``.npz`` with ``accum`` [H, W, 3] float32 and ``meta``, a JSON string of
``samples_done``, ``seed``, ``image_width`` and ``image_height``; either
package reads the other's.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..camera import Camera
from ..geometry.scene import Scene
from . import renderer


def save(path: str, accum, samples_done: int, seed: int, cam: Camera):
    """Save a render checkpoint (accumulator + progress metadata)."""
    meta = dict(
        samples_done=int(samples_done),
        seed=int(seed),
        image_width=cam.image_width,
        image_height=cam.image_height,
    )
    accum = accum.detach().cpu().numpy() if torch.is_tensor(accum) else np.asarray(accum)
    np.savez_compressed(path, accum=accum, meta=json.dumps(meta))


def load(path: str):
    """Load a checkpoint -> (accum [H, W, 3] float32 on the CPU,
    samples_done, seed)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        accum = torch.from_numpy(np.array(z["accum"], dtype=np.float32))
    return accum, meta["samples_done"], meta["seed"]


def render_with_checkpoints(
    scene: Scene,
    cam: Camera,
    path: str,
    *,
    spp: Optional[int] = None,
    seed: int = 0,
    spp_per_checkpoint: int = 16,
    stats: Optional[renderer.RenderStats] = None,
    device=None,
):
    """Render in slices of ``spp_per_checkpoint`` samples, checkpointing to
    ``path`` after each; resumes from ``path`` if it exists.  Returns the
    final accumulation buffer [H, W, 3] on the scene's device.
    ``device=None`` means "cuda", as for ``render``."""
    spp = cam.samples_per_pixel if spp is None else spp
    accum = None
    done = 0
    if os.path.exists(path):
        accum, done, saved_seed = load(path)
        if saved_seed != seed:
            raise ValueError(
                f"checkpoint {path} was rendered with seed {saved_seed}, not {seed}"
            )
    while done < spp:
        n = min(spp_per_checkpoint, spp - done)
        accum = renderer.render(
            scene, cam, spp=n, seed=seed, sample_offset=done, accum=accum,
            stats=stats, device=device,
        )
        done += n
        save(path, accum, done, seed, cam)
    return accum
