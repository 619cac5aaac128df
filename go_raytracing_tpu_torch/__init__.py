"""go_raytracing_tpu_torch — the path tracer's PyTorch/CUDA port.

Second package beside ``go_raytracing_tpu`` (JAX, the reference), with
the same subpackage layout and public names, written for one NVIDIA GPU:
plain tensor code in PyTorch, the bounce loop and its product-chain
gradient in hand-written CUDA kernels (``csrc/``).  It imports ``torch``
and ``numpy`` only.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from .camera import Camera, quick_preview, standard_quality, high_quality
from .geometry.scene import Affine, Scene, SceneBuilder
from .parallel.sharding import apply_params, trainable_params
from .render.grad import render_grad
from .render.renderer import (
    RenderStats,
    render,
    render_image,
    render_progressive,
)
from .scenes.builders import REGISTRY, load_scene
from .core import film

__all__ = [
    "Affine",
    "Camera",
    "REGISTRY",
    "RenderStats",
    "Scene",
    "SceneBuilder",
    "apply_params",
    "film",
    "high_quality",
    "load_scene",
    "quick_preview",
    "render",
    "render_grad",
    "render_image",
    "render_progressive",
    "standard_quality",
    "trainable_params",
]
