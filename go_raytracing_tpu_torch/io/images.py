"""LDR image loading with the reference's linearization quirk.

Copy of the JAX package's ``io/images.py``.  The reference converts PNG and
JPEG texels with ``LinearToGamma``: it applies a square root where a true
linearization would square (rt/image_loader.go:68-78).  Renders therefore
see sqrt-encoded texels, and ``load_ldr`` reproduces that by default.

PIL is imported inside the function: nothing on the render path calls it,
and a machine without PIL can still import the package.
"""

from __future__ import annotations

import numpy as np


def load_ldr(path: str, *, reference_quirk: bool = True) -> np.ndarray:
    """Load an LDR image -> float32 [H, W, 3] in [0, 1].

    With ``reference_quirk`` (default) texel values are sqrt(v/max) exactly
    like the reference loader; with False they are left as-is (v/max)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if reference_quirk:
        arr = np.sqrt(arr)
    return arr
