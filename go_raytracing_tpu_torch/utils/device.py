"""Device selection shared by every entry point.

The package runs on the GPU unless the caller asks for the CPU: a
``device`` argument of ``None`` means ``"cuda"``, and a machine without a
CUDA device raises instead of quietly rendering on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: this package runs on the GPU "
            "unless asked otherwise; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
