"""Radiance HDR (.hdr / RGBE) loader.

NumPy copy of the JAX package's ``io/hdr.py`` (the reference's parser):
header scan to the resolution line, old-format raw scanlines or new-format
per-component run-length encoding, and the RGBE -> float rule
``(mantissa + 0.5) * 2^(e - 136)`` with exponent byte 0 meaning black.
"""

from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Load a Radiance HDR file -> float32 array [H, W, 3] (linear)."""
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---------------------------------------------------------
    pos = data.index(b"\n") + 1
    if not data[:2] == b"#?":
        raise ValueError(f"{path}: missing '#?' Radiance signature")
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if line == b"":
            break
    end = data.index(b"\n", pos)
    parts = data[pos:end].strip().split()
    pos = end + 1
    if len(parts) != 4:
        raise ValueError(f"{path}: bad resolution line {parts}")
    if parts[0] == b"-Y" and parts[2] == b"+X":
        height, width = int(parts[1]), int(parts[3])
    elif parts[0] == b"+X" and parts[2] == b"-Y":
        width, height = int(parts[1]), int(parts[3])
    else:
        raise ValueError(f"{path}: unsupported resolution format {parts}")

    buf = np.frombuffer(data, dtype=np.uint8)
    rgbe = np.zeros((height, width, 4), dtype=np.uint8)

    for y in range(height):
        header = buf[pos : pos + 4]
        pos += 4
        if header[0] == 2 and header[1] == 2:
            scan_w = (int(header[2]) << 8) | int(header[3])
            if scan_w != width:
                raise ValueError(f"{path}: scanline width mismatch at row {y}")
            for comp in range(4):
                x = 0
                while x < width:
                    code = int(buf[pos]); pos += 1
                    if code > 128:  # run
                        count = min(code - 128, width - x)
                        rgbe[y, x : x + count, comp] = buf[pos]
                        pos += 1
                        x += count
                    else:  # literal
                        count = min(code, width - x)
                        rgbe[y, x : x + count, comp] = buf[pos : pos + count]
                        pos += count
                        x += count
        else:
            # Old format: the header bytes are the first pixel, the rest raw RGBE
            rgbe[y, 0] = header
            rest = buf[pos : pos + 4 * (width - 1)].reshape(width - 1, 4)
            rgbe[y, 1:] = rest
            pos += 4 * (width - 1)

    e = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(1.0, e - 136).astype(np.float32)
    rgb = (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]
    rgb[e == 0] = 0.0
    return rgb
