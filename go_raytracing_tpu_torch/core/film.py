"""Film: sample accumulation -> display-ready pixels, plus PNG output.

The colour pipeline:
  1. average accumulated radiance by samples-per-pixel,
  2. gamma-2.0 encode via sqrt,
  3. clamp to [0, 0.999],
  4. quantize with ``byte = floor(256 * clamped)``.

The PNG encoder is hand-rolled on stdlib ``zlib``/``struct`` so the write
path has no imaging dependency.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def linear_to_gamma(linear):
    """Gamma-2.0 encode: sqrt of the positive part.

    The double-where keeps the derivative finite at 0 (sqrt' -> inf would
    NaN-poison gradients of losses on tonemapped images)."""
    safe = torch.clamp_min(linear, 1e-12)
    return torch.where(linear > 0, torch.sqrt(safe), 0.0)


def tonemap(accum, spp):
    """Accumulated linear radiance [H, W, 3] -> float pixels in [0, 0.999].

    ``spp`` is the number of samples already summed into ``accum``."""
    scaled = accum / float(spp)
    g = linear_to_gamma(scaled)
    return torch.clamp(g, 0.0, 0.999)


def to_uint8(pixels01):
    """[0, 0.999] floats -> uint8 numpy array via floor(256 * x)."""
    return torch.floor(256.0 * pixels01).to(torch.uint8).cpu().numpy()


def encode_png(rgb_uint8) -> bytes:
    """Encode an 8-bit RGB PNG. ``rgb_uint8``: uint8 array [H, W, 3]."""
    arr = np.ascontiguousarray(rgb_uint8, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {arr.shape}")
    h, w = arr.shape[:2]

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path, rgb_uint8):
    """Write an 8-bit RGB PNG. ``rgb_uint8``: uint8 array [H, W, 3]."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb_uint8))


def read_png(path):
    """Minimal PNG reader for our own 8-bit RGB output (tests/golden files)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, w, h, idat = 8, None, None, b""
    bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8 or color_type != 2:
        raise ValueError("read_png only supports 8-bit RGB (our own writer)")
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, w, 3), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], dtype=np.uint8
        ).copy()
        if ftype == 0:
            pass
        elif ftype == 2:  # Up
            line = (line + prev).astype(np.uint8)
        elif ftype == 1:  # Sub
            for x in range(3, stride):
                line[x] = (int(line[x]) + int(line[x - 3])) & 0xFF
        elif ftype == 3:  # Average
            for x in range(stride):
                left = int(line[x - 3]) if x >= 3 else 0
                line[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = int(line[x - 3]) if x >= 3 else 0
                b = int(prev[x])
                c = int(prev[x - 3]) if x >= 3 else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        out[y] = line.reshape(w, 3)
        prev = line
    return out
