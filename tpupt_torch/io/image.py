"""Image output. PNG is written with the standard library (zlib), no imaging package.

Image and OBJ *input* waits for its port (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def save_png(path: str, rgb8: np.ndarray) -> None:
    """Write an [H,W,3] uint8 array as an 8-bit RGB PNG (camera.rs:118-123)."""
    img = np.ascontiguousarray(rgb8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_png: need [H,W,3] uint8, got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
