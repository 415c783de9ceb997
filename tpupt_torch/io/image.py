"""Image input and output (counterpart of ``tpupt/io/image.py``).

Input: the reference decodes every texture, `.hdr` Radiance files included, to
Rgb8 (texture.rs:63-68: ``decode().to_rgb8()``); ``load_image_rgb8`` reproduces
that quantization. `.hdr` files (by suffix) are decoded here in numpy; PNG and
JPEG files (by their first bytes) by the port's own readers, ``io/png.py`` and
``io/jpeg.py``, which give PIL's bytes. No path needs an imaging package.

Output: PNG is written with the standard library (zlib), no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import read_jpeg_rgb8
from .png import SIGNATURE as PNG_SIGNATURE
from .png import read_png_rgb8


def _read_radiance_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder -> float32 [H,W,3] linear radiance.

    Handles new-style RLE scanlines (0x02 0x02 marker) and flat RGBE; a pixel is
    c * 2^(e-136) (ldexp(c, e-128-8)), matching the Rust `image` crate the
    reference loads through (texture.rs:63).
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance RGBE file")
    pos = 0
    while True:  # the header ends at the first empty line
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    img = np.zeros((h, w, 4), np.uint8)
    i = 0
    for y in range(h):
        if (
            8 <= w < 32768
            and buf[i] == 2
            and buf[i + 1] == 2
            and ((int(buf[i + 2]) << 8) | int(buf[i + 3])) == w
        ):
            i += 4  # new-style RLE: 4 component planes per scanline
            for c in range(4):
                x = 0
                while x < w:
                    cnt = int(buf[i])
                    i += 1
                    if cnt > 128:  # run
                        n = cnt - 128
                        img[y, x : x + n, c] = buf[i]
                        i += 1
                        x += n
                    else:  # literal
                        img[y, x : x + cnt, c] = buf[i : i + cnt]
                        i += cnt
                        x += cnt
        else:  # flat RGBE scanline
            img[y] = buf[i : i + w * 4].reshape(w, 4)
            i += w * 4

    e = img[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return img[..., :3].astype(np.float32) * scale[..., None]


def _decode_rgb8(path: str) -> np.ndarray:
    """A PNG or JPEG file, told apart by its first bytes -> uint8 [H,W,3]."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return read_png_rgb8(path)
    if head[:2] == b"\xff\xd8":
        return read_jpeg_rgb8(path)
    raise ValueError(f"{path}: not a PNG, JPEG or .hdr image")


def load_image_rgb8(path: str) -> np.ndarray:
    """Load an image as uint8 [H,W,3], matching the reference's Rgb8 quantization.

    Matches the `image` crate pipeline: decode -> to_rgb8 (texture.rs:63-68); the
    /255 happens at lookup time (texture.rs:84-90). For float sources (.hdr) the
    crate clamps to [0,1] and scales by 255.
    """
    if path.lower().endswith(".hdr"):
        data = _read_radiance_hdr(path)
        q = np.clip(data, 0.0, 1.0) * 255.0 + 0.5
        return np.floor(q).clip(0, 255).astype(np.uint8)
    return _decode_rgb8(path)


def load_image_f32(path: str) -> np.ndarray:
    """Load at full precision (HDR stays HDR) -> float32 [H,W,3]."""
    if path.lower().endswith(".hdr"):
        return _read_radiance_hdr(path)
    return _decode_rgb8(path).astype(np.float32) / 255.0


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
