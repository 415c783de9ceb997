"""Radiance (.hdr) images as the Rust reference's textures read them: decoded, clamped to
[0, 1] and quantized to 8 bits a channel (texture.rs:63-68, ``decode().to_rgb8()``).
Only the Radiance format is read: the benchmark's configurations name no other image.
"""

from __future__ import annotations

import numpy as np


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


def load_rgb8(path: str) -> np.ndarray:
    """A .hdr file -> uint8 [H,W,3]: clamp to [0,1], scale by 255, round half up."""
    if not path.lower().endswith(".hdr"):
        raise ValueError(f"{path}: only Radiance .hdr images are read")
    q = np.clip(_read_radiance_hdr(path), 0.0, 1.0) * 255.0 + 0.5
    return np.floor(q).clip(0, 255).astype(np.uint8)
