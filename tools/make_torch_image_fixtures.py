"""Write the port's image fixtures into tests/torch_data/ (needs PIL; run where it is).

    python tools/make_torch_image_fixtures.py

Stand-ins for the texture files of scenes 2, 5 and 7, made from seeded numpy arrays
and written by PIL, a few KB each, and beside each PIL's own decode of it as uint8
[H,W,3] (`<name>.npy`):

- earthmap.jpg: 128x64, 4:2:0, quality 90 (scene 2's sphere texture);
- envmap.jpg: 128x64, 4:4:4, quality 90 (scene 5's environment);
- bricks/color.png, bricks/normal.png: RGB, 32x32 (scene 7's albedo and normal map).

Then their twins in the encodings the reference reads through PIL and the port
reads with its own decoders, each of which decodes to the stand-in's .npy (the tool
checks that with PIL before it writes anything):

- earthmap_progressive.jpg, envmap_progressive.jpg: the same pixels saved progressive
  at the same quality and subsampling (PIL quantizes both encodings to the same
  coefficients); earthmap_progressive_rst.jpg also with a restart marker every MCU
  row, so that end-of-band runs meet restarts;
- bricks/color16.png: 16-bit RGB whose high bytes are color.png's samples (seeded low
  bytes); bricks/normal_adam7.png: normal.png's pixels Adam7-interlaced. PIL writes
  neither, so write_png below does (every row filter in turn).

And a progressive stand-in at a texture's real size, earthmap_1024_progressive.jpg
(1024x512, 4:2:0, quality 90), with the sha256 of PIL's decode of it ([H,W,3] uint8
bytes) in earthmap_1024_progressive.json instead of a .npy, to keep the repo small.

The tests and chip_smoke.py hold the port's decoders (tpupt_torch/io/jpeg.py, png.py)
against the .npy files and the hash; the machine with the card has no PIL to write them.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "torch_data")


def _smooth_rgb(h, w, seed):
    """Smooth colour bands with a little noise: JPEG-like content of a few KB."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([
        127 + 100 * np.sin(x / (6 + 3 * c) + y / (9 + 2 * c) + rng.uniform(0, 6)) for c in range(3)
    ], axis=-1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _bricks(seed):
    """32x32 bricks: (albedo, normal map) with mortar lines and a tilted normal per brick."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:32, 0:32]
    row = y // 8
    mortar = (y % 8 == 0) | ((x + 8 * (row % 2)) % 16 == 0)
    brick = rng.integers(150, 200, (4, 3, 3))[row, ((x + 8 * (row % 2)) // 16) % 3]
    albedo = np.where(mortar[..., None], 200, brick * [1.0, 0.45, 0.35]).astype(np.uint8)
    n = np.stack([np.sin((x % 16) / 16 * np.pi) * 0.4, np.cos((y % 8) / 8 * np.pi) * 0.3,
                  np.ones_like(x, dtype=np.float64)], axis=-1)
    n = np.where(mortar[..., None], [0.0, 0.0, 1.0], n)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal = np.clip((n * 0.5 + 0.5) * 255 + rng.normal(0, 2, n.shape), 0, 255).astype(np.uint8)
    return albedo, normal


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def _save(rel, img, **kw):
    path = os.path.join(OUT, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img, mode="RGB").save(path, **kw)
    np.save(os.path.splitext(path)[0] + ".npy", _pil(path))
    print(f"{path}: {img.shape[1]}x{img.shape[0]}, {os.path.getsize(path)} B")


# ---- a PNG writer for what PIL does not write: 16-bit samples, Adam7 ----

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def filter_row(ftype, cur, prev, bpp):
    """PNG filter `ftype` applied to one row of bytes (the encoder's side)."""
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def png_chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _pack_rows(samples, depth):
    """Samples [h, w, channels] (values below 2^depth) -> the rows' bytes uint8 [h, stride]."""
    h, w, c = samples.shape
    if depth == 16:
        s = samples.astype(">u2")
        return s.view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = np.unpackbits(samples.astype(np.uint8).reshape(h, w * c, 1), axis=2)[..., 8 - depth :]
    bits = bits.reshape(h, w * c * depth)
    return np.packbits(np.pad(bits, ((0, 0), (0, -bits.shape[1] % 8))), axis=1)


def write_png(path, samples, depth, ctype, palette=None, interlace=0):
    """A PNG of samples [h, w, channels] at `depth` bits, colour type `ctype`, plain or
    Adam7 (interlace=1); each pass's row y under filter y % 5, the data in two IDATs."""
    h, w, c = samples.shape
    assert c == CHANNELS[ctype]
    bpp = max(1, c * depth // 8)
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:  # an empty pass has no rows, not even their filter bytes
            continue
        rows = _pack_rows(sub, depth)
        prev = bytes(rows.shape[1])
        for y in range(rows.shape[0]):
            cur = rows[y].tobytes()
            raw += bytes([y % 5]) + filter_row(y % 5, cur, prev, bpp)
            prev = cur
    z = zlib.compress(bytes(raw))
    body = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    body += png_chunk(b"IDAT", z[: len(z) // 2]) + png_chunk(b"IDAT", z[len(z) // 2 :])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + png_chunk(b"IEND", b""))


def _twin(rel, of, write):
    """Write a twin with write(path), and check that PIL decodes it to the .npy of `of`."""
    path = os.path.join(OUT, rel)
    write(path)
    want = np.load(os.path.splitext(os.path.join(OUT, of))[0] + ".npy")
    got = _pil(path)
    if got.shape != want.shape or (got != want).any():
        raise SystemExit(f"{path}: PIL's decode differs from {of}'s")
    print(f"{path}: twin of {of}, {os.path.getsize(path)} B")


def main():
    earth, env = _smooth_rgb(64, 128, 2), _smooth_rgb(64, 128, 5)
    _save("earthmap.jpg", earth, quality=90, subsampling=2)
    _save("envmap.jpg", env, quality=90, subsampling=0)
    albedo, normal = _bricks(7)
    _save("bricks/color.png", albedo)
    _save("bricks/normal.png", normal)

    def jpeg(img, **kw):  # -> a writer of img as a progressive JPEG at quality 90
        return lambda p: Image.fromarray(img, "RGB").save(p, quality=90, progressive=True, **kw)

    _twin("earthmap_progressive.jpg", "earthmap.jpg", jpeg(earth, subsampling=2))
    _twin("earthmap_progressive_rst.jpg", "earthmap.jpg", jpeg(earth, subsampling=2, restart_marker_rows=1))
    _twin("envmap_progressive.jpg", "envmap.jpg", jpeg(env, subsampling=0))
    low = np.random.default_rng(16).integers(0, 256, albedo.shape)
    color = np.load(os.path.join(OUT, "bricks", "color.npy")).astype(np.uint16)
    _twin("bricks/color16.png", "bricks/color.png", lambda p: write_png(p, (color << 8) | low, 16, 2))
    normal_px = np.load(os.path.join(OUT, "bricks", "normal.npy"))
    _twin("bricks/normal_adam7.png", "bricks/normal.png", lambda p: write_png(p, normal_px, 8, 2, interlace=1))

    path = os.path.join(OUT, "earthmap_1024_progressive.jpg")
    Image.fromarray(_smooth_rgb(512, 1024, 11), "RGB").save(path, quality=90, subsampling=2, progressive=True)
    decoded = _pil(path)
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump({"shape": list(decoded.shape), "sha256": hashlib.sha256(decoded.tobytes()).hexdigest()}, f)
        f.write("\n")
    print(f"{path}: 1024x512, {os.path.getsize(path)} B, PIL's decode hashed")


if __name__ == "__main__":
    main()
