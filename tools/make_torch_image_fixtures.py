"""Write the port's image fixtures into tests/torch_data/ (needs PIL; run where it is).

    python tools/make_torch_image_fixtures.py

Stand-ins for the texture files of scenes 2, 5 and 7, made from seeded numpy arrays
and written by PIL, a few KB each, and beside each PIL's own decode of it as uint8
[H,W,3] (`<name>.npy`):

- earthmap.jpg: 128x64, 4:2:0, quality 90 (scene 2's sphere texture);
- envmap.jpg: 128x64, 4:4:4, quality 90 (scene 5's environment);
- bricks/color.png, bricks/normal.png: RGB, 32x32 (scene 7's albedo and normal map).

The tests and chip_smoke.py hold the port's decoders (tpupt_torch/io/jpeg.py, png.py)
against the .npy files; the machine with the card has no PIL to write them.
"""

from __future__ import annotations

import os

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


def _save(rel, img, **kw):
    path = os.path.join(OUT, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img, mode="RGB").save(path, **kw)
    decoded = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    np.save(os.path.splitext(path)[0] + ".npy", decoded)
    print(f"{path}: {img.shape[1]}x{img.shape[0]}, {os.path.getsize(path)} B")


def main():
    _save("earthmap.jpg", _smooth_rgb(64, 128, 2), quality=90, subsampling=2)
    _save("envmap.jpg", _smooth_rgb(64, 128, 5), quality=90, subsampling=0)
    albedo, normal = _bricks(7)
    _save("bricks/color.png", albedo)
    _save("bricks/normal.png", normal)


if __name__ == "__main__":
    main()
