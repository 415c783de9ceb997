"""Time the port's JPEG reader on a large 4:2:0 file, checked against PIL (needs PIL).

    python tools/torch_jpeg_decode_time.py [--width 2048] [--height 1024] [--reps 3]

Writes a seeded, smooth-plus-noise image as a quality-90 4:2:0 JPEG with PIL into a
temporary directory, decodes it with tpupt_torch.io.jpeg.read_jpeg_rgb8 `reps` times
and prints the file size, each decode's wall time on this host and whether the result
equals PIL's decode bit for bit.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpupt_torch.io.jpeg import read_jpeg_rgb8  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0 : args.height, 0 : args.width].astype(np.float64)
    img = np.stack([127 + 100 * np.sin(x / (7 + c) + y / (11 + 2 * c) + rng.uniform(0, 6)) for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "big.jpg")
        Image.fromarray(img, "RGB").save(path, quality=90, subsampling=2)
        want = np.asarray(Image.open(path).convert("RGB"))
        for rep in range(args.reps):
            t0 = time.perf_counter()
            got = read_jpeg_rgb8(path)
            dt = time.perf_counter() - t0
            print(f"{args.width}x{args.height} 4:2:0 JPEG, {os.path.getsize(path)} B: decode {rep + 1}/{args.reps} "
                  f"{dt:.3f} s, equal to PIL's decode: {np.array_equal(got, want)}")


if __name__ == "__main__":
    main()
