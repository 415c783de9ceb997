"""The port's PNG and JPEG readers against PIL, which the reference decodes with.

Tolerance: none. Every accepted input decodes to PIL's ``.convert("RGB")`` bytes:
PNG at every colour type and bit depth the reader takes and under each of the five
row filters; JPEG grey, 4:4:4, 4:2:2 and 4:2:0 at qualities 50, 75 and 95, at sizes
that are not whole blocks or MCUs, and with restart markers (the reader runs
libjpeg's ISLOW IDCT, fancy upsampling and integer colour conversion). Inputs it
does not read (arithmetic-coded or 12-bit JPEG, CMYK, PNG colour types and bit
depths the PNG specification does not define) raise ValueError naming the file.
Progressive JPEG, 16-bit and Adam7 PNG: tests/test_torch_image_formats.py.
"""

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import os
import pathlib
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from tools.make_torch_image_fixtures import filter_row, png_chunk
from tpupt_torch.io.image import load_image_f32, load_image_rgb8
from tpupt_torch.io.jpeg import read_jpeg_rgb8
from tpupt_torch.io.png import read_png_rgb8

DATA = pathlib.Path(__file__).resolve().parent / "torch_data"
FIXTURES = ["earthmap.jpg", "envmap.jpg", "bricks/color.png", "bricks/normal.png"]


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


# ---- PNG ----


def write_png(path, rows, w, depth, ctype, palette=None, interlace=0):
    """A PNG of packed rows uint8 [h, stride], row y under filter y % 5, in two IDATs."""
    h, stride = rows.shape
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, channels * depth // 8)
    raw, prev = bytearray(), bytes(stride)
    for y in range(h):
        cur = rows[y].tobytes()
        raw += bytes([y % 5]) + filter_row(y % 5, cur, prev, bpp)
        prev = cur
    z = zlib.compress(bytes(raw))
    body = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += png_chunk(b"PLTE", palette.tobytes())
    body += png_chunk(b"IDAT", z[: len(z) // 2]) + png_chunk(b"IDAT", z[len(z) // 2 :])
    pathlib.Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + body + png_chunk(b"IEND", b""))


PNG_KINDS = [  # (colour type, bit depth)
    (0, 1), (0, 2), (0, 4), (0, 8), (4, 8), (2, 8), (6, 8), (3, 1), (3, 2), (3, 4), (3, 8),
]


@pytest.mark.parametrize("w,h", [(13, 11), (32, 10)])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_every_filter_matches_pil(tmp_path, ctype, depth, w, h):
    rng = np.random.default_rng(ctype * 16 + depth + w)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    # smooth rows, so each filter predicts something, with noise
    base = (np.arange(w * channels)[None, :] * 3 + np.arange(h)[:, None] * 5) % 256
    samples = ((base + rng.integers(0, 40, base.shape)) % 256).astype(np.uint8)
    palette = None
    if depth < 8:
        samples >>= 8 - depth
        bits = np.unpackbits(samples[..., None], axis=-1)[..., 8 - depth :].reshape(h, -1)
        pad = (-bits.shape[1]) % 8
        rows = np.packbits(np.pad(bits, ((0, 0), (0, pad))), axis=1)
    else:
        rows = samples
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
    path = tmp_path / "f.png"
    write_png(path, rows, w, depth, ctype, palette)
    got = read_png_rgb8(str(path))
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil(path))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "1", "P"])
def test_png_written_by_pil(tmp_path, mode):
    """Files as PIL writes them (its own filter choice per row, a palette of 256)."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (21, 35, 4), dtype=np.uint8)
    img = Image.fromarray(src, "RGBA") if mode in ("RGBA", "LA") else Image.fromarray(src[..., :3], "RGB")
    img = img.convert(mode)
    path = tmp_path / "p.png"
    img.save(path, optimize=True)
    np.testing.assert_array_equal(read_png_rgb8(str(path)), _pil(path))


def test_png_rejected_inputs(tmp_path):
    path = tmp_path / "deep.png"  # a 16-bit palette is not a PNG colour type
    write_png(path, np.zeros((4, 16), np.uint8), 8, 16, 3, palette=np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match=r"deep\.png.*colour type 3 at 16 bits"):
        read_png_rgb8(str(path))
    path = tmp_path / "adam7.png"  # interlace method 2 is not defined (1 is Adam7)
    write_png(path, np.zeros((4, 12), np.uint8), 4, 8, 2, interlace=2)
    with pytest.raises(ValueError, match=r"adam7\.png.*interlace method 2"):
        read_png_rgb8(str(path))
    path = tmp_path / "short.png"
    write_png(path, np.full((4, 8), 5, np.uint8), 8, 8, 3, palette=np.zeros((2, 3), np.uint8))
    with pytest.raises(ValueError, match=r"short\.png.*palette index"):
        read_png_rgb8(str(path))


# ---- JPEG ----


def _smooth(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([127 + 100 * np.sin(x / (7 + c) + y / (11 + 2 * c) + rng.uniform(0, 6))
                    for c in range(channels)], axis=-1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("kind", ["grey", "444", "422", "420"])
def test_jpeg_matches_pil(tmp_path, kind, quality):
    """Bit for bit, 4:2:2 and 4:2:0 included: at whole MCUs, at odd sizes and at a
    chroma width of 2 columns (where libjpeg replicates instead of interpolating)."""
    for h, w in [(64, 128), (17, 23), (33, 65), (9, 3), (1, 1)]:
        img = _smooth(h, w, h * w + quality)
        path = tmp_path / f"{kind}_{h}x{w}.jpg"
        if kind == "grey":
            Image.fromarray(img[..., 0], "L").save(path, quality=quality)
        else:
            sub = {"444": 0, "422": 1, "420": 2}[kind]
            Image.fromarray(img, "RGB").save(path, quality=quality, subsampling=sub)
        got = read_jpeg_rgb8(str(path))
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pil(path), err_msg=f"{kind} {h}x{w} q{quality}")


@pytest.mark.parametrize("kind", ["grey", "444", "420"])
def test_jpeg_restart_markers(tmp_path, kind):
    img = _smooth(40, 72, 9)
    path = tmp_path / "rst.jpg"
    im = Image.fromarray(img[..., 0], "L") if kind == "grey" else Image.fromarray(img, "RGB")
    kw = {} if kind == "grey" else {"subsampling": {"444": 0, "420": 2}[kind]}
    im.save(path, quality=80, restart_marker_blocks=3, **kw)
    assert b"\xff\xdd" in path.read_bytes() and b"\xff\xd1" in path.read_bytes()
    np.testing.assert_array_equal(read_jpeg_rgb8(str(path)), _pil(path))


def test_jpeg_rejected_inputs(tmp_path):
    img = _smooth(16, 16, 1)
    path = tmp_path / "prog.jpg"  # arithmetic-coded progressive (SOF2 -> SOF10)
    Image.fromarray(img, "RGB").save(path, progressive=True)
    path.write_bytes(path.read_bytes().replace(b"\xff\xc2", b"\xff\xca", 1))
    with pytest.raises(ValueError, match=r"prog\.jpg.*arithmetic-coded progressive"):
        read_jpeg_rgb8(str(path))
    path = tmp_path / "deep.jpg"  # 12-bit samples (SOF1, precision 12)
    Image.fromarray(img, "RGB").save(path)
    data = path.read_bytes()
    sof = data.index(b"\xff\xc0")
    path.write_bytes(data[:sof] + b"\xff\xc1" + data[sof + 2 : sof + 4] + b"\x0c" + data[sof + 5 :])
    with pytest.raises(ValueError, match=r"deep\.jpg.*12-bit"):
        read_jpeg_rgb8(str(path))
    path = tmp_path / "cmyk.jpg"
    Image.fromarray(np.concatenate([img, img[..., :1]], axis=-1), "CMYK").save(path)
    with pytest.raises(ValueError, match=r"cmyk\.jpg.*CMYK"):
        read_jpeg_rgb8(str(path))
    path = tmp_path / "arith.jpg"
    Image.fromarray(img, "RGB").save(path)
    data = path.read_bytes()
    path.write_bytes(data.replace(b"\xff\xc0", b"\xff\xc9", 1))  # SOF0 -> SOF9
    with pytest.raises(ValueError, match=r"arith\.jpg.*arithmetic"):
        read_jpeg_rgb8(str(path))
    path.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match=r"arith\.jpg"):
        read_jpeg_rgb8(str(path))


# ---- the loaders and the committed fixtures ----


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixtures_decode_to_their_npy(name):
    path = str(DATA / name)
    want = np.load(os.path.splitext(path)[0] + ".npy")
    np.testing.assert_array_equal(load_image_rgb8(path), want)
    np.testing.assert_array_equal(load_image_f32(path), want.astype(np.float32) / 255.0)


def test_loaders_pick_the_decoder_by_content(tmp_path):
    img = _smooth(8, 12, 4)
    as_jpg = tmp_path / "actually_a_png.jpg"
    Image.fromarray(img, "RGB").save(as_jpg, format="PNG")
    np.testing.assert_array_equal(load_image_rgb8(str(as_jpg)), img)
    as_png = tmp_path / "actually_a_jpeg.png"
    Image.fromarray(img, "RGB").save(as_png, format="JPEG")
    np.testing.assert_array_equal(load_image_rgb8(str(as_png)), _pil(as_png))
    other = tmp_path / "x.bmp"
    Image.fromarray(img, "RGB").save(other)
    with pytest.raises(ValueError, match=r"x\.bmp"):
        load_image_rgb8(str(other))
