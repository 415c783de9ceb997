"""The encodings the reference reads through PIL beside baseline JPEG and plain PNG:
progressive JPEG, 16-bit and Adam7-interlaced PNG, against PIL's decode.

Tolerance: none. Every file decodes to PIL's ``.convert("RGB")`` bytes, or raises
ValueError naming the file where this reader refuses what PIL reads (a progression
whose scans leave low-frequency coefficients unrefined, which libjpeg smooths):

- progressive JPEG (PIL ``progressive=True``) grey, 4:4:4, 4:2:2 and 4:2:0 at qualities
  50, 75 and 95, at sizes that are not whole blocks, with and without restart markers;
  a DQT between scans (a component keeps the table of its first scan); the scans of a
  file cut after each one in turn (PIL then smooths, and this reader raises);
- PNG at every colour type and bit depth the specification defines, plain and Adam7
  (passes empty at 1x1 and 2x3), written by tools/make_torch_image_fixtures.py's
  write_png, since PIL writes neither 16-bit colour nor Adam7;
- the committed twins of the scene stand-ins decode to the stand-ins' .npy (and the
  1024x512 progressive stand-in to the sha256 of PIL's decode), and scenes 2, 5 and 7
  compile from the twins to the reference's SceneData, field for field.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
from PIL import Image

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import tpupt.scenes as JSCENES_MODULE
from chip_smoke import BIG_PROGRESSIVE, TWINS, write_stand_in_assets, write_twin_assets
from test_torch_image import _smooth
from test_torch_scene import _assert_same
from tools.make_torch_image_fixtures import CHANNELS, write_png
from tpupt.scenes import SCENES as JSCENES
from tpupt_torch.io.image import load_image_rgb8
from tpupt_torch.io.jpeg import read_jpeg_rgb8
from tpupt_torch.io.png import read_png_rgb8
from tpupt_torch.scenes import SCENES as TSCENES

DATA = pathlib.Path(__file__).resolve().parent / "torch_data"


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def _equal_or_refused(path):
    """-> True when the port decodes `path` to PIL's bytes, False when it raises
    ValueError naming the file; any other outcome fails."""
    try:
        got = read_jpeg_rgb8(str(path))
    except ValueError as e:
        assert path.name in str(e)
        return False
    np.testing.assert_array_equal(got, _pil(path))
    return True


# ---- progressive JPEG ----


def _save_progressive(path, img, kind, quality, **kw):
    if kind == "grey":
        Image.fromarray(img[..., 0], "L").save(path, quality=quality, progressive=True, **kw)
    else:
        sub = {"444": 0, "422": 1, "420": 2}[kind]
        Image.fromarray(img, "RGB").save(path, quality=quality, subsampling=sub, progressive=True, **kw)


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("kind", ["grey", "444", "422", "420"])
def test_progressive_jpeg_matches_pil(tmp_path, kind, quality, restart):
    """Interleaved DC scans, non-interleaved AC bands over each component's own blocks,
    successive approximation of DC and AC, end-of-band runs (and, with restarts, a
    restart marker every MCU row, where predictors and runs start afresh)."""
    for h, w in [(11, 13), (9, 17), (33, 65), (64, 128), (1, 1)]:
        path = tmp_path / f"{kind}_{h}x{w}.jpg"
        _save_progressive(path, _smooth(h, w, h * w + quality), kind, quality,
                          **({"restart_marker_rows": 1} if restart else {}))
        data = path.read_bytes()
        assert b"\xff\xc2" in data and data.count(b"\xff\xda") > 1
        if restart and h > 16:
            assert b"\xff\xdd" in data and b"\xff\xd0" in data
        got = read_jpeg_rgb8(str(path))
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pil(path), err_msg=f"{kind} {h}x{w} q{quality}")


def _segments(data):
    """A JPEG's marker segments up to EOI -> [(start, end)], a scan's entropy-coded data
    counted into its SOS segment."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        start = pos
        pos += 2 + int.from_bytes(data[pos + 2 : pos + 4], "big")
        if data[start + 1] == 0xDA:  # to the next marker that is not RSTn or a stuffed 0xFF
            while not (data[pos] == 0xFF and data[pos + 1] not in (0x00, *range(0xD0, 0xD8))):
                pos += 1
        out.append((start, pos))
    return out


def test_progressive_jpeg_dqt_between_scans(tmp_path):
    """A DQT that redefines every table before the third scan changes nothing: each
    component latched its table at its first scan (jdinput.c latch_quant_tables)."""
    path = tmp_path / "dqt.jpg"
    _save_progressive(path, _smooth(40, 56, 3), "420", 75)
    data = path.read_bytes()
    sos = [s for s, _ in _segments(data) if data[s + 1] == 0xDA]
    dqt = b"\xff\xdb\x00\x84" + b"".join(bytes([t]) + bytes(range(1, 65)) for t in (0, 1))
    moved = tmp_path / "dqt_between_scans.jpg"
    moved.write_bytes(data[: sos[2]] + dqt + data[sos[2] :])
    want = _pil(path)
    np.testing.assert_array_equal(_pil(moved), want)
    np.testing.assert_array_equal(read_jpeg_rgb8(str(moved)), want)


@pytest.mark.parametrize("kind", ["grey", "420"])
def test_progressive_jpeg_cut_after_each_scan(tmp_path, kind):
    """The file ended (EOI) after each scan in turn: libjpeg smooths the blocks of a
    progression whose first nine AC coefficients are not all refined, which every cut
    of PIL's scan script leaves, so this reader raises there; the whole file decodes."""
    path = tmp_path / "full.jpg"
    _save_progressive(path, _smooth(24, 40, 5), kind, 75)
    data = path.read_bytes()
    segs = _segments(data)
    scans = [e for s, e in segs if data[s + 1] == 0xDA]
    assert len(scans) >= 6
    outcomes = []
    for k, end in enumerate(scans, 1):
        cut = tmp_path / f"cut{k}.jpg"
        cut.write_bytes(data[:end] + b"\xff\xd9")
        outcomes.append(_equal_or_refused(cut))
    assert outcomes == [False] * (len(scans) - 1) + [True]


# ---- PNG: 16-bit samples, Adam7 ----

PNG_KINDS = [  # every (colour type, bit depth) the PNG specification defines
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
    (4, 8), (4, 16), (6, 8), (6, 16),
]


@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_plain_and_adam7_match_pil(tmp_path, ctype, depth):
    """Plain and Adam7 at 1x1 and 2x3 (where passes are empty), 13x11 and 32x10; grey
    16-bit samples both below and above 255."""
    for interlace in (0, 1):
        for h, w in [(1, 1), (2, 3), (13, 11), (32, 10)]:
            rng = np.random.default_rng(ctype * 100 + depth * 10 + interlace + w)
            samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
            if depth == 16:  # small samples too, where grey's clip at 255 does not bite
                samples[::2, ::2] %= 300
            palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8) if ctype == 3 else None
            path = tmp_path / f"p{interlace}_{h}x{w}.png"
            write_png(path, samples, depth, ctype, palette, interlace=interlace)
            got = read_png_rgb8(str(path))
            assert got.shape == (h, w, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, _pil(path), err_msg=f"interlace {interlace} {h}x{w}")


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_png_16_bit_samples(tmp_path, ctype):
    """PIL's two rules for 16 bits: 16-bit grey opens as mode I;16 and clips at 255;
    grey+alpha, RGB and RGBA give each sample's high byte."""
    values = np.array([7, 4007, 55746, 47808, 255, 256], np.uint16)
    samples = np.repeat(values[None, :, None], CHANNELS[ctype], axis=2)
    path = tmp_path / "deep.png"
    write_png(path, samples, 16, ctype)
    want = np.minimum(values, 255) if ctype == 0 else values >> 8  # 47808 -> 186 by the high byte
    np.testing.assert_array_equal(read_png_rgb8(str(path))[0], np.repeat(want[:, None], 3, axis=1))
    np.testing.assert_array_equal(read_png_rgb8(str(path)), _pil(path))


# ---- the committed twins ----


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twins_decode_to_the_stand_ins(name):
    path = DATA / name
    want = np.load((DATA / TWINS[name]).with_suffix(".npy"))
    np.testing.assert_array_equal(load_image_rgb8(str(path)), want)
    np.testing.assert_array_equal(_pil(path), want)


def test_realistic_progressive_stand_in_decodes_to_pils_hash():
    path = DATA / BIG_PROGRESSIVE
    ref = json.loads(path.with_suffix(".json").read_text())
    got = load_image_rgb8(str(path))
    assert list(got.shape) == ref["shape"] == [512, 1024, 3]
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["sha256"]
    assert hashlib.sha256(_pil(path).tobytes()).hexdigest() == ref["sha256"]


@pytest.fixture
def twin_assets(tmp_path, monkeypatch):
    """The twins under the names the scenes read, beside scene 6's stand-ins and the .hdr
    sky, as the asset directory of both packages."""
    write_twin_assets(str(tmp_path))
    write_stand_in_assets(str(tmp_path))
    monkeypatch.setenv("TPUPT_ASSETS", str(tmp_path))
    monkeypatch.setattr(JSCENES_MODULE, "ASSETS", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("sid", [2, 5, 7])
def test_compile_from_twins_matches_reference(sid, twin_assets):
    """Progressive earthmap.jpg and envmap.jpg, a 16-bit color.png and an Adam7
    normal.png: the reference decodes them with PIL, the port with its own readers."""
    jc = JSCENES[sid][1](16, 4)[0].compile()
    tc = TSCENES[sid][1](16, 4)[0].compile(device="cpu")
    assert tc.has_lights == jc.has_lights and tc.data.has_image_textures
    _assert_same(tc.data, jc.data)
