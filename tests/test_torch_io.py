"""The port's OBJ and image readers against the reference package's.

Synthetic files made from a seed stand in for the assets. Tolerance: none; the
readers must return the same arrays, bit for bit.
"""

import numpy as np
import pytest

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
from tpupt.io import image as JI
from tpupt.io.obj import load_obj as j_load_obj
from tpupt.io.obj import subdivide_mesh as j_subdivide
from tpupt_torch import native
from tpupt_torch.io import image as TI
from tpupt_torch.io.obj import load_obj as t_load_obj
from tpupt_torch.io.obj import subdivide_mesh as t_subdivide


def _obj_text(rng, with_vt, with_vn):
    """Quads and triangles, positive and negative indices, mixed v/vt/vn forms."""
    nv = 40
    lines = ["# synthetic", "o thing"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in rng.normal(size=(nv, 3))]
    if with_vt:
        lines += [f"vt {u:.5f} {v:.5f}" for u, v in rng.uniform(size=(nv, 2))]
    if with_vn:
        lines += [f"vn {x:.5f} {y:.5f} {z:.5f}" for x, y, z in rng.normal(size=(nv, 3))]
    for k in range(60):
        n = 4 if k % 3 == 0 else 3
        ids = rng.choice(nv, size=n, replace=False) + 1
        toks = []
        for j, i in enumerate(ids):
            i = int(i) if (k + j) % 4 else int(i) - nv - 1  # some negative (relative) indices
            if with_vt and with_vn:
                toks.append(f"{i}/{i}/{i}")
            elif with_vn:
                toks.append(f"{i}//{i}")
            elif with_vt:
                toks.append(f"{i}/{i}")
            else:
                toks.append(f"{i}")
        lines.append("f " + " ".join(toks))
    return "\n".join(lines) + "\n"


def _assert_same_mesh(a, b):
    for key in ("positions", "indices", "normals", "uvs"):
        if b[key] is None:
            assert a[key] is None, key
        else:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("with_vt,with_vn", [(False, False), (True, False), (False, True), (True, True)])
def test_load_obj_matches_reference(tmp_path, with_vt, with_vn):
    rng = np.random.default_rng(3 + 2 * with_vt + with_vn)
    path = tmp_path / "mesh.obj"
    path.write_text(_obj_text(rng, with_vt, with_vn))
    ref = j_load_obj(str(path), native=False)
    assert ref["indices"].shape == (80, 3)  # 40 quads fanned into 2 triangles + 20 triangles
    _assert_same_mesh(t_load_obj(str(path), native=False), ref)
    assert native.available(), native.builder()
    _assert_same_mesh(t_load_obj(str(path), native=True), ref)


def test_load_obj_missing_file(tmp_path):
    for nat in (True, False):
        with pytest.raises(FileNotFoundError):
            t_load_obj(str(tmp_path / "absent.obj"), native=nat)


def test_subdivide_mesh_matches_reference(tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text(_obj_text(np.random.default_rng(9), True, True))
    mesh = t_load_obj(str(path), native=False)
    got = t_subdivide(mesh, 2)
    _assert_same_mesh(got, j_subdivide(mesh, 2))
    assert got["indices"].shape[0] == 16 * mesh["indices"].shape[0]


def _write_hdr(path, rgbe, rle_rows):
    """Radiance file of rgbe [H,W,4] u8; rows in rle_rows use new-style RLE, others flat."""
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        if y not in rle_rows:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            plane, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and plane[x + run] == plane[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, plane[x]])
                    x += run
                else:
                    n = min(w - x, 8)
                    out += bytes([n]) + plane[x : x + n].tobytes()
                    x += n
    path.write_bytes(bytes(out))


def test_hdr_reader_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    h, w = 7, 40
    rgbe = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 136, (h, w))
    rgbe[2, 5:20] = rgbe[2, 5]  # runs for the RLE encoder
    rgbe[4, :, 3] = 0  # zero exponent: black
    path = tmp_path / "env.hdr"
    _write_hdr(path, rgbe, rle_rows={0, 2, 3, 6})
    ref = JI._read_radiance_hdr(str(path))
    got = TI._read_radiance_hdr(str(path))
    assert got.shape == (h, w, 3) and got.dtype == np.float32 and (got[4] == 0).all()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TI.load_image_rgb8(str(path)), JI.load_image_rgb8(str(path)))
    np.testing.assert_array_equal(TI.load_image_f32(str(path)), JI.load_image_f32(str(path)))


def test_png_reader_and_missing_image(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (5, 9, 3), dtype=np.uint8)
    path = str(tmp_path / "tex.png")
    TI.save_png(path, img)
    np.testing.assert_array_equal(TI.load_image_rgb8(path), img)
    np.testing.assert_array_equal(TI.load_image_rgb8(path), JI.load_image_rgb8(path))
    with pytest.raises(FileNotFoundError):
        TI.load_image_rgb8(str(tmp_path / "absent.hdr"))
