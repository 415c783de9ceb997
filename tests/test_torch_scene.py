"""The port's scene compiler against the reference's: every SceneData field equal.

Tolerance: none. Both compilers run the same float64 host math and cast to float32
once, so every tensor must equal the reference's array exactly. The port's packed
cluster blocks are compared with the reference's relaid (from_reference_packing).
"""

import dataclasses
import pathlib
import shutil

import numpy as np
import pytest
import torch

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import tpupt.scenes as JSCENES_MODULE
from chip_smoke import write_stand_in_assets
from tpupt.scene import builder as JB
from tpupt.scenes import SCENES as JSCENES
from tpupt_torch.ops.tri_kernel import from_reference_packing
from tpupt_torch.scene import builder as TB
from tpupt_torch.scene import data as TD
from tpupt_torch.scene.convert import scene_data_from_numpy
from tpupt_torch.scenes import SCENES as TSCENES

DATA = pathlib.Path(__file__).resolve().parent / "torch_data"


def _assert_same(tsd, jsd):
    geo, attr = from_reference_packing(np.asarray(jsd.tri_pk), np.asarray(jsd.tri_pk2))
    for name in TD.tensor_fields():
        a = getattr(tsd, name)
        b = {"tri_geo": geo, "tri_attr": attr}.get(name)
        b = np.asarray(getattr(jsd, name)) if b is None else b
        assert a.device.type == "cpu"
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        if b.dtype == np.float32:
            assert a.dtype == torch.float32, name
    for name in TD.STATIC_FIELDS:
        assert getattr(tsd, name) == getattr(jsd, name), name


@pytest.fixture
def stand_in_assets(tmp_path, monkeypatch):
    """The committed JPEG and PNG fixtures, scene 6's stand-in meshes and a synthetic
    .hdr sky in a temp dir, which both packages read as their asset directory (the
    reference reads it at import)."""
    for name in ("earthmap.jpg", "envmap.jpg", "bricks/color.png", "bricks/normal.png"):
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(DATA / name, tmp_path / name)
    write_stand_in_assets(str(tmp_path))  # scene 6's OBJ stand-ins and the .hdr sky
    monkeypatch.setenv("TPUPT_ASSETS", str(tmp_path))
    monkeypatch.setattr(JSCENES_MODULE, "ASSETS", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("sid", [1, 2, 3, 4, 5, 6, 7])
def test_compile_matches_reference(sid, stand_in_assets):
    """Scenes 2, 5 and 7 read JPEG and PNG textures, which the reference decodes with
    PIL and the port with its own readers; scene 4 reads the .hdr sky; scene 6 reads
    the lumpy-sphere OBJ stand-ins of chip_smoke.py, and the reference compiles it on
    the CPU to its stackless BVH, which the port takes with bvh=True (the BVH nodes,
    the MXU rows and the cluster tables are compared with the rest)."""
    _, jbuild = JSCENES[sid]
    _, tbuild = TSCENES[sid]
    jc = jbuild(16, 4)[0].compile()
    tc = tbuild(16, 4)[0].compile(device="cpu", bvh=True if sid == 6 else None)
    if sid == 6:
        assert jc.data.has_tri_bvh and tc.data.n_tris > 16000 and tc.data.tri_ca.shape[0] == tc.data.n_tris
    assert tc.has_lights == jc.has_lights
    _assert_same(tc.data, jc.data)
    if sid in (2, 5, 7):
        assert tc.data.has_image_textures
    if sid == 7:
        assert tc.data.has_normal_maps


def _hand_scene(B, image):
    """Moving spheres, a checker, an image texture, an image env, a few triangles."""
    s = B.Scene()
    checker = B.CheckerTexture(0.5, B.SolidTexture((0.2, 0.3, 0.1)), B.SolidTexture((0.9, 0.9, 0.9)))
    s.add_quad((-5.0, 0.0, -5.0), (10.0, 0.0, 0.0), (0.0, 0.0, 10.0), B.Diffuse(checker))
    for i in range(5):
        c = (float(i) - 2.0, 0.3, 0.0)
        s.add_sphere(0.3, c, B.Diffuse((0.5, 0.4, 0.3)), center2=(c[0], 0.8, 0.0))
    s.add_sphere(0.5, (0.0, 1.0, 2.0), B.Metal((0.7, 0.6, 0.5), checker))
    s.add_sphere(0.5, (1.5, 1.0, 2.0), B.Glass.basic(1.5))
    tex = B.ImageTexture(image)
    s.add_cuboid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), B.Diffuse(tex),
                 transform=B.Transform((0.0, 1.0, 0.0), 0.4, (-2.0, 0.0, 3.0)))
    mesh = dict(
        positions=np.array([[0, 0, 4], [1, 0, 4], [0, 1, 4], [1, 1, 4.5]], dtype=np.float64),
        normals=None,
        uvs=np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.float64),
        indices=np.array([[0, 1, 2], [1, 3, 2]]),
    )
    s.add_mesh(mesh, B.Principled((0.6, 0.2, 0.2), metallic=0.3, roughness=0.4))
    s.add_quad((-1.0, 4.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), B.Light((5.0, 5.0, 5.0)), light=True)
    s.add_sphere(0.2, (2.0, 3.0, 0.0), B.Light((3.0, 2.0, 1.0)), light=True)
    s.environment = B.ImageTexture(image)
    return s


def _image(tmp_path):
    from PIL import Image

    img = np.random.default_rng(5).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    path = str(tmp_path / "tex.png")
    Image.fromarray(img, mode="RGB").save(path)
    return img, path


def test_compile_hand_scene_matches_reference(tmp_path):
    img, path = _image(tmp_path)
    jc = _hand_scene(JB, path).compile(bvh=False)
    tc = _hand_scene(TB, img).compile(device="cpu")
    assert tc.has_lights == jc.has_lights
    _assert_same(tc.data, jc.data)
    assert tc.data.has_checker and tc.data.has_image_textures and tc.data.env_map_w == 10
    assert tc.data.n_tris == 8 and tc.data.n_lights_real == 2


def test_scene_data_from_numpy(tmp_path):
    img, path = _image(tmp_path)
    jsd = _hand_scene(JB, path).compile(bvh=False).data
    fields = {f.name: np.asarray(getattr(jsd, f.name)) for f in dataclasses.fields(jsd)}
    static = {n: getattr(jsd, n) for n in ("use_pallas_hit", "has_tri_bvh", *TD.STATIC_FIELDS)}
    tsd = scene_data_from_numpy(fields, static, device="cpu")
    _assert_same(tsd, jsd)
    # the BVH and matmul-sweep flags are ported: a reference SceneData with either converts
    for flag in ("has_tri_bvh", "has_tri_mxu"):
        assert getattr(scene_data_from_numpy(fields, dict(static, **{flag: True}), device="cpu"), flag)
    with pytest.raises(KeyError):
        scene_data_from_numpy({"sph_r": fields["sph_r"]}, static, device="cpu")


def test_unported_inputs_raise(tmp_path, monkeypatch):
    s = TB.Scene()
    s.environment = TB.ImageTexture(np.zeros((2, 2, 3), np.uint8), hdr=True)
    assert s.compile(device="cpu").data.env_is_hdr  # the HDR environment is ported
    s.add_sphere(1.0, (0, 0, 0), TB.Diffuse(TB.ImageTexture(np.zeros((2, 2, 3), np.uint8), hdr=True)))
    with pytest.raises(NotImplementedError, match="hdr=True"):  # only as the environment
        s.compile(device="cpu")

    s = TB.Scene()
    s.add_sphere(1.0, (0, 0, 0), TB.Diffuse(TB.ImageTexture(str(tmp_path / "earthmap.jpg"))))
    with pytest.raises(FileNotFoundError):
        s.compile(device="cpu")

    rng = np.random.default_rng(0)
    s = TB.Scene()
    mesh = dict(positions=rng.normal(size=(200, 3)), normals=None, uvs=None,
                indices=rng.integers(0, 200, (64, 3)))
    s.add_mesh(mesh, TB.Diffuse((0.5, 0.5, 0.5)))
    sd = s.compile(device="cpu").data  # 64 triangles: the cluster route
    assert sd.has_tri_clusters and sd.tri_geo.shape == (64, 10, 64)
    sd = s.compile(device="cpu", bvh=True).data  # the stackless BVH, cluster tables kept
    assert sd.has_tri_bvh and not sd.has_tri_clusters and sd.tri_geo.shape == (64, 10, 64)
    assert int(sd.bvh_skip[0]) == sd.bvh_skip.shape[0] > 1

    monkeypatch.setenv("TPUPT_ASSETS", str(tmp_path))
    scene, _ = TSCENES[2][1](16, 4)
    with pytest.raises(FileNotFoundError, match="earthmap.jpg"):
        scene.compile(device="cpu")
    with pytest.raises(FileNotFoundError, match="bunny.obj"):
        TSCENES[6][1](16, 4)


def test_default_device_is_cuda():
    s, _ = TSCENES[3][1](16, 4)
    if torch.cuda.is_available():
        assert s.compile().data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            s.compile()
