"""Normal-mapped surfaces on the port against the reference (has_normal_maps), CPU.

A floor and a sphere take their shading normals from a 32x16 map made in memory
(the port gets the array, the reference the same map as a PNG file, which it reads
with PIL), and the floor an image albedo. Tolerances, those of the port's other
comparisons with the reference:
- SceneData equal field for field;
- at least 99% of per-(pixel, sample) paths within rtol 1e-3 / atol 1e-4 of the
  reference run op by op (``bounce_step`` outside jit, as in
  tests/test_torch_mesh_render.py): jitted, XLA contracts multiply-adds, and the
  normal map's tangent frame turns an ulp into another branch on ~3% of paths
  (measured: 96.7% of paths within tolerance of the jitted reference);
- render_grads against the jitted reference's: a relative L1 error of at most 2e-2
  per field (tests/test_torch_grad_ref.py).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_grad_ref import assert_grads_close
from test_torch_mesh_render import _reference_op_by_op
from test_torch_scene import _assert_same
import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
from tpupt.render import diff as JD
from tpupt.render.camera import Camera as JCamera
from tpupt.scene import builder as JB
from tpupt_torch.render import diff as TD
from tpupt_torch.render.camera import Camera as TCamera
from tpupt_torch.render.integrator import trace_radiance as t_trace
from tpupt_torch.scene import builder as TB


def _maps():
    """(normal map [16,32,3], albedo [16,32,3]) uint8: bumps tilted about both axes."""
    y, x = np.mgrid[0:16, 0:32].astype(np.float64)
    n = np.stack([0.5 * np.sin(x / 32 * 4 * np.pi), 0.4 * np.cos(y / 16 * 3 * np.pi), np.ones_like(x)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal = np.round((n * 0.5 + 0.5) * 255).astype(np.uint8)
    albedo = np.random.default_rng(4).integers(60, 230, (16, 32, 3), dtype=np.uint8)
    return normal, albedo


def _scene(B, normal, albedo):
    s = B.Scene()
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0),
               B.Diffuse(B.ImageTexture(albedo), normal_map=B.ImageTexture(normal)))
    s.add_sphere(0.7, (0.0, 0.7, 0.0), B.Diffuse((0.7, 0.6, 0.5), normal_map=B.ImageTexture(normal)))
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), B.Light((6.0, 5.0, 4.0)), light=True)
    s.environment = (0.3, 0.35, 0.4)
    return s


def _cam(Camera, width=8):
    return Camera(aspect_ratio=1.0, image_width=width, samples_per_pixel=4, max_depth=8, vfov=40.0,
                  look_from=(0.0, 1.5, 3.0), look_at=(0.0, 0.5, 0.0), blur_strength=0.5,
                  focal_length=3.0, defocus_angle=0.0)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    normal, albedo = _maps()
    d = tmp_path_factory.mktemp("maps")
    Image.fromarray(normal, "RGB").save(d / "normal.png")
    Image.fromarray(albedo, "RGB").save(d / "albedo.png")
    jc = _scene(JB, str(d / "normal.png"), str(d / "albedo.png")).compile()
    tc = _scene(TB, normal, albedo).compile(device="cpu")
    return jc, tc


def test_normal_maps_compile_like_the_reference(scenes):
    jc, tc = scenes
    assert tc.data.has_normal_maps and tc.data.has_image_textures
    _assert_same(tc.data, jc.data)


def test_normal_mapped_paths_match_reference(scenes):
    jc, tc = scenes
    jcam, tcam = _cam(JCamera, 16), _cam(TCamera, 16)  # the op-by-op helper's width and depth
    jcam.max_depth = tcam.max_depth = 6
    rng = np.random.default_rng(2)
    pix = rng.integers(0, 16 * 16, 2048).astype(np.int32)
    smp = rng.integers(0, 64, 2048).astype(np.int32)
    lj = _reference_op_by_op(jc, jcam, pix, smp)
    lanes = (pix, pix // 16, pix % 16, smp)
    lt, _ = t_trace(tc.data, tcam.init("cpu"), *(torch.from_numpy(a) for a in lanes), 0, 6, tc.has_lights)
    ok = np.isclose(lt.numpy(), lj, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert float((lt.sum(-1) > 0).float().mean()) > 0.5


def test_normal_mapped_grads_match_reference(scenes):
    jc, tc = scenes
    jcam, tcam = _cam(JCamera), _cam(TCamera)
    ids = np.arange(64, dtype=np.int32)
    _, jg = JD.render_grads(jc, jcam, ids, spp=4, seed=0)
    tr, tg = TD.render_grads(tc, tcam, ids, spp=4, seed=0)
    assert tr.shape == (64, 3) and bool(torch.isfinite(tr).all())
    assert_grads_close(tg, jg)
    for k in ("atlas", "tex_rgb", "env_color"):
        assert float(np.abs(np.asarray(jg[k])).sum()) > 0.0, k
