"""End-to-end checks of the port's forward render of mesh scenes on the CPU.

The scene: a 5120-triangle UV sphere with smooth vertex normals on a floor quad,
under a quad light (16 px, 4 spp, max_depth 6); the port takes the cluster route
(the flat kernel's plain version), the reference package its stackless BVH.

The reference is run op by op (``bounce_step`` outside jit): then it rounds each
operation as PyTorch does. Jitted, XLA contracts multiply-adds, and in this
scene the reference's jitted and op-by-op runs agree on only ~97% of paths
(measured): paths that graze a surface or hit the light and then sample it end
in a near 0/0 pdf, where one ulp changes the throughput. Tolerances:
- the port's render_image against the op-by-op reference's per-pixel means of
  the same 1024 (pixel, sample) paths: at least 98% of pixels within rtol 1e-3 /
  atol 1e-4; the image mean within 0.5% of the jitted reference's render_image;
- per-(pixel, sample) replay on a lane subset: at least 99% of paths within
  rtol 1e-3 / atol 1e-4 of the op-by-op reference.
Scenes 4 and 6 are also checked against the committed goldens (24 px, 8 spp)
when TPUPT_ASSETS holds the asset files, and skipped otherwise: image mean within
0.5%, at least 95% of pixels within rtol 1e-3 / atol 1e-4 (as for the balls
golden).
"""

import os
import pathlib

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.render.camera import Camera as JCamera
from tpupt.render.camera import generate_rays as j_generate_rays
from tpupt.render.integrator import bounce_step as j_bounce_step
from tpupt.render.renderer import render_image as j_render
from tpupt.scene import builder as JB
from tpupt_torch.render.camera import Camera as TCamera
from tpupt_torch.render.integrator import trace_radiance as t_trace
from tpupt_torch.render.renderer import render_image as t_render
from tpupt_torch.scene import builder as TB
from tpupt_torch.scenes import SCENES as TSCENES

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
WIDTH, SPP, DEPTH = 16, 4, 6


def _sphere_scene(B, Camera):
    nu = nv = 50  # 2 * 50 * 50 triangles, 120 of them degenerate at the poles
    th, ph = np.meshgrid(np.linspace(0, np.pi, nv + 1), np.linspace(0, 2 * np.pi, nu + 1), indexing="ij")
    nrm = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    i = np.arange(nv)[:, None] * (nu + 1) + np.arange(nu)[None, :]
    faces = np.stack([i, i + nu + 1, i + 1, i + 1, i + nu + 1, i + nu + 2], -1).reshape(-1, 3)
    s = B.Scene()
    s.add_mesh(dict(positions=nrm + np.array([0.0, 1.0, 0.0]), normals=nrm, uvs=None, indices=faces),
               B.Principled((0.6, 0.5, 0.4), metallic=0.3, roughness=0.4))
    s.add_quad((-4.0, 0.0, -4.0), (0.0, 0.0, 8.0), (8.0, 0.0, 0.0), B.Diffuse((0.5, 0.5, 0.5)))
    s.add_quad((-1.0, 3.5, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), B.Light((8.0, 8.0, 8.0)), light=True)
    s.environment = (0.1, 0.1, 0.2)
    cam = Camera(aspect_ratio=1.0, image_width=WIDTH, samples_per_pixel=SPP, max_depth=DEPTH,
                 vfov=45.0, look_from=(0.0, 2.0, 5.0), look_at=(0.0, 0.8, 0.0), blur_strength=0.5,
                 focal_length=4.0, defocus_angle=0.0)
    return s, cam


def _reference_op_by_op(compiled, cam, pix, smp):
    """The reference estimator (trace_radiance's loop) with bounce_step run outside jit."""
    J = jnp.asarray
    pix, smp = J(pix), J(smp)
    rows, cols = pix // WIDTH, pix % WIDTH
    o, d, time = j_generate_rays(cam.init(), rows, cols, pix, smp, jnp.uint32(0))
    b = pix.shape[0]
    T, L, alive = jnp.ones((b, 3)), jnp.zeros((b, 3)), jnp.ones(b, bool)
    p_light = jnp.float32(0.5 if compiled.has_lights else 0.0)
    for bounce in range(DEPTH):
        o_next, d_next, T, L, alive = j_bounce_step(
            compiled.data, o, d, time, T, L, alive, jnp.int32(bounce), pix, smp, jnp.uint32(0),
            p_light, 1.0 - p_light, compiled.has_lights,
        )
        o = jnp.where(alive[:, None], o_next, o)
        d = jnp.where(alive[:, None], d_next, d)
    return np.asarray(L)


def _close(a, b):
    return np.isclose(a, b, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean()


def test_mesh_render_matches_reference():
    js, jcam = _sphere_scene(JB, JCamera)
    ts, tcam = _sphere_scene(TB, TCamera)
    jc, tc = js.compile(), ts.compile(device="cpu")
    assert tc.data.has_tri_clusters
    _, m_t, stats = t_render(tc, tcam, seed=0, rays_per_launch=1 << 14, progress=False)
    npix = WIDTH * tcam.image_height
    pix = np.repeat(np.arange(npix, dtype=np.int32), SPP)
    smp = np.tile(np.arange(SPP, dtype=np.int32), npix)
    ref = _reference_op_by_op(jc, jcam, pix, smp).reshape(npix, SPP, 3).mean(1).reshape(m_t.shape)
    assert stats.paths == npix * SPP and stats.iterations > 0 and np.nanmean(m_t) > 0.05
    assert _close(m_t, ref) >= 0.98, _close(m_t, ref)
    _, m_j, _ = j_render(jc, jcam, seed=0, rays_per_launch=1 << 14, progress=False)
    np.testing.assert_allclose(np.nanmean(m_t), np.nanmean(np.asarray(m_j)), rtol=5e-3)


def test_mesh_radiance_replay_matches_reference():
    js, jcam = _sphere_scene(JB, JCamera)
    ts, tcam = _sphere_scene(TB, TCamera)
    jc, tc = js.compile(), ts.compile(device="cpu")
    rng = np.random.default_rng(6)
    pix = rng.integers(0, WIDTH * tcam.image_height, 1024).astype(np.int32)
    smp = rng.integers(0, 64, 1024).astype(np.int32)
    rows, cols = pix // WIDTH, pix % WIDTH
    lt, rays = t_trace(
        tc.data, tcam.init("cpu"), *(torch.from_numpy(a) for a in (pix, rows, cols, smp)),
        0, DEPTH, tc.has_lights,
    )
    assert rays > len(pix)
    ok = _close(lt.numpy(), _reference_op_by_op(jc, jcam, pix, smp))
    assert ok >= 0.99, ok


@pytest.mark.parametrize("sid", [4, 6])
def test_asset_scene_matches_golden(sid):
    name, build = TSCENES[sid]
    assets = os.environ.get("TPUPT_ASSETS", "")
    needed = ("grace_probe_latlong.hdr",) + (("bunny.obj", "spot.obj", "cow.obj") if sid == 6 else ())
    if not assets or not all(os.path.exists(os.path.join(assets, f)) for f in needed):
        pytest.skip(f"scene {sid} needs {', '.join(needed)} under TPUPT_ASSETS")
    golden = np.load(GOLDEN / f"scene{sid}_{name}_24px_8spp.npy")
    scene, cam = build(24, 8)
    _, mean, _ = t_render(scene.compile(device="cpu"), cam, seed=0, rays_per_launch=1 << 14,
                          progress=False)
    np.testing.assert_allclose(np.nanmean(mean), np.nanmean(golden), rtol=5e-3)
    close = np.isclose(mean, golden, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean()
    assert close >= 0.95, close
