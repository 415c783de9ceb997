"""The port's HDR environment with importance sampling against the reference package.

Inputs are made from numpy seeds and fed to both packages. Tolerances:
- the alias, prob and pdf tables and every compiled HDR field: bit-equal (both
  run the same float64 host math and cast once);
- per-direction lookups (texel, radiance, pdf): arccos and atan2 of the two
  packages may differ by an ulp and move a direction on a texel boundary to the
  next texel, so at least 99.9% of seeded directions must give the same texel,
  and those must give equal values; sampled directions (sin, cos of texel
  centres) within rtol 1e-6 / atol 1e-6;
- statistical ports of tests/test_envmap.py at its tolerances;
- an HDR render of a tiny environment_map_scene (in-memory map) against the
  reference's bounce_step run op by op (jitted, XLA contracts multiply-adds):
  at least 99% of (pixel, sample) paths within rtol 1e-3 / atol 1e-4.
"""

import dataclasses

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.ops import envmap as JE
from tpupt.ops import lights as JL
from tpupt.render.camera import generate_rays as j_generate_rays
from tpupt.render.integrator import bounce_step as j_bounce_step
from tpupt.scene import builder as JB
from tpupt.scenes import environment_map_scene as j_env_scene
from tpupt_torch.ops import envmap as TE
from tpupt_torch.ops import lights as TL
from tpupt_torch.render.camera import Camera as TCamera
from tpupt_torch.render.integrator import trace_radiance as t_trace
from tpupt_torch.render.renderer import render_image as t_render
from tpupt_torch.scene import builder as TB
from tpupt_torch.scene import data as TD
from tpupt_torch.scene.compile import CompiledScene
from tpupt_torch.scenes import environment_map_scene as t_env_scene

ENV_FIELDS = ("env_img", "env_wh", "env_alias", "env_prob", "env_pdf", "env_sam")


def _rand_map(h=8, w=16, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.05, 4.0, size=(h, w, 3)).astype(np.float32)
    img[2, 5] = 80.0  # one hot texel, like a sun
    return img


def _hdr_scene(B, img, add_sphere=True, light=False):
    s = B.Scene()
    if add_sphere:
        s.add_sphere(1.0, (0.0, 0.0, -3.0), B.Diffuse((1.0, 1.0, 1.0)))
    if light:
        s.add_quad((-1.0, 2.5, -4.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), B.Light((6.0, 6.0, 6.0)), light=True)
    s.environment = B.ImageTexture(img, hdr=True)
    return s


def _cam(width=16, spp=16, depth=50):
    return TCamera(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=depth,
        vfov=30.0, look_from=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0),
        blur_strength=0.5, focal_length=3.0, defocus_angle=0.0,
    )


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _uniforms(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=n).astype(np.float32), rng.uniform(size=n).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "hot", "zeros", "tall"])
def test_build_env_tables_bit_equal(kind):
    img = {
        "random": _rand_map(),
        "hot": _rand_map(16, 32, seed=5),
        "zeros": np.zeros((4, 8, 3), np.float32),
        "tall": np.random.default_rng(7).exponential(size=(33, 7, 3)).astype(np.float32),
    }[kind]
    for a, b in zip(TE.build_env_tables(img), JE.build_env_tables(img)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_compiled_hdr_fields_equal_reference():
    img = _rand_map()
    js = _hdr_scene(JB, img, light=True).compile()
    tc = _hdr_scene(TB, img, light=True).compile(device="cpu")
    for name in ENV_FIELDS:
        np.testing.assert_array_equal(getattr(tc.data, name).numpy(), np.asarray(getattr(js.data, name)),
                                      err_msg=name)
    assert tc.data.env_is_hdr and js.data.env_is_hdr
    assert tc.has_lights == js.has_lights is True
    assert tc.data.env_wh_host == (16, 8)
    # an HDR environment without geometry lights still samples lights (the env member)
    t0 = _hdr_scene(TB, img).compile(device="cpu")
    assert t0.has_lights and t0.data.n_lights_real == 0
    # an image texture on a material cannot be HDR
    s = TB.Scene()
    s.add_sphere(1.0, (0, 0, 0), TB.Diffuse(TB.ImageTexture(img, hdr=True)))
    with pytest.raises(NotImplementedError, match="hdr=True"):
        s.compile(device="cpu")


def test_env_scene_compiles_like_reference(tmp_path, monkeypatch):
    """environment_map_scene(hdr_env=True) from a .hdr file, through both compilers."""
    rng = np.random.default_rng(3)
    rgbe = rng.integers(1, 255, size=(6, 12, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 136, size=(6, 12))
    (tmp_path / "grace_probe_latlong.hdr").write_bytes(  # flat (not run-length) rows
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 12\n" + rgbe.tobytes()
    )
    monkeypatch.setenv("TPUPT_ASSETS", str(tmp_path))
    ts, _ = t_env_scene(16, 2, hdr_env=True)
    js, _ = j_env_scene(16, 2, hdr_env=True)
    js.environment = JB.ImageTexture(str(tmp_path / "grace_probe_latlong.hdr"), hdr=True)
    tc, jc = ts.compile(device="cpu"), js.compile()
    for name in ENV_FIELDS:
        np.testing.assert_array_equal(getattr(tc.data, name).numpy(), np.asarray(getattr(jc.data, name)),
                                      err_msg=name)
    assert tc.data.env_wh_host == (12, 6) and tc.has_lights and jc.has_lights


def _pair(img, light=False):
    return _hdr_scene(JB, img, light=light).compile().data, _hdr_scene(TB, img, light=light).compile(device="cpu").data


def test_sample_environment_and_pdf_match_reference():
    jsd, tsd = _pair(_rand_map(16, 32, seed=1))
    d = _dirs(20000, 11)
    jt, _, _ = JE._texel_from_dir(jsd, jnp.asarray(d))
    tt, _, _ = TE._texel_from_dir(tsd, torch.from_numpy(d))
    same = np.asarray(jt) == tt.numpy()
    assert same.mean() >= 0.999, same.mean()
    jv = np.asarray(JE.sample_environment(jsd, jnp.asarray(d)))
    tv = TE.sample_environment(tsd, torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(tv[same], jv[same])
    jp = np.asarray(JE.pdf_env_light(jsd, jnp.asarray(d)))
    tp = TE.pdf_env_light(tsd, torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(tp[same], jp[same])


def test_sample_env_light_matches_reference():
    jsd, tsd = _pair(_rand_map(16, 32, seed=2))
    u1, u2 = _uniforms(20000, 12)
    j = np.stack([np.asarray(c) for c in JE.sample_env_light(jsd, jnp.asarray(u1), jnp.asarray(u2))], -1)
    t = np.stack([c.numpy() for c in TE.sample_env_light(tsd, torch.from_numpy(u1), torch.from_numpy(u2))], -1)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("light", [False, True])
def test_env_light_member_matches_reference(light):
    """sample_lights / pdf_lights with the environment as a member, with and without
    a geometry light (n_lights_real 0 and 1)."""
    jsd, tsd = _pair(_rand_map(8, 16, seed=4), light=light)
    n = 8192
    rng = np.random.default_rng(13)
    origin = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    time = rng.uniform(size=n).astype(np.float32)
    pick, u1, u2 = (rng.uniform(size=n).astype(np.float32) for _ in range(3))
    jd, je = JL.sample_lights(jsd, jnp.asarray(origin), jnp.asarray(time), *map(jnp.asarray, (pick, u1, u2)))
    td, te = TL.sample_lights(tsd, torch.from_numpy(origin), torch.from_numpy(time),
                              *map(torch.from_numpy, (pick, u1, u2)))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    if light:  # both members picked
        assert te.any() and not te.all()
    else:  # the environment is the only member
        assert te.all()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    d = _dirs(n, 14)
    jp = np.asarray(JL.pdf_lights(jsd, jnp.asarray(origin), jnp.asarray(d), jnp.asarray(time)))
    tp = TL.pdf_lights(tsd, torch.from_numpy(origin), torch.from_numpy(d), torch.from_numpy(time)).numpy()
    close = np.isclose(tp, jp, rtol=1e-5, atol=1e-7)
    assert close.mean() >= 0.999, close.mean()


# ---- ports of tests/test_envmap.py ----


def test_env_pdf_normalizes():
    img = _rand_map()
    h, w = img.shape[:2]
    _, _, pdf = TE.build_env_tables(img)
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
    omega = (2 * np.pi / w) * (np.pi / h) * np.repeat(sin_t, w)
    np.testing.assert_allclose((pdf * omega).sum(), 1.0, rtol=1e-5)


def test_env_alias_sampling_matches_weights():
    img = _rand_map()
    h, w = img.shape[:2]
    sd = _hdr_scene(TB, img, add_sphere=False).compile(device="cpu").data
    n = 200_000
    u1, u2 = _uniforms(n, 1)
    d = torch.stack(TE.sample_env_light(sd, torch.from_numpy(u1), torch.from_numpy(u2)), dim=-1)
    texel, _, _ = TE._texel_from_dir(sd, d)
    counts = np.bincount(texel.numpy(), minlength=h * w) / n
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
    p = (lum * sin_t[:, None]).reshape(-1)
    p = p / p.sum()
    sigma = np.sqrt(p * (1 - p) / n)  # 200k draws: per-texel rate within ~4 sigma
    assert np.all(np.abs(counts - p) < 4.5 * sigma + 1e-4)


def test_env_sample_pdf_consistency():
    sd = _hdr_scene(TB, _rand_map(seed=3), add_sphere=False).compile(device="cpu").data
    u1, u2 = _uniforms(4096, 2)
    d = torch.stack(TE.sample_env_light(sd, torch.from_numpy(u1), torch.from_numpy(u2)), dim=-1)
    pdf = TE.pdf_env_light(sd, d)
    assert bool((pdf > 0).all())
    texel, _, _ = TE._texel_from_dir(sd, d)
    np.testing.assert_allclose(pdf.numpy(), sd.env_pdf.numpy()[texel.numpy()], rtol=1e-6)


def test_env_hdr_values_preserved():
    img = _rand_map()
    sd = _hdr_scene(TB, img, add_sphere=False).compile(device="cpu").data
    h, w = img.shape[:2]
    theta = (2 + 0.5) / h * np.pi
    phi = (5 + 0.5) / w * 2 * np.pi - np.pi
    d = torch.tensor([[np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)]],
                     dtype=torch.float32)
    np.testing.assert_allclose(TE.sample_environment(sd, d).numpy()[0], img[2, 5], rtol=1e-6)


def test_env_is_white_furnace():
    """A uniform HDR env of 1 around a white Lambertian sphere renders to 1: the env
    member of the MIS mixture keeps the estimator unbiased."""
    compiled = _hdr_scene(TB, np.ones((8, 16, 3), np.float32)).compile(device="cpu")
    assert compiled.data.env_is_hdr and compiled.has_lights
    _, mean, _ = t_render(compiled, _cam(width=16, spp=64), rays_per_launch=1 << 14, progress=False)
    np.testing.assert_allclose(np.mean(mean), 1.0, atol=0.01)
    np.testing.assert_allclose(mean, 1.0, atol=0.35)


def test_env_is_reduces_variance_on_hot_texel():
    """Importance sampling a sun-like env estimates the same image as BSDF-only
    sampling, with less error at equal spp."""
    img = np.full((8, 16, 3), 0.05, dtype=np.float32)
    img[2, 5] = 120.0
    c_is = _hdr_scene(TB, img).compile(device="cpu")
    c_bsdf = CompiledScene(c_is.data, has_lights=False)
    _, truth, _ = t_render(c_is, _cam(width=8, spp=1024, depth=4), rays_per_launch=1 << 16, progress=False)
    cam = _cam(width=8, spp=32, depth=4)
    mses = {}
    for name, c in (("is", c_is), ("bsdf", c_bsdf)):
        errs = [np.mean((t_render(c, cam, seed=100 + s, rays_per_launch=1 << 14, progress=False)[1]
                         - truth) ** 2) for s in range(4)]
        mses[name] = np.mean(errs)
    assert mses["is"] < 0.5 * mses["bsdf"], mses


# ---- the HDR render against the reference run op by op ----


def test_hdr_render_matches_reference_op_by_op():
    img = _rand_map(16, 32, seed=9)
    js, jcam = j_env_scene(16, 2, hdr_env=True)
    ts, tcam = t_env_scene(16, 2, hdr_env=True)
    js.environment = JB.ImageTexture(img, hdr=True)
    ts.environment = TB.ImageTexture(img, hdr=True)
    jc, tc = js.compile(), ts.compile(device="cpu")
    assert jc.has_lights and tc.has_lights and tc.data.n_lights_real == 0
    w, h = 16, tcam.image_height
    npix = w * h
    pix = np.repeat(np.arange(npix, dtype=np.int32), 2)
    smp = np.tile(np.arange(2, dtype=np.int32), npix)
    rows, cols = pix // w, pix % w

    o, d, time = j_generate_rays(jcam.init(), *(jnp.asarray(a) for a in (rows, cols, pix, smp)), jnp.uint32(0))
    b = len(pix)
    T, L, alive = jnp.ones((b, 3)), jnp.zeros((b, 3)), jnp.ones(b, bool)
    for bounce in range(tcam.max_depth):
        if not bool(alive.any()):
            break
        o2, d2, T, L, alive = j_bounce_step(
            jc.data, o, d, time, T, L, alive, bounce, jnp.asarray(pix), jnp.asarray(smp),
            jnp.uint32(0), np.float32(0.5), np.float32(0.5), True,
        )
        o = jnp.where(alive[:, None], o2, o)
        d = jnp.where(alive[:, None], d2, d)
    lt, rays = t_trace(tc.data, tcam.init("cpu"), *(torch.from_numpy(a) for a in (pix, rows, cols, smp)),
                       0, tcam.max_depth, True)
    assert rays >= b
    lj = np.asarray(L)
    assert np.isfinite(lt.numpy()).all() and lt.numpy().max() > 0
    ok = np.isclose(lt.numpy(), lj, rtol=1e-3, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()


def test_dataclass_fields_carried():
    """scene_data_from_numpy takes the reference's HDR fields."""
    from tpupt_torch.scene.convert import scene_data_from_numpy

    jsd = _hdr_scene(JB, _rand_map(), light=True).compile().data
    fields = {f.name: np.asarray(getattr(jsd, f.name)) for f in dataclasses.fields(jsd)}
    static = {n: getattr(jsd, n) for n in TD.STATIC_FIELDS}
    tsd = scene_data_from_numpy(fields, static, device="cpu")
    assert tsd.env_is_hdr and tsd.env_wh_host == (16, 8)
    for name in ENV_FIELDS:
        np.testing.assert_array_equal(getattr(tsd, name).numpy(), fields[name], err_msg=name)


def test_cli_hdr_env(tmp_path, monkeypatch):
    from tpupt_torch import cli

    rgbe = np.random.default_rng(4).integers(1, 255, size=(8, 16, 4)).astype(np.uint8)
    rgbe[..., 3] = 128
    (tmp_path / "grace_probe_latlong.hdr").write_bytes(
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 8 +X 16\n" + rgbe.tobytes()
    )
    monkeypatch.setenv("TPUPT_ASSETS", str(tmp_path))
    out = tmp_path / "lights.png"
    args = ["-s", "4", "--hdr-env", "--width", "16", "--spp", "2", "--device", "cpu", "-o", str(out)]
    assert cli.main(args) == 0 and out.stat().st_size > 0
