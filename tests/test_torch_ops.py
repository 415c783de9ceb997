"""The port's shading ops against their reference twins on seeded batches:
cameras, textures, BSDF sample/pdf/eval per material family, lights, environment.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: rtol 1e-3 / atol 1e-5, on at least 99.5% of lanes for the BSDF and
light values. XLA's CPU code fuses multiply-adds and its transcendentals (sin,
cos, acos, atan2, log2, pow) differ from PyTorch's by an ulp or two; the BSDF
and light-pdf formulas divide by small cosines and distances, which amplifies
that on a few grazing lanes. Everything else must agree on every lane.
"""

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.ops import bsdf as JBS
from tpupt.ops import lights as JL
from tpupt.ops.envmap import sample_environment as j_env
from tpupt.ops.texture import eval_texture as j_tex
from tpupt.render.camera import generate_rays as j_rays
from tpupt.scene import builder as JB
from tpupt.scenes import balls_scene as j_balls
from tpupt.scenes import cornell_box_scene as j_cornell
from tpupt_torch.ops import bsdf as TBS
from tpupt_torch.ops import lights as TL
from tpupt_torch.ops.envmap import sample_environment as t_env
from tpupt_torch.ops.texture import eval_texture as t_tex
from tpupt_torch.render.camera import generate_rays as t_rays
from tpupt_torch.scene import builder as TB
from tpupt_torch.scene import data as D
from tpupt_torch.scenes import balls_scene as t_balls
from tpupt_torch.scenes import cornell_box_scene as t_cornell

N = 4096


def _close(a, b, share=1.0, rtol=1e-3, atol=1e-5):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ok = np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
    ok = ok.reshape(ok.shape[0], -1).all(axis=1)
    assert ok.mean() >= share, f"only {ok.mean():.4f} of lanes close (need {share})"


def _scene(B, image):
    s = B.Scene()
    checker = B.CheckerTexture(0.5, B.SolidTexture((0.2, 0.3, 0.1)), B.SolidTexture((0.9, 0.9, 0.9)))
    s.add_quad((-5.0, 0.0, -5.0), (10.0, 0.0, 0.0), (0.0, 0.0, 10.0), B.Diffuse(checker))
    s.add_sphere(0.5, (0.0, 1.0, 0.0), B.Diffuse(B.ImageTexture(image)))
    s.add_sphere(0.5, (1.0, 1.0, 0.0), B.Metal((0.7, 0.6, 0.5), 0.3))
    s.add_sphere(0.5, (2.0, 1.0, 0.0), B.Glass((0.9, 0.8, 1.0), 0.2, 1.5))
    s.add_sphere(0.5, (3.0, 1.0, 0.0), B.Principled(
        (0.6, 0.5, 0.4), metallic=0.3, roughness=0.4, subsurface=0.2, specular=0.6,
        specular_tint=0.3, spec_trans=0.3, sheen=0.4, sheen_tint=0.5, clearcoat=0.6,
        clearcoat_gloss=0.3))
    s.add_quad((-1.0, 4.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), B.Light((5.0, 4.0, 3.0)), light=True)
    s.add_sphere(0.3, (2.0, 3.0, 1.0), B.Light((3.0, 2.0, 1.0)), center2=(2.0, 3.5, 1.0), light=True)
    s.environment = B.ImageTexture(image)
    return s


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from PIL import Image

    img = np.random.default_rng(5).integers(0, 256, (8, 16, 3), dtype=np.uint8)
    path = str(tmp_path_factory.mktemp("tex") / "tex.png")
    Image.fromarray(img, mode="RGB").save(path)
    return _scene(JB, path).compile().data, _scene(TB, img).compile(device="cpu").data


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("which", ["cornell", "balls"])
def test_generate_rays(which):
    jb, tb = {"cornell": (j_cornell, t_cornell), "balls": (j_balls, t_balls)}[which]
    jcam = jb(48, 4)[1].init()
    tcam = tb(48, 4)[1].init("cpu")
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 48 * 27, N).astype(np.int32)
    smp = rng.integers(0, 64, N).astype(np.int32)
    rows, cols = pix // 48, pix % 48
    jo, jd, jt = jax.jit(j_rays)(jcam, *(jnp.asarray(a) for a in (rows, cols, pix, smp)), jnp.uint32(3))
    to, td, tt = t_rays(tcam, _t(rows), _t(cols), _t(pix), _t(smp), 3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))  # the time draw is exact
    _close(to.numpy(), jo)
    _close(td.numpy(), jd)


def test_textures(scenes):
    jsd, tsd = scenes
    rng = np.random.default_rng(1)
    tid = rng.integers(0, tsd.tex_type.shape[0], N).astype(np.int32)
    u, v = rng.uniform(-0.1, 1.1, (2, N)).astype(np.float32)
    p = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    j = jax.jit(j_tex)(jsd, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v), jnp.asarray(p))
    t = t_tex(tsd, _t(tid), _t(u), _t(v), _t(p))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_environment(scenes):
    jsd, tsd = scenes
    d = _unit(np.random.default_rng(2), N)
    _close(t_env(tsd, _t(d)).numpy(), jax.jit(j_env)(jsd, jnp.asarray(d)), share=0.999)
    jc = j_cornell(8, 1)[0].compile().data
    tc = t_cornell(8, 1)[0].compile(device="cpu").data
    np.testing.assert_array_equal(t_env(tc, _t(d)).numpy(), np.asarray(jax.jit(j_env)(jc, jnp.asarray(d))))


def _shade_inputs(tsd, mtype, seed):
    rng = np.random.default_rng(seed)
    mats = np.nonzero(tsd.mat_type.numpy() == mtype)[0]
    mat_id = rng.choice(mats, N).astype(np.int32)
    u, v = rng.uniform(0, 1, (2, N)).astype(np.float32)
    point = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    ng = _unit(rng, N)
    front = rng.uniform(size=N) < 0.7
    view = _unit(rng, N)
    light = _unit(rng, N)
    uni = rng.uniform(size=(4, N)).astype(np.float32)
    return mat_id, u, v, point, ng, front, view, light, uni


def _j_bsdf(jsd, mat_id, u, v, point, ng, front, view, light, uni):
    sh = JBS.make_shade(jsd, mat_id, u, v, point, ng, ng, front)
    d, ok = JBS.bsdf_sample(sh, view, *uni)
    return sh.base_color, sh.roughness, d, ok, JBS.bsdf_pdf(sh, view, light), JBS.bsdf_eval(sh, view, light)


@pytest.mark.parametrize(
    "mtype", [D.MAT_DIFFUSE, D.MAT_METAL, D.MAT_GLASS, D.MAT_PRINCIPLED, D.MAT_LIGHT]
)
def test_bsdf_per_material(scenes, mtype):
    jsd, tsd = scenes
    mat_id, u, v, point, ng, front, view, light, uni = _shade_inputs(tsd, mtype, 10 + mtype)
    jout = jax.jit(_j_bsdf)(
        jsd, *(jnp.asarray(a) for a in (mat_id, u, v, point, ng, front, view, light)),
        tuple(jnp.asarray(a) for a in uni),
    )
    sh = TBS.make_shade(tsd, _t(mat_id), _t(u), _t(v), _t(point), _t(ng), _t(ng), _t(front))
    d, ok = TBS.bsdf_sample(sh, _t(view), *(_t(a) for a in uni))
    tout = (sh.base_color, sh.roughness, d, ok,
            TBS.bsdf_pdf(sh, _t(view), _t(light)), TBS.bsdf_eval(sh, _t(view), _t(light)))
    base, rough, jd, jok, jpdf, jev = (np.asarray(a) for a in jout)
    np.testing.assert_array_equal(tout[0].numpy(), base)
    np.testing.assert_array_equal(tout[1].numpy(), rough)
    assert (tout[3].numpy() == jok).mean() >= 0.995
    _close(tout[2].numpy(), jd, share=0.995)
    _close(tout[4].numpy(), jpdf, share=0.995)
    _close(tout[5].numpy(), jev, share=0.995)


def test_lights(scenes):
    jsd, tsd = scenes
    rng = np.random.default_rng(20)
    origin = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    time = rng.uniform(size=N).astype(np.float32)
    pick, u1, u2 = rng.uniform(size=(3, N)).astype(np.float32)
    jd, je = jax.jit(JL.sample_lights)(jsd, *(jnp.asarray(a) for a in (origin, time, pick, u1, u2)))
    td, te = TL.sample_lights(tsd, *(_t(a) for a in (origin, time, pick, u1, u2)))
    _close(td.numpy(), jd, share=0.999)
    assert not te.any() and not np.asarray(je).any()  # no HDR environment member here
    # pdf along the sampled directions (which hit a light) and along random ones
    for dirs in (np.asarray(jd), _unit(rng, N)):
        jp = jax.jit(JL.pdf_lights)(jsd, jnp.asarray(origin), jnp.asarray(dirs), jnp.asarray(time))
        tp = TL.pdf_lights(tsd, _t(origin), _t(dirs), _t(time))
        _close(tp.numpy(), jp, share=0.995)
