"""The port's gradients against the reference package's on the CPU: render_grads and
the masked per-sample scan. render_film_grads is in test_torch_film_grads_ref.py.

Both packages render one compiled scene: the reference's SceneData reaches the port
through scene_data_from_numpy, its init_params through params_from_numpy, and the
port's gradients come back through params_to_numpy.

Tolerance. The reference's entry points are jitted, and XLA contracts multiply-adds,
so some paths take another branch than in the port, which agrees bit for bit with
the reference run op by op (measured: 6 of 144 paths of the box scene at depth 12).
A path that branches differently moves a gradient sum by its own share, so:
- entry points: per field, the relative L1 error sum|g_port - g_ref| / sum|g_ref|
  at most 2e-2 (measured: the box scene's env_color 0.9%, the Cornell box's 0.17%,
  every other field below 1e-4), and at least 95% of pixel radiances within
  rtol 1e-3 / atol 1e-4;
- where the paths agree the gradients agree: with the cotangent zeroed on lanes
  whose per-sample radiance differs (beyond rtol 1e-5 / atol 1e-6), every field
  within 1e-4 of its largest element.
"""

import dataclasses

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.render import diff as JD
from tpupt.render.camera import Camera as JCamera
from tpupt.scene import builder as JB
from tpupt.scenes import cornell_box_scene as j_cornell
from tpupt_torch.render import diff as TD
from tpupt_torch.render.camera import Camera as TCamera
from tpupt_torch.scene import data as TDat
from tpupt_torch.scene.compile import CompiledScene
from tpupt_torch.scene.convert import params_from_numpy, params_to_numpy, scene_data_from_numpy
from tpupt_torch.scenes import cornell_box_scene as t_cornell


def port_scene(jc):
    """The reference's compiled scene as the port's, field for field."""
    jsd = jc.data
    fields = {f.name: np.asarray(getattr(jsd, f.name)) for f in dataclasses.fields(jsd)}
    static = {n: getattr(jsd, n) for n in TDat.STATIC_FIELDS}
    return CompiledScene(scene_data_from_numpy(fields, static, "cpu"), jc.has_lights)


def box_scene(B, env=(0.0, 0.0, 0.0)):
    s = B.Scene()
    floor = B.Diffuse((0.73, 0.6, 0.5))
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), floor)
    s.add_sphere(0.7, (0.0, 0.7, 0.0), floor)
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), B.Light((6.0, 5.0, 4.0)), light=True)
    s.environment = env
    return s


def hdr_scene(B):
    """A principled sphere on a metal floor under a quad light and an HDR map: every
    material family's eval and both light members."""
    img = np.random.default_rng(0).uniform(0.05, 3.0, size=(8, 16, 3)).astype(np.float32)
    img[2, 5] = 60.0
    s = B.Scene()
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), B.Metal((0.8, 0.7, 0.6), 0.3))
    s.add_sphere(0.7, (0.0, 0.7, 0.0), B.Principled((0.6, 0.5, 0.4), metallic=0.2, roughness=0.5,
                                                   clearcoat=0.5, sheen=0.3))
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), B.Light((6.0, 5.0, 4.0)), light=True)
    s.environment = B.ImageTexture(img, hdr=True)
    return s


def box_cam(Camera, width=6, depth=12, spp=4):
    return Camera(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=depth,
        vfov=40.0, look_from=(0.0, 1.0, 3.0), look_at=(0.0, 1.0, 0.0),
        blur_strength=0.5, focal_length=3.0, defocus_angle=0.0,
    )


def configs(name):
    """(reference compiled scene, reference camera, port compiled scene, port camera)."""
    if name == "box":
        jc = box_scene(JB).compile()
        jcam, tcam = box_cam(JCamera), box_cam(TCamera)
    else:
        js, jcam = j_cornell(8, 4)
        _, tcam = t_cornell(8, 4)
        jcam.max_depth = tcam.max_depth = 12
        jc = js.compile()
    return jc, jcam, port_scene(jc), tcam


def assert_grads_close(tg, jg, rel_l1=2e-2):
    tg = params_to_numpy(tg)
    assert set(tg) == set(jg)
    for k, ref in jg.items():
        ref = np.asarray(ref)
        got = tg[k]
        assert got.shape == ref.shape and np.isfinite(got).all(), k
        err = np.abs(got - ref).sum() / max(np.abs(ref).sum(), 1e-30)
        assert err <= rel_l1, (k, err)


@pytest.mark.parametrize("name", ["box", "cornell"])
def test_render_grads_match_reference(name):
    jc, jcam, tc, tcam = configs(name)
    ids = np.arange(jcam.image_width * jcam.image_height, dtype=np.int32)
    jr, jg, jrays = JD.render_grads(jc, jcam, ids, spp=4, seed=0, return_stats=True)
    tr, tg, trays = TD.render_grads(tc, tcam, ids, spp=4, seed=0, return_stats=True)
    close = np.isclose(tr.numpy(), np.asarray(jr), rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.95, close.mean()
    assert abs(trays - int(jrays)) <= 0.02 * int(jrays)
    assert_grads_close(tg, jg)
    assert float(np.abs(np.asarray(jg["tex_rgb"])).sum()) > 0.0


@pytest.mark.parametrize("name", ["box_env", "hdr"])
def test_masked_grads_match_reference(name):
    jc = (box_scene(JB, env=(0.4, 0.5, 0.6)) if name == "box_env" else hdr_scene(JB)).compile()
    tc = port_scene(jc)
    jcam, tcam = box_cam(JCamera, depth=8), box_cam(TCamera, depth=8)
    w, spp = jcam.image_width, 4
    pix = np.repeat(np.arange(w * w, dtype=np.int32), spp)
    samp = np.tile(np.arange(spp, dtype=np.int32), w * w)
    lanes = (pix, pix // w, pix % w, samp)
    jfn = JD.make_pixel_fn(jc, jcam)
    jparams = JD.init_params(jc.data)
    jargs = tuple(jnp.asarray(a) for a in lanes) + (jnp.uint32(0),)

    @jax.jit
    def j_value_and_vjp(p, cot):
        val, vjp = jax.vjp(lambda q: jfn(q, *jargs), p)
        return val, vjp(cot)[0]

    jval, _ = j_value_and_vjp(jparams, jnp.zeros((len(pix), 3), jnp.float32))
    tparams = {n: v.requires_grad_(True) for n, v in
               params_from_numpy({n: np.asarray(v) for n, v in jparams.items()}, "cpu").items()}
    tval = TD.make_pixel_fn(tc, tcam)(tparams, *(torch.from_numpy(a) for a in lanes), 0)
    agree = np.isclose(tval.detach().numpy(), np.asarray(jval), rtol=1e-5, atol=1e-6).all(-1)
    assert agree.mean() >= 0.9, agree.mean()
    cot = np.random.default_rng(1).uniform(size=(len(pix), 3)).astype(np.float32) * agree[:, None]
    _, jg = j_value_and_vjp(jparams, jnp.asarray(cot))
    got = torch.autograd.grad((tval * torch.from_numpy(cot)).sum(), list(tparams.values()), allow_unused=True)
    tg = {n: torch.zeros_like(v) if g is None else g for (n, v), g in zip(tparams.items(), got)}
    for k, g in params_to_numpy(tg).items():
        ref = np.asarray(jg[k])
        np.testing.assert_allclose(g, ref, rtol=0.0, atol=1e-4 * max(np.abs(ref).max(), 1e-30), err_msg=k)
    fields = ("env_color",) if name == "box_env" else ("env_img", "mat_params")
    for k in fields:
        assert np.abs(np.asarray(jg[k])).sum() > 0.0, k
