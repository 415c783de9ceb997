"""The roughness gradient against a central finite difference, the port's twin of the
reference's check (tests/test_grad.py, test_grad_roughness_statistical), on the CPU.

Roughness steers the VNDF sampling, and the detached estimator carries no gradient
through the sampled direction, so its gradient equals the finite difference only of the
expected image: the two are compared as the reference compares them, at 256 samples a
pixel of one seed, by sign and within rtol 0.5. The scene is the reference's (a rough
metal floor under a quad light, a dim sky, 6x6 pixels, max_depth 3), compiled by the
reference and carried into the port field for field.

A metal reads its roughness from a texture (the roughness row of tex_rgb, channel 0),
not from mat_params[:, P_ROUGHNESS], which the reference's check perturbs: there its
gradient and its finite difference are both 0, in either package, and the check holds
as the reference's does. On the roughness texture the two agree in sign but not within
rtol 0.5, in either package: the gradient is about a tenth of the finite difference
(tools/torch_roughness_fd.py; ROADMAP Queue 3). The estimator samples the VNDF stretched
by roughness^2 (sampling.rs:57-64, ops/sampling.py) but divides by the density of the
VNDF at alpha = roughness, so the rendered image is not the integral the detached
gradient differentiates. The port keeps the reference's estimator, so this test holds its
gradients to the reference's (every field within relative L1 2e-2: the same estimator and
RNG stream, but the reference's jitted pass contracts multiply-adds and takes another
branch on a few paths, test_torch_grad_ref.py), and the roughness texture's gradient to
the finite difference's sign.
"""

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import numpy as np
import torch

from tpupt.render import diff as JD
from tpupt.render.camera import Camera as JCamera
from tpupt.scene.builder import Light, Metal, Scene
from tpupt_torch.render import diff as TD
from tpupt_torch.render.camera import Camera as TCamera
from tpupt_torch.scene.compile import CompiledScene
from tpupt_torch.scene.data import MAT_METAL, P_ROUGHNESS

from test_torch_grad_ref import assert_grads_close, box_cam, port_scene

SPP = 256
H = 0.05  # the reference's step


def _scene():
    s = Scene()
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), Metal((0.9, 0.9, 0.9), 0.4))
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((5.0, 5.0, 5.0)), light=True)
    s.environment = (0.1, 0.1, 0.1)
    return s


def _fd(tc, tcam, ids, field, idx):
    """Central finite difference of the image sum in `field`[idx], at the reference's step."""

    def loss(v):
        x = getattr(tc.data, field).clone()
        x[idx] = v
        sd = TD.apply_params(tc.data, {field: x})
        radiance, _ = TD.render_grads(CompiledScene(sd, tc.has_lights), tcam, ids, spp=SPP, seed=0)
        return float(radiance.double().sum())

    v0 = float(getattr(tc.data, field)[idx])
    return (loss(v0 + H) - loss(v0 - H)) / (2.0 * H)


def test_roughness_gradient_against_finite_difference():
    jc = _scene().compile()
    tc = port_scene(jc)
    jcam, tcam = box_cam(JCamera, width=6, depth=3), box_cam(TCamera, width=6, depth=3)
    ids = np.arange(6 * 6, dtype=np.int32)
    metal = int(np.nonzero(tc.data.mat_type.numpy() == MAT_METAL)[0][0])
    _, grads = TD.render_grads(tc, tcam, ids, spp=SPP, seed=0)
    _, jgrads = JD.render_grads(jc, jcam, ids, spp=SPP, seed=0)
    assert bool(torch.isfinite(grads["tex_rgb"]).all()) and bool(torch.isfinite(grads["mat_params"]).all())

    # the reference's check, on the parameter it perturbs
    idx = (metal, P_ROUGHNESS)
    g, fd = float(grads["mat_params"][idx]), _fd(tc, tcam, ids, "mat_params", idx)
    assert np.sign(g) == np.sign(fd)
    np.testing.assert_allclose(g, fd, rtol=0.5)
    assert g == float(np.asarray(jgrads["mat_params"])[idx]) == 0.0

    # the roughness the metal reads: its texture's value
    idx = (int(tc.data.mat_rough_tex[metal]), 0)
    assert float(tc.data.tex_rgb[idx]) == np.float32(0.4)
    g, fd = float(grads["tex_rgb"][idx]), _fd(tc, tcam, ids, "tex_rgb", idx)
    assert np.sign(g) == np.sign(fd) == 1.0, (g, fd)
    assert_grads_close(grads, jgrads)
