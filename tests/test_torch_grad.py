"""The port's differentiable pass on the CPU (render/diff.py).

- The scans reproduce the forward integrators: trace_radiance_scan equals
  trace_radiance and trace_film_scan equals trace_film_streamed (same estimator,
  same RNG stream, same rounding: bit-equal here).
- Central finite differences of the same seed, as tests/test_grad.py checks the
  reference: radiance is linear in emission and environment color (rtol 1e-3) and
  a low-degree polynomial in albedo at depth 4 (rtol 2e-2); an image texel's
  gradient (in-memory uint8 texture) within rtol 2e-3.
- render_film_grads equals render_grads (ray counts equal, image rtol 1e-5, grads
  rtol 2e-4 / atol 1e-5, the reference's tolerances for the same pair), and
  segmented_film_vjp equals autograd of trace_radiance_scan (rtol 1e-5).
- Gradients at a clamp's bound take the reference's rule (half at a tie).
- The kernel wrappers take no gradient and refuse tables that require it.
The comparisons with the reference package's gradients are in test_torch_grad_ref.py.
"""

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.ops import sampling as JS
from tpupt_torch.core import linalg as LA
from tpupt_torch.ops import hit_kernel, sampling as S, tri_kernel
from tpupt_torch.render import diff as D
from tpupt_torch.render.camera import Camera
from tpupt_torch.render.integrator import trace_film_streamed, trace_radiance
from tpupt_torch.scene.builder import Diffuse, ImageTexture, Light, Scene
from tpupt_torch.scene.data import MAT_LIGHT
from tpupt_torch.scenes import cornell_box_scene

from chip_smoke import random_mesh_scene
from test_torch_cuda import _mesh_scene, recorded_kernel_outputs


def _cam(width=8, depth=4, spp=4):
    return Camera(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=depth,
        vfov=40.0, look_from=(0.0, 1.0, 3.0), look_at=(0.0, 1.0, 0.0),
        blur_strength=0.5, focal_length=3.0, defocus_angle=0.0,
    )


def _box_scene(albedo=(0.73, 0.6, 0.5), emit=(6.0, 5.0, 4.0), env=(0.0, 0.0, 0.0)):
    """Diffuse floor + sphere + quad area light overhead (tests/test_grad.py's scene)."""
    s = Scene()
    floor = Diffuse(albedo)
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), floor)
    s.add_sphere(0.7, (0.0, 0.7, 0.0), floor)
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light(emit), light=True)
    s.environment = env
    return s


def _lanes(camera, spp):
    w = camera.image_width
    npix = w * camera.image_height
    pix = torch.arange(npix, dtype=torch.int32).repeat_interleave(spp)
    samp = torch.arange(spp, dtype=torch.int32).repeat(npix)
    return pix, pix // w, pix % w, samp


def test_scan_matches_forward():
    compiled = _box_scene(env=(0.4, 0.5, 0.6)).compile(device="cpu")
    cam = _cam(width=8, depth=12)
    c = cam.init("cpu")
    pix, rows, cols, samp = _lanes(cam, 2)
    ref, rays = trace_radiance(compiled.data, c, pix, rows, cols, samp, 3, 12, True)
    got, rays_scan = D.trace_radiance_scan(compiled.data, c, pix, rows, cols, samp, 3, 12, True, with_rays=True)
    assert rays_scan == rays
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    # no segment gate: the same radiance
    np.testing.assert_array_equal(
        D.trace_radiance_scan(compiled.data, c, pix, rows, cols, samp, 3, 12, True, segment_size=0).numpy(),
        ref.numpy(),
    )
    sample0 = torch.zeros_like(pix)
    film, rays_f, _ = trace_film_streamed(compiled.data, c, pix, rows, cols, sample0, 4, 3, 4, 12, True)
    stats = {}
    film_scan, rays_fs = D.trace_film_scan(
        compiled.data, c, pix, rows, cols, sample0, 4, 3, 4, 12, True, with_rays=True, stats=stats
    )
    assert rays_fs == rays_f and stats["trips"] % D.SEGMENT == 0 and stats["trips"] <= 4 * 12 + D.SEGMENT
    np.testing.assert_array_equal(film_scan.numpy(), film.numpy())


def _fd_check(scene_fn, field, idx, h, rtol, atol=1e-4, depth=4, spp=4, width=6, cam=None):
    """Central difference of d(sum image)/d(theta) for one scalar coordinate."""
    cam = cam or _cam(width=width, depth=depth)
    compiled = scene_fn().compile(device="cpu")
    fn = D.make_pixel_fn(compiled, cam)
    args = (*_lanes(cam, spp), 0)
    params = {n: v.detach().clone().requires_grad_(True) for n, v in D.init_params(compiled.data).items()}
    g = torch.autograd.grad(fn(params, *args).sum(), params[field])[0][idx].item()

    def at(v):
        p = {n: t.detach().clone() for n, t in params.items()}
        p[field][idx] = v
        with torch.no_grad():
            return fn(p, *args).double().sum().item()

    v0 = params[field][idx].item()
    fd = (at(v0 + h) - at(v0 - h)) / (2.0 * h)
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=atol)
    return g, fd


def _light_tex(sd):
    (light_ids,) = np.nonzero(sd.mat_type.numpy() == MAT_LIGHT)
    return int(sd.mat_tex.numpy()[light_ids[0]])


def test_grad_emission_linear():
    tex = _light_tex(_box_scene().compile(device="cpu").data)
    g, _ = _fd_check(_box_scene, "tex_rgb", (tex, 1), h=0.5, rtol=1e-3)
    assert g > 0.0


def test_grad_albedo_polynomial():
    g, _ = _fd_check(_box_scene, "tex_rgb", (0, 0), h=5e-3, rtol=2e-2)
    assert g > 0.0


def test_grad_env_color_linear():
    g, _ = _fd_check(lambda: _box_scene(env=(0.4, 0.5, 0.6)), "env_color", (2,), h=0.1, rtol=1e-3)
    assert g > 0.0


def test_grad_zero_for_absent_channel():
    """A black pixel block (light off) has zero gradient w.r.t. albedo."""
    compiled = _box_scene(emit=(0.0, 0.0, 0.0)).compile(device="cpu")
    radiance, grads = D.render_grads(compiled, _cam(), np.arange(4, dtype=np.int32), spp=2, seed=0)
    assert float(grads["tex_rgb"][0].abs().sum()) == 0.0
    assert float(radiance.max()) == 0.0


def _texture(h=16, w=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3)).astype(np.uint8)


def test_grad_image_texture_texel():
    """Atlas texels are differentiable: the nearest-texel gather's scatter-add gives
    per-texel gradients, and radiance is linear in the hit texel's albedo here."""

    def scene():
        s = Scene()
        s.add_sphere(1.0, (0.0, 0.0, -3.0), Diffuse(ImageTexture(_texture())))
        s.environment = (1.0, 1.0, 1.0)
        return s

    cam = Camera(aspect_ratio=1.0, image_width=6, samples_per_pixel=4, max_depth=3, vfov=40.0,
                 look_from=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0), blur_strength=0.5,
                 focal_length=3.0, defocus_angle=0.0)
    compiled = scene().compile(device="cpu")
    _, grads = D.render_grads(compiled, cam, np.arange(36, dtype=np.int32), spp=4)
    g = grads["atlas"].numpy()
    assert (g != 0).any(), "no gradient reached the atlas"
    ti = int(np.abs(g[:, 0]).argmax())
    _fd_check(scene, "atlas", (ti, 0), h=0.25, rtol=2e-3, atol=1e-5, cam=cam)


def test_env_img_grads_flow():
    rng = np.random.default_rng(0)
    img = rng.uniform(0.05, 4.0, size=(8, 16, 3)).astype(np.float32)
    img[2, 5] = 80.0
    s = Scene()
    s.add_sphere(1.0, (0.0, 0.0, -3.0), Diffuse((1.0, 1.0, 1.0)))
    s.environment = ImageTexture(img, hdr=True)
    compiled = s.compile(device="cpu")
    cam = Camera(aspect_ratio=1.0, image_width=6, samples_per_pixel=4, max_depth=4, vfov=30.0,
                 look_from=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0), blur_strength=0.5,
                 focal_length=3.0, defocus_angle=0.0)
    _, grads = D.render_grads(compiled, cam, np.arange(8, dtype=np.int32), spp=4)
    g = grads["env_img"]
    assert g.shape == compiled.data.env_img.shape
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0
    mean, grads_f = D.render_film_grads(compiled, cam, spp=4)
    assert bool(torch.isfinite(mean).all()) and all(bool(torch.isfinite(v).all()) for v in grads_f.values())


def test_env_map_scene_grads_finite(monkeypatch, tmp_path):
    """The lights_hdr scene (a near-mirror sphere under an HDR sky with a hot texel, the
    env as the only light member): film and every gradient finite, env_img reached."""
    from tpupt_torch.scenes import environment_map_scene

    img = np.random.default_rng(0).uniform(0.05, 3.0, size=(64, 128, 3)).astype(np.float32)
    img[10, 40] = 500.0
    monkeypatch.setenv("TPUPT_ASSETS", str(tmp_path))
    scene, cam = environment_map_scene(32, 4, hdr_env=True)
    scene.environment = ImageTexture(img, hdr=True)
    mean, grads = D.render_film_grads(scene.compile(device="cpu"), cam)
    assert bool(torch.isfinite(mean).all()) and all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["env_img"].abs().sum()) > 0.0


@pytest.mark.parametrize("which", ["cornell", "two_level"])
def test_film_grads_match_render_grads(which):
    """The regenerating scan (render_film_grads) against the masked scan (render_grads):
    same estimator and RNG stream, different scheduling. two_level: 60000 triangles, the
    two-level cluster route (K3's plain version here)."""
    if which == "cornell":
        scene, cam = cornell_box_scene(8, 4)
        cam.max_depth = 12
    else:
        scene, cam = random_mesh_scene(8, 4)
    compiled = scene.compile(device="cpu")
    assert compiled.data.has_tri_clusters_hbm == (which == "two_level")
    ids = np.arange(cam.image_width * cam.image_height, dtype=np.int32)
    rad1, g1, rays1 = D.render_grads(compiled, cam, ids, spp=4, seed=0, return_stats=True)
    mean2, g2, st = D.render_film_grads(compiled, cam, spp=4, seed=0, replicas=2, return_stats=True)
    assert rays1 == st.rays and st.lanes == 2 * len(ids) and st.trips > 0
    assert st.launches_forward == st.launches_backward == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}  # plain on the CPU
    np.testing.assert_allclose(mean2.reshape(-1, 3).numpy(), rad1.numpy(), rtol=1e-5, atol=1e-6)
    for k in g1:
        assert bool(torch.isfinite(g2[k]).all()), k
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=2e-4, atol=1e-5, err_msg=k)
    assert float(g1["tex_rgb"].abs().sum()) > 0.0
    assert which == "two_level" or float(g1["mat_params"].abs().sum()) > 0.0


def test_segmented_vjp_matches_autograd():
    compiled = _box_scene(env=(0.4, 0.5, 0.6)).compile(device="cpu")
    cam = _cam(width=6, depth=12)
    c = cam.init("cpu")
    pix, rows, cols, samp = _lanes(cam, 2)
    cot = torch.from_numpy(np.random.default_rng(1).uniform(size=(pix.shape[0], 3)).astype(np.float32))
    params = D.init_params(compiled.data)
    rad, grads = D.segmented_film_vjp(params, compiled.data, c, pix, rows, cols, samp, 0, 12, True, cot,
                                      segment_size=4)
    leaves = {n: v.detach().clone().requires_grad_(True) for n, v in params.items()}
    ref = D.trace_radiance_scan(D.apply_params(compiled.data, leaves), c, pix, rows, cols, samp, 0, 12, True)
    got = torch.autograd.grad((ref * cot).sum(), list(leaves.values()), allow_unused=True)
    np.testing.assert_array_equal(rad.numpy(), ref.detach().numpy())
    for (n, g_ref) in zip(leaves, got):
        g_ref = torch.zeros_like(leaves[n]) if g_ref is None else g_ref
        np.testing.assert_allclose(grads[n].numpy(), g_ref.numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
    assert float(grads["env_color"].abs().sum()) > 0.0


def _jgrad(f, x):
    return np.asarray(jax.grad(lambda v: jnp.sum(f(v)))(jnp.asarray(x)))


def _tgrad(f, x):
    t = torch.tensor(x, requires_grad=True)
    f(t).sum().backward()
    return t.grad.numpy()


@pytest.mark.parametrize("case", ["clip", "clamp_min", "schlick", "ggx_D"])
def test_clamp_tie_gradient_matches_reference(case):
    """At a clamp's bound the reference (jnp.clip, jnp.maximum) passes half the
    gradient; torch.clamp would pass all of it. The port's clip and clamp_min
    follow the reference, at the tie and away from it."""
    if case == "clip":
        x = np.array([-0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
        tg, jg = _tgrad(lambda v: LA.clip(v, 0.0, 1.0), x), _jgrad(lambda v: jnp.clip(v, 0.0, 1.0), x)
        np.testing.assert_array_equal(tg, [0.0, 0.5, 1.0, 0.5, 0.0])
    elif case == "clamp_min":
        x = np.array([0.001, 0.5, 1e-4], np.float32)
        tg = _tgrad(lambda v: LA.clamp_min(v, float(np.float32(0.001))), x)
        jg = _jgrad(lambda v: jnp.maximum(v, np.float32(0.001)), x)
        assert tg[0] == 0.5
    elif case == "schlick":  # pow5(clip(1 - x, 0, 1)) at x = 0 and x = 1
        x = np.array([0.0, 0.3, 1.0], np.float32)
        tg, jg = _tgrad(S.schlick_weight, x), _jgrad(JS.schlick_weight, x)
    else:  # ggx_D with roughness^2 at the 1e-3 floor, through the component form
        r = np.array([np.sqrt(np.float32(0.001)), 0.3], np.float32)
        h = (np.full(2, 0.3, np.float32), np.full(2, 0.2, np.float32), np.full(2, 0.9, np.float32))
        tg = _tgrad(lambda v: S.ggx_D(tuple(torch.from_numpy(c) for c in h), v), r)
        jg = _jgrad(lambda v: JS.ggx_D(tuple(jnp.asarray(c) for c in h), v), r)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=0.0)


def test_kernels_take_no_gradient():
    sd = _box_scene().compile(device="cpu").data
    sph, quad = hit_kernel.tables(sd)
    o = torch.zeros((4, 3), requires_grad=True)
    d = torch.tensor([[0.0, -1.0, 0.0]] * 4, requires_grad=True)
    tm = torch.zeros(4)
    t, kind, idx = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    assert t.grad_fn is None and not t.requires_grad
    with pytest.raises(ValueError, match="no gradient"):
        hit_kernel.closest_sphere_quad(o, d, tm, sph.clone().requires_grad_(True), quad)
    rng = np.random.default_rng(0)
    s = Scene()
    mesh = dict(positions=rng.normal(size=(200, 3)), normals=None, uvs=None, indices=rng.integers(0, 200, (64, 3)))
    s.add_mesh(mesh, Diffuse((0.5, 0.5, 0.5)))
    msd = s.compile(device="cpu").data
    assert msd.has_tri_clusters
    t_in = torch.full((4,), 3e38)
    t, _, aux = tri_kernel.closest_tri(msd, o, d, t_in, 1e-3)
    assert t.grad_fn is None and aux["ns_raw"].grad_fn is None
    with pytest.raises(ValueError, match="no gradient"):
        tri_kernel.closest_tri_flat(o, d, t_in, 1e-3, msd.tri_scl, msd.tri_cl,
                                    msd.tri_geo.clone().requires_grad_(True), msd.tri_attr)


@pytest.mark.parametrize("which", ["K1", "K2", "K3"])
def test_checkpoint_replay_sees_the_same_hits(monkeypatch, which):
    """The backward pass replays every forward trip once (non-reentrant checkpoint),
    newest first, and the replayed intersection returns the forward trip's bits."""
    if which == "K1":
        scene, cam = cornell_box_scene(8, 4)
        cam.max_depth = 12
        spy = dict(module=hit_kernel, name="closest_sphere_quad")
    else:
        scene, cam = _mesh_scene(8, 4) if which == "K2" else random_mesh_scene(8, 4)
        spy = dict(module=tri_kernel, name="closest_tri")
    fwd, replay, st = recorded_kernel_outputs(monkeypatch, scene.compile(device="cpu"), cam, **spy)
    assert len(fwd) == len(replay) == st.trips > 0
    for a, b in zip(fwd, replay):
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
