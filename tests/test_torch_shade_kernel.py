"""The wavefront iteration's two kernels (``csrc/wavefront.cu``, ``ops/wavefront_kernel.py``).

On the card, ``StreamStages.step`` runs the regeneration kernel, the hit kernels and the
shading kernel; its plain version is ``_stream_step``, which the CPU keeps. The card tests
hold one fused iteration against ``_stream_step`` on the same state, every field bit for bit,
over the scenes and routes the kernels serve (spheres and quads through K1 alone; the
triangle routes K2, K3, K4 and the dense sweep; solid, checker and image textures, normal
maps, the constant, image and HDR environments, sphere and quad lights, the HDR map as a light
member beside them or alone), and whole
renders against ``plain_launches()`` at the benchmark's limits. They skip without a card and
import neither jax nor the reference package:

    python -m pytest tests/test_torch_shade_kernel.py -q --noconftest

The CPU tests hold the routing: the CPU's stage runner stays on ``_stream_step``, and a
scene without triangles skips the triangle route.
"""

import os
import shutil

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import numpy as np
import pytest
import torch

from ptbench.core.compare import film_numbers
from tpupt_torch.ops import wavefront_kernel
from tpupt_torch.render import integrator as I
from tpupt_torch.render.camera import Camera
from tpupt_torch.render.renderer import plain_launches, render_image
from tpupt_torch.scene.builder import (CheckerTexture, Diffuse, Glass, ImageTexture, Light, Metal, Principled, Scene,
                                       SolidTexture)
from tpupt_torch import scenes

from chip_smoke import FIXTURE_DIR, FIXTURES, random_mesh_scene, small_mesh_scene, write_stand_in_assets

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def asset_dir(tmp_path_factory):
    """The image fixtures and the stand-in meshes and sky under the names the scenes read."""
    root = str(tmp_path_factory.mktemp("assets"))
    for name in FIXTURES:
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        shutil.copy(os.path.join(FIXTURE_DIR, name), os.path.join(root, name))
    write_stand_in_assets(root)
    return root


def lights_scene(width, spp):
    """A sphere light and a quad light over a checker floor, with a moving diffuse sphere, a
    rough metal, a glass sphere and two Principled spheres (clear coat; transmission):
    sphere-light sampling and pdfs, every family and every Principled lobe."""
    s = Scene()
    floor = CheckerTexture(0.7, SolidTexture((0.8, 0.8, 0.8)), SolidTexture((0.2, 0.3, 0.1)))
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), Diffuse(floor))
    s.add_sphere(0.5, (-1.5, 0.5, 0.0), Diffuse((0.7, 0.2, 0.2)), center2=(-1.5, 0.8, 0.0))
    s.add_sphere(0.5, (-0.5, 0.5, 0.8), Metal((0.9, 0.8, 0.6), 0.3))
    s.add_sphere(0.5, (0.5, 0.5, 0.0), Glass(ior=1.5, roughness=0.05))
    s.add_sphere(0.5, (1.5, 0.5, 0.8), Principled((0.3, 0.5, 0.8), metallic=0.2, roughness=0.35,
                                                  clearcoat=0.8, clearcoat_gloss=0.6, sheen=0.5, subsurface=0.3))
    s.add_sphere(0.4, (0.0, 0.4, -1.2), Principled((0.9, 0.9, 0.9), spec_trans=0.7, roughness=0.15))
    s.add_sphere(0.3, (1.0, 2.5, 1.0), Light((8.0, 7.0, 6.0)), light=True)
    s.add_quad((-1.0, 3.0, -1.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), Light((5.0, 5.0, 5.0)), light=True)
    s.environment = (0.05, 0.05, 0.08)
    cam = Camera(aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=12, vfov=45.0,
                 look_from=(0.0, 2.0, 5.0), look_at=(0.0, 0.5, 0.0), blur_strength=0.5,
                 focal_length=5.0, defocus_angle=0.5)
    return s, cam


def lights_hdr_scene(width, spp):
    """lights_scene under the stand-in HDR sky: the environment a light member beside a sphere
    light and a quad light."""
    s, cam = lights_scene(width, spp)
    s.environment = ImageTexture(os.path.join(os.environ["TPUPT_ASSETS"], "grace_probe_latlong.hdr"), hdr=True)
    return s, cam


# case: (scene builder, Scene.compile's bvh, the route it takes)
CASES = {
    "cornell": (scenes.cornell_box_scene, None),  # scene 3: K1, a quad light, Principled
    "balls": (scenes.balls_scene, None),  # scene 1: 486 spheres, motion blur, checker, defocus
    "earth": (scenes.earth_scene, None),  # scene 2: an image texture
    "envmap": (scenes.environment_map_scene, None),  # scene 4: the LDR image environment
    "envmap_hdr": (lambda w, spp: scenes.environment_map_scene(w, spp, hdr_env=True), None),  # the HDR map alone
    "lights_hdr": (lights_hdr_scene, None),  # the HDR map beside geometry lights
    "bsdf": (scenes.bsdf_demo_scene, None),  # scene 5
    "normal": (scenes.normal_demo_scene, None),  # scene 7: brick normal map, glass
    "lights": (lights_scene, None),  # a sphere light and a quad light, every lobe
    "scene6_K2": (scenes.everything_scene, None),  # the scene-6 stand-in on the flat clusters
    "K3": (random_mesh_scene, None),  # 60000 triangles on the two-level clusters
    "scene6_K4": (scenes.everything_scene, True),  # the BVH
    "sweep": (small_mesh_scene, False),  # the dense sweep: attributes gathered from the tables
}


def _stages(case, dev, asset_dir, monkeypatch, width=48, spp=4, k=2, r=2, depth=None):
    monkeypatch.setenv("TPUPT_ASSETS", asset_dir)
    build, bvh = CASES[case]
    scene, cam = build(width, spp)
    compiled = scene.compile(device=dev, bvh=bvh)
    depth = depth or cam.max_depth
    c = cam.init(dev)
    w, h = cam.image_width, cam.image_height
    pix = torch.arange(w * h, dtype=torch.int32, device=dev).repeat(r)
    sample0 = torch.from_numpy(np.repeat(np.arange(r) * k, w * h).astype(np.int32)).to(dev)
    st = I.StreamStages(compiled.data, c, pix.shape[0], r * k, k, depth, compiled.has_lights, dev)
    st.set_inputs(pix, pix // w, pix % w, sample0, 3_000_000_017, c)
    st.reset()
    return st, compiled, cam


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("case", list(CASES))
def test_fused_iteration_bit_equal_to_plain(cuda, case, asset_dir, monkeypatch):
    """From the same state, one iteration by the two kernels (and the hit kernels between
    them) and one by _stream_step give the same state, every field bit for bit, and the same
    rays; iteration after iteration, each from the plain route's state, until no lane has
    work."""
    st, _, _ = _stages(case, cuda, asset_dir, monkeypatch)
    assert st.fused
    s = st.states[0]
    before = dict(wavefront_kernel.launches)
    iterations = 0
    while int(loop_work(st, s)) and iterations < 64:
        plain = {key: v.clone() for key, v in s.items()}
        fused = {key: v.clone() for key, v in s.items()}
        rays0 = int(st.rays)
        st.fused = False
        st.states[0] = plain
        st.step(0)
        rays_plain = int(st.rays) - rays0
        st.fused = True
        st.states[0] = fused
        st.step(0)
        rays_fused = int(st.rays) - rays0 - rays_plain
        off = {key: float((_bits(plain[key]) != _bits(fused[key])).reshape(s[key].shape[0], -1).any(1).float().mean())
               for key in I.STEP_KEYS}
        assert rays_fused == rays_plain and not any(off.values()), (iterations, off)
        s = plain
        iterations += 1
    assert iterations > 3
    assert {key: wavefront_kernel.launches[key] - before[key] for key in before} == {"regen": iterations,
                                                                                      "shade": iterations}


def loop_work(st, s):
    return (s["alive"] | ((s["sample"] < st.k) & ((s["sample0"] + s["sample"]) < st.spp_limit))).sum()


@pytest.mark.parametrize("case", ["cornell", "balls", "normal", "lights", "lights_hdr", "scene6_K2", "scene6_K4"])
def test_render_matches_plain_launches(cuda, case, asset_dir, monkeypatch):
    """render_image on the card (graphs, the two kernels in every iteration) against the same
    render by plain_launches(): within the benchmark's limits (rel_l1 <= 1e-2, pixels_off <=
    3e-2), rays and iterations equal, every iteration fused, each kernel launched once an
    iteration."""
    monkeypatch.setenv("TPUPT_ASSETS", asset_dir)
    build, bvh = CASES[case]
    scene, cam = build(64, 8)
    compiled = scene.compile(device=cuda, bvh=bvh)
    before = dict(wavefront_kernel.launches)
    _, m_g, st_g = render_image(compiled, cam, seed=11, progress=False)
    launched = {key: wavefront_kernel.launches[key] - before[key] for key in before}
    with plain_launches():
        _, m_e, st_e = render_image(compiled, cam, seed=11, progress=False)
    numbers = film_numbers(m_g.reshape(-1, 3), m_e.reshape(-1, 3))
    print(f"{case}: rel_l1 {numbers['rel_l1']!r} pixels_off {numbers['pixels_off']!r}")
    assert numbers["rel_l1"] <= 1e-2 and numbers["pixels_off"] <= 3e-2
    assert (st_g.rays, st_g.iterations) == (st_e.rays, st_e.iterations)
    assert st_g.fused_iterations == st_g.iterations > 0 and st_e.fused_iterations == 0
    assert launched == {"regen": st_g.iterations, "shade": st_g.iterations}


def test_stage_body_is_a_few_kernel_nodes(cuda):
    """Under a recording, render.capture holds each stage body's node count: the Cornell
    box's iteration is the two kernels and K1, a handful of nodes."""
    from tpupt_torch import trace

    scene, cam = scenes.cornell_box_scene(64, 8)
    compiled = scene.compile(device=cuda)
    with trace.recording() as rec:
        render_image(compiled, cam, progress=False)
    (cap,) = [s for s in rec.named("render.capture") if "body_nodes" in s.attrs]
    print("body nodes", cap.attrs["body_nodes"])
    assert cap.attrs["body_nodes"] and max(cap.attrs["body_nodes"]) <= 8


# ---- CPU: the stage runner's route ----------------------------------------------------


def test_cpu_stage_runner_keeps_the_plain_route():
    """On the CPU StreamStages is not fused: its step is _stream_step (the runner equals
    trace_film_streamed), render_image counts no fused iteration, and the kernels' wrappers
    launch nothing."""
    scene, cam = scenes.cornell_box_scene(16, 4)
    cam.max_depth = 8
    compiled = scene.compile(device=CPU)
    c = cam.init(CPU)
    before = dict(wavefront_kernel.launches)
    pix = torch.arange(16 * 16, dtype=torch.int32).repeat(2)
    sample0 = torch.from_numpy(np.repeat(np.arange(2) * 2, 256).astype(np.int32))
    st = I.StreamStages(compiled.data, c, pix.shape[0], 4, 2, cam.max_depth, compiled.has_lights, CPU)
    assert not st.fused
    st.set_inputs(pix, pix // 16, pix % 16, sample0, 5, c)
    bank, rays, iters = st.run()
    film, rays_e, iters_e = I.trace_film_streamed(compiled.data, c, pix, pix // 16, pix % 16, sample0, 4, 5, 2,
                                                  cam.max_depth, compiled.has_lights)
    assert torch.equal(bank, film) and (rays, iters) == (rays_e, iters_e)
    _, _, stats = render_image(compiled, cam, progress=False)
    assert stats.fused_iterations == 0 < stats.iterations
    assert wavefront_kernel.launches == before


def test_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: no fallback to the plain route."""
    scene, cam = scenes.cornell_box_scene(8, 1)
    compiled = scene.compile(device=CPU)
    st = I.StreamStages(compiled.data, cam.init(CPU), 64, 1, 1, 4, compiled.has_lights, CPU)
    with pytest.raises(ValueError, match="unsupported device"):
        wavefront_kernel.regenerate(st.states[0], st.cam, st.seed, 1, 1, st.rays)


# ---- CPU: the scenes without a triangle skip the triangle route ------------------------


@pytest.mark.parametrize("case", ["cornell", "balls", "earth", "bsdf", "normal", "scene6_K2", "sweep"])
def test_has_real_tris_follows_the_triangle_table(case, asset_dir, monkeypatch):
    """Scene.compile records whether the triangle table holds a scene triangle: exactly where
    a row has a nonzero edge (the pad row of a scene without triangles has none)."""
    monkeypatch.setenv("TPUPT_ASSETS", asset_dir)
    build, bvh = CASES[case]
    sd = build(8, 1)[0].compile(device=CPU, bvh=bvh).data
    assert sd.has_real_tris == bool(((sd.tri_e1 != 0) | (sd.tri_e2 != 0)).any())
    assert sd.has_real_tris == (case in ("scene6_K2", "sweep"))


@pytest.mark.parametrize("case", ["cornell", "balls"])
def test_closest_hit_without_triangles_equals_the_pad_sweep(case, asset_dir, monkeypatch):
    """closest_hit on a scene without triangles skips the triangle route; the hit record is
    bit for bit the one the dense sweep over the pad row gives, on every lane."""
    import dataclasses

    from tpupt_torch.ops import intersect

    monkeypatch.setenv("TPUPT_ASSETS", asset_dir)
    sd = CASES[case][0](8, 1)[0].compile(device=CPU).data
    assert not sd.has_real_tris
    lo, hi = (0.0, 555.0) if case == "cornell" else (-12.0, 12.0)
    gen = torch.Generator().manual_seed(7)
    o = lo + (hi - lo) * torch.rand((1 << 14, 3), generator=gen)
    d = torch.nn.functional.normalize(torch.randn((1 << 14, 3), generator=gen), dim=1)
    tm = torch.rand(1 << 14, generator=gen)
    alive = torch.rand(1 << 14, generator=gen) < 0.8
    swept = dataclasses.replace(sd, has_real_tris=True)
    assert intersect.hit_kernels(sd, o, d, tm, 1e-3, I.T_MAX, alive)[3] is None
    got, want = (intersect.closest_hit(x, o, d, tm, 1e-3, I.T_MAX, alive=alive) for x in (sd, swept))
    assert got.valid.any() and not got.valid.all()
    for f in dataclasses.fields(got):
        assert torch.equal(_bits(getattr(got, f.name)), _bits(getattr(want, f.name))), f.name
