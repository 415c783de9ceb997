"""The benchmark's `balls` configuration (scene 1 of the Rust reference, bouncing balls) on
the CPU, and the counts of K1's tile cull.

- ``ptbench/configs/balls.json`` built through the benchmark's builder compiles to the
  same tables as ``tpupt_torch.scenes.balls_scene(600, 100)``, and gives the same camera.
- ``render_image`` on the CPU agrees with the benchmark's plain reference on balls cut
  to 16x9 px, 2 spp and max_depth 8, by the check and the limits of the cell
  ``balls.fast``; its RenderStats carry the cull's counts, which the stage runner
  counts alike.
- K1's plain version counts what the kernel's culled variant counts (lanes, tile slots,
  tiles entered, tiles swept by warps of 32 consecutive rays) as a brute-force numpy
  count of box entries gives them, with lanes that may not cull and a short last warp.
"""

import dataclasses
import json
import os

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import numpy as np
import pytest
import torch

from ptbench import reference
from ptbench.core import compare
from ptbench.core.scenes import build_scene, camera
from tpupt_torch import trace
from tpupt_torch.ops import hit_kernel as HK
from tpupt_torch.render import integrator as I
from tpupt_torch.render import renderer as R
from tpupt_torch.render.renderer import render_image
from tpupt_torch.scene.compile import compile_numpy
from tpupt_torch.scenes import balls_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(image_width=16, samples_per_pixel=2, max_depth=8)


def _json(*parts):
    with open(os.path.join(ROOT, "ptbench", *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cfg():
    return _json("configs", "balls.json")


@pytest.fixture(scope="module")
def compiled(cfg):
    return build_scene(cfg, "").compile(device="cpu")


def test_config_compiles_to_the_scene_of_balls_scene(cfg):
    scene, cam = balls_scene(600, 100)
    fields, static, lights = compile_numpy(scene)
    fields_c, static_c, lights_c = compile_numpy(build_scene(cfg, ""))
    assert fields.keys() == fields_c.keys() and static == static_c and lights == lights_c
    for key, val in fields.items():
        assert np.array_equal(np.asarray(val), np.asarray(fields_c[key])), key
    assert camera(cfg) == cam
    kinds = [cfg["materials"][o["material"]]["type"] for o in cfg["objects"]]
    assert len(kinds) == 486 and kinds.count("diffuse") == 393 and kinds.count("metal") == 69
    assert kinds.count("glass") == 24 and sum("center2" in o for o in cfg["objects"]) == 391
    assert cfg["reduced"] == [] and (cam.image_width, cam.image_height) == (600, 337)


@pytest.mark.parametrize("seed", [2**31 + 11, 977])
def test_render_agrees_with_the_reference(cfg, compiled, seed):
    cam = camera(cfg, **CUT)
    with trace.recording() as rec:
        _, mean, stats = render_image(compiled, cam, seed=seed, progress=False)
    ids = np.arange(cam.image_width * cam.image_height)
    want = reference.render_means(cfg, "", torch.device("cpu"), [(seed, CUT, ids)])[0]
    numbers = compare.film_numbers(mean.reshape(-1, 3)[ids], want)
    ok, _ = compare.judge(numbers, _json("workloads", "balls.fast.json")["limits"])
    assert ok, numbers

    # the cull's counts: every lane of every iteration over the table's 61 tiles
    assert stats.k1_lanes == stats.lane_slots > 0 and stats.k1_tile_slots == 61 * stats.k1_lanes
    assert 0 < stats.k1_tiles_entered <= stats.k1_tiles_swept <= stats.k1_tile_slots
    (span,) = [s for s in rec.spans if s.name == "render"]
    assert {k: span.attrs[k] for k in HK.K1_COUNTS} == {k: getattr(stats, k) for k in HK.K1_COUNTS}

    # the stage runner that the card's graphs capture counts the same, on the same lanes (the
    # pixels in render_image's order: a warp's lanes are 32 consecutive lanes of the launch)
    sd = compiled.data
    pix = torch.from_numpy(R._morton_pixel_order(cam.image_width, cam.image_height))
    st = I.StreamStages(sd, cam.init("cpu"), pix.shape[0], 2, 2, cam.max_depth, compiled.has_lights, "cpu")
    st.set_inputs(pix, pix // cam.image_width, pix % cam.image_width, torch.zeros_like(pix), seed)
    st.run()
    assert dict(zip(HK.K1_COUNTS, st.k1_counts.tolist())) == {k: getattr(stats, k) for k in HK.K1_COUNTS}


def _rays(cfg, n=1000, seed=5):
    """n balls rays: camera rays of consecutive pixels, then rays from random points in
    random directions; about one in ten may not cull (time outside [0,1], or |d|^2 off 1)."""
    from tpupt_torch.render.camera import generate_rays

    rng = np.random.default_rng(seed)
    cam = camera(cfg)
    pix = torch.arange(20000, 20000 + n // 2, dtype=torch.int32)
    o_c, d_c, t_c = generate_rays(cam.init("cpu"), pix // cam.image_width, pix % cam.image_width, pix,
                                  torch.zeros_like(pix), 7)
    m = n - n // 2
    o_r = rng.uniform([-12.0, 0.05, -12.0], [12.0, 3.0, 12.0], size=(m, 3))
    d_r = rng.normal(size=(m, 3))
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o = torch.cat([o_c, torch.from_numpy(o_r).float()])
    d = torch.cat([d_c, torch.from_numpy(d_r).float()])
    tm = torch.cat([t_c, torch.from_numpy(rng.uniform(0.0, 1.0, m)).float()])
    odd = rng.random(n)
    tm = torch.where(torch.from_numpy(odd < 0.05), torch.from_numpy(rng.choice([-0.25, 1.5], n)).float(), tm)
    d = torch.where(torch.from_numpy((odd >= 0.05) & (odd < 0.1))[:, None], d * 1.01, d)
    return o.contiguous(), d.contiguous(), tm.contiguous()


def _numpy_counts(o, d, tm, boxes, tiles):
    """K1_COUNTS by brute force: every (ray, tile) box test in float32, warps of 32 rays."""
    f = np.float32
    o, d, tm, boxes = (np.asarray(x, dtype=f) for x in (o, d, tm, boxes[:tiles]))
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    inv = [f(1) / np.where(np.abs(c) < f(1e-20), np.where(c < 0, f(-1e-20), f(1e-20)), c) for c in (dx, dy, dz)]
    may_cull = ((tm[:, None] >= 0) & (tm[:, None] <= 1)
                & (np.abs(dx * dx + dy * dy + dz * dz - f(1)) <= f(HK.CULL_DIR))
                & (np.abs(ox) + np.abs(oy) + np.abs(oz) < f(HK.CULL_ORIGIN)))
    lo, hi, ce, rad = boxes[None, :, 0:3], boxes[None, :, 4:7], boxes[None, :, 8:11], boxes[None, :, 11]
    m = f(HK.CULL_MARGIN) * (np.abs(ox - ce[..., 0]) + np.abs(oy - ce[..., 1]) + np.abs(oz - ce[..., 2]) + rad)
    near, far = [], []
    for axis, (oc, ic) in enumerate(zip((ox, oy, oz), inv)):
        t1, t2 = (lo[..., axis] - m - oc) * ic, (hi[..., axis] + m - oc) * ic
        near.append(np.minimum(t1, t2))
        far.append(np.maximum(t1, t2))
    tn = np.maximum(np.maximum(near[0], near[1]), near[2])
    tf = np.minimum(np.minimum(far[0], far[1]), far[2])
    enters = ~may_cull | ((tn <= tf) & (tf >= 0))  # [B, tiles]
    b = o.shape[0]
    swept = 0
    for w in range(0, b, 32):
        swept += int(enters[w : w + 32].any(axis=0).sum()) * min(32, b - w)
    return {"k1_lanes": b, "k1_tile_slots": b * tiles, "k1_tiles_entered": int(enters.sum()),
            "k1_tiles_swept": swept}, may_cull


def test_plain_counts_match_a_brute_force_count(cfg, compiled):
    o, d, tm = _rays(cfg)
    sph, quad = HK.tables(compiled.data)
    n_s, _ = HK.real_rows(sph, quad)
    tiles = -(-n_s // HK.CULL_TILE)
    assert o.shape[0] % 32 and tiles == 61
    want, may_cull = _numpy_counts(o, d, tm, HK.sphere_tile_boxes(sph).numpy(), tiles)
    assert 0 < (~may_cull).sum() < o.shape[0] // 4  # some lanes may not cull, most may
    got = {}
    out = HK.closest_sphere_quad_plain(o, d, tm, sph, quad, counts=got)
    assert {k: got[k] for k in HK.K1_COUNTS} == want
    assert want["k1_tiles_entered"] < want["k1_tiles_swept"] < want["k1_tile_slots"]

    # the wrapper adds the same counts into a tensor, call after call, and hits as without it
    acc = torch.zeros(len(HK.K1_COUNTS), dtype=torch.int64)
    for _ in range(2):
        again = HK.closest_sphere_quad(o, d, tm, sph, quad, counts=acc)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert acc.tolist() == [2 * want[k] for k in HK.K1_COUNTS]

    # a table of one tile is swept whole: nothing counted
    small = dataclasses.replace(compiled.data, **{f: getattr(compiled.data, f)[:5]
                                                 for f in ("sph_c1", "sph_c2", "sph_r", "sph_mat")})
    one = torch.zeros(len(HK.K1_COUNTS), dtype=torch.int64)
    HK.closest_sphere_quad(o, d, tm, *HK.tables(small), counts=one)
    assert one.tolist() == [0] * len(HK.K1_COUNTS)
