"""Tests of the port that need a CUDA card (the kernel has no CPU mode).

They skip without a GPU. This file imports neither jax nor the reference package,
so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: each kernel is bit-equal to its plain version (both round every
operation on its own); a small render on the card matches the same render on the
CPU on at least 95% of pixels within rtol 1e-3 / atol 1e-4, with image means
within 1% (the card's transcendentals differ from the CPU's by an ulp, which
flips a rare branch).
"""

import json

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import numpy as np
import pytest
import torch

from tpupt_torch.ops import bvh_kernel, hit_kernel, tri_kernel
from tpupt_torch.ops.bvh import build_tri_bvh, build_tri_bvh_sah, bvh_closest_tri_plain
from tpupt_torch.render.camera import Camera
from tpupt_torch.render.renderer import render_image
from tpupt_torch.scene.builder import Diffuse, Light, Scene
from tpupt_torch.scenes import balls_scene, cornell_box_scene

from chip_smoke import FIXTURE_DIR, FIXTURES, TWINS, grad_hdr_scene, random_mesh_scene, write_twin_assets


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rays(b, seed, lo, hi, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(size=b).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (o, d, t))


def _random_tables(n_sph, n_quad, seed, dev, real_sph=True, real_quad=True):
    """Tables in the reference layout of n_sph moving spheres and n_quad quads scattered in
    [-10, 10]^3, every 7th row a pad (r = -1, a zero quad); real_sph / real_quad False
    makes every row of that table a pad."""
    rng = np.random.default_rng(seed)
    c1 = rng.uniform(-10, 10, size=(3, n_sph))
    c2 = c1 + rng.normal(size=(3, n_sph)) * (rng.uniform(size=n_sph) < 0.5)
    r = rng.uniform(0.2, 1.5, size=(1, n_sph))
    r[:, ::7] = -1.0
    if not real_sph:
        r[:] = -1.0
    q = rng.uniform(-10, 10, size=(3, n_quad))
    u, v = rng.normal(size=(2, 3, n_quad)) * 2.0
    n = np.cross(u, v, axis=0)
    n_len2 = (n * n).sum(axis=0, keepdims=True)
    normal, w = n / np.sqrt(n_len2), n / n_len2
    quad = np.concatenate([normal, q, u, v, w, (normal * q).sum(axis=0, keepdims=True)], axis=0)
    quad[:, ::7] = 0.0
    if not real_quad:
        quad[:] = 0.0
    sph = np.concatenate([c1, c2, r], axis=0)
    return tuple(torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(dev) for a in (sph, quad))


def _k1_tables(which, dev):
    """(sph, quad, lo, hi): one of K1's table shapes and the box its random rays start in."""
    if which in ("cornell", "balls"):
        build, lo, hi = {"cornell": (cornell_box_scene, 0.0, 555.0), "balls": (balls_scene, -12.0, 12.0)}[which]
        return (*hit_kernel.tables(build(16, 4)[0].compile(device=dev).data), lo, hi)
    shape = {"1000x700": (1000, 700, True, True),  # more than one staged tile of each
             "8x0-real": (8, 8, True, False), "0-realx24": (8, 24, False, True)}[which]
    return (*_random_tables(shape[0], shape[1], 40, dev, shape[2], shape[3]), -12.0, 12.0)


K1_TABLES = ["cornell", "balls", "1000x700", "8x0-real", "0-realx24"]
SPARSE = ("8x0-real", "0-realx24")  # few primitives in a wide box: few rays hit


def _assert_k1_bit_equal(o, d, tm, sph, quad):
    """One launch of K1 against its plain version -> the plain version's (t, kind, idx)."""
    before = hit_kernel.launches
    got = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    want = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    torch.cuda.synchronize()
    assert hit_kernel.launches == before + (1 if o.shape[0] else 0)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    return want


@pytest.mark.parametrize("b", [0, 1, 31, 33, 255, 257, 100_003, 2**20 + 1])
@pytest.mark.parametrize("which", K1_TABLES)
def test_kernel_bit_equal_to_plain(cuda, which, b):
    """Random rays, batch sizes around the ragged ends of a warp's and a block's runs."""
    sph, quad, lo, hi = _k1_tables(which, cuda)
    o, d, tm = _rays(b, 11, lo, hi, cuda)
    want = _assert_k1_bit_equal(o, d, tm, sph, quad)
    if b > 1000:
        assert (want[0] < 3e38).float().mean() > (0.002 if which in SPARSE else 0.1)
        assert which != "8x0-real" or not (want[1] == 1).any()
        assert which != "0-realx24" or (want[1][want[0] < 3e38] == 1).all()


@pytest.mark.parametrize("which", K1_TABLES)
def test_kernel_camera_and_bounce_rays(cuda, which):
    """Coherent rays (one eye, a 160 x 120 fan, one time per row of the fan) and the rays
    that leave their hit points in random directions of the normal's hemisphere."""
    sph, quad, lo, hi = _k1_tables(which, cuda)
    eye = {"cornell": (278.0, 278.0, -800.0), "balls": (13.0, 2.0, 3.0)}.get(which, (0.0, 3.0, 25.0))
    at = {"cornell": (278.0, 278.0, 0.0)}.get(which, (0.0, 0.0, 0.0))
    rng = np.random.default_rng(5)
    fwd = np.asarray(at) - np.asarray(eye)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, (0.0, 1.0, 0.0))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    x, y = np.meshgrid(np.linspace(-0.4, 0.4, 160), np.linspace(-0.3, 0.3, 120))
    d = fwd + x.reshape(-1, 1) * right + y.reshape(-1, 1) * up
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.asarray(eye), d.shape)
    tm = np.repeat(rng.uniform(size=120), 160)
    o, d, tm = (torch.from_numpy(np.ascontiguousarray(a.astype(np.float32))).to(cuda) for a in (o, d, tm))
    t, kind, idx = _assert_k1_bit_equal(o, d, tm, sph, quad)
    hit = t < 3e38
    assert hit.float().mean() > (0.002 if which in SPARSE else 0.2)
    # bounce: from the hit points, about the geometric normal of what was hit
    p = o + torch.where(hit, t, 0.0)[:, None] * d
    i_s, i_q = idx.long().clamp_max(sph.shape[1] - 1), idx.long().clamp_max(quad.shape[1] - 1)
    centre = sph[0:3, i_s].T + (sph[3:6, i_s] - sph[0:3, i_s]).T * tm[:, None]
    n = torch.where((kind == 0)[:, None], p - centre, quad[0:3, i_q].T)
    n = n / n.norm(dim=1, keepdim=True).clamp_min(1e-20)
    n = torch.where((n * d).sum(dim=1, keepdim=True) > 0, -n, n)
    nd = torch.from_numpy(rng.normal(size=d.shape).astype(np.float32)).to(cuda)
    nd = nd / nd.norm(dim=1, keepdim=True)
    nd = torch.where((nd * n).sum(dim=1, keepdim=True) < 0, -nd, nd)
    t2, _, _ = _assert_k1_bit_equal(p.contiguous(), nd.contiguous(), tm, sph, quad)
    assert which in SPARSE or (t2[hit] < 3e38).float().mean() > 0.02


def _balls_rays(which, sph, quad, dev):
    """Rays on the balls table: the camera's rays of a 600x337 frame at sample 0 in
    render_image's lane order (its lens and times), the rays that leave their hits in
    random directions of the normal's hemisphere, or 100,003 random rays of which one in
    ten of the first half may not cull (time outside [0,1]); a last warp of 11 rays in the
    bounce rays, of 3 in the random ones."""
    from tpupt_torch.render import renderer as R
    from tpupt_torch.render.camera import generate_rays

    cam = balls_scene(600, 100)[1]
    if which == "random":
        o, d, tm = _rays(100_003, 12, -12.0, 12.0, dev)
        lane = torch.arange(tm.shape[0], device=dev)
        tm = torch.where((lane % 10 == 3) & (lane < 50_000), 1.5, tm)
        return o, d, tm.contiguous()
    pix = torch.from_numpy(R._morton_pixel_order(cam.image_width, cam.image_height)).to(dev)
    o, d, tm = (x.contiguous() for x in generate_rays(cam.init(dev), pix // cam.image_width,
                                                       pix % cam.image_width, pix, torch.zeros_like(pix), 3))
    if which == "camera":
        return o, d, tm
    t, kind, idx = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    hit = t < 3e38
    p = o + torch.where(hit, t, 0.0)[:, None] * d
    i_s = idx.long().clamp_max(sph.shape[1] - 1)
    n = p - (sph[0:3, i_s].T + (sph[3:6, i_s] - sph[0:3, i_s]).T * tm[:, None])
    n = torch.where((n * d).sum(dim=1, keepdim=True) > 0, -n, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    nd = torch.randn(d.shape, generator=gen, device=dev)
    nd = nd / nd.norm(dim=1, keepdim=True)
    nd = torch.where((nd * n).sum(dim=1, keepdim=True) < 0, -nd, nd)
    keep = hit.nonzero()[:, 0][: 32 * (hit.sum().item() // 32) - 21]  # bounce rays only, a short warp last
    return p[keep].contiguous(), nd[keep].contiguous(), tm[keep].contiguous()


@pytest.mark.parametrize("which", ["camera", "bounce", "random"])
def test_kernel_counts_equal_plain(cuda, which):
    """K1's counts of its tile cull (the culled variant, given a counts buffer) equal its
    plain version's, summed over two launches; its hits are bit-equal to those of the launch
    without the buffer; a table of one tile counts nothing."""
    sph, quad, _, _ = _k1_tables("balls", cuda)
    o, d, tm = _balls_rays(which, sph, quad, cuda)
    want = {}
    hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad, counts=want)
    counts = torch.zeros(len(hit_kernel.K1_COUNTS), dtype=torch.int64, device=cuda)
    with_counts = [hit_kernel.closest_sphere_quad(o, d, tm, sph, quad, counts=counts) for _ in range(2)]
    bare = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    torch.cuda.synchronize()
    assert counts.tolist() == [2 * want[k] for k in hit_kernel.K1_COUNTS], (counts.tolist(), want)
    assert 0 < want["k1_tiles_entered"] < want["k1_tiles_swept"] < want["k1_tile_slots"]
    for got in with_counts:
        assert torch.equal(got[0].view(torch.int32), bare[0].view(torch.int32))
        assert torch.equal(got[1], bare[1]) and torch.equal(got[2], bare[2])
    c_sph, c_quad, _, _ = _k1_tables("cornell", cuda)
    none = torch.zeros_like(counts)
    hit_kernel.closest_sphere_quad(o, d, tm, c_sph, c_quad, counts=none)
    assert none.tolist() == [0] * len(hit_kernel.K1_COUNTS)


def test_render_counts_equal_the_kernels_calls(cuda, monkeypatch):
    """RenderStats' K1 counts of a balls render through the graphs equal those of the same
    render by the eager loop, and the plain version's counts of every K1 call of that loop
    summed."""
    from tpupt_torch.render import renderer as R

    scene, cam = balls_scene(64, 4)
    cam.max_depth = 12
    compiled = scene.compile(device=cuda)
    _, _, st_g = render_image(compiled, cam, seed=9, progress=False)
    real, summed = hit_kernel.closest_sphere_quad, dict.fromkeys(hit_kernel.K1_COUNTS, 0)

    def counted(o, d, time, sph, quad, tmin=1e-3, counts=None):
        mine = {}
        hit_kernel.closest_sphere_quad_plain(o, d, time, sph, quad, tmin, counts=mine)
        for key in summed:
            summed[key] += mine[key]
        return real(o, d, time, sph, quad, tmin, counts=counts)

    monkeypatch.setattr(hit_kernel, "closest_sphere_quad", counted)
    with R.plain_launches():
        _, _, st_e = render_image(compiled, cam, seed=9, progress=False)
    stats = [{key: getattr(st, key) for key in hit_kernel.K1_COUNTS} for st in (st_g, st_e)]
    assert stats[0] == stats[1] == summed
    assert st_g.k1_lanes == st_g.lane_slots and st_g.k1_tile_slots == 61 * st_g.k1_lanes
    assert 0 < st_g.k1_tiles_entered < st_g.k1_tiles_swept < st_g.k1_tile_slots


@pytest.mark.parametrize("which", K1_TABLES)
def test_kernel_edge_rays(cuda, which):
    """NaN and infinite components, times outside [0,1], directions that are not unit or
    lie along an axis, spread over a batch of ordinary rays so that they share warps."""
    sph, quad, lo, hi = _k1_tables(which, cuda)
    o, d, tm = _rays(20_011, 17, lo, hi, cuda)
    nan, inf = float("nan"), float("inf")
    for k, (what, col, val) in enumerate([
        (o, 0, nan), (o, 1, inf), (o, 2, -inf), (d, 0, nan), (d, 1, inf), (d, 2, -inf),
        (tm, None, nan), (tm, None, inf), (tm, None, -3.0), (tm, None, 2.5), (o, 0, 1e30), (o, 1, -3e38),
    ]):
        rows = torch.arange(100 + k, 20_000, 997, device=cuda)
        if col is None:
            what[rows] = val
        else:
            what[rows, col] = val
    d[5000:5040] *= torch.linspace(0.5, 2.0, 40, device=cuda)[:, None]
    d[6000:6006] = torch.tensor([[0.0, 0.0, 1.0], [0.0, -0.0, -1.0], [1.0, 0.0, 0.0], [-0.0, 1.0, 0.0],
                                 [0.0, 0.0, 0.0], [1e-30, -1.0, 0.0]], device=cuda)
    want = _assert_k1_bit_equal(o, d, tm, sph, quad)
    assert (want[0] < 3e38).float().mean() > (0.002 if which in SPARSE else 0.1)
    assert not torch.isnan(want[0]).any()  # a NaN t is a miss


def test_kernel_exact_ties(cuda):
    """Equal t: the lower index wins and a sphere beats a quad, whatever lane or run of
    a thread the ray falls into; a pad row between the winners changes nothing."""
    s = Scene()
    s.add_quad((-1.0, -1.0, 5.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), Diffuse((0.5, 0.5, 0.5)))
    s.add_quad((-1.0, -1.0, 5.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), Diffuse((0.5, 0.5, 0.5)))
    s.add_sphere(1.0, (0.0, 0.0, 6.0), Diffuse((0.5, 0.5, 0.5)))
    s.add_sphere(1.0, (0.0, 0.0, 6.0), Diffuse((0.5, 0.5, 0.5)))
    sph, quad = (x.clone() for x in hit_kernel.tables(s.compile(device=cuda).data))
    rays = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0, 1.0],  # sphere 0 and both quads at t = 5
                         [0.5, 0.5, 0.0, 0.0, 0.0, 1.0],  # both quads at t = 5, spheres behind them
                         [0.0, 0.0, 0.0, 0.0, 0.0, -1.0]], device=cuda).repeat(211, 1)  # a miss
    o, d, tm = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous(), torch.zeros(633, device=cuda)
    t, kind, idx = _assert_k1_bit_equal(o, d, tm, sph, quad)
    assert (t[0::3] == 5.0).all() and (kind[0::3] == 0).all() and (idx[0::3] == 0).all()
    assert (t[1::3] == 5.0).all() and (kind[1::3] == 1).all() and (idx[1::3] == 0).all()
    assert (t[2::3] == 3e38).all() and (kind[2::3] == 0).all() and (idx[2::3] == 0).all()
    sph[6, 0] = -1.0  # the first of the two spheres becomes a pad: the second wins the tie
    quad[:, 0] = 0.0
    t, kind, idx = _assert_k1_bit_equal(o, d, tm, sph, quad)
    assert (t[0::3] == 5.0).all() and (kind[0::3] == 0).all() and (idx[0::3] == 1).all()
    assert (t[1::3] == 5.0).all() and (kind[1::3] == 1).all() and (idx[1::3] == 1).all()


def test_kernel_follows_a_table_edited_in_place(cuda):
    """The packed tables kept with a table are made anew when it changes in place."""
    sph, quad, lo, hi = _k1_tables("1000x700", cuda)
    o, d, tm = _rays(10_000, 19, lo, hi, cuda)
    first = _assert_k1_bit_equal(o, d, tm, sph, quad)
    sph[6, :] = -1.0
    second = _assert_k1_bit_equal(o, d, tm, sph, quad)
    assert (first[1][first[0] < 3e38] == 0).any() and (second[1][second[0] < 3e38] == 1).all()


def test_kernel_rejects_mixed_devices(cuda):
    sd = cornell_box_scene(16, 4)[0].compile(device=cuda).data
    sph, quad = hit_kernel.tables(sd)
    o, d, tm = _rays(64, 1, 0.0, 555.0, cuda)
    with pytest.raises(ValueError, match="is on"):
        hit_kernel.closest_sphere_quad(o, d.cpu(), tm, sph, quad)


def test_small_render_matches_cpu(cuda):
    scene, cam = cornell_box_scene(32, 4)
    _, m_cpu, _ = render_image(scene.compile(device="cpu"), cam, progress=False)
    before = hit_kernel.launches
    _, m_gpu, stats = render_image(scene.compile(device=cuda), cam, progress=False)
    assert hit_kernel.launches - before == stats.iterations > 0
    close = np.isclose(m_gpu, m_cpu, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean()
    assert close >= 0.95
    np.testing.assert_allclose(np.nanmean(m_gpu), np.nanmean(m_cpu), rtol=1e-2)


def _cluster_tables(n, sc_size, dev, seed=0):
    """Cluster tables of an n-triangle random soup with random attributes."""
    rng = np.random.default_rng(seed)
    v0 = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    e1, e2 = ((rng.normal(size=(n, 3)) * 0.2).astype(np.float32) for _ in range(2))
    order, _, clusters = build_tri_bvh_sah(v0, e1, e2)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    attrs = (f32(n, 3), f32(n, 3), f32(n, 3), f32(n, 2), f32(n, 2), f32(n, 2),
             rng.uniform(size=n) < 0.5, rng.integers(0, 9, n).astype(np.int32))
    packed = tri_kernel.pack_clusters(v0[order], e1[order], e2[order], clusters,
                                      *(a[order] for a in attrs), sc_size=sc_size)
    return [torch.from_numpy(a).to(dev) for a in packed]


def _tri_call(which, tables, o, d, t_in, plain, sc_size=tri_kernel.SC_TWO_LEVEL):
    cl, geo, attr, scl = tables
    if which == "flat":
        fn = tri_kernel.closest_tri_flat_plain if plain else tri_kernel.closest_tri_flat
        return fn(o, d, t_in, 1e-3, scl, cl, geo, attr)
    fn = tri_kernel.closest_tri_two_level_plain if plain else tri_kernel.closest_tri_two_level
    return fn(o, d, t_in, 1e-3, scl, cl, geo, attr, sc_size)


def _assert_bit_equal(which, tables, o, d, t_in, sc_size=tri_kernel.SC_TWO_LEVEL):
    """One launch of the kernel against its plain version -> the plain version's t."""
    before = tri_kernel.launches[which]
    kt, ki, ka = _tri_call(which, tables, o, d, t_in, False, sc_size)
    pt, pi, pa = _tri_call(which, tables, o, d, t_in, True, sc_size)
    torch.cuda.synchronize()
    assert tri_kernel.launches[which] == before + 1
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32)) and torch.equal(ki, pi)
    for k in ("ns_raw", "u", "v"):
        assert torch.equal(ka[k].view(torch.int32), pa[k].view(torch.int32)), k
    assert torch.equal(ka["mat"], pa["mat"])
    return pt


@pytest.mark.parametrize("b", [1, 255, 100_003])
@pytest.mark.parametrize("which,n", [("flat", 3000), ("two_level", 3000), ("two_level", 60_000)])
def test_tri_kernel_bit_equal_to_plain(cuda, which, n, b):
    sc = tri_kernel.SC_FLAT if which == "flat" else tri_kernel.SC_TWO_LEVEL
    tables = _cluster_tables(n, sc, cuda)
    o, d, _ = _rays(b, 12, -3.0, 3.0, cuda)
    if b > 1000:  # edge lanes: axis-aligned (flushed 1/d), signed zeros, NaN
        d[:8] = torch.tensor([[0.0, 0.0, 1.0], [0.0, -0.0, -1.0], [1.0, 0.0, 0.0], [-0.0, 1.0, 0.0],
                              [float("nan"), 0.0, 1.0], [0.0, 0.0, 0.0], [1e-30, -1.0, 0.0],
                              [0.6, 0.8, -0.0]], device=cuda)
        o[8] = float("nan")
    rng = np.random.default_rng(b)
    t_in = torch.from_numpy(np.where(rng.uniform(size=b) < 0.2, 0.0, 3e38).astype(np.float32)).to(cuda)
    pt = _assert_bit_equal(which, tables, o, d, t_in)
    if b > 1000:
        assert (pt < 3e38).float().mean() > 0.05


@pytest.mark.parametrize("p", [1, 2, 19, 20, 21, 32])
@pytest.mark.parametrize("which", ["flat", "two_level"])
def test_tri_kernel_lane_masks(cuda, which, p):
    """Warps in which p lanes carry the same ray and the others are dead, so every visited
    cluster has a lane mask of p lanes, from one to the whole warp. The batch ends in a
    ragged packet."""
    sc = tri_kernel.SC_FLAT if which == "flat" else tri_kernel.SC_TWO_LEVEL
    tables = _cluster_tables(3000 if which == "flat" else 40_000, sc, cuda, seed=5)
    warps, tail = 600, 7
    rng = np.random.default_rng(p)
    o = rng.uniform(-3.0, 3.0, size=(warps + 1, 1, 3)).astype(np.float32)
    d = -o + rng.normal(size=(warps + 1, 1, 3)).astype(np.float32)  # toward the soup
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    live = np.argsort(rng.uniform(size=(warps + 1, 32)), axis=1) < p  # p random lanes a warp
    t_in = np.where(live, 3e38, 0.0).astype(np.float32)
    b = 32 * warps + tail
    o, d = (np.broadcast_to(a, (warps + 1, 32, 3)).reshape(-1, 3)[:b].copy() for a in (o, d))
    o, d, t_in = (torch.from_numpy(a).to(cuda) for a in (o, d, t_in.reshape(-1)[:b].copy()))
    pt = _assert_bit_equal(which, tables, o, d, t_in)
    assert (pt[t_in > 0] < 3e38).float().mean() > 0.3 and not (pt[t_in == 0] < 3e38).any()


def _sliced_tables(n_clusters, per, sc_size, dev, seed=0):
    """Tables of n_clusters clusters of `per` random triangles each: the triangles sorted
    along x and cut into consecutive runs (any partition into runs is a valid table)."""
    rng = np.random.default_rng(seed)
    n = n_clusters * per
    v0 = (rng.uniform(-2.0, 2.0, size=(n, 3))).astype(np.float32)
    v0 = v0[np.argsort(v0[:, 0])]
    e1, e2 = ((rng.normal(size=(n, 3)) * 0.1).astype(np.float32) for _ in range(2))
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1).reshape(n_clusters, 3 * per, 3)
    clusters = dict(start=(np.arange(n_clusters) * per).astype(np.int32),
                    count=np.full(n_clusters, per, np.int32),
                    bmin=corners.min(axis=1), bmax=corners.max(axis=1))
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    attrs = (f32(n, 3), f32(n, 3), f32(n, 3), f32(n, 2), f32(n, 2), f32(n, 2),
             rng.uniform(size=n) < 0.5, rng.integers(0, 9, n).astype(np.int32))
    packed = tri_kernel.pack_clusters(v0, e1, e2, clusters, *attrs, sc_size=sc_size)
    return [torch.from_numpy(a).to(dev) for a in packed]


@pytest.mark.parametrize("which,n_clusters,sc_size", [
    ("flat", 760, tri_kernel.SC_FLAT),  # packs to the flat kernel's limit of 768 clusters
    ("two_level", 17_000, 8),  # 2126 superclusters: their boxes alone pass 48 KB of shared memory
    ("two_level", 1000, 32),  # the largest superclusters the two-level kernel takes
])
def test_tri_kernel_table_sizes(cuda, which, n_clusters, sc_size):
    tables = _sliced_tables(n_clusters, 8, sc_size, cuda)
    cp = tables[0].shape[0]
    assert cp == {760: tri_kernel.FLAT_MAX_CLUSTERS, 17_000: 17_008, 1000: 1024}[n_clusters]
    o, d, _ = _rays(50_001, 13, -2.0, 2.0, cuda)
    t_in = torch.full((o.shape[0],), 3e38, device=cuda)
    pt = _assert_bit_equal(which, tables, o, d, t_in, sc_size)
    assert (pt < 3e38).float().mean() > 0.3


def test_tri_kernel_argument_checks(cuda):
    cl, geo, attr, scl = _cluster_tables(500, tri_kernel.SC_TWO_LEVEL, cuda)
    o, d, _ = _rays(64, 1, -3.0, 3.0, cuda)
    t_in = torch.full((64,), 3e38, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        tri_kernel.closest_tri_two_level(o, d.cpu(), t_in, 1e-3, scl, cl, geo, attr, 16)
    with pytest.raises(ValueError, match="sc_size 64 must divide"):  # tables packed in 16s
        tri_kernel.closest_tri_flat(o, d, t_in, 1e-3, scl, cl, geo, attr)
    f_cl, f_geo, f_attr, f_scl = _cluster_tables(500, tri_kernel.SC_FLAT, cuda)
    with pytest.raises(ValueError, match="is on"):
        tri_kernel.closest_tri_flat(o, d.cpu(), t_in, 1e-3, f_scl, f_cl, f_geo, f_attr)
    with pytest.raises(ValueError, match="sc_size"):
        tri_kernel.closest_tri_two_level(o, d, t_in, 1e-3, scl, cl, geo, attr, 64)
    with pytest.raises(TypeError, match="float32"):
        tri_kernel.closest_tri_two_level(o, d, t_in.double(), 1e-3, scl, cl, geo, attr, 16)


# ---- K4, the stackless BVH walk ----


def _bvh_tables(n, dev, seed=0, morton=False):
    """(nodes, tris, attr) of an n-triangle random soup in its tree's order (binned SAH,
    or Morton), with random normals, UVs on every other triangle and material ids."""
    rng = np.random.default_rng(seed)
    v0 = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    e1, e2 = ((rng.normal(size=(n, 3)) * 0.2).astype(np.float32) for _ in range(2))
    order, nodes = build_tri_bvh(v0, e1, e2) if morton else build_tri_bvh_sah(v0, e1, e2)[:2]
    attr = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    attr += [rng.uniform(size=(n, 2)).astype(np.float32) for _ in range(3)]
    attr += [np.arange(n) % 2 == 0, rng.integers(0, 50, size=n).astype(np.int32)]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (tuple(to(nodes[k]) for k in ("bmin", "bmax", "skip", "start", "count")),
            tuple(to(a[order]) for a in (v0, e1, e2)), tuple(to(a[order]) for a in attr))


def _assert_bvh_bit_equal(tables, o, d, t_in, tmin=1e-3):
    """One launch of K4 against its plain version (t's bits, idx and the four attribute
    fields on every lane) -> the plain version's t."""
    before = bvh_kernel.launches
    kt, ki, ka = bvh_kernel.closest_tri_bvh(o, d, t_in, tmin, *tables)
    pt, pi, pa = bvh_closest_tri_plain(o, d, t_in, tmin, *tables)
    torch.cuda.synchronize()
    assert bvh_kernel.launches == before + 1
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32)) and torch.equal(ki, pi)
    for k in ("ns_raw", "u", "v"):
        assert torch.equal(ka[k].view(torch.int32), pa[k].view(torch.int32)), k
    assert torch.equal(ka["mat"], pa["mat"])
    return pt


@pytest.mark.parametrize("b", [1, 255, 100_003])
@pytest.mark.parametrize("n,morton", [(3000, False), (60_000, False), (3000, True)])
def test_bvh_kernel_bit_equal_to_plain(cuda, n, morton, b):
    tables = _bvh_tables(n, cuda, morton=morton)
    o, d, _ = _rays(b, 12, -3.0, 3.0, cuda)
    t_in = torch.full((b,), 3e38, device=cuda)
    if b > 1000:  # edge lanes: axis-aligned (flushed 1/d), signed zeros, NaN, infinite origin
        d[:8] = torch.tensor([[0.0, 0.0, 1.0], [0.0, -0.0, -1.0], [1.0, 0.0, 0.0], [-0.0, 1.0, 0.0],
                              [float("nan"), 0.0, 1.0], [0.0, 0.0, 0.0], [1e-30, -1.0, 0.0],
                              [0.6, 0.8, -0.0]], device=cuda)
        o[8] = float("nan")
        o[9, 0] = float("inf")
    pt = _assert_bvh_bit_equal(tables, o, d, t_in)
    if b > 1000:
        assert (pt < 3e38).float().mean() > 0.05
        assert not bool((pt[[4, 8]] < 3e38).any())  # NaN rays miss
    _assert_bvh_bit_equal(tables, o, d, torch.full_like(t_in, 2.0), tmin=0.5)  # a window of t
    # per-ray t_in: dead lanes (0) on every other lane, short and NaN seeds on others
    lane = torch.arange(b, device=cuda)
    t_in = torch.where(lane % 2 == 0, 0.0, torch.where(lane % 3 == 0, 1.5, 3e38))
    t_in = torch.where(lane % 7 == 1, float("nan"), t_in)
    pt = _assert_bvh_bit_equal(tables, o, d, t_in)
    assert not bool((pt[lane % 2 == 0] < 3e38).any())


def test_bvh_kernel_mesh_rays(cuda):
    """K4 on the camera rays of a mesh scene compiled with bvh=True and on the rays that
    follow their hits (dead where the camera ray missed); on a scene without the tree (one
    dummy node) every ray misses."""
    from chip_smoke import bounce_rays, camera_rays

    scene, cam = _mesh_scene(64, 1)
    sd = scene.compile(device=cuda, bvh=True).data
    assert sd.has_tri_bvh and sd.bvh_skip.shape[0] > 1000
    tables = bvh_kernel.scene_nodes(sd)
    o, d, _ = camera_rays(cam, cuda)
    open_ = torch.full((o.shape[0],), 3e38, device=cuda)
    pt = _assert_bvh_bit_equal(tables, o, d, open_)
    assert (pt < 3e38).float().mean() > 0.3
    _, _, aux = bvh_kernel.closest_tri_bvh(o, d, open_, 1e-3, *tables)
    no, nd, t_in = bounce_rays(o, d, pt, aux["ns_raw"], 7)
    _assert_bvh_bit_equal(tables, no, nd, t_in)
    empty = cornell_box_scene(16, 1)[0].compile(device=cuda).data
    et = _assert_bvh_bit_equal(bvh_kernel.scene_nodes(empty), o, d, open_)
    assert not bool((et < 3e38).any())


def test_bvh_kernel_counts(cuda):
    """The counting build gives the same triangle tests as the binary walk's plain
    version (the same leaves are tested), fewer wide-node fetches than binary node
    visits, and a stack no deeper than the packing's bound."""
    tables = _bvh_tables(60_000, cuda)
    o, d, _ = _rays(20_000, 5, -3.0, 3.0, cuda)
    t_in = torch.full((20_000,), 3e38, device=cuda)
    counts, plain = bvh_kernel.walk_counts(o, d, t_in, 1e-3, *tables), {}
    bvh_closest_tri_plain(o, d, t_in, 1e-3, *tables, plain)
    assert counts["tri_tests"] == plain["tri_tests"] > 0
    assert 0 < counts["node_fetches"] < plain["box_tests"]
    assert 0 < counts["deepest_stack"] <= bvh_kernel.pack_wide(tables[0])[1] <= bvh_kernel.STACK


def test_bvh_kernel_argument_checks(cuda):
    nodes, tris, attr = _bvh_tables(500, cuda)
    o, d, _ = _rays(64, 1, -3.0, 3.0, cuda)
    t_in = torch.full((64,), 3e38, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        bvh_kernel.closest_tri_bvh(o, d.cpu(), t_in, 1e-3, nodes, tris, attr)
    with pytest.raises(ValueError, match="is on"):
        bvh_kernel.closest_tri_bvh(o, d, t_in.cpu(), 1e-3, nodes, tris, attr)
    with pytest.raises(ValueError, match="t_in"):
        bvh_kernel.closest_tri_bvh(o, d, t_in[:10], 1e-3, nodes, tris, attr)
    with pytest.raises(TypeError, match="float32"):
        bvh_kernel.closest_tri_bvh(o.double(), d.double(), t_in.double(), 1e-3, nodes, tris, attr)
    with pytest.raises(TypeError, match="int32"):
        bvh_kernel.closest_tri_bvh(o, d, t_in, 1e-3, nodes, tris, (*attr[:7], attr[7].long()))
    with pytest.raises(ValueError, match="no gradient"):
        bvh_kernel.closest_tri_bvh(o, d, t_in, 1e-3, nodes, (tris[0].requires_grad_(), *tris[1:]), attr)


def _left_deep(levels):
    """Binary node arrays of a tree whose left spine is `levels` internal nodes deep,
    with a leaf of one triangle to the right of each and one below the last. In DFS
    pre-order: the spine 0..L-1, the bottom leaf at L, then the right leaves of spine
    nodes L-1 down to 0."""
    m = 2 * levels + 1
    skip = np.arange(1, m + 1, dtype=np.int32)
    skip[:levels] = 2 * levels - np.arange(levels) + 1  # past its right leaf at 2L - k
    count = np.ones(m, np.int32)
    count[:levels] = 0
    start = np.zeros(m, np.int32)
    start[levels:] = np.arange(levels + 1)
    bmin = np.zeros((m, 3), np.float32)
    bmax = np.ones((m, 3), np.float32)
    return tuple(torch.from_numpy(a) for a in (bmin, bmax, skip, start, count))


def test_bvh_kernel_refuses_a_tree_deeper_than_its_stack(cuda):
    """A tree whose all-pass walk needs more stack than the kernel holds raises before a
    launch (a left spine of 80 internal nodes, a leaf to the right of each)."""
    nodes = tuple(x.to(cuda) for x in _left_deep(80))
    n = 81
    tris = tuple(torch.zeros((n, 3), device=cuda) for _ in range(3))
    attr = (*(torch.zeros((n, 3), device=cuda) for _ in range(3)), *(torch.zeros((n, 2), device=cuda)
            for _ in range(3)), torch.zeros(n, dtype=torch.bool, device=cuda),
            torch.zeros(n, dtype=torch.int32, device=cuda))
    o, d, _ = _rays(64, 1, -3.0, 3.0, cuda)
    before = bvh_kernel.launches
    with pytest.raises(ValueError, match="stack"):
        bvh_kernel.closest_tri_bvh(o, d, torch.full((64,), 3e38, device=cuda), 1e-3, nodes, tris, attr)
    assert bvh_kernel.launches == before


def test_small_bvh_render_matches_cpu(cuda):
    scene, cam = _mesh_scene(32, 4)
    _, m_cpu, _ = render_image(scene.compile(device="cpu", bvh=True), cam, progress=False)
    before = bvh_kernel.launches
    _, m_gpu, stats = render_image(scene.compile(device=cuda, bvh=True), cam, progress=False)
    assert bvh_kernel.launches - before == stats.iterations > 0
    close = np.isclose(m_gpu, m_cpu, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean()
    assert close >= 0.95
    np.testing.assert_allclose(np.nanmean(m_gpu), np.nanmean(m_cpu), rtol=1e-2)


def _mesh_scene(width, spp):
    """A wavy 5000-triangle height field under a quad light."""
    n = 50
    x, z = np.meshgrid(np.linspace(-2, 2, n + 1), np.linspace(-2, 2, n + 1))
    y = 0.3 * np.sin(3 * x) * np.cos(2 * z)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    i = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
    quads = np.stack([i, i + 1, i + n + 2, i, i + n + 2, i + n + 1], axis=-1).reshape(-1, 3)
    s = Scene()
    s.add_mesh(dict(positions=pos, normals=None, uvs=None, indices=quads), Diffuse((0.6, 0.5, 0.4)))
    s.add_quad((-1.0, 2.5, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((6.0, 6.0, 6.0)), light=True)
    s.environment = (0.1, 0.1, 0.2)
    cam = Camera(aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=6, vfov=50.0,
                 look_from=(0.0, 2.0, 4.0), look_at=(0.0, 0.0, 0.0), blur_strength=0.5,
                 focal_length=4.0, defocus_angle=0.0)
    return s, cam


def test_small_mesh_render_matches_cpu(cuda):
    scene, cam = _mesh_scene(32, 4)
    assert scene.compile(device="cpu").data.has_tri_clusters
    _, m_cpu, _ = render_image(scene.compile(device="cpu"), cam, progress=False)
    before = tri_kernel.launches["flat"]
    _, m_gpu, stats = render_image(scene.compile(device=cuda), cam, progress=False)
    assert tri_kernel.launches["flat"] - before == stats.iterations > 0
    close = np.isclose(m_gpu, m_cpu, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean()
    assert close >= 0.95
    np.testing.assert_allclose(np.nanmean(m_gpu), np.nanmean(m_cpu), rtol=1e-2)


# ---- gradients (render/diff.py): the kernels inside autograd and its replays ----


def _grad_box_scene():
    s = Scene()
    floor = Diffuse((0.73, 0.6, 0.5))
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), floor)
    s.add_sphere(0.7, (0.0, 0.7, 0.0), floor)
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((6.0, 5.0, 4.0)), light=True)
    s.environment = (0.4, 0.5, 0.6)
    cam = Camera(aspect_ratio=1.0, image_width=16, samples_per_pixel=8, max_depth=12, vfov=40.0,
                 look_from=(0.0, 1.0, 3.0), look_at=(0.0, 1.0, 0.0), blur_strength=0.5,
                 focal_length=3.0, defocus_angle=0.0)
    return s, cam


@pytest.mark.parametrize("which", ["box", "mesh", "two_level", "bvh"])
def test_grads_match_cpu(cuda, which):
    """render_film_grads on the card against the CPU (plain kernels): per field a
    relative L1 error of at most 2e-2 (an ulp of the card's transcendentals flips a
    rare path, and the gathers' backward adds with atomics on the card), and the
    image on at least 95% of pixels within rtol 1e-3 / atol 1e-4. mesh runs K2 in
    every trip and its replay, two_level (60000 triangles) K3, bvh (the mesh compiled
    with bvh=True) K4."""
    from tpupt_torch.render.diff import render_film_grads

    scene, cam = {"box": _grad_box_scene, "mesh": lambda: _mesh_scene(16, 8), "bvh": lambda: _mesh_scene(16, 8),
                  "two_level": lambda: random_mesh_scene(16, 8)}[which]()
    bvh = True if which == "bvh" else None
    m_cpu, g_cpu = render_film_grads(scene.compile(device="cpu", bvh=bvh), cam, seed=0)
    before = hit_kernel.launches
    m_gpu, g_gpu, st = render_film_grads(scene.compile(device=cuda, bvh=bvh), cam, seed=0, return_stats=True)
    assert st.launches_forward["K1"] == st.launches_backward["K1"] == st.trips > 0
    kernel = {"mesh": "K2", "two_level": "K3", "bvh": "K4"}.get(which)
    if kernel:
        assert st.launches_forward[kernel] == st.launches_backward[kernel] == st.trips
    assert hit_kernel.launches - before == 2 * st.trips
    close = np.isclose(m_gpu.cpu().numpy(), m_cpu.numpy(), rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.95, close
    for k, ref in g_cpu.items():
        got = g_gpu[k].cpu()
        assert bool(torch.isfinite(got).all()), k
        err = float((got - ref).abs().sum() / ref.abs().sum().clamp_min(1e-30))
        assert err <= 2e-2, (k, err)


def test_kernels_take_no_gradient_on_the_card(cuda):
    sd = cornell_box_scene(16, 4)[0].compile(device=cuda).data
    sph, quad = hit_kernel.tables(sd)
    o, d, tm = _rays(256, 2, 0.0, 555.0, cuda)
    o.requires_grad_(True)
    t, kind, idx = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    assert t.grad_fn is None and not t.requires_grad
    with pytest.raises(ValueError, match="no gradient"):
        hit_kernel.closest_sphere_quad(o, d, tm, sph, quad.clone().requires_grad_(True))
    tables = _cluster_tables(3000, tri_kernel.SC_FLAT, cuda)
    t_in = torch.full_like(tm, 3e38)
    kt, _, ka = _tri_call("flat", tables, o, d, t_in, False)
    assert kt.grad_fn is None and ka["u"].grad_fn is None
    cl, geo, attr, scl = tables
    with pytest.raises(ValueError, match="no gradient"):
        _tri_call("flat", (cl.requires_grad_(True), geo, attr, scl), o, d, t_in, False)


def recorded_kernel_outputs(monkeypatch, compiled, cam, module=hit_kernel, name="closest_sphere_quad"):
    """render_film_grads by the eager route (checkpointed trips; within plain_grads on the
    card, where the graph route would call the wrapper only while capturing) with the
    outputs of every call of module.name (K1's wrapper by default) recorded -> (forward
    calls, the backward pass's calls in trip order, GradStats)."""
    from tpupt_torch.render.diff import plain_grads, render_film_grads

    calls = []
    wrapped = getattr(module, name)

    def spy(*args, **kwargs):
        out = wrapped(*args, **kwargs)
        tensors = (*out[:2], *out[2].values()) if len(out) > 2 and isinstance(out[2], dict) else out
        calls.append(tuple(x.clone() for x in tensors))
        return out

    monkeypatch.setattr(module, name, spy)
    with plain_grads():
        _, grads, st = render_film_grads(compiled, cam, spp=4, replicas=2, return_stats=True)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    n = len(calls) // 2
    return calls[:n], calls[n:][::-1], st


@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K4"])
def test_checkpoint_replay_bits_equal_on_the_card(cuda, monkeypatch, which):
    """A kernel's outputs in each forward trip and in its checkpoint replay in the backward
    pass are the same bits (K1 and K4 are deterministic; K2 and K3 zero their packet counter
    at every launch), and it launches once for each: the eager route's replays. The graph
    route's replays are held by test_grad_graph_route_matches_eager_route (films bit-equal,
    gradients within relative L1 1e-6)."""
    bvh = None
    if which == "K1":
        scene, cam = cornell_box_scene(16, 4)
        cam.max_depth = 12
        spy = dict(module=hit_kernel, name="closest_sphere_quad")
    elif which == "K4":
        scene, cam = _mesh_scene(16, 4)
        bvh, spy = True, dict(module=bvh_kernel, name="closest_tri_bvh")
    else:
        scene, cam = _mesh_scene(16, 4) if which == "K2" else random_mesh_scene(16, 4)
        spy = dict(module=tri_kernel, name="closest_tri")
    fwd, replay, st = recorded_kernel_outputs(monkeypatch, scene.compile(device=cuda, bvh=bvh), cam, **spy)
    assert len(fwd) == len(replay) == st.trips == st.launches_forward[which] == st.launches_backward[which]
    for a, b in zip(fwd, replay):
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


# ---- the image readers and the sharded render on the card's machine ----


@pytest.mark.parametrize("name", FIXTURES)
def test_decoders_on_the_committed_fixtures(cuda, name):
    """The PNG and JPEG readers where there is no PIL: PIL's decode of each fixture (.npy)
    bit for bit."""
    import os

    from tpupt_torch.io.image import load_image_rgb8

    path = os.path.join(FIXTURE_DIR, name)
    np.testing.assert_array_equal(load_image_rgb8(path), np.load(os.path.splitext(path)[0] + ".npy"))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_decoders_on_the_committed_twins(cuda, name):
    """Progressive JPEG, 16-bit and Adam7 PNG where there is no PIL: each twin decodes to
    its stand-in's .npy, bit for bit."""
    import os

    from tpupt_torch.io.image import load_image_rgb8

    want = np.load(os.path.join(FIXTURE_DIR, os.path.splitext(TWINS[name])[0] + ".npy"))
    np.testing.assert_array_equal(load_image_rgb8(os.path.join(FIXTURE_DIR, name)), want)


@pytest.mark.parametrize("sid", [2, 5, 7])
def test_twin_renders_bit_equal_to_stand_ins(cuda, sid, tmp_path, monkeypatch):
    """Scenes 2, 5 and 7 on the card from the twins (progressive JPEG, 16-bit and Adam7
    PNG) and from the baseline stand-ins: the same texels, so the same film, bit for bit,
    and the same rays."""
    import shutil

    from tpupt_torch.scenes import SCENES

    stand_in, twin = tmp_path / "stand_in", tmp_path / "twin"
    for name in FIXTURES:
        (stand_in / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(f"{FIXTURE_DIR}/{name}", stand_in / name)
    write_twin_assets(str(twin))
    films = []
    for root in (stand_in, twin):
        monkeypatch.setenv("TPUPT_ASSETS", str(root))
        scene, cam = SCENES[sid][1](32, 4)
        _, mean, st = render_image(scene.compile(device=cuda), cam, progress=False)
        films.append((mean, st.rays))
    np.testing.assert_array_equal(films[1][0], films[0][0])
    assert films[1][1] == films[0][1]


def test_dryrun_multichip_over_nccl(cuda):
    """tpupt_torch.entry.dryrun_multichip over every visible card, a rank a card over NCCL:
    its four checks pass in each rank, and its renders and gradients launch K1."""
    from tpupt_torch.entry import dryrun_multichip

    ranks = dryrun_multichip(torch.cuda.device_count())
    assert [r["rank"] for r in ranks] == list(range(torch.cuda.device_count()))
    assert all(r["K1_launches"] > 0 and r["device"] == f"cuda:{r['rank']}" for r in ranks)


def test_entry_on_the_card(cuda):
    """entry()'s radiance on the card against entry(device="cpu"): the card's tolerance of
    this file (95% of lanes within rtol 1e-3 / atol 1e-4)."""
    from tpupt_torch.entry import entry

    fn, args = entry()
    assert args[0].device.type == "cuda"
    got = fn(*args)
    assert got.is_cuda and got.shape == (4096, 3)
    fn_cpu, args_cpu = entry(device="cpu")
    want = fn_cpu(*args_cpu).numpy()
    close = np.isclose(got.cpu().numpy(), want, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.95, close


def test_nccl_world_of_one_bit_equal(cuda):
    """render_image under a world of 1 over NCCL equals the render without a mesh, bit for bit."""
    import socket

    import torch.distributed as dist

    from tpupt_torch.parallel.sharding import make_mesh

    compiled, cam = cornell_box_scene(32, 8)[0].compile(device=cuda), cornell_box_scene(32, 8)[1]
    _, ref, st_ref = render_image(compiled, cam, progress=False)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        _, mean, st = render_image(compiled, cam, progress=False, mesh=make_mesh(1, device="cuda:0"))
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(mean, ref)
    assert st.rays == st_ref.rays


def test_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two spawned ranks on cuda:0 over gloo against one: rays equal, the image within
    rtol 1e-5 / atol 1e-6 (the float32 film sum in another order). Each rank is joined
    with its own timeout."""
    import torch.multiprocessing as mp

    import torch_sharding_worker as W

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.card_worker, args=(r, 2, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
        if p.is_alive():
            p.kill()
        assert p.exitcode == 0
    scene, cam = cornell_box_scene(32, 8)
    _, ref, st_ref = render_image(scene.compile(device=cuda), cam, progress=False)
    for r in range(2):
        mean, rays = torch.load(tmp_path / f"card_rank{r}.pt", weights_only=False)
        assert rays == st_ref.rays
        np.testing.assert_allclose(mean, ref, rtol=1e-5, atol=1e-6)


# ---- the launch as CUDA graphs (render/graph.py) against the eager loop ----


def _graph_scene(which, cuda):
    """(compiled, camera, kernel) of a small render whose launch has several stages: the
    Cornell box (K1), the 5000-triangle mesh on the flat clusters (K2), 60000 random
    triangles on the two-level clusters (K3), the mesh on the BVH (K4)."""
    if which == "K1":
        scene, cam = cornell_box_scene(96, 8)
        cam.max_depth = 12
        return scene.compile(device=cuda), cam
    if which == "K3":
        scene, cam = random_mesh_scene(64, 4)
        return scene.compile(device=cuda), cam
    scene, cam = _mesh_scene(64, 4)
    return scene.compile(device=cuda, bvh=True if which == "K4" else None), cam


@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K4"])
def test_graph_route_bit_equal_to_eager_loop(cuda, which):
    """render_image on the card (graphs) against the same render by the eager loop: films
    bit-equal, rays and iterations equal, and the kernel's launches true under replay
    (K1, K2 or K3, K4: one an iteration)."""
    from tpupt_torch.ops import loop_cond
    from tpupt_torch.render import renderer as R

    compiled, cam = _graph_scene(which, cuda)
    count = {"K1": lambda: hit_kernel.launches, "K2": lambda: tri_kernel.launches["flat"],
             "K3": lambda: tri_kernel.launches["two_level"], "K4": lambda: bvh_kernel.launches}[which]
    before, cond_before = count(), loop_cond.launches
    _, m_g, st_g = render_image(compiled, cam, progress=False)
    launched, conds = count() - before, loop_cond.launches - cond_before
    with R.plain_launches():
        _, m_e, st_e = render_image(compiled, cam, progress=False)
    np.testing.assert_array_equal(m_g, m_e)
    assert (st_g.rays, st_g.iterations) == (st_e.rays, st_e.iterations)
    assert (st_g.work_lanes, st_g.lane_slots) == (st_e.work_lanes, st_e.lane_slots)
    assert st_g.work_lanes == st_g.rays and st_g.device_s > 0 == st_e.device_s
    assert launched == st_g.iterations > 0
    assert conds >= st_g.iterations and st_g.capture_s > 0


def _card_in(rec, inner, outer, slack=0):
    """inner lies within outer, give or take the clock's calibrated error and `slack` ns."""
    err = rec.clock[1] + slack
    return outer.start - err <= inner.start <= inner.end <= outer.end + err


def test_card_intervals_lie_in_their_waits(cuda):
    """Under a recording, the card's stamps: every launch's card.chain lies within its
    render.wait span, its stages one after another within it; a gradient call's card.forward
    within its chunk's span, its card.backward after its chunk's launch and before the call's
    end; the stats' device seconds are the intervals' sums."""
    from tpupt_torch import trace
    from tpupt_torch.ops import loop_cond
    from tpupt_torch.render.diff import render_film_grads

    compiled, cam = _graph_scene("K1", cuda)
    gc, gcam = _grad_case("cornell", cuda)
    stamped = loop_cond.stamp_launches
    with trace.recording() as rec:
        stats = [render_image(compiled, cam, progress=False)[2] for _ in range(2)]
        gstats = [render_film_grads(gc, gcam, return_stats=True)[2] for _ in range(2)]
    stamped = loop_cond.stamp_launches - stamped
    assert rec.clock is not None and 0 <= rec.clock[1] < 1_000_000
    by_id = {s.id: s for s in rec.spans}
    waits = rec.named("render.wait")
    assert len(waits) == sum(st.launches for st in stats)
    for w in waits:
        (chain,) = [c for c in rec.children(w, "card") if c.name == "card.chain"]
        stages = sorted((c for c in rec.children(w, "card") if c.name != "card.chain"), key=lambda c: c.name)
        assert stages and _card_in(rec, chain, w)
        assert chain.start == stages[0].start and all(a.end == b.start for a, b in zip(stages, stages[1:]))
        assert all(chain.start <= c.start <= c.end <= chain.end for c in stages)
    chains = rec.named("card.chain")
    assert sum(c.ns for c in chains) * 1e-9 == pytest.approx(sum(st.device_s for st in stats), rel=1e-9)
    for c in rec.named("card.forward"):
        assert by_id[c.parent].name == "grads.forward.chunk" and _card_in(rec, c, by_id[c.parent])
    grads = rec.named("grads")
    for c in rec.named("card.backward"):
        chunk = by_id[c.parent]
        call = by_id[c.call]
        assert chunk.name == "grads.backward.chunk" and call in grads
        assert chunk.start - rec.clock[1] <= c.start <= c.end <= call.end + rec.clock[1]
    fwd, bwd = rec.named("card.forward"), rec.named("card.backward")
    assert len(fwd) == sum(g.chunks for g in gstats) and bwd
    # each chain's stamps counted apart from K5: a render chain's n - start + 2, a gradient chain's 2
    assert stamped == sum(len(rec.children(w, "card")) + 1 for w in waits) + 2 * (len(fwd) + len(bwd))
    assert sum(c.ns for c in fwd) * 1e-9 == pytest.approx(sum(g.device_forward_s for g in gstats), rel=1e-9)
    assert sum(c.ns for c in bwd) * 1e-9 == pytest.approx(sum(g.device_backward_s for g in gstats), rel=1e-9)


def test_profiler_kernels_of_a_chain_fall_inside_its_wait(cuda, tmp_path):
    """render_image(profile_dir=...) merges the program's spans into torch.profiler's trace. CUPTI
    records the chain's stamp kernels, whose reads of the card's clock the program places on
    the host's: their offset from CUPTI's own times is one constant (within 20 us) through a
    launch, and with the clocks aligned by it every kernel CUPTI records for the chain's launch
    (by its correlation id) lies within 100 us of that launch's render.wait span."""
    compiled, cam = _graph_scene("K1", cuda)
    render_image(compiled, cam, progress=False)  # the graphs' capture, outside the trace
    render_image(compiled, cam, progress=False, profile_dir=str(tmp_path))
    events = json.loads((tmp_path / "render_rank0.json").read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "tpupt_torch"]
    waits = {e["args"]["id"]: e for e in ours if e["name"] == "render.wait"}
    assert waits
    for wid, w in waits.items():
        cards = [e for e in ours if e["tid"] == "card" and e["args"]["parent"] == wid]
        (chain,) = [e for e in cards if e["name"] == "card.chain"]
        ends = [e["ts"] + e["dur"] for e in cards if e is not chain]
        stamps = sorted([chain["ts"], chain["ts"] + chain["dur"], *ends])  # the chain's stamps, host clock
        corr = {e["args"]["correlation"] for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaGraphLaunch") and w["ts"] <= e["ts"] <= w["ts"] + w["dur"]}
        kernels = [e for e in events if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in corr]
        recorded = sorted(e["ts"] for e in kernels if "stamp_kernel" in e["name"])
        assert len(recorded) == len(stamps), (recorded, stamps)
        offsets = [a - b for a, b in zip(stamps, recorded)]
        assert max(offsets) - min(offsets) < 20, offsets
        shift = sorted(offsets)[len(offsets) // 2]
        for k in kernels:
            assert w["ts"] - 100 <= k["ts"] + shift <= k["ts"] + k["dur"] + shift <= w["ts"] + w["dur"] + 100, \
                (k["name"], k["ts"], shift, w)


def test_the_profilers_device_ops_hold_no_program_span(cuda):
    """The benchmark's traced window (ptbench/core/profile.py) under a recording: the spans are
    not profiler events, so its device operations name no span of the program."""
    from ptbench.core.profile import traced
    from tpupt_torch import trace

    compiled, cam = _graph_scene("K1", cuda)
    render_image(compiled, cam, progress=False)
    with trace.recording() as rec:
        prof = traced(lambda: render_image(compiled, cam, progress=False))
    names = {s.name for s in rec.spans}
    assert "render.wait" in names
    ops = [n for n, _ in prof["breakdown"]["device_ops"]]
    assert ops and not any("tpupt" in n or n in names for n in ops)


def test_graph_replays_equal_their_first_launch(cuda):
    """One LaunchGraphs: the first launch (an eager iteration, then the capture) and two
    replays of the same lanes give the same film, rays and iterations, which are the eager
    loop's; a render of several launches (each replayed) equals its eager render."""
    from tpupt_torch.render import renderer as R
    from tpupt_torch.render.graph import LaunchGraphs

    compiled, cam = _graph_scene("K2", cuda)
    c = cam.init(cuda)
    pix = torch.arange(64 * 64, dtype=torch.int32, device=cuda)
    kw = dict(k=2, r=2, max_depth=cam.max_depth, has_lights=compiled.has_lights, width=64)
    with R.plain_launches():
        film_e, rays_e, it_e = R._chunk_film(compiled.data, c, pix, 64 * 64, 0, 4, 0, **kw)
    with LaunchGraphs() as graphs:
        runs = []
        for _ in range(3):
            film, rays, it = R._chunk_film(compiled.data, c, pix, 64 * 64, 0, 4, 0, graphs=graphs, **kw)
            runs.append((film.clone(), rays, it))
    for film, rays, it in runs:
        assert torch.equal(film, film_e) and (rays, it) == (rays_e, it_e)
    _, m_g, st_g = render_image(compiled, cam, samples_per_launch=1, progress=False)
    with R.plain_launches():
        _, m_e, st_e = render_image(compiled, cam, samples_per_launch=1, progress=False)
    assert st_g.launches == 4
    np.testing.assert_array_equal(m_g, m_e)
    assert (st_g.rays, st_g.iterations) == (st_e.rays, st_e.iterations)


def test_graph_launch_without_work(cuda):
    """A launch whose lanes all start at spp_limit (a mesh rank past the samples) gives the
    eager loop's zero film, rays and iterations, without capturing anything."""
    from tpupt_torch.render import renderer as R
    from tpupt_torch.render.graph import LaunchGraphs

    compiled, cam = _graph_scene("K1", cuda)
    c = cam.init(cuda)
    pix = torch.arange(1024, dtype=torch.int32, device=cuda)
    kw = dict(k=2, r=2, max_depth=cam.max_depth, has_lights=compiled.has_lights, width=cam.image_width)
    with R.plain_launches():
        film_e, rays_e, it_e = R._chunk_film(compiled.data, c, pix, 1024, 8, 8, 0, **kw)
    with LaunchGraphs() as graphs:
        film, rays, it = R._chunk_film(compiled.data, c, pix, 1024, 8, 8, 0, graphs=graphs, **kw)
        assert graphs.capture_s == 0.0
    assert torch.equal(film, film_e) and (rays, it) == (rays_e, it_e) == (0, 0)


def test_graph_route_under_profile_dir_and_debug_checks(cuda, tmp_path):
    """render_image(profile_dir=..., debug_checks=True) on the graph route writes its trace
    and gives the eager loop's film."""
    from tpupt_torch.render import renderer as R

    compiled, cam = _graph_scene("K1", cuda)
    _, m_g, st_g = render_image(compiled, cam, progress=False, profile_dir=str(tmp_path), debug_checks=True)
    with R.plain_launches():
        _, m_e, st_e = render_image(compiled, cam, progress=False)
    assert (tmp_path / "render_rank0.json").stat().st_size > 0
    np.testing.assert_array_equal(m_g, m_e)
    assert (st_g.rays, st_g.iterations) == (st_e.rays, st_e.iterations) and st_g.capture_s > 0


def test_graph_capture_failure_raises(cuda, monkeypatch):
    """A host read planted in the iteration under capture makes render_image raise, naming
    the part being captured; the eager loop does not take over."""
    from tpupt_torch.render import integrator

    step = integrator.StreamStages.step

    def planted(self, i):
        if torch.cuda.is_current_stream_capturing():
            int(self.rays)  # a host read: illegal while the stream is captured
        step(self, i)

    monkeypatch.setattr(integrator.StreamStages, "step", planted)
    compiled, cam = _graph_scene("K1", cuda)
    with pytest.raises(RuntimeError, match="capturing the iteration of stage 0"):
        render_image(compiled, cam, progress=False)
    monkeypatch.setattr(integrator.StreamStages, "step", step)
    _, mean, st = render_image(compiled, cam, progress=False)  # the card still works
    assert st.iterations > 0 and np.isfinite(mean).mean() > 0.99


def test_a_collection_during_capture_frees_no_graph(cuda, monkeypatch):
    """A captured graph left in a reference cycle becomes garbage while a launch's iteration
    is captured, with the cyclic collector set to run at every allocation: the capture
    completes (the collector is off while a capture lasts; freeing a graph inside one would
    invalidate it) and the render equals the eager loop's."""
    import gc

    from tpupt_torch.render import integrator
    from tpupt_torch.render import renderer as R

    junk = torch.cuda.CUDAGraph()
    x = torch.zeros(8, device=cuda)
    with torch.cuda.graph(junk):
        x.add_(1.0)
    held = [junk]
    del junk
    step = integrator.StreamStages.step

    def planted(self, i):
        if torch.cuda.is_current_stream_capturing() and held:
            cycle = [held.pop()]
            cycle.append(cycle)  # garbage that only the cyclic collector frees
            del cycle
            _ = [[] for _ in range(100)]  # allocations that would start a collection
        step(self, i)

    monkeypatch.setattr(integrator.StreamStages, "step", planted)
    compiled, cam = _graph_scene("K1", cuda)
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        _, m_g, st_g = render_image(compiled, cam, progress=False)
    finally:
        gc.set_threshold(*threshold)
    monkeypatch.setattr(integrator.StreamStages, "step", step)
    gc.collect()
    with R.plain_launches():
        _, m_e, st_e = render_image(compiled, cam, progress=False)
    assert not held
    np.testing.assert_array_equal(m_g, m_e)
    assert st_g.iterations == st_e.iterations > 0


def test_tables_are_never_built_under_capture(cuda):
    """K1's tables and K4's wide tree raise when first made under capture."""
    compiled, _ = _graph_scene("K4", cuda)
    sd = compiled.data
    o = torch.zeros((32, 3), device=cuda)
    d = torch.zeros((32, 3), device=cuda)
    d[:, 2] = 1.0
    stream = torch.cuda.Stream()
    for what, fn in (("tables", lambda: hit_kernel.tables(sd)),
                     ("wide tree", lambda: bvh_kernel.closest_tri_bvh(o, d, torch.ones(32, device=cuda), 1e-3,
                                                                    *bvh_kernel.scene_nodes(sd)))):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            g.capture_begin()
            try:
                with pytest.raises(RuntimeError, match="under CUDA graph capture"):
                    fn()
            finally:
                g.capture_end()


@pytest.mark.parametrize("n", [0, 7, 100_003, 360_000])
def test_stage_cond_kernel_bit_equal_to_plain(cuda, n):
    """K5 against its plain version: the lanes with work, the decision on either side of
    the threshold, the counter bumped once."""
    from tpupt_torch.ops import loop_cond

    rng = np.random.default_rng(n)
    alive = torch.from_numpy(rng.uniform(size=n) < 0.3).to(cuda)
    sample = torch.from_numpy(rng.integers(0, 10, n).astype(np.int32)).to(cuda)
    sample0 = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)).to(cuda)
    n_work = int(loop_cond.stage_cond_plain(alive, sample, sample0, 8, 32, 0)[0])
    for thr in sorted({0, n_work, max(n_work - 1, 0), n // 2}):
        it = torch.zeros(1, dtype=torch.int64, device=cuda)
        out = loop_cond.stage_cond(alive, sample, sample0, 8, 32, thr, it, bump=True)
        assert out.tolist() == loop_cond.stage_cond_plain(alive, sample, sample0, 8, 32, thr).tolist()
        assert int(it) == 1


# ---- the gradient pass as CUDA graphs (render/graph.py GradGraphs) against the eager route ----


def _grad_case(which, cuda):
    """(compiled, camera) of a small gradient case on the card: the box (K1), the Cornell box
    (K1), the HDR-map scene (K1; principled, metal, the env_img gradient), the mesh on the flat
    clusters (K2), 60000 random triangles on the two-level clusters (K3), the mesh on the BVH
    (K4)."""
    if which == "cornell":
        scene, cam = cornell_box_scene(32, 8)
        cam.max_depth = 12
    elif which == "box":
        scene, cam = _grad_box_scene()
    elif which == "hdr":
        scene, cam = grad_hdr_scene(16, 8)
    elif which == "two_level":
        scene, cam = random_mesh_scene(16, 8)
    else:
        scene, cam = _mesh_scene(16, 8)
    return scene.compile(device=cuda, bvh=True if which == "bvh" else None), cam


def _grad_counts():
    from tpupt_torch.ops import loop_cond

    return {"K1": hit_kernel.launches, "K2": tri_kernel.launches["flat"], "K3": tri_kernel.launches["two_level"],
            "K4": bvh_kernel.launches, "gate": loop_cond.gate_launches, "countdown": loop_cond.countdown_launches}


def _grads_by_route(compiled, cam, seed=0, route="graphs"):
    """render_film_grads by one route -> (mean, grads, GradStats, launches by kernel in the call)."""
    from tpupt_torch.render import diff as D

    before = _grad_counts()
    with D.plain_grads() if route == "eager" else _nullcontext():
        mean, grads, st = D.render_film_grads(compiled, cam, seed=seed, return_stats=True)
    torch.cuda.synchronize()
    after = _grad_counts()
    return mean, grads, st, {k: after[k] - before[k] for k in before}


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


def _assert_grads_rel_l1(got, ref, rel_l1=1e-6):
    for n, g in ref.items():
        assert bool(torch.isfinite(got[n]).all()), n
        total, err = float(g.abs().sum()), float((got[n] - g).abs().sum())
        assert (err == 0.0) if total == 0.0 else err <= rel_l1 * total, (n, err, total)


@pytest.mark.parametrize("which", ["box", "cornell", "hdr", "mesh", "two_level", "bvh"])
def test_grad_graph_route_matches_eager_route(cuda, which):
    """render_film_grads through the graphs against plain_grads() on the card: film bit-equal,
    rays and trips equal, gradients within relative L1 1e-6 (a trip's gradient is summed
    before it joins the total, and the gathers' backward adds with atomics); every kernel of
    the case launched once a trip forward and once in its replay, the gate once a trip and
    once a chunk, the countdown the same; one host read a chunk and one more."""
    compiled, cam = _grad_case(which, cuda)
    m_g, g_g, st_g, n_g = _grads_by_route(compiled, cam)
    m_e, g_e, st_e, _ = _grads_by_route(compiled, cam, route="eager")
    assert torch.equal(m_g.view(torch.int32), m_e.view(torch.int32))
    assert (st_g.rays, st_g.trips) == (st_e.rays, st_e.trips) and st_g.trips > 0
    _assert_grads_rel_l1(g_g, g_e)
    kernel = {"mesh": "K2", "two_level": "K3", "bvh": "K4"}.get(which, "K1")
    assert st_g.launches_forward[kernel] == st_g.launches_backward[kernel] == st_g.trips
    assert n_g[kernel] == 2 * st_g.trips
    assert n_g["gate"] == st_g.trips + st_g.chunks and n_g["countdown"] == st_g.trips + st_g.chunks
    assert st_g.host_reads == st_g.chunks + 1 and st_g.chunks >= 1 and st_g.capture_s > 0
    assert not any(v.data_ptr() == w.data_ptr() for v in g_g.values() for w in g_e.values())


def test_grad_graph_second_call_replays(cuda):
    """A second call of one configuration, with another seed and other parameter values,
    replays the kept graphs (capture_s 0) and equals the eager route at that seed; the first
    call's gradients are the caller's, untouched by the second."""
    from tpupt_torch.render import diff as D

    compiled, cam = _grad_case("box", cuda)
    _, g1, st1, _ = _grads_by_route(compiled, cam, seed=0)
    kept = {n: g.clone() for n, g in g1.items()}
    with torch.no_grad():
        compiled.data.tex_rgb.mul_(0.75)
    m2, g2, st2, n2 = _grads_by_route(compiled, cam, seed=7)
    m_e, g_e, st_e, _ = _grads_by_route(compiled, cam, seed=7, route="eager")
    assert st1.capture_s > 0 and st2.capture_s == 0.0
    assert torch.equal(m2.view(torch.int32), m_e.view(torch.int32)) and st2.trips == st_e.trips
    _assert_grads_rel_l1(g2, g_e)
    assert all(torch.equal(g1[n], kept[n]) for n in kept)
    assert n2["K1"] == 2 * st2.trips  # every launch on the card, none eager, counted
    assert len(compiled._grad_graphs) == 1


def test_grad_graph_recaptures_after_a_geometry_edit(cuda):
    """An edit in place of a geometry tensor between two calls makes new graphs (the kept ones
    would read K1's old tables), and the call equals the eager route on the edited scene."""
    compiled, cam = _grad_case("box", cuda)
    _grads_by_route(compiled, cam)
    with torch.no_grad():
        compiled.data.sph_r.mul_(1.25)  # a bigger sphere
    m, g, st, _ = _grads_by_route(compiled, cam)
    m_e, g_e, _, _ = _grads_by_route(compiled, cam, route="eager")
    assert st.capture_s > 0
    assert torch.equal(m.view(torch.int32), m_e.view(torch.int32))
    _assert_grads_rel_l1(g, g_e)


def test_grad_graph_chunks(cuda, monkeypatch):
    """A staging budget of one segment: chunks of 8 trips, their rows copied out and back,
    one host read a chunk and one more; the same film and gradients as the eager route."""
    from tpupt_torch.render import diff as D

    compiled, cam = _grad_case("cornell", cuda)
    monkeypatch.setattr(D, "STAGING_BYTES", 1)
    m, g, st, n = _grads_by_route(compiled, cam)
    m_e, g_e, st_e, _ = _grads_by_route(compiled, cam, route="eager")
    assert st.chunks == -(-st.trips // D.SEGMENT) >= 2 and st.host_reads == st.chunks + 1
    assert torch.equal(m.view(torch.int32), m_e.view(torch.int32)) and st.trips == st_e.trips
    _assert_grads_rel_l1(g, g_e)
    assert n["gate"] == st.trips + st.chunks and n["countdown"] == st.trips + st.chunks


@pytest.mark.parametrize("which", ["cornell", "mesh", "two_level", "bvh"])
def test_grad_graph_replays_see_the_forward_bits(cuda, monkeypatch, which):
    """Inside the graphs, each replayed trip's output state is, bit for bit, the carry its
    forward trip handed to the next trip (saved in the next staging row), with chunks of one
    segment so that every chunk's rows went out to a store and came back: the kernels (K1;
    K2, K3 or K4 on the meshes) see the forward trip's rays in the replay. Counted on the
    card, for every replay but each chunk's newest (whose next carry is in the next chunk)."""
    from tpupt_torch.render import diff as D

    compiled, cam = _grad_case(which, cuda)
    mismatches = torch.zeros(1, dtype=torch.int64, device=cuda)
    checked = torch.zeros(1, dtype=torch.int64, device=cuda)
    step = D.FilmScanStages._step

    def checked_step(self, s, sd):
        out = step(self, s, sd)
        if torch.is_grad_enabled():  # a replay (forward trips run without autograd)
            row = torch.clamp(self.row + 1, max=self.chunk_trips - 1)
            inside = (self.index + 1 < self.chunk[1]).to(torch.int64)
            for key, buf in self.saved.items():
                a, b = out[0][key].detach(), torch.index_select(buf, 0, row)[0]
                if a.is_floating_point():
                    a, b = a.view(torch.int32), b.view(torch.int32)
                mismatches.add_((a != b).sum() * inside)
            checked.add_(inside)
        return out

    monkeypatch.setattr(D.FilmScanStages, "_step", checked_step)
    monkeypatch.setattr(D, "STAGING_BYTES", 1)
    _, _, st, n = _grads_by_route(compiled, cam)
    kernel = {"mesh": "K2", "two_level": "K3", "bvh": "K4"}.get(which, "K1")
    assert st.chunks == st.trips // D.SEGMENT >= 1 and n[kernel] == 2 * st.trips
    assert int(mismatches) == 0 and int(checked) == st.trips - st.chunks > 0


@pytest.mark.parametrize("part", ["forward", "backward"])
def test_grad_graph_capture_failure_raises(cuda, monkeypatch, part):
    """A host read planted in a trip under capture makes render_film_grads raise, naming the
    trip being captured; the eager route does not take over, and the next call captures anew."""
    from tpupt_torch.render import diff as D

    trip = getattr(D.FilmScanStages, f"{part}_trip")

    def planted(self):
        if torch.cuda.is_current_stream_capturing():
            int(self.rays)  # a host read: illegal while the stream is captured
        trip(self)

    monkeypatch.setattr(D.FilmScanStages, f"{part}_trip", planted)
    compiled, cam = _grad_case("box", cuda)
    with pytest.raises(RuntimeError, match=f"capturing the {part} trip"):
        D.render_film_grads(compiled, cam, seed=0)
    monkeypatch.setattr(D.FilmScanStages, f"{part}_trip", trip)
    m, g, st, _ = _grads_by_route(compiled, cam)
    m_e, _, _, _ = _grads_by_route(compiled, cam, route="eager")
    assert st.capture_s > 0 and torch.equal(m.view(torch.int32), m_e.view(torch.int32))


def test_grad_graph_bodies_hold_only_body_nodes(cuda):
    """The census of the captured trips: kernel, memcpy, memset (and empty, child graph)
    nodes only, in particular no event record or wait nodes from the autograd engine."""
    from tpupt_torch.ops import loop_cond
    from tpupt_torch.render import graph as G

    compiled, cam = _grad_case("mesh", cuda)
    _grads_by_route(compiled, cam)
    (graphs,) = compiled._grad_graphs.values()
    for name in ("forward", "backward"):
        kinds = G._node_types(graphs.bodies[name])
        assert kinds.get("kernel", 0) > 0 and set(kinds) <= set(loop_cond.BODY_NODE_TYPES), (name, kinds)


@pytest.mark.parametrize("n", [1, 4097, 65_536, 360_000])
def test_grad_conditions_bit_equal_to_plain(cuda, n):
    """K5's gate and countdown against their plain versions at every trip of two chunks, with
    lanes with work and without, segments of 1, 3 and 8 trips."""
    from tpupt_torch.ops import loop_cond

    rng = np.random.default_rng(n)
    k, spp = 4, 16
    sample0 = torch.from_numpy(rng.integers(0, spp, n).astype(np.int32)).to(cuda)
    bad = 0
    for segment in (1, 3, 8):
        cap = -(-(k * 5) // segment) * segment
        for p_alive, s in ((0.2, 1), (0.0, k)):
            alive = torch.from_numpy(rng.uniform(size=n) < p_alive).to(cuda)
            sample = torch.full((n,), s, dtype=torch.int32, device=cuda)
            for c0 in (0, 2 * segment):
                chunk = torch.tensor([c0, c0 + 2 * segment], device=cuda)
                for t in range(c0, c0 + 2 * segment + 1):
                    for bump in (False, True):
                        trips = torch.tensor([t - bump], device=cuda)
                        trips_ref = trips.clone()
                        out = loop_cond.grad_gate(alive, sample, sample0, k, spp, segment, cap, trips, chunk, bump)
                        ref = loop_cond.grad_gate_plain(alive, sample, sample0, k, spp, segment, cap, trips_ref,
                                                        chunk, bump)
                        bad += int(out.tolist() != ref.tolist() or int(trips) != int(trips_ref))
    chunk = torch.tensor([5, 13], device=cuda)
    index, replays = torch.tensor([12], device=cuda), torch.zeros(1, dtype=torch.int64, device=cuda)
    index_ref, replays_ref = index.clone(), replays.clone()
    for bump in [False] + [True] * 9:
        out = loop_cond.grad_countdown(index, chunk, replays, bump)
        ref = loop_cond.grad_countdown_plain(index_ref, chunk, replays_ref, bump)
        bad += int(out.tolist() != ref.tolist() or int(index) != int(index_ref) or int(replays) != int(replays_ref))
    assert bad == 0


# ---- kept launch graphs, render_grads and segmented_film_vjp as CUDA graphs ----


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_render_second_call_replays_kept_graphs(cuda, which):
    """A second render_image call of one compiled scene, with another seed, replays the
    graphs kept from the first (capture_s 0, no eager iteration: every kernel launch is
    counted on the card) and equals the eager loop at that seed, bit for bit."""
    from tpupt_torch.ops import loop_cond
    from tpupt_torch.render import renderer as R

    compiled, cam = _graph_scene(which, cuda)
    count = {"K1": lambda: hit_kernel.launches, "K3": lambda: tri_kernel.launches["two_level"]}[which]
    _, _, st1 = render_image(compiled, cam, seed=0, progress=False)
    before, conds = count(), loop_cond.launches
    _, m2, st2 = render_image(compiled, cam, seed=1, progress=False)
    launched, conds = count() - before, loop_cond.launches - conds
    with R.plain_launches():
        _, m_e, st_e = render_image(compiled, cam, seed=1, progress=False)
    assert st1.capture_s > 0 and st2.capture_s == 0.0
    np.testing.assert_array_equal(m2, m_e)
    assert (st2.rays, st2.iterations) == (st_e.rays, st_e.iterations)
    assert launched == st2.iterations > 0 and conds >= st2.iterations
    assert len(compiled._launch_graphs._launches) == 1


def test_render_recaptures_after_a_geometry_edit(cuda):
    """An edit in place of a geometry tensor between two calls makes the launch graphs anew
    (the kept ones would read K1's old tables), and the call equals the eager loop on the
    edited scene; so does a replaced parameter tensor, which the render's graphs read where
    it lies."""
    from tpupt_torch.render import renderer as R

    compiled, cam = _graph_scene("K1", cuda)
    render_image(compiled, cam, progress=False)
    with torch.no_grad():
        compiled.data.sph_r.mul_(1.25)
    _, m, st = render_image(compiled, cam, progress=False)
    with R.plain_launches():
        _, m_e, _ = render_image(compiled, cam, progress=False)
    assert st.capture_s > 0
    np.testing.assert_array_equal(m, m_e)
    compiled.data.tex_rgb = compiled.data.tex_rgb * 0.5
    _, m, st = render_image(compiled, cam, progress=False)
    with R.plain_launches():
        _, m_e, _ = render_image(compiled, cam, progress=False)
    assert st.capture_s > 0
    np.testing.assert_array_equal(m, m_e)


def _render_grads_by_route(compiled, cam, seed=0, route="graphs", spp=4):
    """render_grads of every pixel by one route -> (radiance, grads, rays, launches by kernel,
    the kept graphs of the call (graph route) or None)."""
    from tpupt_torch.render import diff as D

    ids = np.arange(cam.image_width * cam.image_height, dtype=np.int32)
    before = _grad_counts()
    with D.plain_grads() if route == "eager" else _nullcontext():
        radiance, grads, rays = D.render_grads(compiled, cam, ids, spp, seed=seed, return_stats=True)
    torch.cuda.synchronize()
    after = _grad_counts()
    graphs = None if route == "eager" else next(iter(compiled._radiance_graphs.values()))
    return radiance, grads, rays, {k: after[k] - before[k] for k in before}, graphs


@pytest.mark.parametrize("which", ["box", "mesh", "two_level", "bvh"])
def test_render_grads_graph_route_matches_eager_route(cuda, which):
    """render_grads through the graphs against plain_grads() on the card: radiance bit-equal,
    rays equal, gradients within relative L1 1e-6; the kernel launched once a trip forward
    and once in its replay by both routes; the gate and the countdown once a trip and a
    chunk; one host read a chunk and one more."""
    compiled, cam = _grad_case(which, cuda)
    r_g, g_g, rays_g, n_g, graphs = _render_grads_by_route(compiled, cam)
    r_e, g_e, rays_e, n_e, _ = _render_grads_by_route(compiled, cam, route="eager")
    assert torch.equal(r_g.view(torch.int32), r_e.view(torch.int32)) and rays_g == rays_e
    _assert_grads_rel_l1(g_g, g_e)
    kernel = {"mesh": "K2", "two_level": "K3", "bvh": "K4"}.get(which, "K1")
    trips = graphs.trips
    assert 0 < trips <= cam.max_depth and n_g[kernel] == n_e[kernel] == 2 * trips
    assert n_g["gate"] == n_g["countdown"] == trips + graphs.chunks
    assert graphs.host_reads == graphs.chunks + 1 and graphs.capture_s > 0
    assert not any(v.data_ptr() == w.data_ptr() for v in g_g.values() for w in g_e.values())


def test_render_grads_second_call_replays(cuda, monkeypatch):
    """A second render_grads call with another seed and other parameter values replays the
    kept graphs (capture_s 0) and equals the eager route at that seed; with chunks of one
    segment, every chunk's rows go out to a store and come back."""
    from tpupt_torch.render import diff as D

    monkeypatch.setattr(D, "STAGING_BYTES", 1)
    compiled, cam = _grad_case("cornell", cuda)
    _render_grads_by_route(compiled, cam)
    with torch.no_grad():
        compiled.data.tex_rgb.mul_(0.75)
    r2, g2, rays2, n2, graphs = _render_grads_by_route(compiled, cam, seed=7)
    r_e, g_e, rays_e, _, _ = _render_grads_by_route(compiled, cam, seed=7, route="eager")
    assert graphs.capture_s == 0.0 and graphs.chunks == -(-graphs.trips // D.SEGMENT) >= 2
    assert torch.equal(r2.view(torch.int32), r_e.view(torch.int32)) and rays2 == rays_e
    _assert_grads_rel_l1(g2, g_e)
    assert n2["K1"] == 2 * graphs.trips and len(compiled._radiance_graphs) == 1


@pytest.mark.parametrize("part", ["forward", "backward"])
def test_render_grads_capture_failure_raises(cuda, monkeypatch, part):
    """A host read planted in a trip under capture makes render_grads raise, naming the trip
    being captured; the eager route does not take over, and the next call captures anew."""
    from tpupt_torch.render import diff as D

    trip = getattr(D.RadianceScanStages, f"{part}_trip")

    def planted(self):
        if torch.cuda.is_current_stream_capturing():
            int(self.rays)  # a host read: illegal while the stream is captured
        trip(self)

    monkeypatch.setattr(D.RadianceScanStages, f"{part}_trip", planted)
    compiled, cam = _grad_case("box", cuda)
    with pytest.raises(RuntimeError, match=f"capturing the {part} trip"):
        D.render_grads(compiled, cam, np.arange(cam.image_width * cam.image_height, dtype=np.int32), 4)
    monkeypatch.setattr(D.RadianceScanStages, f"{part}_trip", trip)
    r, _, rays, _, graphs = _render_grads_by_route(compiled, cam)
    r_e, _, rays_e, _, _ = _render_grads_by_route(compiled, cam, route="eager")
    assert len(compiled._radiance_graphs) == 1 and not graphs.closed
    assert graphs.capture_s > 0 and torch.equal(r.view(torch.int32), r_e.view(torch.int32)) and rays == rays_e


def test_render_grads_sharded_nccl_world_of_one(cuda):
    """render_grads_sharded over a world of 1 over NCCL, by the graphs and by the eager route:
    film bit-equal, gradients within relative L1 1e-6; each route issues one all-reduce a
    segment and one for the film; a second graph call replays."""
    import socket

    import torch.distributed as dist

    from tpupt_torch.parallel import sharding as S
    from tpupt_torch.render import diff as D

    compiled, cam = _grad_case("box", cuda)
    ids = np.arange(cam.image_width * cam.image_height, dtype=np.int32)
    calls = []
    reduce = S.Mesh.all_reduce

    def counted(self, tensor, async_op=False):
        calls.append(tensor.numel())
        return reduce(self, tensor, async_op=async_op)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = S.make_mesh(1, device="cuda:0")
        S.Mesh.all_reduce = counted
        runs = {}
        for route in ("graphs", "graphs again", "eager"):
            calls.clear()
            with D.plain_grads() if route == "eager" else _nullcontext():
                runs[route] = S.render_grads_sharded(compiled, cam, ids, ids // cam.image_width,
                                                     ids % cam.image_width, spp=8, mesh=mesh) + (len(calls),)
    finally:
        S.Mesh.all_reduce = reduce
        dist.destroy_process_group()
    n_seg = -(-cam.max_depth // D.SEGMENT)
    (f_g, g_g, c_g), (f_2, g_2, c_2), (f_e, g_e, c_e) = runs["graphs"], runs["graphs again"], runs["eager"]
    assert c_g == c_2 == c_e == n_seg + 1
    assert torch.equal(f_g.view(torch.int32), f_e.view(torch.int32)) and torch.equal(f_2, f_g)
    _assert_grads_rel_l1(g_g, g_e)
    _assert_grads_rel_l1(g_2, g_e)
    (graphs,) = compiled.data._radiance_graphs.values()
    assert graphs.capture_s == 0.0 and graphs.trips > 0


def _same_bits(a, b):
    """Float arrays bit-equal, a NaN's payload aside (the card's arithmetic makes the canonical
    NaN, the host's keeps an operand's)."""
    a, b = np.asarray(a), np.asarray(b)
    na, nb = np.isnan(a), np.isnan(b)
    assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(na, nb)
    assert a[~na].tobytes() == b[~nb].tobytes()


def test_film_kernels_bit_equal_to_their_twins(cuda):
    """csrc/film.cu's add over 12 launches (4 pixel blocks of 16384, the last padded, whose
    padded lanes hold NaN; NaN and +-inf among the real lanes too) and its resolve, against
    ops/film_kernel.py's plain versions and numpy's formulas, on that film and on films of
    the tonemap's edges (tests/test_torch_film.py)."""
    from test_torch_film import edge_film
    from tpupt_torch.ops import film_kernel
    from tpupt_torch.render.film import tonemap_quantize

    rng = np.random.default_rng(11)
    npix, pb = 60000, 16384
    order = rng.permutation(npix).astype(np.int32)
    card = torch.zeros((npix, 3), dtype=torch.float64, device=cuda)
    plain = torch.zeros((npix, 3), dtype=torch.float64)
    added = film_kernel.launches["add"]
    for _ in range(3):
        for lo in range(0, npix, pb):
            n_valid = min(pb, npix - lo)
            ids = np.zeros(pb, np.int32)
            ids[:n_valid] = order[lo : lo + n_valid]
            out = rng.exponential(size=(pb, 3)).astype(np.float32) * np.float32(10.0 ** rng.integers(-3, 3))
            out[rng.random(out.shape) < 0.001] = np.nan
            out[rng.random(out.shape) < 0.001] = np.inf
            out[rng.random(out.shape) < 0.001] = -np.inf
            out[n_valid:] = np.nan
            film_kernel.add(card, torch.from_numpy(out).to(cuda), torch.from_numpy(ids).to(cuda), n_valid)
            film_kernel.add_plain(plain, torch.from_numpy(out), torch.from_numpy(ids), n_valid)
    assert film_kernel.launches["add"] - added == 12
    _same_bits(card.cpu().numpy(), plain.numpy())
    for spp in (1, 7, 100):
        for film in (plain, torch.from_numpy(edge_film(spp, spp))):
            img_c, mean_c = film_kernel.resolve(film.to(cuda), spp)
            img_p, mean_p = film_kernel.resolve_plain(film, spp)
            want = film.numpy() / spp
            assert img_c.cpu().numpy().tobytes() == img_p.numpy().tobytes() == tonemap_quantize(want).tobytes()
            _same_bits(mean_c.cpu().numpy(), mean_p.numpy())
            _same_bits(mean_c.cpu().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("case", ["cornell", "balls", "blocks"])
def test_card_render_resolves_its_film_as_numpy(cuda, case, tmp_path):
    """The image and mean of a card render (the benchmark's Cornell and balls frames, and
    Cornell at 300 px over 2 pixel blocks, the last padded, and 2 sample chunks) bit-equal
    numpy's formulas over the float64 film its checkpoint holds; the same render again,
    without a checkpoint, takes its inputs from the kept buffers and gives the same bits."""
    from tpupt_torch.render.film import tonemap_quantize

    build, size, spp, kw = {"cornell": (cornell_box_scene, 600, 100, {}), "balls": (balls_scene, 600, 100, {}),
                            "blocks": (cornell_box_scene, 300, 16,
                                       dict(rays_per_launch=65536, samples_per_launch=8))}[case]
    scene, cam = build(size, spp)
    compiled = scene.compile(device=cuda)
    ck = str(tmp_path / "film.npz")
    img, mean, st = render_image(compiled, cam, seed=5, progress=False, checkpoint_path=ck, **kw)
    assert st.launches == (4 if case == "blocks" else 1) and st.host_free_launches == 0
    want = (np.load(ck)["film"] / spp).reshape(cam.image_height, cam.image_width, 3)
    assert img.tobytes() == tonemap_quantize(want).tobytes()
    _same_bits(mean, want.astype(np.float32))
    img2, mean2, st2 = render_image(compiled, cam, seed=5, progress=False, **kw)
    assert st2.host_free_launches == st2.launches == st.launches
    assert img2.tobytes() == img.tobytes()
    _same_bits(mean2, mean)


def test_successive_card_frames_do_not_alias(cuda):
    """Each call's image and mean are arrays of its own: a later frame neither shares memory
    with an earlier one nor writes into it."""
    scene, cam = cornell_box_scene(96, 8)
    compiled = scene.compile(device=cuda)
    img1, mean1, _ = render_image(compiled, cam, seed=1, progress=False)
    kept_img, kept_mean = img1.copy(), mean1.copy()
    img2, mean2, st2 = render_image(compiled, cam, seed=2, progress=False)
    assert not any(np.shares_memory(a, b) for a in (img1, mean1) for b in (img2, mean2))
    assert img1.tobytes() == kept_img.tobytes() and mean1.tobytes() == kept_mean.tobytes()
    assert mean2.tobytes() != mean1.tobytes() and st2.host_free_launches == st2.launches
    _, mean3, _ = render_image(compiled, cam, seed=1, progress=False)
    assert mean3.tobytes() == kept_mean.tobytes()
