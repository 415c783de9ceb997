"""The 4-wide tables of K4 (ops/bvh_kernel.py) and its walk, on the CPU.

The kernel cannot run here, so its walk is emulated in this file with the same
floats: fetch a wide node, test its children's boxes against the slabs, tmin and
t_in, push those that pass last first with their tn, pop, go on only where tn <=
best. No tolerance anywhere: the emulation must give bvh_closest_tri_plain's bits
(t, idx and the winner's attributes) on every lane, and the BVH route's hit record
with the walk's attributes must equal the one gathered in _make_hit.
"""

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tpupt_torch.core.linalg import BIG
from tpupt_torch.ops import bvh_kernel, intersect, tri_kernel
from tpupt_torch.ops.bvh import LEAF_SIZE, build_tri_bvh, build_tri_bvh_sah, bvh_closest_tri_plain
from tpupt_torch.scene import builder as TB
from tpupt_torch.scenes import everything_scene

from test_torch_bvh import _blob, _shell_rays
from test_torch_cuda import _left_deep

FIELDS = ("valid", "t", "point", "ng", "ns", "front", "u", "v", "mat_id")
W = bvh_kernel.WIDTH


def _soup(n, seed, morton):
    """(nodes, tris, attr) of an n-triangle random soup in its tree's order, CPU tensors,
    with random normals, UVs on every other triangle and random material ids. A tenth
    of the triangles are nine copies each of a few, so that rays meet exact ties in t
    across leaves, which only the binary tree's leaf order resolves."""
    rng = np.random.default_rng(seed)
    v0 = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    e1, e2 = ((rng.normal(size=(n, 3)) * 0.5).astype(np.float32) for _ in range(2))
    copies = rng.permutation(n)[: n // 10]
    for a in (v0, e1, e2):
        a[copies] = a[copies[np.arange(copies.size) // 9 * 9]]
    order, nodes = build_tri_bvh(v0, e1, e2) if morton else build_tri_bvh_sah(v0, e1, e2)[:2]
    attr = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    attr += [rng.uniform(size=(n, 2)).astype(np.float32) for _ in range(3)]
    attr += [np.arange(n) % 2 == 0, rng.integers(0, 50, size=n).astype(np.int32)]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (tuple(to(nodes[k]) for k in ("bmin", "bmax", "skip", "start", "count")),
            tuple(to(a[order]) for a in (v0, e1, e2)), tuple(to(a[order]) for a in attr))


def _scene6_tables():
    """(nodes, tris, attr) of chip_smoke.py's scene-6 stand-in compiled with bvh=True."""
    with tempfile.TemporaryDirectory() as d:
        old = os.environ.get("TPUPT_ASSETS")
        os.environ["TPUPT_ASSETS"] = d
        try:
            CS.write_stand_in_assets(d)
            sd = everything_scene(32, 1)[0].compile(device="cpu", bvh=True).data
        finally:
            if old is None:
                del os.environ["TPUPT_ASSETS"]
            else:
                os.environ["TPUPT_ASSETS"] = old
    assert sd.has_tri_bvh
    return bvh_kernel.scene_nodes(sd)


def _tables(which):
    if which == "scene6":
        return _scene6_tables()
    return _soup(3000, 0, morton=which == "morton")


def _binary_leaves(nodes):
    """(start, count) of the binary tree's leaves in its DFS order."""
    start, count = nodes[3].numpy(), nodes[4].numpy()
    return [(int(s), int(c)) for s, c in zip(start, count) if c > 0]


def _wide_dfs_leaves(wide):
    """The leaves' (start, count) of the packed wide tree in its DFS order (children in
    slot order), and the deepest stack of a walk in which every child passes."""
    ref = wide[:, 6 * W : 7 * W].contiguous().view(torch.int32).numpy()
    real = ~np.isnan(wide[:, 0:W].numpy())
    leaves, stack, deepest = [], [0], 0
    while stack:
        r = stack.pop()
        if r >= 0:
            kids = [int(ref[r, k]) for k in range(W) if real[r, k]]
            stack.extend(reversed(kids))
            deepest = max(deepest, len(stack))
        else:
            leaves.append(((~r) >> 3, (~r) & 7))
    return leaves, deepest


@pytest.mark.parametrize("which", ["morton", "sah", "scene6"])
def test_wide_packing(which):
    """Each slot holds its binary node's exact box; the children of a wide node are
    disjoint binary subtrees in DFS order, nested in the slot that points to them; the
    leaves come out in the binary tree's order with its (start, count); the stack bound
    is the deepest stack of an all-pass walk."""
    nodes = _tables(which)[0]
    bmin, bmax, skip, _, count = (x.numpy() for x in nodes)
    slots, deepest = bvh_kernel.wide_tree(skip, count, bmin, bmax)
    wide, deepest_packed = bvh_kernel.pack_wide(nodes)
    assert deepest == deepest_packed and wide.shape == (len(slots), bvh_kernel.NODE_FLOATS)
    assert wide.dtype == torch.float32
    w = wide.numpy()
    ref = w[:, 6 * W : 7 * W].copy().view(np.int32)
    for i, s in enumerate(slots):
        assert 1 <= len(s) <= bvh_kernel.WIDTH or (i == 0 and nodes[2].shape[0] == 1)
        for a, b in zip(s, s[1:]):  # in DFS order, disjoint subtrees
            assert skip[a] <= b
        for k in range(bvh_kernel.WIDTH):
            box = w[i, [k, 2 * W + k, 4 * W + k]], w[i, [W + k, 3 * W + k, 5 * W + k]]
            if k >= len(s):
                assert np.isnan(box[0]).all() and np.isnan(box[1]).all()
                continue
            np.testing.assert_array_equal(box[0], bmin[s[k]])
            np.testing.assert_array_equal(box[1], bmax[s[k]])
            if count[s[k]] == 0:  # an internal slot: its wide node's slots lie inside it
                inner = slots[ref[i, k]]
                assert all(s[k] < c < skip[s[k]] for c in inner)
                assert (bmin[inner] >= bmin[s[k]]).all() and (bmax[inner] <= bmax[s[k]]).all()
    leaves, walked = _wide_dfs_leaves(wide)
    assert leaves == _binary_leaves(nodes)
    assert walked == deepest <= bvh_kernel.STACK


def test_stack_bound_too_deep_raises():
    nodes = _left_deep(80)
    n = 81
    tris = tuple(torch.zeros((n, 3)) for _ in range(3))
    attr = (*(torch.zeros((n, 3)) for _ in range(3)), *(torch.zeros((n, 2)) for _ in range(3)),
            torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32))
    _, deepest = bvh_kernel.pack_wide(nodes)
    assert deepest > bvh_kernel.STACK
    assert _wide_dfs_leaves(bvh_kernel.pack_wide(nodes)[0])[0] == _binary_leaves(nodes)
    with pytest.raises(ValueError, match="stack"):
        bvh_kernel._packed(nodes, tris, attr)
    assert bvh_kernel.pack_wide(_left_deep(10))[1] <= bvh_kernel.STACK


def _emulate(o, d, t_in, tmin, nodes, tris, attr):
    """csrc/bvh_kernel.cu's walk over the packed tables, all rays at once: one step a
    loop, each step a fetch (if a node is due) and a pop, as the kernel's loop."""
    wide, deepest = bvh_kernel.pack_wide(nodes)
    rows, arows = bvh_kernel.pack_rows(tris), bvh_kernel.pack_attr(attr)
    geo = rows[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]]
    box = wide[:, 0 : 6 * W].reshape(-1, 6, W)  # min x, max x, min y, max y, min z, max z; child in lane
    ref = wide[:, 6 * W : 7 * W].contiguous().view(torch.int32).long()
    b, cap = o.shape[0], bvh_kernel.STACK
    inv = torch.stack([tri_kernel._inv(d[:, k]) for k in range(3)], dim=1)
    tmin_t = torch.tensor(tmin, dtype=torch.float32)
    best = torch.full((b,), BIG)
    best_i = torch.zeros(b, dtype=torch.int32)
    best_u, best_v = torch.zeros(b), torch.zeros(b)
    st_ref = torch.zeros((b, cap), dtype=torch.int64)
    st_tn = torch.zeros((b, cap))
    sp = torch.zeros(b, dtype=torch.int64)
    node = torch.zeros(b, dtype=torch.int64)
    live = torch.arange(b)
    deepest_seen = 0
    while live.numel():
        f = live[node[live] >= 0]
        if f.numel():
            n, oo, iv = node[f], o[f][:, :, None], inv[f][:, :, None]
            t1x, t2x = (box[n, 0] - oo[:, 0]) * iv[:, 0], (box[n, 1] - oo[:, 0]) * iv[:, 0]
            t1y, t2y = (box[n, 2] - oo[:, 1]) * iv[:, 1], (box[n, 3] - oo[:, 1]) * iv[:, 1]
            t1z, t2z = (box[n, 4] - oo[:, 2]) * iv[:, 2], (box[n, 5] - oo[:, 2]) * iv[:, 2]
            mn, mx = torch.minimum, torch.maximum
            tn = mx(mx(mn(t1x, t2x), mn(t1y, t2y)), mx(mn(t1z, t2z), tmin_t))
            tf = mn(mn(mx(t1x, t2x), mx(t1y, t2y)), mx(t1z, t2z))
            ok = (tn <= tf) & (tn <= t_in[f, None])
            for k in reversed(range(W)):
                m = ok[:, k]
                r = f[m]
                st_ref[r, sp[r]] = ref[n[m], k]
                st_tn[r, sp[r]] = tn[m, k]
                sp[r] += 1
            node[f] = -1
            deepest_seen = max(deepest_seen, int(sp[f].max()))
        live = live[sp[live] > 0]
        if not live.numel():
            break
        p = live
        sp[p] -= 1
        e_ref, e_tn = st_ref[p, sp[p]], st_tn[p, sp[p]]
        go = e_tn <= best[p]
        node[p[go & (e_ref >= 0)]] = e_ref[go & (e_ref >= 0)]
        leaf = go & (e_ref < 0)
        r, code = p[leaf], ~e_ref[leaf]
        start, cnt = code >> 3, code & 7
        for k in range(LEAF_SIZE):
            on = k < cnt
            rr, ti = r[on], start[on] + k
            oo, dd = o[rr], d[rr]
            limit = best[rr]
            hit, t, u, v = tri_kernel._mt(geo[ti], oo[:, 0], oo[:, 1], oo[:, 2], dd[:, 0], dd[:, 1], dd[:, 2],
                                          tmin_t, limit)
            hit = hit & (t < t_in[rr])
            best[rr] = torch.where(hit, t, limit)
            best_i[rr] = torch.where(hit, ti.to(torch.int32), best_i[rr])
            best_u[rr] = torch.where(hit, u, best_u[rr])
            best_v[rr] = torch.where(hit, v, best_v[rr])
        live = live[(sp[live] > 0) | (node[live] >= 0)]
    assert deepest_seen <= deepest <= cap
    # the winner's attribute row, as the kernel reads it
    found = best < BIG
    a = arows[best_i.long()]
    w = 1.0 - best_u - best_v
    ns = torch.stack([a[:, c] * w + a[:, 3 + c] * best_u + a[:, 6 + c] * best_v for c in range(3)], dim=1)
    has_uv = a[:, 15] >= tri_kernel.HAS_UV_FLAG
    uu = torch.where(has_uv, a[:, 9] * w + a[:, 11] * best_u + a[:, 13] * best_v, best_u)
    vv = torch.where(has_uv, a[:, 10] * w + a[:, 12] * best_u + a[:, 14] * best_v, best_v)
    mat = torch.where(has_uv, a[:, 15] - tri_kernel.HAS_UV_FLAG, a[:, 15]).to(torch.int32)
    zero = torch.zeros_like(best)
    aux = dict(ns_raw=torch.where(found[:, None], ns, 0.0), u=torch.where(found, uu, zero),
               v=torch.where(found, vv, zero), mat=torch.where(found, mat, 0))
    return best, best_i, aux


def _hard_rays(b, nodes, seed):
    """b rays over the tree's box (origins inside and around it, so many start inside
    boxes) with t_in 80% open, 8% short, 4% tiny, 4% dead (0), 4% NaN or infinite; the
    first lanes axis-parallel, signed zeros, NaN and infinite directions and origins."""
    rng = np.random.default_rng(seed)
    lo, hi = nodes[0][0].numpy(), nodes[1][0].numpy()
    span = hi - lo
    o = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, size=(b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nan, inf = float("nan"), float("inf")
    edge = np.array([[0, 0, 1], [0, -0.0, -1], [1, 0, 0], [-0.0, 1, 0], [nan, 0, 1], [0, 0, 0], [1e-30, -1, 0],
                     [0.6, 0.8, -0.0], [inf, 0, 0], [-inf, 1, 0], [inf, inf, inf], [0, -1, 0]], np.float32)
    d[: len(edge)] = edge
    d[len(edge) : 4096, rng.integers(0, 3, 4096 - len(edge))] = 0.0  # axis-parallel in one axis
    o[12] = nan
    o[13, 0] = inf
    o[14, 1] = -inf
    u = rng.uniform(size=b)
    t_in = np.where(u < 0.8, 3e38, rng.uniform(0, float(span.max()), b))
    t_in = np.where((u >= 0.88) & (u < 0.92), rng.uniform(0, 1e-2, b), t_in)
    t_in = np.where((u >= 0.92) & (u < 0.96), 0.0, t_in)
    t_in = np.where((u >= 0.96) & (u < 0.98), nan, t_in)
    t_in = np.where(u >= 0.98, inf, t_in)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for a in (o, d, t_in))


def _assert_bits_equal(got, want):
    (gt, gi, ga), (wt, wi, wa) = got, want
    assert torch.equal(gt.view(torch.int32), wt.view(torch.int32))
    assert torch.equal(gi, wi)
    for k in ("ns_raw", "u", "v"):
        assert torch.equal(ga[k].view(torch.int32), wa[k].view(torch.int32)), k
    assert torch.equal(ga["mat"], wa["mat"])


@pytest.mark.parametrize("which", ["morton", "sah"])
def test_wide_walk_bit_equal_to_plain(which):
    nodes, tris, attr = _tables(which)
    o, d, t_in = _hard_rays(1 << 20, nodes, seed=3)
    want = bvh_closest_tri_plain(o, d, t_in, 1e-3, nodes, tris, attr)
    _assert_bits_equal(_emulate(o, d, t_in, 1e-3, nodes, tris, attr), want)
    t = want[0]
    hits = t < BIG
    assert 0.05 < float(hits.float().mean()) < 0.95
    assert not bool(hits[(t_in == 0) | torch.isnan(t_in)].any())  # dead and NaN lanes miss
    assert not bool(hits[[4, 10, 12]].any())  # NaN rays miss
    assert bool(torch.equal(want[1][~hits], torch.zeros_like(want[1][~hits])))
    assert float(want[2]["u"][hits].abs().sum()) > 0


def test_wide_walk_bit_equal_on_the_scene6_stand_in():
    nodes, tris, attr = _tables("scene6")
    o, d, t_in = _hard_rays(1 << 17, nodes, seed=4)
    _assert_bits_equal(_emulate(o, d, t_in, 1e-3, nodes, tris, attr),
                       bvh_closest_tri_plain(o, d, t_in, 1e-3, nodes, tris, attr))


def _both_hit_records(monkeypatch, sd, o, d, alive=None):
    """closest_hit's record, and the record _make_hit gathers itself from the same
    winners (tri_aux=None): one closest_hit call, its _make_hit arguments kept."""
    make_hit, seen = intersect._make_hit, []
    monkeypatch.setattr(intersect, "_make_hit", lambda *a: seen.append(a) or make_hit(*a))
    with_aux = intersect.closest_hit(sd, o, d, torch.zeros(o.shape[0]), 1e-3, 3e38, alive=alive)
    (args,) = seen
    assert args[8] is not None  # the BVH route passes the walk's attributes
    return with_aux, make_hit(*args[:8], None)


def _assert_records_equal(a, b, lanes):
    for k in FIELDS:
        x, y = getattr(a, k)[lanes], getattr(b, k)[lanes]
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k


@pytest.mark.parametrize("dead", [False, True])
def test_bvh_route_aux_equals_gathers(monkeypatch, dead):
    """closest_hit on a bvh=True mesh scene: the walk's attributes (tri_aux) give the
    hit record that the gathers of _make_hit give, bit for bit (on live lanes when half
    the lanes are dead); dead lanes find no triangle."""
    scene = _blob(TB, nu=24, nv=20)
    scene.add_sphere(0.9, (0.0, 0.0, 0.0), TB.Diffuse((0.5, 0.5, 0.5)))
    sd = scene.compile(device="cpu", bvh=True).data
    assert sd.has_tri_bvh
    o, d = (torch.from_numpy(a) for a in _shell_rays(4096, 8))
    alive = torch.arange(4096) % 2 == 0 if dead else None
    with_aux, gathered = _both_hit_records(monkeypatch, sd, o, d, alive)
    assert float(with_aux.valid.float().mean()) > 0.2
    _assert_records_equal(with_aux, gathered, alive if dead else torch.ones(4096, dtype=torch.bool))
    if dead:
        nodes, tris, attr = bvh_kernel.scene_nodes(sd)
        t_in = torch.where(alive, 3e38, 0.0)
        t, idx, aux = bvh_kernel.closest_tri_bvh(o, d, t_in, 1e-3, nodes, tris, attr)
        assert not bool((t[~alive] < BIG).any()) and not bool(idx[~alive].any())
        assert float(aux["ns_raw"][~alive].abs().sum()) == 0.0


def test_bvh_route_aux_on_uv_mesh(monkeypatch):
    """The same with UVs on one mesh and not on the other, two materials: the has_uv
    branch of the attributes."""
    rng = np.random.default_rng(5)
    s = TB.Scene()
    th, ph = np.meshgrid(np.linspace(0.1, 3.0, 13), np.linspace(0, 2 * np.pi, 17), indexing="ij")
    pos = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    i = np.arange(12)[:, None] * 17 + np.arange(16)[None, :]
    faces = np.stack([i, i + 17, i + 1, i + 1, i + 17, i + 18], -1).reshape(-1, 3)
    uvs = rng.uniform(size=(pos.shape[0], 2))
    s.add_mesh(dict(positions=pos * 2.0, normals=pos, uvs=uvs, indices=faces), TB.Diffuse((0.3, 0.6, 0.2)))
    s.add_mesh(dict(positions=pos + 3.0, normals=None, uvs=None, indices=faces), TB.Metal((0.8, 0.8, 0.8), 0.1))
    s.environment = (1.0, 1.0, 1.0)
    sd = s.compile(device="cpu", bvh=True).data
    assert sd.has_tri_bvh and bool(sd.tri_has_uv.any()) and not bool(sd.tri_has_uv.all())
    o, d = (torch.from_numpy(a) for a in _shell_rays(4096, 9))
    with_aux, gathered = _both_hit_records(monkeypatch, sd, o * 0.6 + 1.5, d)
    assert float(with_aux.valid.float().mean()) > 0.2
    _assert_records_equal(with_aux, gathered, torch.ones(4096, dtype=torch.bool))
    assert len(set(with_aux.mat_id[with_aux.valid].tolist())) >= 2


def test_bvh_walk_matches_cluster_kernels_plain():
    """On one SceneData the BVH walk and the cluster kernels' plain version give the same
    t, idx and attributes (both index the SAH-ordered tables)."""
    sd = _blob(TB).compile(device="cpu", bvh=True).data
    o, d = (torch.from_numpy(a) for a in _shell_rays(2048, 10))
    t_in = torch.full((2048,), 3e38)
    got = bvh_kernel.closest_tri_bvh(o, d, t_in, 1e-3, *bvh_kernel.scene_nodes(sd))
    want = tri_kernel.closest_tri(dataclasses.replace(sd, has_tri_bvh=False, has_tri_clusters=True), o, d, t_in,
                                  1e-3)
    assert float((got[0] < BIG).float().mean()) > 0.2
    _assert_bits_equal(got, want)
