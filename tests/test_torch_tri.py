"""The cluster kernels' plain versions (ops/tri_kernel.py) and the port's
closest_hit on mesh scenes, against the reference package.

On the CPU the wrappers run the plain versions; the CUDA kernels themselves are
held bit-equal to those on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances:
- plain flat version vs the Pallas VMEM kernel in interpret mode: as in
  tests/test_torch_clusters.py (ids, materials, hit masks equal; t rtol 2e-5 /
  atol 1e-3; attributes 1e-4);
- closest_hit vs the reference's dense sweep over the same SAH-ordered tables:
  valid, mat_id and front equal on every lane; t rtol 2e-5 / atol 1e-3, ng and u
  2e-3, as in tests/test_torch_hit.py (XLA contracts multiply-adds);
- ties, dead lanes, and the flat against the two-level version: exact.
"""

import dataclasses

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_clusters import compare_with_pallas
from tpupt.ops.intersect import closest_hit as j_closest_hit
from tpupt.scene import builder as JB
from tpupt_torch.ops import tri_kernel as TK
from tpupt_torch.ops.intersect import closest_hit as t_closest_hit
from tpupt_torch.scene import builder as TB

BIG = 3.0e38


def test_flat_plain_matches_pallas_vmem_kernel():
    compare_with_pallas(hbm=False)


def _blob(B, n=3000, seed=0):
    """A ~3k-triangle mesh with normals and UVs, and a sphere in front of part of it."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n, 1, 3)) * np.array([2.0, 1.5, 1.0])
    pos = (c + rng.normal(size=(n, 3, 3)) * 0.2).reshape(-1, 3)
    nrm = rng.normal(size=(3 * n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    s = B.Scene()
    s.add_mesh(dict(positions=pos, normals=nrm, uvs=rng.uniform(size=(3 * n, 2)),
                    indices=np.arange(3 * n).reshape(n, 3)), B.Diffuse((0.7, 0.7, 0.7)))
    s.add_sphere(1.0, (0.0, 0.5, 3.0), B.Diffuse((0.5, 0.5, 0.5)))
    return s


def as_two_level(sd):
    """The same clusters repacked with superclusters of 16, routed to the two-level kernel."""
    geo, cl = sd.tri_geo.numpy(), sd.tri_cl.numpy()
    count = (geo[:, 9, :] < TK.BIG_IDF).sum(axis=1)
    real = count > 0
    clusters = dict(start=geo[real, 9, 0].astype(np.int32), count=count[real].astype(np.int32),
                    bmin=cl[real, 0:3], bmax=cl[real, 3:6])
    n = int(count.sum())
    tri = [getattr(sd, f"tri_{k}").numpy()[:n]
           for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "has_uv", "mat")]
    cl_box, g, a, sc_box = TK.pack_clusters(*tri[:3], clusters, *tri[3:], sc_size=TK.SC_TWO_LEVEL)
    return dataclasses.replace(
        sd, tri_cl=torch.from_numpy(cl_box), tri_geo=torch.from_numpy(g),
        tri_attr=torch.from_numpy(a), tri_scl=torch.from_numpy(sc_box),
        has_tri_clusters=False, has_tri_clusters_hbm=True, tri_sc_size=TK.SC_TWO_LEVEL,
    )


@pytest.mark.parametrize("route", ["flat", "two_level"])
def test_closest_hit_matches_reference_sweep(route):
    jsd = dataclasses.replace(_blob(JB).compile().data, has_tri_bvh=False)  # dense sweep
    tsd = _blob(TB).compile(device="cpu").data
    assert tsd.has_tri_clusters
    if route == "two_level":
        tsd = as_two_level(tsd)
    rng = np.random.default_rng(7)
    b = 2048
    o = np.tile(np.array([[0.0, 0.5, 8.0]], np.float32), (b, 1))
    d = (rng.normal(size=(b, 3)) * np.array([2.0, 1.5, 1.0]) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.zeros(b, np.float32)
    jh = jax.jit(lambda: j_closest_hit(jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                       jnp.float32(1e-3), jnp.float32(BIG)))()
    th = t_closest_hit(tsd, *(torch.from_numpy(a) for a in (o, d, tm)), 1e-3, BIG)
    valid = np.asarray(jh.valid)
    assert valid.mean() > 0.5
    sphere = np.asarray(jh.mat_id) == 1
    assert sphere.mean() > 0.05  # the seeded case: the sphere hides part of the mesh
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    np.testing.assert_array_equal(th.mat_id.numpy()[valid], np.asarray(jh.mat_id)[valid])
    np.testing.assert_array_equal(th.front.numpy()[valid], np.asarray(jh.front)[valid])
    np.testing.assert_allclose(th.t.numpy()[valid], np.asarray(jh.t)[valid], rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(th.ng.numpy()[valid], np.asarray(jh.ng)[valid], atol=2e-3)
    np.testing.assert_allclose(th.u.numpy()[valid], np.asarray(jh.u)[valid], atol=2e-3)


def _tables(tris, starts, counts, sc_size):
    """Pack given triangles ([N,3,3] vertices) into the given clusters."""
    v = np.asarray(tris, np.float32)
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2) - 1e-3
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2) + 1e-3
    cl = dict(start=np.asarray(starts, np.int32), count=np.asarray(counts, np.int32),
              bmin=np.stack([lo[s : s + c].min(0) for s, c in zip(starts, counts)]),
              bmax=np.stack([hi[s : s + c].max(0) for s, c in zip(starts, counts)]))
    n = len(v)
    z3, z2 = np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32)
    mat = np.arange(n, dtype=np.int32) + 3
    packed = TK.pack_clusters(v0, e1, e2, cl, z3 + 1, z3, z3, z2, z2, z2, np.zeros(n, bool), mat,
                              sc_size=sc_size)
    return [torch.from_numpy(a) for a in packed]


def _run(route, tables, o, d, t_in):
    cl, geo, attr, scl = tables
    args = (torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32),
            torch.tensor(t_in, dtype=torch.float32), 1e-3)
    if route == "flat":
        return TK.closest_tri_flat(*args, scl, cl, geo, attr)
    return TK.closest_tri_two_level(*args, scl, cl, geo, attr, TK.SC_TWO_LEVEL)


@pytest.mark.parametrize("route", ["flat", "two_level"])
@pytest.mark.parametrize("same_cluster", [True, False])
def test_ties_go_to_lower_id_and_dead_lanes_miss(route, same_cluster):
    quad = [[-1.0, -1.0, 5.0], [1.0, -1.0, 5.0], [-1.0, 1.0, 5.0]]
    far = [[-1.0, -1.0, 9.0], [1.0, -1.0, 9.0], [-1.0, 1.0, 9.0]]
    tris = [far, quad, quad]  # ids 1 and 2 coincide
    starts, counts = ([0], [3]) if same_cluster else ([0, 2], [2, 1])
    sc = TK.SC_FLAT if route == "flat" else TK.SC_TWO_LEVEL
    tables = _tables(tris, starts, counts, sc)
    o = [[-0.5, -0.5, 0.0]] * 4
    d = [[0.0, 0.0, 1.0]] * 4
    t, idx, aux = _run(route, tables, o, d, [BIG, 0.0, 5.0, 7.0])
    assert t[0].item() == 5.0 and idx[0].item() == 1 and aux["mat"][0].item() == 4
    assert aux["ns_raw"][0].tolist() == [0.5, 0.5, 0.5]  # n0 = 1, n1 = n2 = 0, w = 0.5
    assert aux["u"][0].item() == 0.25 and aux["v"][0].item() == 0.25  # barycentrics
    for lane in (1, 2):  # a dead lane (t_in = 0), and a seed equal to the hit's t
        assert t[lane].item() == np.float32(BIG) and idx[lane].item() == 0
        assert aux["mat"][lane].item() == 0 and aux["ns_raw"][lane].abs().sum().item() == 0.0
    assert idx[3].item() == 1


def one_level_plain(o, d, t_in, tmin, cl, geo, attr, counts):
    """The cull without superclusters, on the plain versions' parts: every cluster box
    against every ray, then the triangles of the (ray, cluster) pairs that pass."""
    p = TK._Plain(o, d, t_in, tmin, geo, counts)
    for rows in TK._ray_chunks(o.shape[0], cl.shape[0], o.device):
        r, c = torch.nonzero(p.box_hits(rows, cl[None]), as_tuple=True)
        p.triangles(rows[r], c)
    return p.result(attr)


def test_flat_and_two_level_plain_bit_equal():
    tsd = _blob(TB, n=4000, seed=3).compile(device="cpu").data
    tl = as_two_level(tsd)
    rng = np.random.default_rng(4)
    b = 3000
    o = torch.from_numpy(rng.uniform(-3, 3, size=(b, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    t_in = torch.from_numpy(np.where(rng.uniform(size=b) < 0.2, 0.0, 3e38).astype(np.float32))
    c1, c2 = {}, {}
    t1, i1, a1 = one_level_plain(o, d, t_in, 1e-3, tsd.tri_cl, tsd.tri_geo, tsd.tri_attr, c1)
    t2, i2, a2 = TK.closest_tri_two_level_plain(
        o, d, t_in, 1e-3, tl.tri_scl, tl.tri_cl, tl.tri_geo, tl.tri_attr, tl.tri_sc_size, c2
    )
    assert (t1 < BIG).float().mean() > 0.3
    assert torch.equal(t1.view(torch.int32), t2.view(torch.int32)) and torch.equal(i1, i2)
    for k in ("ns_raw", "u", "v", "mat"):
        assert torch.equal(a1[k], a2[k]), k
    assert c1["box_tests"] == b * tsd.tri_cl.shape[0]
    assert c1["tri_tests"] == c2["tri_tests"] > 0  # the two-level cull only skips boxes
    assert c2["box_tests"] < c1["box_tests"]


def test_flat_plain_with_and_without_superclusters_bit_equal():
    """The flat plain version culling top and supercluster boxes first returns the
    bits of the one-level cull over every cluster box, on a 3k-triangle mesh."""
    tsd = _blob(TB, n=3000, seed=5).compile(device="cpu").data
    assert tsd.has_tri_clusters and tsd.tri_sc_size == TK.SC_FLAT
    rng = np.random.default_rng(6)
    b = 3000
    o = torch.from_numpy(rng.uniform(-3, 3, size=(b, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    d[:3] = torch.tensor([[0.0, 0.0, 1.0], [0.0, -0.0, -1.0], [1.0, 0.0, 0.0]])  # flushed 1/d
    t_in = torch.from_numpy(np.where(rng.uniform(size=b) < 0.2, 0.0,
                                     np.where(rng.uniform(size=b) < 0.3, 2.0, 3e38)).astype(np.float32))
    tables = (tsd.tri_cl, tsd.tri_geo, tsd.tri_attr)
    c1, c2 = {}, {}
    t1, i1, a1 = one_level_plain(o, d, t_in, 1e-3, *tables, c1)
    t2, i2, a2 = TK.closest_tri_flat_plain(o, d, t_in, 1e-3, tsd.tri_scl, *tables, c2)
    assert (t1 < BIG).float().mean() > 0.3
    assert torch.equal(t1.view(torch.int32), t2.view(torch.int32)) and torch.equal(i1, i2)
    for k in ("ns_raw", "u", "v", "mat"):
        assert torch.equal(a1[k], a2[k]), k
    assert c1["tri_tests"] == c2["tri_tests"] > 0  # the extra levels only skip boxes
    n_sc = tsd.tri_cl.shape[0] // TK.SC_FLAT
    assert b <= c2["box_tests"] <= b * (1 + n_sc + tsd.tri_cl.shape[0])  # one top box, then down
    assert c2["box_tests"] < c1["box_tests"] == b * tsd.tri_cl.shape[0]
    t3, i3, _ = TK.closest_tri_flat(o, d, t_in, 1e-3, tsd.tri_scl, *tables)  # the wrapper on the CPU
    assert torch.equal(t3.view(torch.int32), t2.view(torch.int32)) and torch.equal(i3, i2)


def test_wrapper_argument_checks():
    tables = _tables([[[0.0, 0.0, 5.0], [1.0, 0.0, 5.0], [0.0, 1.0, 5.0]]], [0], [1], 64)
    cl, geo, attr, scl = tables
    o, d, t_in = torch.zeros(8, 3), torch.ones(8, 3), torch.full((8,), 3e38)
    with pytest.raises(ValueError, match="o \\[B,3\\]"):
        TK.closest_tri_flat(o[:, :2].contiguous(), d, t_in, 1e-3, scl, cl, geo, attr)
    with pytest.raises(ValueError, match="t_in"):
        TK.closest_tri_flat(o, d, t_in[:4], 1e-3, scl, cl, geo, attr)
    with pytest.raises(TypeError, match="float32"):
        TK.closest_tri_flat(o, d, t_in.double(), 1e-3, scl, cl, geo, attr)
    with pytest.raises(ValueError, match="contiguous"):
        TK.closest_tri_flat(o, torch.ones(3, 8).T, t_in, 1e-3, scl, cl, geo, attr)
    with pytest.raises(ValueError, match="geo \\[C,10,64\\]"):
        TK.closest_tri_flat(o, d, t_in, 1e-3, scl, cl, attr, geo)
    with pytest.raises(ValueError, match="sc_size"):
        TK.closest_tri_two_level(o, d, t_in, 1e-3, scl, cl, geo, attr, 48)
    big = torch.zeros(TK.FLAT_MAX_CLUSTERS + 64, 8)
    with pytest.raises(ValueError, match="two_level"):
        TK.closest_tri_flat(o, d, t_in, 1e-3, scl, big, torch.zeros(big.shape[0], 10, 64),
                            torch.zeros(big.shape[0], 16, 64))
    before = dict(TK.launches)
    TK.closest_tri_flat(o, d, t_in, 1e-3, scl, cl, geo, attr)
    assert TK.launches == before  # the plain version is not a launch
