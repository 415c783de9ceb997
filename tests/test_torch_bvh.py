"""The stackless BVH and the matmul (MXU) sweep against the reference package.

- Morton builds (numpy and host library) and count_node_visits: no tolerance, the
  reference's arrays and counts.
- bvh_closest_tri_plain against the reference's jitted bvh_closest_tri on the
  reference's own SceneData (compiled with bvh=True, converted): valid and idx equal
  on every lane, t within rtol 4e-6. XLA contracts multiply-adds and eager PyTorch
  rounds each operation: on this test's 4352-triangle mesh the largest relative
  difference is 4.77e-7, with 51% of hits bit-equal; on a 4968-triangle lumpy
  sphere (chip_smoke.py's bunny stand-in) it was 1.38e-6.
- The port's BVH route against its dense sweep and its cluster route on one
  SceneData: the same operations on the same rows, so t is bit-equal.
- Renders: the BVH route against the dense sweep, rtol 1e-4 / atol 1e-5 (the
  reference's tests/test_bvh.py); against the reference's default CPU render (its
  BVH route) run op by op, at tests/test_torch_mesh_render.py's tolerances.
- The matmul sweep: tables bit-equal to the reference's; against the port's dense
  sweep and against the reference's MXU path on the reference's tables, valid masks
  agree on more than 99.9% of lanes and t within rtol / atol 1e-4 where both hit
  (tests/test_bvh.py: the products sum in another order).
"""

import dataclasses

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mesh_render import _close, _reference_op_by_op, _sphere_scene
from tpupt.ops.bvh import build_tri_bvh as j_build
from tpupt.ops.bvh import bvh_closest_tri as j_bvh_closest_tri
from tpupt.ops.bvh import count_node_visits as j_count_node_visits
from tpupt.ops.intersect import closest_hit as j_closest_hit
from tpupt.render.camera import Camera as JCamera
from tpupt.render.renderer import render_image as j_render
from tpupt.scene import builder as JB
from tpupt_torch import native
from tpupt_torch.ops import bvh as TBVH
from tpupt_torch.ops import bvh_kernel
from tpupt_torch.ops.intersect import closest_hit as t_closest_hit
from tpupt_torch.render.camera import Camera as TCamera
from tpupt_torch.render.renderer import render_image as t_render
from tpupt_torch.scene import builder as TB
from tpupt_torch.scene import data as TD
from tpupt_torch.scene.compile import CompiledScene
from tpupt_torch.scene.convert import scene_data_from_numpy


def _soup333():
    """tests/test_bvh.py's 333 random triangles."""
    rng = np.random.default_rng(0)
    n = 333
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    return v0, e1, e2


def _blob(B, nu=48, nv=44, seed=1):
    """A lumpy UV sphere of 2*nu*nv triangles (4224 by default) with vertex normals."""
    rng = np.random.default_rng(seed)
    k = rng.integers(2, 6, size=4)
    th, ph = np.meshgrid(np.linspace(0, np.pi, nv + 1), np.linspace(0, 2 * np.pi, nu + 1), indexing="ij")
    r = 1.0 + 0.15 * np.sin(k[0] * th) * np.cos(k[1] * ph) + 0.08 * np.cos(k[2] * th + k[3] * ph)
    n = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    i = np.arange(nv)[:, None] * (nu + 1) + np.arange(nu)[None, :]
    faces = np.stack([i, i + nu + 1, i + 1, i + 1, i + nu + 1, i + nu + 2], -1).reshape(-1, 3)
    s = B.Scene()
    s.add_mesh(dict(positions=r.reshape(-1, 1) * n, normals=n, uvs=None, indices=faces),
               B.Diffuse((0.7, 0.7, 0.7)))
    s.environment = (1.0, 1.0, 1.0)
    return s


def _shell_rays(b, seed):
    """tests/test_bvh.py's rays: origins on a sphere of radius 8, aimed at points near the mesh."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(b, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 8.0
    d = rng.normal(size=(b, 3)).astype(np.float32) * 1.5 - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _converted(jsd):
    """The reference's SceneData as the port's, on the CPU."""
    fields = {f.name: np.asarray(getattr(jsd, f.name)) for f in dataclasses.fields(jsd)}
    static = {n: getattr(jsd, n) for n in TD.STATIC_FIELDS}
    return scene_data_from_numpy(fields, static, device="cpu")


@pytest.mark.parametrize("nat", [True, False])
def test_morton_build_matches_reference(nat):
    v0, e1, e2 = _soup333()
    assert native.available(), native.builder()
    order, nodes = TBVH.build_tri_bvh(v0, e1, e2, native=nat)
    j_order, j_nodes = j_build(v0, e1, e2, native=False)
    np.testing.assert_array_equal(order, j_order)
    for k in ("bmin", "bmax", "skip", "start", "count"):
        assert nodes[k].dtype == j_nodes[k].dtype, k
        np.testing.assert_array_equal(nodes[k], j_nodes[k], err_msg=k)
    # the structure invariants of tests/test_bvh.py:25-48
    n, m = v0.shape[0], nodes["skip"].shape[0]
    assert sorted(order.tolist()) == list(range(n))
    leaf = nodes["count"] > 0
    covered = np.zeros(n, dtype=int)
    for s_, c in zip(nodes["start"][leaf], nodes["count"][leaf]):
        covered[s_ : s_ + c] += 1
        assert 1 <= c <= TBVH.LEAF_SIZE
    assert (covered == 1).all()
    assert nodes["skip"][0] == m
    assert (nodes["skip"] > np.arange(m)).all() and (nodes["skip"] <= m).all()
    for i in np.nonzero(~leaf)[0][:50]:
        assert (nodes["bmin"][i] <= nodes["bmin"][i + 1] + 1e-6).all()
        assert (nodes["bmax"][i] >= nodes["bmax"][i + 1] - 1e-6).all()


def test_count_node_visits_matches_reference():
    v0, e1, e2 = _soup333()
    order, nodes = TBVH.build_tri_bvh(v0, e1, e2)
    v0, e1, e2 = v0[order], e1[order], e2[order]
    rng = np.random.default_rng(3)
    o = rng.normal(size=(200, 3)).astype(np.float32) * 3.0
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = TBVH.count_node_visits(nodes, v0, e1, e2, o, d)
    assert got == j_count_node_visits(nodes, v0, e1, e2, o, d)
    assert got[0] > 1.0 and got[1] > 0.0


def test_traversal_matches_reference():
    jsd = _blob(JB).compile(bvh=True).data
    assert jsd.has_tri_bvh and int(jsd.bvh_skip.shape[0]) > 1000
    tsd = _converted(jsd)
    assert tsd.has_tri_bvh and tsd.n_tris >= 4096
    o, d = _shell_rays(4096, 1)
    counts = {}
    t, idx, _ = TBVH.bvh_closest_tri_plain(torch.from_numpy(o), torch.from_numpy(d), torch.full((4096,), 3e38),
                                           1e-3, *bvh_kernel.scene_nodes(tsd), counts)
    J = jnp.asarray
    jt, jidx = jax.jit(lambda: j_bvh_closest_tri(
        jsd, J(o[:, 0]), J(o[:, 1]), J(o[:, 2]), J(d[:, 0]), J(d[:, 1]), J(d[:, 2]),
        jnp.float32(1e-3), jnp.float32(3e38)))()
    jt, jidx = np.asarray(jt), np.asarray(jidx)
    valid = t.numpy() < 3e38
    np.testing.assert_array_equal(valid, jt < 3e38)
    assert valid.mean() > 0.1
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(t.numpy()[valid], jt[valid], rtol=4e-6)
    assert counts["box_tests"] > 10 * 4096 and counts["tri_tests"] > 4096  # node visits, leaf tests


def test_route_matches_sweep_and_clusters():
    """tests/test_bvh.py::test_bvh_matches_bruteforce_on_bunny on a seeded mesh, in the
    port: its BVH route, its dense sweep and its cluster route on one SceneData."""
    sd = _blob(TB).compile(device="cpu", bvh=True).data
    assert sd.has_tri_bvh and not sd.has_tri_clusters and sd.tri_sc_size == 64
    o, d = (torch.from_numpy(a) for a in _shell_rays(4096, 2))
    time = torch.zeros(4096)
    routes = {
        "bvh": sd,
        "sweep": dataclasses.replace(sd, has_tri_bvh=False),
        "clusters": dataclasses.replace(sd, has_tri_bvh=False, has_tri_clusters=True),
    }
    hits = {k: t_closest_hit(v, o, d, time, 1e-3, 3e38) for k, v in routes.items()}
    hv = hits["bvh"].valid
    assert hv.float().mean() > 0.1
    for k in ("sweep", "clusters"):
        torch.testing.assert_close(hits[k].valid, hv)
        assert torch.equal(hits[k].t, hits["bvh"].t), k
        torch.testing.assert_close(hits[k].ng[hv], hits["bvh"].ng[hv], rtol=0, atol=1e-5)
        assert torch.equal(hits[k].mat_id, hits["bvh"].mat_id)


def _bunny_camera(Camera):
    return Camera(aspect_ratio=1.0, image_width=12, samples_per_pixel=8, max_depth=6, vfov=35.0,
                  look_from=(0.0, 1.0, 6.0), look_at=(0.0, 0.0, 0.0), blur_strength=0.5,
                  focal_length=5.0, defocus_angle=0.0)


def test_bvh_render_matches_sweep():
    """tests/test_bvh.py::test_bvh_render_matches_sweep on a seeded mesh."""
    compiled = _blob(TB).compile(device="cpu", bvh=True)
    cam = _bunny_camera(TCamera)
    _, m_bvh, st = t_render(compiled, cam, rays_per_launch=1 << 14, progress=False)
    sweep = CompiledScene(dataclasses.replace(compiled.data, has_tri_bvh=False), compiled.has_lights)
    _, m_swp, _ = t_render(sweep, cam, rays_per_launch=1 << 14, progress=False)
    assert st.rays > st.paths and np.nanmean(m_bvh) > 0.05
    np.testing.assert_allclose(m_bvh, m_swp, rtol=1e-4, atol=1e-5)


def test_bvh_render_matches_reference():
    """The port's BVH route against the reference's default CPU render of the same
    scene (its stackless BVH), as tests/test_torch_mesh_render.py holds the cluster
    route: the op-by-op reference's per-pixel means of the same paths, and the
    jitted reference's image mean."""
    js, jcam = _sphere_scene(JB, JCamera)
    ts, tcam = _sphere_scene(TB, TCamera)
    jc, tc = js.compile(), ts.compile(device="cpu", bvh=True)
    assert jc.data.has_tri_bvh and tc.data.has_tri_bvh
    _, m_t, stats = t_render(tc, tcam, seed=0, rays_per_launch=1 << 14, progress=False)
    npix, spp = tcam.image_width * tcam.image_height, tcam.samples_per_pixel
    pix = np.repeat(np.arange(npix, dtype=np.int32), spp)
    smp = np.tile(np.arange(spp, dtype=np.int32), npix)
    ref = _reference_op_by_op(jc, jcam, pix, smp).reshape(npix, spp, 3).mean(1).reshape(m_t.shape)
    assert stats.paths == npix * spp and np.nanmean(m_t) > 0.05
    assert _close(m_t, ref) >= 0.98, _close(m_t, ref)
    _, m_j, _ = j_render(jc, jcam, seed=0, rays_per_launch=1 << 14, progress=False)
    np.testing.assert_allclose(np.nanmean(m_t), np.nanmean(np.asarray(m_j)), rtol=5e-3)


def test_mxu_tables_match_reference():
    jsd = _blob(JB, nu=20, nv=10).compile().data
    tsd = _blob(TB, nu=20, nv=10).compile(device="cpu").data
    for k in ("tri_ca", "tri_cu", "tri_cv", "tri_ct"):
        got, want = getattr(tsd, k).numpy(), np.asarray(getattr(jsd, k))
        assert got.shape == want.shape == (tsd.n_tris, 10), k
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=k)
    small = TB.Scene()
    small.add_mesh(dict(positions=np.eye(3), normals=None, uvs=None, indices=np.array([[0, 1, 2]])),
                   TB.Diffuse((0.5, 0.5, 0.5)))
    assert small.compile(device="cpu").data.tri_ca.shape == (1, 10)


def _mxu_agrees(h_mxu, h_swp):
    hv = h_swp.valid
    assert hv.mean() > 0.1
    assert (h_mxu.valid == hv).mean() > 0.999
    both = h_mxu.valid & hv
    np.testing.assert_allclose(h_mxu.t[both], h_swp.t[both], rtol=1e-4, atol=1e-4)


class _Np:
    """A hit record's valid and t as numpy arrays."""

    def __init__(self, h):
        self.valid, self.t = np.asarray(h.valid), np.asarray(h.t)


def test_mxu_matches_sweep():
    """tests/test_bvh.py::test_mxu_path_matches_sweep_on_bunny, in the port."""
    sd = _blob(TB).compile(device="cpu", bvh=True).data
    o, d = (torch.from_numpy(a) for a in _shell_rays(4096, 5))
    time = torch.zeros(4096)
    h_mxu = t_closest_hit(dataclasses.replace(sd, has_tri_bvh=False, has_tri_mxu=True), o, d, time, 1e-3, 3e38)
    h_swp = t_closest_hit(dataclasses.replace(sd, has_tri_bvh=False), o, d, time, 1e-3, 3e38)
    _mxu_agrees(_Np(h_mxu), _Np(h_swp))


def test_mxu_matches_reference():
    """The port's matmul sweep on the reference's tables against the reference's MXU path."""
    jsd = dataclasses.replace(_blob(JB).compile().data, has_tri_bvh=False, has_tri_mxu=True)
    tsd = _converted(jsd)
    assert tsd.has_tri_mxu and not tsd.has_tri_bvh
    o, d = _shell_rays(4096, 6)
    time = np.zeros(4096, np.float32)
    h_j = jax.jit(lambda: j_closest_hit(jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(time),
                                        jnp.float32(1e-3), jnp.float32(3e38)))()
    h_t = t_closest_hit(tsd, *(torch.from_numpy(a) for a in (o, d, time)), 1e-3, 3e38)
    _mxu_agrees(_Np(h_t), _Np(h_j))
