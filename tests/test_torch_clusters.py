"""SAH build, cluster cut and packing against the reference package, and the
two-level cluster kernel's plain version against the Pallas HBM kernel.

- Builds (host library and numpy), boxes and packed blocks: no tolerance, every
  array equal to the reference's.
- The compiled tables of a mesh scene, remapped triangle lights included: every
  field equal to the reference's compile.
- Plain two-level version vs ``pallas_closest_tri(..., hbm=True)`` in interpret
  mode: ids, materials and hit masks equal; t within rtol 2e-5 / atol 1e-3 (as in
  tests/test_torch_hit.py: XLA contracts multiply-adds, PyTorch does not);
  interpolated attributes within 1e-4.
"""

import dataclasses

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.ops.bvh import build_tri_bvh_sah as j_build
from tpupt.ops.pallas_tri import pack_clusters as j_pack
from tpupt.ops.pallas_tri import pallas_closest_tri
from tpupt.scene import builder as JB
from tpupt_torch import native
from tpupt_torch.ops import tri_kernel as TK
from tpupt_torch.ops.bvh import build_tri_bvh_sah as t_build
from tpupt_torch.scene import builder as TB
from tpupt_torch.scene import data as TD


def _soup(n, seed, spread=1.5, size=0.15):
    """n random triangles (v0, e1, e2) f32 clustered in space, plus per-vertex attributes."""
    rng = np.random.default_rng(seed)
    v0 = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    e1 = (rng.normal(size=(n, 3)) * size).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * size).astype(np.float32)
    attrs = dict(
        tri_n0=rng.normal(size=(n, 3)).astype(np.float32),
        tri_n1=rng.normal(size=(n, 3)).astype(np.float32),
        tri_n2=rng.normal(size=(n, 3)).astype(np.float32),
        tri_uv0=rng.uniform(size=(n, 2)).astype(np.float32),
        tri_uv1=rng.uniform(size=(n, 2)).astype(np.float32),
        tri_uv2=rng.uniform(size=(n, 2)).astype(np.float32),
        tri_has_uv=rng.uniform(size=n) < 0.5,
        tri_mat=rng.integers(0, 5, n).astype(np.int32),
    )
    return v0, e1, e2, attrs


_ATTR = ("tri_n0", "tri_n1", "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2", "tri_has_uv", "tri_mat")


@pytest.mark.parametrize("nat", [True, False])
def test_sah_build_matches_reference(nat):
    v0, e1, e2, _ = _soup(777, 0, spread=1.0, size=0.1)
    assert native.available(), native.builder()
    order, nodes, cl = t_build(v0, e1, e2, native=nat)
    j_order, j_nodes, j_cl = j_build(v0, e1, e2, native=False)
    np.testing.assert_array_equal(order, j_order)
    for got, want in ((nodes, j_nodes), (cl, j_cl)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(cl["start"]) > 8  # several clusters, so the cut is exercised


@pytest.mark.parametrize("sc_size", [64, 16])
def test_packing_matches_reference(sc_size):
    v0, e1, e2, at = _soup(1500, 1)
    order, _, cl = t_build(v0, e1, e2)
    v0, e1, e2 = v0[order], e1[order], e2[order]
    at = {k: v[order] for k, v in at.items()}
    attrs = [at[k] for k in _ATTR]
    cl_box, geo, attr, sc_box = TK.pack_clusters(v0, e1, e2, cl, *attrs, sc_size=sc_size)
    j_box, pk, pk2, j_sc = j_pack(v0, e1, e2, cl, *attrs, sc_size=sc_size)
    np.testing.assert_array_equal(cl_box, j_box)
    np.testing.assert_array_equal(sc_box, j_sc)
    assert geo.shape == (cl_box.shape[0], 10, 64) and attr.shape == (cl_box.shape[0], 16, 64)
    # every slot equals the reference's slot (row c*8 + l%8, lanes (l//8)*16 + field)
    for c in range(cl_box.shape[0]):
        for l in range(64):
            row, lane = c * 8 + l % 8, (l // 8) * 16
            np.testing.assert_array_equal(geo[c, :, l], pk[row, lane : lane + 10])
            np.testing.assert_array_equal(attr[c, :, l], pk2[row, lane : lane + 16])
    r_geo, r_attr = TK.from_reference_packing(pk, pk2)
    np.testing.assert_array_equal(r_geo, geo)
    np.testing.assert_array_equal(r_attr, attr)


@pytest.mark.parametrize("sc_size", [64, 16])
def test_boxes_nest(sc_size):
    """Every packed cluster box lies inside its supercluster box, and every
    supercluster box inside its top box (no tolerance: the unions are exact)."""
    v0, e1, e2, at = _soup(3000 if sc_size == 64 else 30_000, 3, spread=3.0, size=0.1)
    order, _, cl = t_build(v0, e1, e2)
    packed = TK.pack_clusters(v0[order], e1[order], e2[order], cl,
                              *(at[k][order] for k in _ATTR), sc_size=sc_size)
    cl_box, sc_box = packed[0], packed[3]
    n_sc = cl_box.shape[0] // sc_size
    real = cl_box[:, 0] < TK.PAD_BOX
    assert real.sum() == len(cl["start"]) and not real[-1]  # at least one pad cluster
    parent = sc_box[np.arange(cl_box.shape[0]) // sc_size]
    assert (parent[real, 0:3] <= cl_box[real, 0:3]).all() and (cl_box[real, 3:6] <= parent[real, 3:6]).all()
    top = TK.top_boxes(torch.from_numpy(sc_box), n_sc).numpy()
    assert top.shape == ((n_sc + TK.TOP_GROUP - 1) // TK.TOP_GROUP, 8)
    assert (n_sc > TK.TOP_GROUP) == (sc_size == 16)  # the small table has one top box
    sc_real = sc_box[:n_sc, 0] < TK.PAD_BOX
    parent = top[np.arange(n_sc) // TK.TOP_GROUP]
    assert (parent[sc_real, 0:3] <= sc_box[:n_sc][sc_real, 0:3]).all()
    assert (sc_box[:n_sc][sc_real, 3:6] <= parent[sc_real, 3:6]).all()
    assert (top[:, 3:6] < TK.PAD_BOX).all()  # pad rows do not widen a top box
    # a group of pad rows only gives a pad box, which no ray enters
    pads = torch.full((20, 8), TK.PAD_BOX)
    pads[3, :6] = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    t2 = TK.top_boxes(pads, 20)
    assert t2[0, :6].tolist() == [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    assert (t2[1, :6] == TK.PAD_BOX).all()


def _mesh_scene(B, n=2500, seed=2):
    """A random mesh with vertex normals and UVs, a triangle-mesh light, a sphere."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n, 1, 3)) * 1.5
    pos = (c + rng.normal(size=(n, 3, 3)) * 0.15).reshape(-1, 3)
    nrm = rng.normal(size=(3 * n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    s = B.Scene()
    s.add_mesh(dict(positions=pos, normals=nrm, uvs=rng.uniform(size=(3 * n, 2)),
                    indices=np.arange(3 * n).reshape(n, 3)), B.Diffuse((0.5, 0.4, 0.3)))
    lpos = rng.normal(size=(90, 3)) * 0.3 + np.array([0.0, 4.0, 0.0])
    s.add_mesh(dict(positions=lpos, normals=None, uvs=None, indices=np.arange(90).reshape(30, 3)),
               B.Light((4.0, 4.0, 4.0)))
    s.lights.append(s.objects.pop())  # the mesh is a light
    s.add_sphere(0.5, (0.0, 0.0, 3.0), B.Metal((0.8, 0.8, 0.8), 0.1))
    return s


def test_compiled_mesh_tables_match_reference():
    jsd = _mesh_scene(JB).compile().data  # the reference's CPU route: SAH order + BVH
    tsd = _mesh_scene(TB).compile(device="cpu").data
    assert tsd.has_tri_clusters and not tsd.has_tri_clusters_hbm and tsd.tri_sc_size == 64
    assert jsd.has_tri_bvh and jsd.tri_sc_size == 64
    geo, attr = TK.from_reference_packing(np.asarray(jsd.tri_pk), np.asarray(jsd.tri_pk2))
    for name in TD.tensor_fields():
        want = {"tri_geo": geo, "tri_attr": attr}.get(name)
        want = np.asarray(getattr(jsd, name)) if want is None else want
        got = getattr(tsd, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    tri_lights = tsd.light_idx.numpy()[tsd.light_kind.numpy() == TD.GEOM_TRI]
    assert len(tri_lights) == 30 and tri_lights.min() != 2500  # remapped through the SAH order


def test_large_mesh_routes_to_two_level():
    v0, e1, e2, _ = _soup(50_000, 4, spread=6.0, size=0.05)
    pos = np.stack([v0, v0 + e1, v0 + e2], axis=1).reshape(-1, 3)
    s = TB.Scene()
    idx = np.arange(len(pos)).reshape(-1, 3)
    s.add_mesh(dict(positions=pos, normals=None, uvs=None, indices=idx), TB.Diffuse((0.5, 0.5, 0.5)))
    sd = s.compile(device="cpu").data
    assert sd.has_tri_clusters_hbm and not sd.has_tri_clusters and sd.tri_sc_size == 16
    cp = sd.tri_cl.shape[0]
    assert cp > TK.FLAT_MAX_CLUSTERS and cp % 16 == 0
    assert sd.tri_scl.shape[0] >= cp // 16 and sd.tri_geo.shape == (cp, 10, 64)
    assert not s.compile(device="cpu", bvh=False).data.has_tri_clusters
    bvh = s.compile(device="cpu", bvh=True).data  # the stackless BVH, two-level tables kept
    assert bvh.has_tri_bvh and not (bvh.has_tri_clusters or bvh.has_tri_clusters_hbm)
    assert bvh.tri_sc_size == 16 and bvh.tri_cl.shape == sd.tri_cl.shape


def _rays(b, seed):
    """Rays from a sphere of radius 8 toward the soup; seeds: open, short, and dead lanes."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(b, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 8.0).astype(np.float32)
    d = (rng.normal(size=(b, 3)) * 1.5 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_in = np.full(b, 3e38, np.float32)
    t_in[b // 2 : 3 * b // 4] = rng.uniform(5.0, 9.0, b // 4)
    t_in[3 * b // 4 :] = 0.0
    return o, d.astype(np.float32), t_in


def _pallas_sd(v0, e1, e2, at, cl, sc_size):
    """A reference SceneData holding just the cluster tables the Pallas kernel reads."""
    j_box, pk, pk2, j_sc = j_pack(v0, e1, e2, cl, *(at[k] for k in _ATTR), sc_size=sc_size)
    base = _mesh_scene(JB, n=70).compile().data
    return dataclasses.replace(
        base, tri_cl=jnp.asarray(j_box), tri_pk=jnp.asarray(pk), tri_pk2=jnp.asarray(pk2),
        tri_scl=jnp.asarray(j_sc), tri_sc_size=sc_size, has_tri_bvh=False,
        has_tri_clusters=sc_size == 64, has_tri_clusters_hbm=sc_size != 64,
    )


def compare_with_pallas(hbm):
    """Plain version vs pallas_closest_tri (interpret mode) on a 300-triangle soup."""
    v0, e1, e2, at = _soup(300, 6, spread=1.0, size=0.4)
    order, _, cl = t_build(v0, e1, e2)
    v0, e1, e2 = v0[order], e1[order], e2[order]
    at = {k: v[order] for k, v in at.items()}
    sc = TK.SC_TWO_LEVEL if hbm else TK.SC_FLAT
    jsd = _pallas_sd(v0, e1, e2, at, cl, sc)
    o, d, t_in = _rays(1024, 8)
    jt, ji, jaux = pallas_closest_tri(
        jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_in), 1e-3, interpret=True, hbm=hbm
    )
    cl_box, geo, attr, sc_box = (torch.from_numpy(a) for a in TK.pack_clusters(
        v0, e1, e2, cl, *(at[k] for k in _ATTR), sc_size=sc))
    args = [torch.from_numpy(a) for a in (o, d, t_in)] + [1e-3]
    if hbm:
        tt, ti, taux = TK.closest_tri_two_level(*args, sc_box, cl_box, geo, attr, sc)
    else:
        tt, ti, taux = TK.closest_tri_flat(*args, sc_box, cl_box, geo, attr)
    hit = np.asarray(jt) < 3e38
    assert 0.2 < hit.mean() < 0.6 and not hit[768:].any()  # dead lanes miss
    np.testing.assert_array_equal(tt.numpy() < 3e38, hit)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(taux["mat"].numpy(), np.asarray(jaux["mat"]))
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit], rtol=2e-5, atol=1e-3)
    for k in ("ns_raw", "u", "v"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), atol=1e-4, err_msg=k)


def test_two_level_plain_matches_pallas_hbm_kernel():
    compare_with_pallas(hbm=True)
