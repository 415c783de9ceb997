"""Scene compiler: builder records -> SceneData tensors.

Counterpart of ``tpupt/scene/compile.py``. Geometry is flattened (instances pre-baked
by the builder), materials and textures are interned into integer-indexed tables,
images are packed into one flat atlas, and light geometry is appended *after* object
geometry so closest-hit ties resolve to objects (world.rs:47-62). The tables are
built in numpy (float64 where the reference does) and moved to the device once by
``scene/convert.py``.

Meshes of ``BVH_THRESHOLD`` triangles or more are SAH-ordered and cut into
clusters for the cluster kernels (ops/tri_kernel.py). The route is chosen by the
table size, for the card, not by backend: at most ``FLAT_MAX_CLUSTERS`` packed
clusters go to the flat kernel, more (up to ``MAX_CLUSTERS``) to the two-level
kernel with superclusters of 16, beyond that the dense sweep. ``bvh=True`` takes
the stackless BVH instead (ops/bvh_kernel.py), the reference's CPU route, which
is also the default under the f64 oracle. The nodes and the cluster tables are
kept together, so the route flags can be flipped on one SceneData.

An environment ``ImageTexture(..., hdr=True)`` is kept in f32 with its alias and
pdf tables (ops/envmap.py).
"""

from __future__ import annotations

import numpy as np

from . import builder as B
from . import data as D
from .. import trace
from ..core.dtypes import NP_REAL, ORACLE_X64
from ..ops.bvh import build_tri_bvh_sah
from ..ops.envmap import build_env_tables
from ..ops.tri_kernel import (
    ATTR_ROWS, FLAT_MAX_CLUSTERS, GEO_ROWS, MAX_CLUSTERS, SC_FLAT, SC_TWO_LEVEL, SLOTS,
    pack_clusters,
)
from .convert import scene_data_from_numpy

BVH_THRESHOLD = 64  # meshes at or above this size need the BVH / cluster paths


def _image_rgb8(tex: "B.ImageTexture") -> np.ndarray:
    if isinstance(tex.path, np.ndarray):
        img = np.asarray(tex.path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError("an in-memory ImageTexture must be a uint8 [H,W,3] array")
        return img
    from ..io.image import load_image_rgb8

    with trace.span("scene.image"):
        return load_image_rgb8(tex.path)


def _intern_texture(tex, tables) -> int:
    key = id(tex)
    if key in tables["tex_ids"]:
        return tables["tex_ids"][key]

    if isinstance(tex, B.SolidTexture):
        row = dict(type=D.TEX_SOLID, rgb=tex.rgb, inv_scale=0.0, child=(-1, -1), img=(0, 0, 0))
    elif isinstance(tex, B.CheckerTexture):
        c1 = _intern_texture(tex.tex1, tables)
        c2 = _intern_texture(tex.tex2, tables)
        row = dict(
            type=D.TEX_CHECKER,
            rgb=(0.0, 0.0, 0.0),
            inv_scale=1.0 / tex.scale,  # texture.rs:36
            child=(c1, c2),
            img=(0, 0, 0),
        )
    elif isinstance(tex, B.ImageTexture):
        if tex.hdr:
            raise NotImplementedError("hdr=True is supported for Scene.environment only")
        img = _image_rgb8(tex)
        h, w = img.shape[:2]
        offset = sum(len(a) for a in tables["atlas"])
        tables["atlas"].append(img.reshape(-1, 3))
        row = dict(
            type=D.TEX_IMAGE, rgb=(0.0, 0.0, 0.0), inv_scale=0.0, child=(-1, -1), img=(offset, w, h)
        )
    else:
        raise TypeError(f"unknown texture {tex!r}")

    idx = len(tables["tex_rows"])
    tables["tex_rows"].append(row)
    tables["tex_ids"][key] = idx
    return idx


def _intern_material(mat, tables) -> int:
    key = id(mat)
    if key in tables["mat_ids"]:
        return tables["mat_ids"][key]

    params = np.zeros(D.N_PARAMS, dtype=np.float64)
    tex = -1
    rough_tex = -1
    normal_tex = -1

    if isinstance(mat, B.Diffuse):
        mtype = D.MAT_DIFFUSE
        tex = _intern_texture(mat.base_color, tables)
        if mat.normal_map is not None:
            normal_tex = _intern_texture(mat.normal_map, tables)
    elif isinstance(mat, B.Metal):
        mtype = D.MAT_METAL
        tex = _intern_texture(mat.base_color, tables)
        rough_tex = _intern_texture(mat.roughness, tables)
    elif isinstance(mat, B.Glass):
        mtype = D.MAT_GLASS
        tex = _intern_texture(mat.base_color, tables)
        rough_tex = _intern_texture(mat.roughness, tables)
        params[D.P_IOR] = mat.ior
    elif isinstance(mat, B.Principled):
        mtype = D.MAT_PRINCIPLED
        tex = _intern_texture(mat.base_color, tables)
        params[D.P_METALLIC] = mat.metallic
        params[D.P_ROUGHNESS] = mat.roughness
        params[D.P_SUBSURFACE] = mat.subsurface
        params[D.P_SPECULAR] = mat.specular
        params[D.P_SPECULAR_TINT] = mat.specular_tint
        params[D.P_IOR] = mat.ior
        params[D.P_SPEC_TRANS] = mat.spec_trans
        params[D.P_SHEEN] = mat.sheen
        params[D.P_SHEEN_TINT] = mat.sheen_tint
        params[D.P_CLEARCOAT] = mat.clearcoat
        params[D.P_CLEARCOAT_GLOSS] = mat.clearcoat_gloss
    elif isinstance(mat, B.Light):
        mtype = D.MAT_LIGHT
        tex = _intern_texture(mat.emission, tables)
    else:
        raise TypeError(f"unknown material {mat!r}")

    idx = len(tables["mat_rows"])
    tables["mat_rows"].append(
        dict(type=mtype, tex=tex, rough_tex=rough_tex, normal_tex=normal_tex, params=params)
    )
    tables["mat_ids"][key] = idx
    return idx


def _emit_geometry(rec, tables, is_light: bool):
    mid = _intern_material(rec.material, tables)
    if isinstance(rec, B.SphereRec):
        idx = len(tables["sph"])
        tables["sph"].append((rec.center1, rec.center2, rec.radius, mid))
        if is_light:
            tables["lights"].append((D.GEOM_SPHERE, idx))
    elif isinstance(rec, B.QuadRec):
        idx = len(tables["quad"])
        tables["quad"].append((rec.q, rec.u, rec.v, mid))
        if is_light:
            tables["lights"].append((D.GEOM_QUAD, idx))
    elif isinstance(rec, B.MeshRec):
        pos, nrm, uvs, ind = rec.positions, rec.normals, rec.uvs, rec.indices
        for f in ind:
            i0, i1, i2 = int(f[0]), int(f[1]), int(f[2])
            idx = len(tables["tri"])
            v0, v1, v2 = pos[i0], pos[i1], pos[i2]
            if nrm is not None:
                n = (nrm[i0], nrm[i1], nrm[i2])
            else:
                # face normal (mesh.rs:88): normalize(e1 x e2), same for all hits
                fn = np.cross(v1 - v0, v2 - v0)
                ln = np.linalg.norm(fn)
                fn = fn / ln if ln > 0 else np.array([0.0, 0.0, 1.0])
                n = (fn, fn, fn)
            if uvs is not None:
                uv = (uvs[i0], uvs[i1], uvs[i2])
                has_uv = True
            else:
                uv = (np.zeros(2),) * 3
                has_uv = False
            tables["tri"].append((v0, v1, v2, n, uv, has_uv, mid))
            if is_light:
                tables["lights"].append((D.GEOM_TRI, idx))
    else:
        raise TypeError(f"unknown geometry {rec!r}")


def _env_tables(src) -> dict:
    """The HDR environment's tables for SceneData: src is a file path (read by
    ``io.image.load_image_f32``) or an in-memory [H,W,3] array, taken as float32.
    src None gives the one-row dummies of a scene without an HDR map."""
    if src is None:
        img = np.zeros((1, 3), dtype=NP_REAL)
        w = h = 1
        alias = np.zeros(1, dtype=np.int32)
        prob = np.ones(1, dtype=NP_REAL)
        pdf = np.full(1, 1.0 / (4.0 * np.pi), dtype=NP_REAL)
    else:
        if isinstance(src, np.ndarray):
            img = np.asarray(src, dtype=NP_REAL)
        else:
            from ..io.image import load_image_f32

            with trace.span("scene.image"):
                img = load_image_f32(src).astype(NP_REAL)
        h, w = img.shape[:2]
        with trace.span("scene.envmap"):
            alias, prob, pdf = build_env_tables(img)
        # env_sam holds alias indices as f32: exact only below 2^24
        assert alias.size < (1 << 24), "env map too large for f32-exact alias rows"
    return dict(
        env_img=img.reshape(-1, 3),
        env_wh=np.array([w, h], dtype=np.int32),
        env_alias=alias,
        env_prob=prob,
        env_pdf=pdf,
        env_sam=np.stack([prob, alias.astype(NP_REAL), pdf], axis=-1).astype(NP_REAL),
    )


class CompiledScene:
    """SceneData + whether MIS samples lights (p_light = 0.5 iff the scene has geometry
    lights or an HDR environment)."""

    def __init__(self, data: D.SceneData, has_lights: bool):
        self.data = data
        self.has_lights = has_lights


def _pad_rows(a):
    """Pad a table to the sweep's block multiple (8 rows, or 256 above 64 rows)."""
    n = max(a.shape[0], 1)
    blk = 8 if n <= 64 else 256
    target = ((n + blk - 1) // blk) * blk
    if target == a.shape[0]:
        return a
    pad_shape = (target - a.shape[0],) + a.shape[1:]
    return np.concatenate([a, np.zeros(pad_shape, dtype=a.dtype)], axis=0)


def _pad_to_block(rows, pad_row):
    n = max(len(rows), 1)
    blk = 8 if n <= 64 else 256
    target = ((n + blk - 1) // blk) * blk
    return list(rows) + [pad_row] * (target - len(rows))


def _tri_route(tri: dict, n_real: int, bvh):
    """SAH-order the triangle tables, keep the BVH nodes and pack the clusters
    -> (tri, perm, tables, static).

    bvh None: meshes of BVH_THRESHOLD triangles or more take the cluster kernels
    (the stackless BVH under the f64 oracle, whose cluster routes raise); True: the
    stackless BVH for any mesh of 2 or more triangles; False: the dense sweep.
    Whenever the tree is built both its nodes and the cluster tables are kept, as
    in the reference, so a caller can flip the route flags on one SceneData. perm
    is the SAH order (old index per new slot), None when the tables keep their order.
    The cluster flags stay off for tables beyond MAX_CLUSTERS (the dense sweep).
    """
    box = np.zeros((8, 8), dtype=np.float32)
    box[:, 0:6] = 1e30  # pad boxes: the slab test never passes
    tables = dict(
        tri_cl=box, tri_scl=box.copy(),
        tri_geo=np.zeros((8, GEO_ROWS, SLOTS), np.float32),
        tri_attr=np.zeros((8, ATTR_ROWS, SLOTS), np.float32),
        bvh_min=np.zeros((1, 3), dtype=NP_REAL),
        bvh_max=np.zeros((1, 3), dtype=NP_REAL),
        bvh_skip=np.ones(1, dtype=np.int32),
        bvh_start=np.zeros(1, dtype=np.int32),
        bvh_count=np.zeros(1, dtype=np.int32),
    )
    static = dict(has_tri_bvh=False, has_tri_clusters=False, has_tri_clusters_hbm=False, tri_sc_size=SC_FLAT)
    if bvh is None:
        use_bvh = ORACLE_X64 and n_real >= BVH_THRESHOLD
    else:
        use_bvh = bool(bvh) and n_real >= 2
    if not use_bvh and (bvh is False or n_real < BVH_THRESHOLD):
        return tri, None, tables, static
    with trace.span("scene.bvh"):
        order, nodes, clusters = build_tri_bvh_sah(tri["tri_v0"], tri["tri_e1"], tri["tri_e2"])
    tri = {k: v[order] for k, v in tri.items()}
    tables.update(bvh_min=nodes["bmin"], bvh_max=nodes["bmax"], bvh_skip=nodes["skip"],
                  bvh_start=nodes["start"], bvh_count=nodes["count"])
    packed = pack_clusters(*(tri[k] for k in _TRI_GEOM), clusters, *(tri[k] for k in _TRI_ATTR))
    cp = packed[0].shape[0]
    route = {"has_tri_clusters": True}
    if cp > MAX_CLUSTERS:
        packed, route = None, {}
    elif cp > FLAT_MAX_CLUSTERS:
        packed = pack_clusters(
            *(tri[k] for k in _TRI_GEOM), clusters, *(tri[k] for k in _TRI_ATTR),
            sc_size=SC_TWO_LEVEL,
        )
        route = {"has_tri_clusters_hbm": True}
        static["tri_sc_size"] = SC_TWO_LEVEL
    if packed is not None:
        tables.update(zip(("tri_cl", "tri_geo", "tri_attr", "tri_scl"), packed))
    static.update({"has_tri_bvh": True} if use_bvh else route)
    return tri, order, tables, static


def _mxu_tables(tri: dict, n_real: int) -> dict:
    """The matmul sweep's coefficient rows [T,10] of the padded triangle tables
    (the reference's formulas, in the same float32 numpy operations), built from
    BVH_THRESHOLD triangles on; one row of zeros each below that."""
    if n_real < BVH_THRESHOLD:
        zero = np.zeros((1, 10), dtype=NP_REAL)
        return dict(tri_ca=zero, tri_cu=zero.copy(), tri_cv=zero.copy(), tri_ct=zero.copy())
    v0, e1, e2 = tri["tri_v0"], tri["tri_e1"], tri["tri_e2"]
    z = np.zeros_like(v0[:, :1])
    n_vec = np.cross(e1, e2)
    return dict(
        tri_ca=np.concatenate([np.cross(e2, e1), 0 * v0, 0 * v0, z], axis=1).astype(NP_REAL),
        tri_cu=np.concatenate([-np.cross(e2, v0), 0 * v0, e2, z], axis=1).astype(NP_REAL),
        tri_cv=np.concatenate([-np.cross(v0, e1), 0 * v0, -e1, z], axis=1).astype(NP_REAL),
        tri_ct=np.concatenate(
            [0 * v0, n_vec, 0 * v0, -(v0 * n_vec).sum(-1, keepdims=True)], axis=1
        ).astype(NP_REAL),
    )


_TRI_GEOM = ("tri_v0", "tri_e1", "tri_e2")
_TRI_ATTR = ("tri_n0", "tri_n1", "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2", "tri_has_uv", "tri_mat")


def compile_numpy(scene: "B.Scene", bvh: bool | None = None) -> tuple[dict, dict, bool]:
    """Builder scene -> (numpy tensor fields, static facts, has_lights).

    bvh: None routes meshes of BVH_THRESHOLD triangles or more to the cluster
    kernels (to the stackless BVH under the f64 oracle); True routes any mesh to
    the stackless BVH; False forces the dense sweep (see _tri_route).
    """
    tables = dict(
        sph=[], quad=[], tri=[], lights=[], mat_rows=[], mat_ids={}, tex_rows=[], tex_ids={}, atlas=[]
    )
    f32 = NP_REAL

    # environment must be interned before padding defaults
    env_is_hdr = isinstance(scene.environment, B.ImageTexture) and scene.environment.hdr
    env = _env_tables(scene.environment.path if env_is_hdr else None)
    if env_is_hdr:
        env_tex_id = -1
        env_color = np.zeros(3, dtype=f32)
    elif isinstance(scene.environment, B.ImageTexture):
        env_tex_id = _intern_texture(scene.environment, tables)
        env_color = np.zeros(3, dtype=f32)
    else:
        env_tex_id = -1
        env_color = np.asarray(scene.environment, dtype=f32)

    # objects first, then lights: ties go to objects (world.rs:56-60 uses strict <)
    for rec in scene.objects:
        _emit_geometry(rec, tables, is_light=False)
    for rec in scene.lights:
        _emit_geometry(rec, tables, is_light=True)

    # ---- spheres (pad: negative radius is the explicit miss sentinel) ----
    sph = _pad_to_block(tables["sph"], (np.zeros(3), np.zeros(3), -1.0, 0))
    sph_c1 = np.stack([s[0] for s in sph]).astype(f32)
    sph_c2 = np.stack([s[1] for s in sph]).astype(f32)
    sph_r = np.array([s[2] for s in sph], dtype=f32)
    sph_mat = np.array([s[3] for s in sph], dtype=np.int32)

    # ---- quads (pad: zero u,v gives zero normal -> |nd| < eps reject, quad.rs:44) ----
    quad = _pad_to_block(tables["quad"], (np.zeros(3), np.zeros(3), np.zeros(3), 0))
    quad_q = np.stack([q[0] for q in quad]).astype(np.float64)
    quad_u = np.stack([q[1] for q in quad]).astype(np.float64)
    quad_v = np.stack([q[2] for q in quad]).astype(np.float64)
    quad_mat = np.array([q[3] for q in quad], dtype=np.int32)
    n = np.cross(quad_u, quad_v)
    n_len2 = np.maximum((n * n).sum(-1, keepdims=True), 1e-300)
    normal = n / np.sqrt(n_len2)
    quad_w = n / n_len2  # quad.rs:25
    quad_d = (normal * quad_q).sum(-1)  # quad.rs:24

    # ---- triangles (pad: zero edges -> |a| < 1e-8 parallel reject, mesh.rs:60) ----
    tri_real = tables["tri"] or [
        (np.zeros(3), np.zeros(3), np.zeros(3), (np.zeros(3),) * 3, (np.zeros(2),) * 3, False, 0)
    ]
    tri = dict(
        tri_v0=np.stack([t[0] for t in tri_real]).astype(f32),
        tri_e1=np.stack([t[1] - t[0] for t in tri_real]).astype(f32),
        tri_e2=np.stack([t[2] - t[0] for t in tri_real]).astype(f32),
        tri_n0=np.stack([t[3][0] for t in tri_real]).astype(f32),
        tri_n1=np.stack([t[3][1] for t in tri_real]).astype(f32),
        tri_n2=np.stack([t[3][2] for t in tri_real]).astype(f32),
        tri_uv0=np.stack([t[4][0] for t in tri_real]).astype(f32),
        tri_uv1=np.stack([t[4][1] for t in tri_real]).astype(f32),
        tri_uv2=np.stack([t[4][2] for t in tri_real]).astype(f32),
        tri_has_uv=np.array([t[5] for t in tri_real], dtype=bool),
        tri_mat=np.array([t[6] for t in tri_real], dtype=np.int32),
    )
    tri, perm, route_tables, route_static = _tri_route(tri, len(tables["tri"]), bvh)
    tri = {k: _pad_rows(v) for k, v in tri.items()}
    mxu = _mxu_tables(tri, len(tables["tri"]))

    # ---- lights (pad row never selected: the integrator masks on n_lights) ----
    if perm is not None:  # the triangle table was SAH-reordered: remap triangle lights
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(len(perm), dtype=perm.dtype)
        tables["lights"] = [
            (k, int(inv_perm[g]) if k == D.GEOM_TRI else g) for k, g in tables["lights"]
        ]
    lights = tables["lights"] or [(D.GEOM_SPHERE, 0)]
    light_kind = np.array([l[0] for l in lights], dtype=np.int32)
    light_idx = np.array([l[1] for l in lights], dtype=np.int32)
    has_lights = len(tables["lights"]) > 0

    light_geom = np.zeros((len(lights), 10), dtype=f32)
    for i, (k, g) in enumerate(lights):
        if k == D.GEOM_SPHERE:
            light_geom[i, 0:3] = sph_c1[g]
            light_geom[i, 3:6] = sph_c2[g]
            light_geom[i, 6] = sph_r[g]
        elif k == D.GEOM_QUAD:
            light_geom[i, 0:3] = quad_q[g]
            light_geom[i, 3:6] = quad_u[g]
            light_geom[i, 6:9] = quad_v[g]
        else:
            light_geom[i, 0:3] = tri["tri_v0"][g]
            light_geom[i, 3:6] = tri["tri_e1"][g]
            light_geom[i, 6:9] = tri["tri_e2"][g]
        light_geom[i, 9] = k

    # ---- materials ----
    mats = tables["mat_rows"] or [
        dict(type=D.MAT_DIFFUSE, tex=0, rough_tex=-1, normal_tex=-1, params=np.zeros(D.N_PARAMS))
    ]
    mat_type = np.array([m["type"] for m in mats], dtype=np.int32)
    mat_rough_tex = np.array([m["rough_tex"] for m in mats], dtype=np.int32)
    mat_normal_tex = np.array([m["normal_tex"] for m in mats], dtype=np.int32)

    # ---- textures ----
    texs = tables["tex_rows"] or [
        dict(type=D.TEX_SOLID, rgb=(0.0, 0.0, 0.0), inv_scale=0.0, child=(-1, -1), img=(0, 0, 0))
    ]
    tex_type = np.array([t["type"] for t in texs], dtype=np.int32)
    tex_img = np.array([t["img"] for t in texs], dtype=np.int32)
    atlas = (
        np.concatenate(tables["atlas"], axis=0)
        if tables["atlas"]
        else np.zeros((1, 3), dtype=np.uint8)
    ).astype(f32) / f32(255.0)

    fields = dict(
        sph_c1=sph_c1,
        sph_c2=sph_c2,
        sph_r=sph_r,
        sph_mat=sph_mat,
        quad_q=quad_q.astype(f32),
        quad_u=quad_u.astype(f32),
        quad_v=quad_v.astype(f32),
        quad_w=quad_w.astype(f32),
        quad_n=normal.astype(f32),
        quad_d=quad_d.astype(f32),
        quad_mat=quad_mat,
        **tri,
        **route_tables,
        **mxu,
        light_kind=light_kind,
        light_idx=light_idx,
        light_geom=light_geom,
        mat_type=mat_type,
        mat_tex=np.array([m["tex"] for m in mats], dtype=np.int32),
        mat_rough_tex=mat_rough_tex,
        mat_normal_tex=mat_normal_tex,
        mat_params=np.stack([m["params"] for m in mats]).astype(f32),
        tex_type=tex_type,
        tex_rgb=np.array([t["rgb"] for t in texs], dtype=f32),
        tex_inv_scale=np.array([t["inv_scale"] for t in texs], dtype=f32),
        tex_child=np.array([t["child"] for t in texs], dtype=np.int32),
        tex_img=tex_img,
        atlas=atlas,
        env_color=env_color,
        env_tex=np.asarray(env_tex_id, dtype=np.int32),
        **env,
    )
    env_img = env_tex_id >= 0 and int(tex_type[env_tex_id]) == D.TEX_IMAGE
    static = dict(
        has_normal_maps=bool((mat_normal_tex >= 0).any()),
        mat_types=tuple(sorted(set(int(t) for t in mat_type))),
        has_image_textures=bool((tex_type == D.TEX_IMAGE).any()) or env_tex_id >= 0,
        has_checker=bool((tex_type == D.TEX_CHECKER).any()),
        rough_all_solid=all(
            int(tex_type[int(rt)]) == D.TEX_SOLID for rt in mat_rough_tex if int(rt) >= 0
        ),
        env_is_map=env_tex_id >= 0,
        env_is_hdr=env_is_hdr,
        env_map_off=int(tex_img[env_tex_id][0]) if env_img else 0,
        env_map_w=int(tex_img[env_tex_id][1]) if env_img else 0,
        env_map_h=int(tex_img[env_tex_id][2]) if env_img else 0,
        n_lights_real=len(tables["lights"]),
        has_real_tris=bool(tables["tri"]),
        has_tri_mxu=False,
        **route_static,
    )
    # with importance sampling the environment is a light member, so MIS engages
    # (p_light = 0.5) even when the geometry lights list is empty
    return fields, static, has_lights or env_is_hdr


def compile_scene(scene: "B.Scene", device=None, bvh: bool | None = None) -> CompiledScene:
    """Compile a builder scene to SceneData on `device` (default cuda); bvh as in compile_numpy.
    The span ``scene.compile``, with ``scene.image`` (image decodes), ``scene.bvh`` (the SAH
    build), ``scene.envmap`` (the HDR environment's tables) and ``scene.upload`` in it."""
    with trace.span("scene.compile"):
        fields, static, has_lights = compile_numpy(scene, bvh)
        with trace.span("scene.upload"):
            return CompiledScene(scene_data_from_numpy(fields, static, device), has_lights)
