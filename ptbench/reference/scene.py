"""A configuration file's scene as the reference's tables, worked out from the file alone.

Follows the Rust reference renderer's scene semantics (its instance, cuboid, mesh and
material records) as the port's scene compiler lays them out: geometry baked to world
space in float64 and stored as float32, objects before lights (ties go to objects),
materials and textures interned in first-use order, images in one flat atlas scaled
to [0, 1]. Meshes are read from the OBJ files the configuration names, and the
environment image from its Radiance file, both with this package's own readers. No
acceleration structure is built: ``intersect.py`` tests every primitive.
"""

from __future__ import annotations

import os

import numpy as np

from . import tables as D
from .camera import Camera
from .hdr import load_rgb8
from .obj import load_obj

f32 = np.float32


def _quat(tr):
    ax = np.asarray(tr.get("axis", (0.0, 1.0, 0.0)), dtype=np.float64)
    ax = ax / np.linalg.norm(ax)
    h = 0.5 * float(tr.get("angle", 0.0))
    return np.concatenate([np.sin(h) * ax, [np.cos(h)]])


def _rotate(tr, v):
    """Rotation by the transform's quaternion (instance.rs:11,20-30)."""
    q = _quat(tr)
    qv, w = q[:3], q[3]
    t = np.cross(qv, v) + w * v
    return v + 2.0 * np.cross(qv, t)


def _point(tr, p):
    return _rotate(tr, p) + np.asarray(tr.get("translation", (0.0, 0.0, 0.0)), dtype=np.float64)


class _Interner:
    """Materials, textures and the atlas, interned in first-use order."""

    def __init__(self, cfg, asset_dir):
        self.cfg, self.asset_dir = cfg, asset_dir
        self.mat_rows, self.mat_ids = [], {}
        self.tex_rows, self.tex_ids = [], {}
        self.atlas = []

    def texture(self, spec, key):
        if key in self.tex_ids:
            return self.tex_ids[key]
        if isinstance(spec, dict) and "checker" in spec:
            c = spec["checker"]
            child = (self.texture(c["even"], key + ".even"), self.texture(c["odd"], key + ".odd"))
            row = dict(type=D.TEX_CHECKER, rgb=(0.0, 0.0, 0.0), inv_scale=1.0 / float(c["scale"]),
                       child=child, img=(0, 0, 0))
        elif isinstance(spec, dict) and "image" in spec:
            img = load_rgb8(os.path.join(self.asset_dir, spec["image"]))
            h, w = img.shape[:2]
            offset = sum(len(a) for a in self.atlas)
            self.atlas.append(img.reshape(-1, 3))
            row = dict(type=D.TEX_IMAGE, rgb=(0.0, 0.0, 0.0), inv_scale=0.0, child=(-1, -1),
                       img=(offset, w, h))
        else:
            rgb = np.atleast_1d(np.asarray(spec, dtype=np.float64))
            rgb = np.repeat(rgb, 3) if rgb.shape == (1,) else rgb
            row = dict(type=D.TEX_SOLID, rgb=tuple(float(x) for x in rgb), inv_scale=0.0,
                       child=(-1, -1), img=(0, 0, 0))
        self.tex_ids[key] = len(self.tex_rows)
        self.tex_rows.append(row)
        return self.tex_ids[key]

    def material(self, name):
        if name in self.mat_ids:
            return self.mat_ids[name]
        m = self.cfg["materials"][name]
        params = np.zeros(D.N_PARAMS, dtype=np.float64)
        rough = -1
        kind = m["type"]
        if kind == "light":
            mtype, tex = D.MAT_LIGHT, self.texture(m["emission"], name + ".emission")
        else:
            tex = self.texture(m["base_color"], name + ".base_color")
            if kind == "diffuse":
                mtype = D.MAT_DIFFUSE
            elif kind == "metal":
                mtype = D.MAT_METAL
                rough = self.texture(m["roughness"], name + ".roughness")
            elif kind == "glass":
                mtype = D.MAT_GLASS
                rough = self.texture(m.get("roughness", 0.001), name + ".roughness")
                params[D.P_IOR] = float(m.get("ior", 1.5))
            elif kind == "principled":
                mtype = D.MAT_PRINCIPLED
                defaults = dict(metallic=0.0, roughness=0.5, subsurface=0.0, specular=0.5,
                                specular_tint=0.0, ior=1.5, spec_trans=0.0, sheen=0.0,
                                sheen_tint=0.0, clearcoat=0.0, clearcoat_gloss=0.0)
                for col, key in enumerate(defaults):
                    params[col] = float(m.get(key, defaults[key]))
            else:
                raise ValueError(f"unknown material type {kind!r}")
        self.mat_ids[name] = len(self.mat_rows)
        self.mat_rows.append(dict(type=mtype, tex=tex, rough_tex=rough, params=params))
        return self.mat_ids[name]


def _cuboid_quads(a, b):
    """An axis-aligned box as 6 quads, in cuboid.rs:18-53's order."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    mn, mx = np.minimum(a, b), np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0.0, 0.0])
    dy = np.array([0.0, mx[1] - mn[1], 0.0])
    dz = np.array([0.0, 0.0, mx[2] - mn[2]])
    return [
        (np.array([mn[0], mn[1], mx[2]]), dx, dy),
        (np.array([mx[0], mn[1], mx[2]]), -dz, dy),
        (np.array([mx[0], mn[1], mn[2]]), -dx, dy),
        (np.array([mn[0], mn[1], mn[2]]), dz, dy),
        (np.array([mn[0], mx[1], mx[2]]), dx, -dz),
        (np.array([mn[0], mn[1], mn[2]]), dx, dz),
    ]


def build_tables(cfg: dict, asset_dir: str, device) -> tuple[D.SceneTables, bool]:
    """Configuration -> (SceneTables on `device`, whether the scene has lights)."""
    it = _Interner(cfg, asset_dir)
    env = cfg["environment"]
    env_tex = it.texture(env, "environment") if isinstance(env, dict) else -1
    env_color = np.zeros(3, f32) if isinstance(env, dict) else np.asarray(env, dtype=f32)

    sph, quad, tri, mesh_ranges = [], [], [], []
    lights = []
    objects = [o for o in cfg["objects"] if not o.get("light")]
    lits = [o for o in cfg["objects"] if o.get("light")]
    for is_light, group in ((False, objects), (True, lits)):
        for ob in group:
            mid = it.material(ob["material"])
            tr = ob.get("transform")
            if ob["type"] == "sphere":
                c1 = np.asarray(ob["center"], dtype=np.float64)
                c2 = np.asarray(ob.get("center2", ob["center"]), dtype=np.float64)
                if tr is not None:
                    c1, c2 = _point(tr, c1), _point(tr, c2)
                if is_light:
                    lights.append((D.GEOM_SPHERE, len(sph)))
                sph.append((c1, c2, max(float(ob["radius"]), 0.0), mid))
            elif ob["type"] in ("quad", "cuboid"):
                faces = ([(np.asarray(ob["q"], dtype=np.float64), np.asarray(ob["u"], dtype=np.float64),
                           np.asarray(ob["v"], dtype=np.float64))]
                         if ob["type"] == "quad" else _cuboid_quads(ob["a"], ob["b"]))
                for q, u, v in faces:
                    if tr is not None:
                        q, u, v = _point(tr, q), _rotate(tr, u), _rotate(tr, v)
                    if is_light:
                        lights.append((D.GEOM_QUAD, len(quad)))
                    quad.append((q, u, v, mid))
            elif ob["type"] == "mesh":
                mesh = load_obj(os.path.join(asset_dir, ob["file"]))
                pos = mesh["positions"].astype(np.float64) * float(ob.get("scale", 1.0))
                nrm = None if mesh["normals"] is None else mesh["normals"].astype(np.float64)
                if tr is not None:
                    pos = _rotate(tr, pos) + np.asarray(tr.get("translation", (0.0, 0.0, 0.0)))
                    if nrm is not None:
                        nrm = _rotate(tr, nrm)
                uvs = mesh["uvs"]
                lo = len(tri)
                for f in mesh["indices"]:
                    i0, i1, i2 = int(f[0]), int(f[1]), int(f[2])
                    v0, v1, v2 = pos[i0], pos[i1], pos[i2]
                    if nrm is not None:
                        n = (nrm[i0], nrm[i1], nrm[i2])
                    else:
                        fn = np.cross(v1 - v0, v2 - v0)
                        ln = np.linalg.norm(fn)
                        fn = fn / ln if ln > 0 else np.array([0.0, 0.0, 1.0])
                        n = (fn, fn, fn)
                    uv = (uvs[i0], uvs[i1], uvs[i2]) if uvs is not None else (np.zeros(2),) * 3
                    tri.append((v0, v1, v2, n, uv, uvs is not None, mid))
                mesh_ranges.append((lo, len(tri)))
            else:
                raise ValueError(f"unknown object type {ob['type']!r}")

    sph = sph or [(np.zeros(3), np.zeros(3), -1.0, 0)]
    quad = quad or [(np.zeros(3), np.zeros(3), np.zeros(3), 0)]
    tri = tri or [(np.zeros(3), np.zeros(3), np.zeros(3), (np.zeros(3),) * 3, (np.zeros(2),) * 3, False, 0)]
    sph_c1 = np.stack([s[0] for s in sph]).astype(f32)
    sph_c2 = np.stack([s[1] for s in sph]).astype(f32)
    sph_r = np.array([s[2] for s in sph], dtype=f32)
    quad_q = np.stack([q[0] for q in quad])
    quad_u = np.stack([q[1] for q in quad])
    quad_v = np.stack([q[2] for q in quad])
    n = np.cross(quad_u, quad_v)
    n_len2 = np.maximum((n * n).sum(-1, keepdims=True), 1e-300)
    normal = n / np.sqrt(n_len2)
    tri_v0 = np.stack([t[0] for t in tri]).astype(f32)
    tri_e1 = np.stack([t[1] - t[0] for t in tri]).astype(f32)
    tri_e2 = np.stack([t[2] - t[0] for t in tri]).astype(f32)

    light_rows = lights or [(D.GEOM_SPHERE, 0)]
    light_geom = np.zeros((len(light_rows), 10), dtype=f32)
    for i, (k, g) in enumerate(light_rows):
        if k == D.GEOM_SPHERE:
            light_geom[i, 0:3], light_geom[i, 3:6], light_geom[i, 6] = sph_c1[g], sph_c2[g], sph_r[g]
        else:
            light_geom[i, 0:3], light_geom[i, 3:6], light_geom[i, 6:9] = quad_q[g], quad_u[g], quad_v[g]
        light_geom[i, 9] = k

    mats, texs = it.mat_rows, it.tex_rows
    tex_type = np.array([t["type"] for t in texs], dtype=np.int32)
    tex_img = np.array([t["img"] for t in texs], dtype=np.int32)
    mat_type = np.array([m["type"] for m in mats], dtype=np.int32)
    mat_rough_tex = np.array([m["rough_tex"] for m in mats], dtype=np.int32)
    atlas = (np.concatenate(it.atlas) if it.atlas else np.zeros((1, 3), np.uint8)).astype(f32) / f32(255.0)
    env_img = env_tex >= 0 and int(tex_type[env_tex]) == D.TEX_IMAGE
    sd = D.SceneTables(
        device,
        sph_c1=sph_c1, sph_c2=sph_c2, sph_r=sph_r,
        sph_mat=np.array([s[3] for s in sph], dtype=np.int32),
        quad_q=quad_q.astype(f32), quad_u=quad_u.astype(f32), quad_v=quad_v.astype(f32),
        quad_w=(n / n_len2).astype(f32), quad_n=normal.astype(f32),
        quad_d=(normal * quad_q).sum(-1).astype(f32),
        quad_mat=np.array([q[3] for q in quad], dtype=np.int32),
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
        tri_n0=np.stack([t[3][0] for t in tri]).astype(f32),
        tri_n1=np.stack([t[3][1] for t in tri]).astype(f32),
        tri_n2=np.stack([t[3][2] for t in tri]).astype(f32),
        tri_uv0=np.stack([t[4][0] for t in tri]).astype(f32),
        tri_uv1=np.stack([t[4][1] for t in tri]).astype(f32),
        tri_uv2=np.stack([t[4][2] for t in tri]).astype(f32),
        tri_has_uv=np.array([t[5] for t in tri], dtype=bool),
        tri_mat=np.array([t[6] for t in tri], dtype=np.int32),
        light_kind=np.array([k for k, _ in light_rows], dtype=np.int32),
        light_geom=light_geom,
        mat_type=mat_type,
        mat_tex=np.array([m["tex"] for m in mats], dtype=np.int32),
        mat_rough_tex=mat_rough_tex,
        mat_normal_tex=np.full(len(mats), -1, dtype=np.int32),
        mat_params=np.stack([m["params"] for m in mats]).astype(f32),
        tex_type=tex_type,
        tex_rgb=np.array([t["rgb"] for t in texs], dtype=f32),
        tex_inv_scale=np.array([t["inv_scale"] for t in texs], dtype=f32),
        tex_child=np.array([t["child"] for t in texs], dtype=np.int32),
        tex_img=tex_img,
        atlas=atlas,
        env_color=env_color,
        env_tex=np.asarray(env_tex, dtype=np.int32),
    )
    sd.lights_host = tuple(light_rows)
    sd.n_lights_real = len(lights)
    sd.mesh_ranges = tuple(mesh_ranges)
    sd.has_tris = bool(mesh_ranges)
    sd.has_normal_maps = False
    sd.mat_types = tuple(sorted(set(int(t) for t in mat_type)))
    sd.has_image_textures = bool((tex_type == D.TEX_IMAGE).any()) or env_tex >= 0
    sd.has_checker = bool((tex_type == D.TEX_CHECKER).any())
    sd.rough_all_solid = all(int(tex_type[int(r)]) == D.TEX_SOLID for r in mat_rough_tex if int(r) >= 0)
    sd.env_is_map = env_tex >= 0
    sd.env_is_hdr = False
    sd.env_map_off = int(tex_img[env_tex][0]) if env_img else 0
    sd.env_map_w = int(tex_img[env_tex][1]) if env_img else 0
    sd.env_map_h = int(tex_img[env_tex][2]) if env_img else 0
    return sd, bool(lights)


def camera(cfg: dict, **override) -> Camera:
    """The configuration's camera, with fields overridden (a moved look_from, say)."""
    fields = dict(cfg["camera"], **override)
    return Camera(**fields)
