"""A configuration file's scene and camera through the port's public builder.

The program under test gets the scene as a user builds it: ``Scene.add_quad``,
``add_sphere``, ``add_cuboid``, ``add_mesh`` (meshes read by the port's own OBJ
reader) and ``Camera``; ``Scene.compile`` then makes the program's tables.
"""

from __future__ import annotations

import os


def _texture(B, spec, cache, key):
    if key in cache:
        return cache[key]
    if isinstance(spec, dict) and "checker" in spec:
        c = spec["checker"]
        tex = B.CheckerTexture(float(c["scale"]), _texture(B, c["even"], cache, key + ".even"),
                               _texture(B, c["odd"], cache, key + ".odd"))
    elif isinstance(spec, dict) and "image" in spec:
        tex = B.ImageTexture(os.path.join(cache["_assets"], spec["image"]))
    else:
        tex = B.SolidTexture(spec)
    cache[key] = tex
    return tex


def _material(B, cfg, name, cache):
    key = "material." + name
    if key in cache:
        return cache[key]
    m = cfg["materials"][name]
    kind = m["type"]
    if kind == "light":
        mat = B.Light(_texture(B, m["emission"], cache, name + ".emission"))
    else:
        base = _texture(B, m["base_color"], cache, name + ".base_color")
        if kind == "diffuse":
            mat = B.Diffuse(base)
        elif kind == "metal":
            mat = B.Metal(base, _texture(B, m["roughness"], cache, name + ".roughness"))
        elif kind == "glass":
            mat = B.Glass(base, _texture(B, m.get("roughness", 0.001), cache, name + ".roughness"),
                          m.get("ior", 1.5))
        elif kind == "principled":
            mat = B.Principled(base, **{k: v for k, v in m.items() if k not in ("type", "base_color")})
        else:
            raise ValueError(f"unknown material type {kind!r}")
    cache[key] = mat
    return mat


def _transform(B, tr):
    if tr is None:
        return None
    return B.Transform(tuple(tr.get("axis", (0.0, 1.0, 0.0))), float(tr.get("angle", 0.0)),
                       tuple(tr.get("translation", (0.0, 0.0, 0.0))))


def build_scene(cfg: dict, asset_dir: str):
    """The port's builder Scene of a configuration."""
    from tpupt_torch.io.obj import load_obj
    from tpupt_torch.scene import builder as B

    s = B.Scene()
    cache = {"_assets": asset_dir}
    env = cfg["environment"]
    s.environment = _texture(B, env, cache, "environment") if isinstance(env, dict) else tuple(env)
    for ob in cfg["objects"]:
        mat = _material(B, cfg, ob["material"], cache)
        tr = _transform(B, ob.get("transform"))
        if ob["type"] == "sphere":
            s.add_sphere(ob["radius"], tuple(ob["center"]), mat,
                         center2=tuple(ob["center2"]) if "center2" in ob else None,
                         light=bool(ob.get("light")), transform=tr)
        elif ob["type"] == "quad":
            s.add_quad(tuple(ob["q"]), tuple(ob["u"]), tuple(ob["v"]), mat, transform=tr,
                       light=bool(ob.get("light")))
        elif ob["type"] == "cuboid":
            s.add_cuboid(tuple(ob["a"]), tuple(ob["b"]), mat, transform=tr)
        elif ob["type"] == "mesh":
            s.add_mesh(load_obj(os.path.join(asset_dir, ob["file"])), mat, scale=float(ob.get("scale", 1.0)),
                       transform=tr)
        else:
            raise ValueError(f"unknown object type {ob['type']!r}")
    return s


def camera(cfg: dict, **override):
    """The port's Camera of a configuration, with fields overridden."""
    from tpupt_torch.render.camera import Camera

    fields = dict(cfg["camera"], **override)
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    return Camera(**fields)
