"""Python scene-builder API (the port's own copy of ``tpupt/scene/builder.py``).

Mirrors the reference's construction surface (main.rs scenes: World::add_object /
add_light with Sphere / Quad / Cuboid / Instance / TriangleMesh and the five material
families) but produces a flat description that `scene.compile` lowers to SoA tensors.

Instancing (rotate-then-translate, instance.rs:20-30) is expressed as a `Transform`
passed to the add_* calls and baked into world-space geometry at compile time. This is
exact for all reference scenes: instances only ever wrap cuboids and meshes, whose hit
UVs are invariant under rigid transforms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class SolidTexture:
    """texture.rs:11-25. `rgb` may be a scalar (scalar texture) or 3-vector."""

    rgb: tuple

    def __init__(self, rgb):
        arr = np.atleast_1d(np.asarray(rgb, dtype=np.float64))
        if arr.shape == (1,):
            arr = np.repeat(arr, 3)
        object.__setattr__(self, "rgb", tuple(float(x) for x in arr))


@dataclasses.dataclass(frozen=True, eq=False)
class CheckerTexture:
    """texture.rs:27-54: 3D world-position parity check at 1/scale."""

    scale: float
    tex1: "Texture"
    tex2: "Texture"


@dataclasses.dataclass(frozen=True, eq=False)
class ImageTexture:
    """texture.rs:56-92: nearest-neighbor lookup, u clamped, v flipped.

    `path` is an image file (read by io/image.py) or an in-memory uint8 [H,W,3]
    array. hdr=True, for Scene.environment only, keeps the map in float32 (an
    in-memory array is taken as float32) and importance-samples it as a light.
    """

    path: object
    hdr: bool = False


Texture = Union[SolidTexture, CheckerTexture, ImageTexture]


def as_texture(x) -> Texture:
    if isinstance(x, (SolidTexture, CheckerTexture, ImageTexture)):
        return x
    return SolidTexture(x)


# ---------------------------------------------------------------------------
# materials
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Diffuse:
    """Lambertian BRDF (bsdf/diffuse.rs), optional normal map (hit_info.rs:33-43)."""

    base_color: Texture
    normal_map: Optional[ImageTexture] = None

    def __init__(self, base_color, normal_map=None):
        object.__setattr__(self, "base_color", as_texture(base_color))
        object.__setattr__(self, "normal_map", normal_map)


@dataclasses.dataclass(frozen=True, eq=False)
class Metal:
    """GGX metal (bsdf/metal.rs); roughness may be a scalar or a texture."""

    base_color: Texture
    roughness: Texture

    def __init__(self, base_color, roughness):
        object.__setattr__(self, "base_color", as_texture(base_color))
        object.__setattr__(self, "roughness", as_texture(roughness))


@dataclasses.dataclass(frozen=True, eq=False)
class Glass:
    """Walter rough dielectric (bsdf/glass.rs)."""

    base_color: Texture
    roughness: Texture
    ior: float = 1.5

    def __init__(self, base_color=(1.0, 1.0, 1.0), roughness=0.001, ior=1.5):
        object.__setattr__(self, "base_color", as_texture(base_color))
        object.__setattr__(self, "roughness", as_texture(roughness))
        object.__setattr__(self, "ior", float(ior))

    @staticmethod
    def basic(ior: float) -> "Glass":
        """GlassBSDF::basic (glass.rs:42-49): white, roughness 0.001."""
        return Glass((1.0, 1.0, 1.0), 0.001, ior)


@dataclasses.dataclass(frozen=True, eq=False)
class Principled:
    """Disney principled BSDF, 11 scalar params + textured base color
    (bsdf/principled.rs:23-42; anisotropic is commented out in the reference too)."""

    base_color: Texture
    metallic: float = 0.0
    roughness: float = 0.5
    subsurface: float = 0.0
    specular: float = 0.5
    specular_tint: float = 0.0
    ior: float = 1.5
    spec_trans: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0

    def __init__(self, base_color, **kw):
        object.__setattr__(self, "base_color", as_texture(base_color))
        for f in dataclasses.fields(self):
            if f.name == "base_color":
                continue
            object.__setattr__(self, f.name, float(kw.pop(f.name, f.default)))
        if kw:
            raise TypeError(f"unknown Principled params: {sorted(kw)}")


@dataclasses.dataclass(frozen=True, eq=False)
class Light:
    """Emissive material (DiffuseLight, material.rs:150-191)."""

    emission: Texture

    def __init__(self, emission):
        object.__setattr__(self, "emission", as_texture(emission))


Material = Union[Diffuse, Metal, Glass, Principled, Light]


# ---------------------------------------------------------------------------
# transforms & geometry records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Transform:
    """Rotate about `axis` by `angle` radians, then translate (instance.rs:11,20-30)."""

    axis: tuple = (0.0, 1.0, 0.0)
    angle: float = 0.0
    translation: tuple = (0.0, 0.0, 0.0)

    def quat(self) -> np.ndarray:
        ax = np.asarray(self.axis, dtype=np.float64)
        ax = ax / np.linalg.norm(ax)
        h = 0.5 * self.angle
        return np.concatenate([np.sin(h) * ax, [np.cos(h)]])  # (x,y,z,w)

    def rotate(self, v: np.ndarray) -> np.ndarray:
        q = self.quat()
        qv, w = q[:3], q[3]
        t = np.cross(qv, v) + w * v
        return v + 2.0 * np.cross(qv, t)

    def apply_point(self, p: np.ndarray) -> np.ndarray:
        return self.rotate(p) + np.asarray(self.translation, dtype=np.float64)


@dataclasses.dataclass
class SphereRec:
    center1: np.ndarray
    center2: np.ndarray
    radius: float
    material: Material


@dataclasses.dataclass
class QuadRec:
    q: np.ndarray
    u: np.ndarray
    v: np.ndarray
    material: Material


@dataclasses.dataclass
class MeshRec:
    positions: np.ndarray  # [V,3] already scaled+transformed
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]
    indices: np.ndarray  # [F,3]
    material: Material


GeomRec = Union[SphereRec, QuadRec, MeshRec]


class Scene:
    """Accumulates geometry + lights + camera config, then `compile()`s to SceneData."""

    def __init__(self):
        self.objects: list[GeomRec] = []
        self.lights: list[GeomRec] = []
        # EnvironmentType (camera.rs:16-19): rgb tuple or ImageTexture
        self.environment: Union[tuple, ImageTexture] = (0.0, 0.0, 0.0)

    # -- spheres ------------------------------------------------------------
    def add_sphere(
        self, radius, center, material, center2=None, light=False,
        transform: Optional[Transform] = None,
    ):
        """Sphere, optionally instanced (instance.rs:20-30 wraps ANY Hittable,
        spheres included; no reference scene uses it on a sphere — main.rs
        instances only meshes/cuboids — but the capability is part of the
        Instance contract). A rotate+translate maps a sphere to a sphere:
        both centers go through the transform, the radius is invariant."""
        c1 = np.asarray(center, dtype=np.float64)
        c2 = c1 if center2 is None else np.asarray(center2, dtype=np.float64)
        if transform is not None:
            c1 = transform.apply_point(c1)
            c2 = transform.apply_point(c2)
        rec = SphereRec(c1, c2, max(float(radius), 0.0), material)
        (self.lights if light else self.objects).append(rec)

    # -- quads --------------------------------------------------------------
    def add_quad(self, q, u, v, material, transform: Optional[Transform] = None, light=False):
        q = np.asarray(q, dtype=np.float64)
        u = np.asarray(u, dtype=np.float64)
        v = np.asarray(v, dtype=np.float64)
        if transform is not None:
            q = transform.apply_point(q)
            u = transform.rotate(u)
            v = transform.rotate(v)
        (self.lights if light else self.objects).append(QuadRec(q, u, v, material))

    def add_cuboid(self, a, b, material, transform: Optional[Transform] = None):
        """Axis-aligned box as 6 quads (cuboid.rs:11-58), optionally instanced."""
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0.0, 0.0])
        dy = np.array([0.0, mx[1] - mn[1], 0.0])
        dz = np.array([0.0, 0.0, mx[2] - mn[2]])
        faces = [  # order matches cuboid.rs:18-53
            (np.array([mn[0], mn[1], mx[2]]), dx, dy),  # front
            (np.array([mx[0], mn[1], mx[2]]), -dz, dy),  # right
            (np.array([mx[0], mn[1], mn[2]]), -dx, dy),  # back
            (np.array([mn[0], mn[1], mn[2]]), dz, dy),  # left
            (np.array([mn[0], mx[1], mx[2]]), dx, -dz),  # top
            (np.array([mn[0], mn[1], mn[2]]), dx, dz),  # bottom
        ]
        for q, u, v in faces:
            self.add_quad(q, u, v, material, transform=transform)

    # -- meshes -------------------------------------------------------------
    def add_mesh(
        self,
        obj: dict,
        material: Material,
        scale: float = 1.0,
        transform: Optional[Transform] = None,
    ):
        """Triangle mesh from io.obj.load_obj output.

        Matches TriangleMesh::from_obj (mesh.rs:149-197): positions scaled, normals
        unscaled; an outer Instance rotation rotates both.
        """
        pos = obj["positions"].astype(np.float64) * float(scale)
        nrm = None if obj["normals"] is None else obj["normals"].astype(np.float64)
        if transform is not None:
            pos = transform.rotate(pos) + np.asarray(transform.translation)
            if nrm is not None:
                nrm = transform.rotate(nrm)
        uvs = None if obj["uvs"] is None else obj["uvs"].astype(np.float64)
        self.objects.append(MeshRec(pos, nrm, uvs, obj["indices"], material))

    def compile(self, device=None, bvh: bool | None = None):
        """Compile to SceneData tensors on `device` (default cuda; see core/device.py).

        bvh: None routes meshes of 64+ triangles to the cluster kernels, False
        forces the dense triangle sweep, True (the stackless BVH) raises.
        """
        from .compile import compile_scene

        return compile_scene(self, device=device, bvh=bvh)
