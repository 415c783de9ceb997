"""Scene intermediate representation: dense SoA tensors, compiled ahead of time.

Counterpart of ``tpupt/scene/data.py``. The compiler (scene/compile.py) flattens
every scene into the tables below; the reference package's trace-time static
flags are plain Python attributes here.

- geometry: sphere / quad / triangle SoA tables (instance transforms and cuboids are
  baked to world space at compile time);
- materials: a type tag + parameter rows (Disney 12-vector);
- textures: a type tag + params + one flat f32 image atlas gathered by offset;
- lights: index rows pointing back into the geometry tables, whose light rows come
  *after* object rows so equal-distance ties resolve to objects.

Every table holds at least one row (a degenerate pad entry: negative-radius sphere,
zero quad, zero-area triangle).

Meshes of 64 or more triangles (and any mesh compiled with ``bvh=True``) are
SAH-ordered: the stackless BVH's nodes and the cluster tables (``ops/tri_kernel.py``
documents their layout) are both kept, whichever route the flags pick, and from 64
triangles on the MXU coefficient rows of the matmul sweep as well. Tables a scene
does not build hold one dummy row (or block) each.
"""

from __future__ import annotations

import dataclasses

import torch

# material type tags
MAT_DIFFUSE = 0
MAT_METAL = 1
MAT_GLASS = 2
MAT_PRINCIPLED = 3
MAT_LIGHT = 4

# texture type tags
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2

# geometry kind tags (light table, hit kinds)
GEOM_SPHERE = 0
GEOM_QUAD = 1
GEOM_TRI = 2

# principled parameter vector layout (mat_params columns)
P_METALLIC = 0
P_ROUGHNESS = 1
P_SUBSURFACE = 2
P_SPECULAR = 3
P_SPECULAR_TINT = 4
P_IOR = 5
P_SPEC_TRANS = 6
P_SHEEN = 7
P_SHEEN_TINT = 8
P_CLEARCOAT = 9
P_CLEARCOAT_GLOSS = 10
N_PARAMS = 11

STATIC_FIELDS = (
    "has_normal_maps",
    "mat_types",
    "has_image_textures",
    "has_checker",
    "rough_all_solid",
    "env_is_map",
    "env_is_hdr",
    "env_map_off",
    "env_map_w",
    "env_map_h",
    "n_lights_real",
    "has_tri_bvh",
    "has_tri_mxu",
    "has_tri_clusters",
    "has_tri_clusters_hbm",
    "tri_sc_size",
)
# the port's own static facts, which the reference's SceneData does not carry
PORT_STATIC_FIELDS = ("has_real_tris",)


@dataclasses.dataclass
class SceneData:
    # spheres — moving spheres lerp c1 -> c2 by ray time
    sph_c1: torch.Tensor  # [S,3]
    sph_c2: torch.Tensor  # [S,3]
    sph_r: torch.Tensor  # [S]
    sph_mat: torch.Tensor  # [S] int32

    # quads — w/normal/d derived at compile time
    quad_q: torch.Tensor  # [Q,3]
    quad_u: torch.Tensor  # [Q,3]
    quad_v: torch.Tensor  # [Q,3]
    quad_w: torch.Tensor  # [Q,3]   n / |n|^2
    quad_n: torch.Tensor  # [Q,3]   unit normal
    quad_d: torch.Tensor  # [Q]     plane offset
    quad_mat: torch.Tensor  # [Q] int32

    # triangles — instance transforms baked in
    tri_v0: torch.Tensor  # [T,3]
    tri_e1: torch.Tensor  # [T,3]  v1 - v0
    tri_e2: torch.Tensor  # [T,3]  v2 - v0
    tri_n0: torch.Tensor  # [T,3]  vertex normals (face normal replicated if absent)
    tri_n1: torch.Tensor  # [T,3]
    tri_n2: torch.Tensor  # [T,3]
    tri_uv0: torch.Tensor  # [T,2]
    tri_uv1: torch.Tensor  # [T,2]
    tri_uv2: torch.Tensor  # [T,2]
    tri_has_uv: torch.Tensor  # [T] bool — false => barycentric (u,v)
    tri_mat: torch.Tensor  # [T] int32

    # triangle clusters (SAH order; layout in ops/tri_kernel.py)
    tri_cl: torch.Tensor  # [Cp,8] cluster AABBs
    tri_scl: torch.Tensor  # [SCp,8] supercluster AABBs
    tri_geo: torch.Tensor  # [Cp,10,64] v0, e1, e2, id per slot
    tri_attr: torch.Tensor  # [Cp,16,64] n0, n1, n2, uv0, uv1, uv2, mat + HAS_UV_FLAG

    # stackless BVH over the triangles (ops/bvh.py): DFS pre-order nodes with escape
    # indices, over the SAH-ordered tables; one dummy node without the tree
    bvh_min: torch.Tensor  # [M,3] node AABB min (padded by 1e-3 like aabb.rs:16-21)
    bvh_max: torch.Tensor  # [M,3]
    bvh_skip: torch.Tensor  # [M] int32 first node after the subtree
    bvh_start: torch.Tensor  # [M] int32 leaf triangle range start
    bvh_count: torch.Tensor  # [M] int32 leaf size, 0 = internal node

    # matmul sweep (ops/intersect.py _tri_block_mxu): each triangle's Möller–Trumbore
    # determinants as linear functionals of the ray features [d, o, o x d, 1];
    # [1,10] zeros below 64 triangles
    tri_ca: torch.Tensor  # [T,10] a   = d.(e2 x e1)
    tri_cu: torch.Tensor  # [T,10] u a = (o x d).e2 - d.(e2 x v0)
    tri_cv: torch.Tensor  # [T,10] v a = -(o x d).e1 - d.(v0 x e1)
    tri_ct: torch.Tensor  # [T,10] t a = o.n - v0.n, n = e1 x e2

    # lights: rows referencing geometry
    light_kind: torch.Tensor  # [L] int32 GEOM_*
    light_idx: torch.Tensor  # [L] int32 index into that geometry table
    # kind-uniform per-light geometry for sampling: [L,10] =
    #   sphere: c1(3), c2(3), radius, 0, 0, kind
    #   quad:   q(3), u(3), v(3), kind
    #   tri:    v0(3), e1(3), e2(3), kind
    light_geom: torch.Tensor

    # materials
    mat_type: torch.Tensor  # [M] int32 MAT_*
    mat_tex: torch.Tensor  # [M] int32 base-color (or emission) texture id
    mat_rough_tex: torch.Tensor  # [M] int32 roughness texture id (metal/glass)
    mat_normal_tex: torch.Tensor  # [M] int32 normal-map texture id, -1 = none
    mat_params: torch.Tensor  # [M,N_PARAMS] float32

    # textures
    tex_type: torch.Tensor  # [X] int32 TEX_*
    tex_rgb: torch.Tensor  # [X,3] solid value (scalar textures use .x)
    tex_inv_scale: torch.Tensor  # [X] checker inv_scale
    tex_child: torch.Tensor  # [X,2] int32 checker children
    tex_img: torch.Tensor  # [X,3] int32 (atlas offset, width, height)
    atlas: torch.Tensor  # [P,3] f32 u8-quantized texels

    # environment
    env_color: torch.Tensor  # [3]
    env_tex: torch.Tensor  # [] int32 texture id, -1 = constant color

    # full-precision HDR environment with importance sampling (ops/envmap.py): f32
    # texels, a Vose alias table over luminance*sin(theta) texel weights and the
    # solid-angle pdf per texel. One dummy row each when the scene has no HDR map.
    env_img: torch.Tensor  # [Hw*Ww,3] f32 texels
    env_wh: torch.Tensor  # [2] int32 (W, H)
    env_alias: torch.Tensor  # [Hw*Ww] int32 alias targets
    env_prob: torch.Tensor  # [Hw*Ww] f32 alias acceptance probabilities
    env_pdf: torch.Tensor  # [Hw*Ww] f32 solid-angle pdf per texel
    # (prob, alias as f32, pdf) rows: one row gather per alias draw or pdf lookup;
    # alias indices are exact in f32 below 2^24 (asserted at compile)
    env_sam: torch.Tensor  # [Hw*Ww,3] f32

    # static facts about the scene (plain attributes)
    has_normal_maps: bool = False
    mat_types: tuple = ()  # sorted tuple of MAT_* present in the scene
    has_image_textures: bool = False
    has_checker: bool = False  # no checker -> texture eval skips the child resolve
    rough_all_solid: bool = False  # every roughness texture is SOLID
    env_is_map: bool = False
    env_is_hdr: bool = False  # f32 HDR env + importance sampling
    # atlas coordinates of a plain-image env map (env_map_w == 0: generic path)
    env_map_off: int = 0
    env_map_w: int = 0
    env_map_h: int = 0
    n_lights_real: int = 0  # geometry lights (light table may hold one pad row)
    # triangle routing (the reference's flag names), tested in this order: the flat
    # cluster kernel, the two-level one (the reference's HBM kernel), the stackless
    # BVH, the matmul sweep, else the dense sweep
    has_tri_bvh: bool = False
    has_tri_mxu: bool = False
    has_tri_clusters: bool = False
    has_tri_clusters_hbm: bool = False
    tri_sc_size: int = 64  # clusters per supercluster of tri_scl
    # whether the triangle table holds a scene triangle, not its pad row alone (zero edges,
    # which no ray hits): False skips the triangle route in closest_hit
    has_real_tris: bool = True

    def __post_init__(self):
        # host copy of the (kind, index) light rows: the light pdf loops over
        # lights in Python and needs each light's kind without a device sync
        self.lights_host = tuple(
            zip(self.light_kind.tolist(), self.light_idx.tolist())
        )
        # env_wh as Python ints, for the same reason
        self.env_wh_host = tuple(int(x) for x in self.env_wh.tolist())

    @property
    def device(self) -> torch.device:
        return self.sph_r.device

    @property
    def n_spheres(self):
        return self.sph_r.shape[0]

    @property
    def n_quads(self):
        return self.quad_d.shape[0]

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]

    @property
    def n_lights(self):
        return self.light_kind.shape[0]


def tensor_fields() -> list[str]:
    return [f.name for f in dataclasses.fields(SceneData) if f.name not in STATIC_FIELDS + PORT_STATIC_FIELDS]


@dataclasses.dataclass
class CameraData:
    """Derived camera basis (Camera::init), computed host-side in f64, stored f32."""

    center: torch.Tensor  # [3]
    pixel00: torch.Tensor  # [3]
    pixel_du: torch.Tensor  # [3]
    pixel_dv: torch.Tensor  # [3]
    right: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    defocus_radius: torch.Tensor  # []
    blur_strength: torch.Tensor  # []
