"""Ray-scene closest hit over the SoA geometry tables (counterpart of ``tpupt/ops/intersect.py``).

Spheres and quads always go through ``ops/hit_kernel.closest_sphere_quad`` (the
CUDA kernel on the GPU, its plain version on the CPU). Triangles take the route
the scene's flags pick, in the reference's order: the cluster kernels
(``ops/tri_kernel.closest_tri``, flat or two-level, seeded with the sphere/quad
winner), the BVH walk (``ops/bvh_kernel.closest_tri_bvh``, K4, unseeded), the matmul
sweep (the reference's MXU path: Möller–Trumbore's determinants as products of
coefficient rows and ray features, ``torch.matmul`` in full float32), or the dense
Möller–Trumbore sweep.

Intersection math matches the reference:
  sphere   sphere.rs:64-100  (moving center lerped by time)
  quad     quad.rs:40-70     (plane + bilinear alpha/beta in [0,1])
  triangle mesh.rs:50-112    (Möller–Trumbore, interpolated normals/UVs)
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import linalg as la
from ..scene import data as D
from . import bvh_kernel, hit_kernel, tri_kernel
from .texture import eval_texture

BIG = la.BIG
KIND_SPHERE = D.GEOM_SPHERE
KIND_QUAD = D.GEOM_QUAD
KIND_TRI = D.GEOM_TRI

_TRI_BLOCK = 64  # triangles per step of the dense sweep
_MXU_BLOCK_BYTES = 1 << 30  # one [blk, B] product block of the matmul sweep stays below this
_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass
class Hit:
    """SoA hit record (reference HitInfo, hit_info.rs:4-13)."""

    valid: torch.Tensor  # [B] bool
    t: torch.Tensor  # [B]
    point: torch.Tensor  # [B,3]
    ng: torch.Tensor  # [B,3] geometric normal, unit, front-face flipped
    ns: torch.Tensor  # [B,3] shading normal (normal-mapped where the material has one)
    front: torch.Tensor  # [B] bool
    u: torch.Tensor  # [B]
    v: torch.Tensor  # [B]
    mat_id: torch.Tensor  # [B] int32


def _tri_block(sd, base, n, ox, oy, oz, dx, dy, dz, tmin, tmax):
    """mesh.rs:50-82 (Möller–Trumbore) for triangles [base, base+n) -> [B, n] (BIG on miss)."""
    v0x, v0y, v0z = (c[None, base : base + n] for c in sd.tri_v0.T)
    e1x, e1y, e1z = (c[None, base : base + n] for c in sd.tri_e1.T)
    e2x, e2y, e2z = (c[None, base : base + n] for c in sd.tri_e2.T)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(torch.abs(a) < 1e-8, 1.0, a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    miss = (
        (torch.abs(a) < 1e-8)
        | (u < 0.0)
        | (u > 1.0)
        | (v < 0.0)
        | (u + v > 1.0)
        | (t <= tmin)
        | (t >= tmax)
    )
    return torch.where(miss, BIG, t)


def _tri_block_mxu(sd, base, n, phi, tmin, tmax):
    """Möller–Trumbore as matmuls for triangles [base, base+n) -> [n, B] (BIG on miss).

    The four determinants are linear in the ray features phi = [d, o, o x d, 1]
    (``ray_features``): a = d.(e2 x e1), u a = (o x d).e2 - d.(e2 x v0), v a =
    -(o x d).e1 - d.(v0 x e1), t a = o.n - v0.n, with the coefficient rows
    tri_ca/cu/cv/ct [T,10] made by the compiler. The epilogue and miss tests are
    _tri_block's.
    """
    a = torch.matmul(sd.tri_ca[base : base + n], phi)
    u = torch.matmul(sd.tri_cu[base : base + n], phi)
    v = torch.matmul(sd.tri_cv[base : base + n], phi)
    t = torch.matmul(sd.tri_ct[base : base + n], phi)
    f = 1.0 / torch.where(torch.abs(a) < 1e-8, 1.0, a)
    u, v, t = f * u, f * v, f * t
    miss = (
        (torch.abs(a) < 1e-8)
        | (u < 0.0)
        | (u > 1.0)
        | (v < 0.0)
        | (u + v > 1.0)
        | (t <= tmin)
        | (t >= tmax)
    )
    return torch.where(miss, BIG, t)


def ray_features(ox, oy, oz, dx, dy, dz):
    """phi [10, B] for the matmul sweep: [d, o, o x d, 1]."""
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    return torch.stack([dx, dy, dz, ox, oy, oz, mx, my, mz, torch.ones_like(ox)], dim=0)


def _fold_sweep(n_tris, blk, block):
    """Closest triangle per ray over blocks of `blk` triangles -> (t [B], idx [B] int32).

    block(base, n) gives [B, n] distances (BIG on a miss); within a block the first
    minimum wins and across blocks only a strictly smaller t, so ties go to the lower
    index."""
    best_t = best_i = None
    for base in range(0, n_tris, blk):
        m, am = block(base, min(blk, n_tris - base)).min(dim=1)
        am = (am + base).to(torch.int32)
        if best_t is None:
            best_t, best_i = m, am
        else:
            better = m < best_t
            best_t = torch.where(better, m, best_t)
            best_i = torch.where(better, am, best_i)
    return best_t, best_i


def _tri_sweep(sd, o, d, tmin, tmax):
    """Closest triangle per ray by the dense sweep -> (t [B], idx [B] int32)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    return _fold_sweep(sd.n_tris, _TRI_BLOCK,
                       lambda base, n: _tri_block(sd, base, n, ox, oy, oz, dx, dy, dz, tmin, tmax))


def _mxu_sweep(sd, o, d, tmin, tmax):
    """Closest triangle per ray by the matmul sweep -> (t [B], idx [B] int32).

    The reference asks for full float32 products (Precision.HIGHEST); on the card a
    float32 product takes TF32 when PyTorch is told to allow it, so that raises.
    Blocks of triangles keep one [blk, B] product under _MXU_BLOCK_BYTES.
    """
    if o.device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "the matmul sweep needs full float32 products: set torch.backends.cuda.matmul.allow_tf32 = "
            "False and torch.set_float32_matmul_precision('highest')"
        )
    phi = ray_features(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
    blk = max(1, _MXU_BLOCK_BYTES // max(o.shape[0] * o.element_size(), 1))
    return _fold_sweep(sd.n_tris, blk, lambda base, n: _tri_block_mxu(sd, base, n, phi, tmin, tmax).T)


def closest_hit(sd: "D.SceneData", o, d, time, tmin, tmax, alive=None, k1_counts=None) -> Hit:
    """Closest hit across all geometry (World::intersect_all, world.rs:47-62).

    Light rows sit after object rows (scene/compile.py), so strict-min selection
    reproduces the reference's tie-break (objects win); across kinds ties go
    sphere < quad < tri.

    alive (optional [B] bool): dead lanes give the triangle kernels t_in = 0, so
    they cull every cluster or box and stop widening their warp's visits (their hit
    record is garbage either way; callers mask by alive). k1_counts: hit_kernels'.
    """
    t_sq, kind_sq, idx_sq, tri = hit_kernels(sd, o, d, time, tmin, tmax, alive, k1_counts)
    is_sph = kind_sq == KIND_SPHERE
    t_s = torch.where(is_sph, t_sq, BIG)
    i_s = torch.where(is_sph, idx_sq, 0)
    t_q = torch.where(~is_sph, t_sq, BIG)
    i_q = torch.where(~is_sph, idx_sq, 0)
    tri_aux = None
    if tri is None:  # no triangle: the sphere/quad winner alone
        t_best = torch.minimum(t_s, t_q)
        kind = torch.where(t_s == t_best, KIND_SPHERE, KIND_QUAD).to(torch.int32)
        idx = torch.where(kind == KIND_SPHERE, i_s, i_q)
    else:
        t_t, i_t, tri_aux = tri
        t_best = torch.minimum(torch.minimum(t_s, t_q), t_t)
        kind = torch.where(
            t_s == t_best,
            KIND_SPHERE,
            torch.where(t_q == t_best, KIND_QUAD, KIND_TRI),
        ).to(torch.int32)
        idx = torch.where(kind == KIND_SPHERE, i_s, torch.where(kind == KIND_QUAD, i_q, i_t))
    valid = t_best < BIG
    return _make_hit(sd, o, d, time, t_best, kind, idx, valid, tri_aux)


def hit_kernels(sd, o, d, time, tmin, tmax, alive=None, k1_counts=None):
    """closest_hit's kernel calls -> (t_sq, kind_sq, idx_sq, tri): K1's outputs (or its plain
    version's), and the triangle route's (t, idx, the kernels' attributes or None on the
    sweeps), None where the scene has no triangle (``has_real_tris``: its table's pad row
    hits nothing). The selection and the hit's attributes are the caller's: closest_hit's,
    or the shading kernel's (``ops/wavefront_kernel.py``). k1_counts, if given, gets K1's
    counts of its tile cull added (``hit_kernel.K1_COUNTS``)."""
    sph, quad = hit_kernel.tables(sd)
    t_sq, kind_sq, idx_sq = hit_kernel.closest_sphere_quad(
        o.contiguous(), d.contiguous(), time.contiguous(), sph, quad, tmin=tmin, counts=k1_counts
    )
    if not sd.has_real_tris:
        return t_sq, kind_sq, idx_sq, None
    if sd.has_tri_clusters or sd.has_tri_clusters_hbm:
        # seeded with the sphere/quad winner, so closer geometry culls clusters (K1's t is
        # at most BIG, so this is min(t_sphere, t_quad, tmax))
        t_in = torch.minimum(t_sq, torch.full_like(t_sq, tmax))
        if alive is not None:
            t_in = torch.where(alive, t_in, 0.0)
        tri = tri_kernel.closest_tri(sd, o.contiguous(), d.contiguous(), t_in.contiguous(), tmin)
    elif sd.has_tri_bvh:
        # the BVH walk (K4) from the root with tmax, unseeded as in the reference (a
        # sphere's t as seed could drop a triangle an ulp below it)
        t_in = torch.full_like(t_sq, tmax)
        if alive is not None:
            t_in = torch.where(alive, t_in, 0.0)
        tri = bvh_kernel.closest_tri_bvh(o.contiguous(), d.contiguous(), t_in, tmin, *bvh_kernel.scene_nodes(sd))
    elif sd.has_tri_mxu:
        tri = (*_mxu_sweep(sd, o, d, tmin, tmax), None)
    else:
        tri = (*_tri_sweep(sd, o, d, tmin, tmax), None)
    return t_sq, kind_sq, idx_sq, tri


def _make_hit(sd, o, d, time, t, kind, idx, valid, tri_aux=None) -> Hit:
    """Reconstruct hit attributes at the winning primitive (HitInfo::new).

    Miss lanes have t = BIG; t is clamped to 0 there so attribute math stays
    finite (every consumer masks by `valid`). tri_aux: the triangle kernel's
    (cluster or BVH) interpolated attributes of the triangle winner, which replace
    the gathers over the triangle tables that the sweeps need.
    """
    t = torch.where(valid, t, 0.0)
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz

    # ---- sphere attributes (sphere.rs:52-56, 88-90) ----
    si = torch.where(kind == KIND_SPHERE, idx, 0).to(torch.int64)
    c1 = sd.sph_c1[si]
    c2 = sd.sph_c2[si]
    mat_sph = sd.sph_mat[si]
    cx = c1[:, 0] + (c2[:, 0] - c1[:, 0]) * time
    cy = c1[:, 1] + (c2[:, 1] - c1[:, 1]) * time
    cz = c1[:, 2] + (c2[:, 2] - c1[:, 2]) * time
    nsx, nsy, nsz = px - cx, py - cy, pz - cz
    inv = 1.0 / torch.sqrt(torch.clamp(nsx * nsx + nsy * nsy + nsz * nsz, min=1e-24))
    nsx, nsy, nsz = nsx * inv, nsy * inv, nsz * inv
    theta = torch.arccos(torch.clamp(-nsy, -1.0, 1.0))
    phi = torch.atan2(-nsz, nsx) + math.pi
    u_sph = phi / _TWO_PI
    v_sph = theta / math.pi

    # ---- quad attributes (quad.rs:53-69) ----
    qi = torch.where(kind == KIND_QUAD, idx, 0).to(torch.int64)
    qqx, qqy, qqz = la.unpack3(sd.quad_q[qi])
    qux, quy, quz = la.unpack3(sd.quad_u[qi])
    qvx, qvy, qvz = la.unpack3(sd.quad_v[qi])
    qwx, qwy, qwz = la.unpack3(sd.quad_w[qi])
    qnx, qny, qnz = la.unpack3(sd.quad_n[qi])
    mat_quad = sd.quad_mat[qi]
    prx, pry, prz = px - qqx, py - qqy, pz - qqz
    alpha = qwx * (pry * qvz - prz * qvy) + qwy * (prz * qvx - prx * qvz) + qwz * (prx * qvy - pry * qvx)
    beta = qwx * (quy * prz - quz * pry) + qwy * (quz * prx - qux * prz) + qwz * (qux * pry - quy * prx)

    # ---- triangle attributes (mesh.rs:84-101) ----
    if tri_aux is not None:
        ntx, nty, ntz = la.unpack3(tri_aux["ns_raw"])
        invt = 1.0 / torch.sqrt(torch.clamp(ntx * ntx + nty * nty + ntz * ntz, min=1e-24))
        return _select_hit(
            sd, t, kind, valid, dx, dy, dz, px, py, pz,
            nsx, nsy, nsz, u_sph, v_sph, mat_sph,
            qnx, qny, qnz, alpha, beta, mat_quad,
            ntx * invt, nty * invt, ntz * invt, tri_aux["u"], tri_aux["v"], tri_aux["mat"],
        )
    ti = torch.where(kind == KIND_TRI, idx, 0).to(torch.int64)
    v0x, v0y, v0z = la.unpack3(sd.tri_v0[ti])
    e1x, e1y, e1z = la.unpack3(sd.tri_e1[ti])
    e2x, e2y, e2z = la.unpack3(sd.tri_e2[ti])
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(torch.abs(a) < 1e-12, 1.0, a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    bu = f * (sx * hx + sy * hy + sz * hz)
    qx2 = sy * e1z - sz * e1y
    qy2 = sz * e1x - sx * e1z
    qz2 = sx * e1y - sy * e1x
    bv = f * (dx * qx2 + dy * qy2 + dz * qz2)
    bw = 1.0 - bu - bv
    n0x, n0y, n0z = la.unpack3(sd.tri_n0[ti])
    n1x, n1y, n1z = la.unpack3(sd.tri_n1[ti])
    n2x, n2y, n2z = la.unpack3(sd.tri_n2[ti])
    uv0, uv1, uv2 = sd.tri_uv0[ti], sd.tri_uv1[ti], sd.tri_uv2[ti]
    has_uv = sd.tri_has_uv[ti]
    mat_tri = sd.tri_mat[ti]
    ntx = n0x * bw + n1x * bu + n2x * bv
    nty = n0y * bw + n1y * bu + n2y * bv
    ntz = n0z * bw + n1z * bu + n2z * bv
    invt = 1.0 / torch.sqrt(torch.clamp(ntx * ntx + nty * nty + ntz * ntz, min=1e-24))
    ntx, nty, ntz = ntx * invt, nty * invt, ntz * invt
    u_tri = torch.where(has_uv, uv0[:, 0] * bw + uv1[:, 0] * bu + uv2[:, 0] * bv, bu)
    v_tri = torch.where(has_uv, uv0[:, 1] * bw + uv1[:, 1] * bu + uv2[:, 1] * bv, bv)

    return _select_hit(
        sd, t, kind, valid, dx, dy, dz, px, py, pz,
        nsx, nsy, nsz, u_sph, v_sph, mat_sph,
        qnx, qny, qnz, alpha, beta, mat_quad,
        ntx, nty, ntz, u_tri, v_tri, mat_tri,
    )


def _select_hit(
    sd, t, kind, valid, dx, dy, dz, px, py, pz,
    nsx, nsy, nsz, u_sph, v_sph, mat_sph,
    qnx, qny, qnz, alpha, beta, mat_quad,
    ntx, nty, ntz, u_tri, v_tri, mat_tri,
) -> Hit:
    """Kind-select the winner's attributes + HitInfo::new epilogue
    (front-face flip and normal mapping, hit_info.rs:25-43)."""
    is_s = kind == KIND_SPHERE
    is_q = kind == KIND_QUAD
    nrx = torch.where(is_s, nsx, torch.where(is_q, qnx, ntx))
    nry = torch.where(is_s, nsy, torch.where(is_q, qny, nty))
    nrz = torch.where(is_s, nsz, torch.where(is_q, qnz, ntz))
    uu = torch.where(is_s, u_sph, torch.where(is_q, alpha, u_tri))
    vv = torch.where(is_s, v_sph, torch.where(is_q, beta, v_tri))
    mat_id = torch.where(is_s, mat_sph, torch.where(is_q, mat_quad, mat_tri))

    front = dx * nrx + dy * nry + dz * nrz < 0.0
    invn = 1.0 / torch.sqrt(torch.clamp(nrx * nrx + nry * nry + nrz * nrz, min=1e-24))
    sign = torch.where(front, invn, -invn)
    ngx, ngy, ngz = nrx * sign, nry * sign, nrz * sign

    point = torch.stack([px, py, pz], dim=-1)
    ng = torch.stack([ngx, ngy, ngz], dim=-1)

    if sd.has_normal_maps:
        ntex = sd.mat_normal_tex[mat_id.to(torch.int64)]
        has_nm = ntex >= 0
        mapped = 2.0 * eval_texture(sd, ntex, uu, vv, point) - 1.0
        # ad-hoc tangent basis (hit_info.rs:58-67)
        use_y = torch.abs(ngx) > 0.9
        axx = torch.where(use_y, 0.0, 1.0)
        axy = torch.where(use_y, 1.0, 0.0)
        tx = ngy * 0.0 - ngz * axy
        ty = ngz * axx - ngx * 0.0
        tz = ngx * axy - ngy * axx
        invtg = 1.0 / torch.sqrt(torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-24))
        tx, ty, tz = tx * invtg, ty * invtg, tz * invtg
        bx = ngy * tz - ngz * ty
        by = ngz * tx - ngx * tz
        bz = ngx * ty - ngy * tx
        mx, my, mz = mapped[..., 0], mapped[..., 1], mapped[..., 2]
        nsx2 = mx * tx + my * bx + mz * ngx
        nsy2 = mx * ty + my * by + mz * ngy
        nsz2 = mx * tz + my * bz + mz * ngz
        invm = 1.0 / torch.sqrt(torch.clamp(nsx2 * nsx2 + nsy2 * nsy2 + nsz2 * nsz2, min=1e-24))
        ns_mapped = torch.stack([nsx2 * invm, nsy2 * invm, nsz2 * invm], dim=-1)
        ns_arr = torch.where(has_nm[..., None], ns_mapped, ng)
    else:
        ns_arr = ng

    return Hit(valid=valid, t=t, point=point, ng=ng, ns=ns_arr, front=front, u=uu, v=vv, mat_id=mat_id)
