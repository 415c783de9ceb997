"""Geometric light sampling and pdf for NEE / MIS (counterpart of ``tpupt/ops/lights.py``).

- `sample_lights`: pick one light uniformly (list.rs:78-84), sample a point on it
  (quad.rs:80-86 uniform in parallelogram; sphere.rs:110-121 uniform on the *full*
  sphere; mesh.rs:122-129 uniform-uv triangle, reference bias kept), return the
  normalized direction from the shading point.
- `pdf_lights`: MEAN over all lights of the per-light pdf (list.rs:86-96), each of
  which re-intersects its own geometry with interval (0, inf). The sphere uses the
  reference's `2*PI*sqrt(1 - r^2/d^2)` solid angle.

The importance-sampled HDR environment member is left out: no configuration of the
benchmark uses it.
"""

from __future__ import annotations

import math

import torch

from . import linalg as la
from . import tables as D
from .gather import take_rows

TWO_PI = la.f32(2.0 * math.pi)


def sample_lights(sd: "D.SceneData", origin, time, u_pick, u1, u2):
    """Pick a light member uniformly and sample a direction toward it.

    Returns (dir [B,3] unit, is_env [B] bool); is_env marks lanes whose pick was the
    HDR environment member (the integrator kills those aimed below the shading
    horizon of an opaque lane).
    """
    li = torch.clamp((u_pick * sd.n_lights).to(torch.int32), max=sd.n_lights - 1)
    dir_ = _sample_geom_lights(sd, origin, time, li, u1, u2)
    return dir_, torch.zeros(u_pick.shape, dtype=torch.bool, device=u_pick.device)


def _sample_geom_lights(sd: "D.SceneData", origin, time, li, u1, u2):
    """Sample a direction toward geometry light `li` [B] -> [B,3] unit dirs."""
    li = torch.clamp(li, max=sd.n_lights - 1)
    rows = take_rows(sd.light_geom, li)  # [B, 10] kind-uniform rows
    kind = rows[..., 9].to(torch.int32)
    ox, oy, oz = la.unpack3(origin)

    ax, ay, az = rows[..., 0], rows[..., 1], rows[..., 2]
    bx, by, bz = rows[..., 3], rows[..., 4], rows[..., 5]
    cx, cy, cz = rows[..., 6], rows[..., 7], rows[..., 8]

    # sphere: uniform point on the full sphere (sphere.rs:110-121)
    theta = TWO_PI * u1
    phi = torch.arccos(la.clip(2.0 * u2 - 1.0, -1.0, 1.0))
    sp = torch.sin(phi)
    r = cx  # radius slot for spheres
    scx = ax + (bx - ax) * time
    scy = ay + (by - ay) * time
    scz = az + (bz - az) * time
    p_sph = (
        scx + sp * torch.cos(theta) * r,
        scy + sp * torch.sin(theta) * r,
        scz + torch.cos(phi) * r,
    )

    # quad: q + u*u1 + v*u2 (quad.rs:80-86); triangle: v0 + e1*u1 + e2*u2
    # (mesh.rs:122-129, no fold) is the same expression over its row
    p_flat = (ax + bx * u1 + cx * u2, ay + by * u1 + cy * u2, az + bz * u1 + cz * u2)

    p = la.where3(kind == D.GEOM_SPHERE, p_sph, p_flat)
    d = la.normalize3((p[0] - ox, p[1] - oy, p[2] - oz), eps=1e-30)
    return la.pack3(d)


def _sphere_light_pdf(c1, c2, r, o, d, time):
    """sphere.rs:123-135 with interval (0, inf)."""
    cx = c1[0] + (c2[0] - c1[0]) * time
    cy = c1[1] + (c2[1] - c1[1]) * time
    cz = c1[2] + (c2[2] - c1[2]) * time
    lx, ly, lz = cx - o[0], cy - o[1], cz - o[2]
    s = lx * d[0] + ly * d[1] + lz * d[2]
    l2 = lx * lx + ly * ly + lz * lz
    r2 = r * r
    d2 = l2 - s * s
    q = torch.sqrt(la.clamp_min(r2 - d2, 0.0))
    t = torch.where(l2 > r2, s - q, s + q)
    hit = ~(((s < 0.0) & (l2 > r2)) | (d2 > r2)) & (t > 0.0)
    solid_angle = TWO_PI * torch.sqrt(la.clamp_min(1.0 - r2 / la.clamp_min(l2, 1e-20), 0.0))
    return torch.where(hit, 1.0 / la.clamp_min(solid_angle, 1e-20), 0.0)


def _quad_light_pdf(q, u, v, w, nrm, dd, o, d):
    """quad.rs:88-98 with interval (0, inf)."""
    nd = nrm[0] * d[0] + nrm[1] * d[1] + nrm[2] * d[2]
    no = nrm[0] * o[0] + nrm[1] * o[1] + nrm[2] * o[2]
    t = (dd - no) / torch.where(torch.abs(nd) < 1e-8, 1.0, nd)
    px = o[0] + t * d[0] - q[0]
    py = o[1] + t * d[1] - q[1]
    pz = o[2] + t * d[2] - q[2]
    alpha = w[0] * (py * v[2] - pz * v[1]) + w[1] * (pz * v[0] - px * v[2]) + w[2] * (px * v[1] - py * v[0])
    beta = w[0] * (u[1] * pz - u[2] * py) + w[1] * (u[2] * px - u[0] * pz) + w[2] * (u[0] * py - u[1] * px)
    hit = (
        (torch.abs(nd) >= 1e-8)
        & (t > 0.0)
        & (alpha >= 0.0)
        & (alpha <= 1.0)
        & (beta >= 0.0)
        & (beta <= 1.0)
    )
    ucv = la.cross3(u, v)
    area = torch.sqrt(la.dot3(ucv, ucv))
    cos_theta = torch.abs(nd)
    pdf = (t * t) / la.clamp_min(cos_theta * area, 1e-20)
    return torch.where(hit, pdf, 0.0)


def _tri_light_pdf(v0, e1, e2, n0, n1, n2, o, d):
    """mesh.rs:131-141 with interval (0, inf)."""
    h = la.cross3(d, e2)
    a = la.dot3(e1, h)
    f = 1.0 / torch.where(torch.abs(a) < 1e-8, 1.0, a)
    s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = f * la.dot3(s, h)
    q = la.cross3(s, e1)
    v = f * la.dot3(d, q)
    t = f * la.dot3(e2, q)
    hit = (torch.abs(a) >= 1e-8) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    w = 1.0 - u - v
    nrm = la.normalize3(
        (
            n0[0] * w + n1[0] * u + n2[0] * v,
            n0[1] * w + n1[1] * u + n2[1] * v,
            n0[2] * w + n1[2] * u + n2[2] * v,
        ),
        eps=1e-30,
    )
    e1xe2 = la.cross3(e1, e2)
    area = 0.5 * torch.sqrt(la.dot3(e1xe2, e1xe2))
    cos_theta = torch.abs(la.dot3(d, nrm))
    pdf = (t * t) / la.clamp_min(cos_theta * area, 1e-20)
    return torch.where(hit, pdf, 0.0)


def pdf_lights(sd: "D.SceneData", origin, direction, time):
    """Mean per-member pdf (list.rs:86-96), the HDR environment included -> [B]."""
    o = la.unpack3(origin)
    d = la.unpack3(direction)
    return _sum_geom_light_pdfs(sd, o, d, time, sd.lights_host) / float(sd.n_lights)


def _sum_geom_light_pdfs(sd: "D.SceneData", o, d, time, lights):
    total = torch.zeros_like(o[0])
    # the light table is tiny; each light's kind is known on the host, so only
    # its own kind's pdf is evaluated
    for kind, gi in lights:
        if kind == D.GEOM_SPHERE:
            p = _sphere_light_pdf(
                tuple(sd.sph_c1[gi]), tuple(sd.sph_c2[gi]), sd.sph_r[gi], o, d, time
            )
        elif kind == D.GEOM_QUAD:
            p = _quad_light_pdf(
                tuple(sd.quad_q[gi]), tuple(sd.quad_u[gi]), tuple(sd.quad_v[gi]),
                tuple(sd.quad_w[gi]), tuple(sd.quad_n[gi]), sd.quad_d[gi], o, d,
            )
        else:
            p = _tri_light_pdf(
                tuple(sd.tri_v0[gi]), tuple(sd.tri_e1[gi]), tuple(sd.tri_e2[gi]),
                tuple(sd.tri_n0[gi]), tuple(sd.tri_n1[gi]), tuple(sd.tri_n2[gi]), o, d,
            )
        total = total + p
    return total
