"""Microfacet distributions and samplers (counterpart of ``tpupt/ops/sampling.py``).

Component-form functions (3-tuples of [B] tensors) with explicit uniforms, in the
shading-local frame where the normal is +z. Reference quirks are reproduced
deliberately, as in the reference package:

- ``ggx.D`` uses alpha^2 = roughness^2 with 0.001 floors (sampling.rs:38-43);
- the VNDF sampler stretches by roughness^2 where D/G1 use alpha = roughness;
- ``gtr1.D`` divides by ``log2(alpha^2)`` (sampling.rs:121-125);
- ``gtr1.sample`` omits the sqrt on cos_theta (sampling.rs:132).
"""

from __future__ import annotations

import math

import torch

from . import linalg as la
from .tables import NP_REAL

PI = la.f32(math.pi)


def cosine_sample_hemisphere(u1, u2):
    """sampling.rs:18-24. u1 -> phi, u2 -> r2."""
    phi = (2.0 * PI) * u1
    r2s = torch.sqrt(u2)
    return (r2s * torch.cos(phi), r2s * torch.sin(phi), torch.sqrt(1.0 - u2))


def ggx_D(h, roughness):
    """sampling.rs:38-43. h is a local 3-tuple."""
    cos_theta = la.clamp_min(h[2], 0.001)
    alpha2 = la.clamp_min(roughness * roughness, 0.001)
    denom = (alpha2 - 1.0) * cos_theta * cos_theta + 1.0
    return alpha2 / (PI * denom * denom)


def ggx_G1(w, roughness):
    """sampling.rs:51-55."""
    alpha2 = la.clamp_min(roughness * roughness, 0.001)
    cos_theta = torch.abs(w[2])
    return (
        2.0
        * cos_theta
        / (cos_theta + torch.sqrt(cos_theta * cos_theta * (1.0 - alpha2) + alpha2))
    )


def ggx_G(v, l, roughness):
    """sampling.rs:45-49 (separable Smith)."""
    return ggx_G1(v, roughness) * ggx_G1(l, roughness)


def _sample_ggx_vndf(v, a2, e1, e2):
    """Heitz VNDF sampling with the stretch trick (sampling.rs:66-94)."""
    vs = la.normalize3((v[0] * a2, v[1] * a2, v[2]))
    t1_generic = la.normalize3((vs[1], -vs[0], torch.zeros_like(vs[0])), eps=1e-30)
    lo_z = vs[2] < 0.9999
    t1 = (
        torch.where(lo_z, t1_generic[0], 1.0),
        torch.where(lo_z, t1_generic[1], 0.0),
        torch.zeros_like(vs[0]),
    )
    t2 = la.cross3(t1, vs)
    a = 1.0 / (1.0 + vs[2])
    r = torch.sqrt(e1)
    lo = e2 < a
    phi = torch.where(lo, e2 / a * PI, PI + (e2 - a) / (1.0 - a) * PI)
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(lo, 1.0, vs[2])
    pz = torch.sqrt(la.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    n = (
        p1 * t1[0] + p2 * t2[0] + pz * vs[0],
        p1 * t1[1] + p2 * t2[1] + pz * vs[1],
        p1 * t1[2] + p2 * t2[2] + pz * vs[2],
    )
    return la.normalize3((a2 * n[0], a2 * n[1], la.clamp_min(n[2], 0.0)), eps=1e-30)


def _flip_to_upper(h):
    neg = h[2] < 0.0
    return (
        torch.where(neg, -h[0], h[0]),
        torch.where(neg, -h[1], h[1]),
        torch.where(neg, -h[2], h[2]),
    )


def ggx_sample_microfacet_normal(v, roughness, e1, e2):
    """sampling.rs:57-64: VNDF sample with a2 = roughness^2, flipped to z >= 0."""
    return _flip_to_upper(_sample_ggx_vndf(v, roughness * roughness, e1, e2))


def gtr1_D(abs_cos_theta, alpha_g):
    """sampling.rs:121-125, with the reference's log2."""
    alpha2 = alpha_g * alpha_g
    t = 1.0 + (alpha2 - 1.0) * abs_cos_theta * abs_cos_theta
    return (alpha2 - 1.0) / (PI * t * torch.log2(alpha2))


def gtr1_sample_microfacet_normal(alpha, e1, e2):
    """sampling.rs:127-142 — cos_theta without sqrt, as in the reference."""
    alpha2 = alpha * alpha
    cos_theta = (1.0 - torch.pow(alpha2, 1.0 - e1)) / (1.0 - alpha2)
    sin_theta = torch.sqrt(la.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = (2.0 * PI) * e2
    h = (sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
    return _flip_to_upper(h)


# -- fresnel (bsdf/mod.rs:74-97) --------------------------------------------


def fresnel_dielectric3(w, h, eta_i, eta_o):
    """Exact dielectric Fresnel (bsdf/mod.rs:77-88); 1.0 on TIR (g^2 < 0).

    The sqrt argument and the x denominator are floored as in the reference
    package; the floors only bind on lanes the final select discards.
    """
    c = torch.abs(la.dot3(w, h))
    ratio = eta_o / eta_i
    g_squared = ratio * ratio - 1.0 + c * c
    g = torch.sqrt(la.clamp_min(g_squared, 1e-20))
    gmc = g - c
    gpc = g + c
    den = c * gmc + 1.0
    den = torch.where(torch.abs(den) > 1e-12, den, 1e-12)
    x = (c * gpc - 1.0) / den
    f = 0.5 * (gmc * gmc) / la.clamp_min(gpc * gpc, 1e-18) * (1.0 + x * x)
    return torch.where(g_squared < 0.0, 1.0, f)


def pow5(x):
    """x^5 via multiplies — matches Rust `powi(5)` for negative bases too."""
    x2 = x * x
    return x2 * x2 * x


def fresnel_schlick3(r0, angle):
    """bsdf/mod.rs:90-92: r0 is an rgb 3-tuple, angle [B] (may be negative)."""
    w = pow5(1.0 - angle)
    return (r0[0] + (1.0 - r0[0]) * w, r0[1] + (1.0 - r0[1]) * w, r0[2] + (1.0 - r0[2]) * w)


def schlick_weight(x):
    """bsdf/mod.rs:94-96."""
    return pow5(la.clip(1.0 - x, 0.0, 1.0))


def luminance3(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def tint3(base_color):
    """c_tint (bsdf/mod.rs:61-68): color / luminance, or 1 when black."""
    lum = luminance3(base_color)
    pos = lum > 0.0
    inv = 1.0 / torch.where(pos, lum, 1.0)
    return (
        torch.where(pos, base_color[0] * inv, 1.0),
        torch.where(pos, base_color[1] * inv, 1.0),
        torch.where(pos, base_color[2] * inv, 1.0),
    )


def r0_from_eta(eta):
    """bsdf/mod.rs:70-72."""
    x = (eta - 1.0) / (eta + 1.0)
    return x * x


# r0_from_eta(1.5) rounded through REAL steps, as a scalar
_X15 = (NP_REAL(1.5) - NP_REAL(1.0)) / (NP_REAL(1.5) + NP_REAL(1.0))
R0_15 = float(_X15 * _X15)
