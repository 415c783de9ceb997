"""Material shading: sample / pdf / eval for all five material families.

Counterpart of ``tpupt/ops/bsdf.py``. Every lane evaluates the material families
present in the scene and the result is selected by the material type tag; families
absent from ``Shade.mat_types`` are skipped entirely.

Normal conventions follow the reference:
- Diffuse / Metal / Glass shade in the *shading* normal frame (possibly normal-mapped);
- Principled shades in the *geometric* (front-face-flipped) normal frame;
- DiffuseLight: sample is invalid, pdf = 1, eval = (1,1,1) (material.rs:167-178).
"""

from __future__ import annotations

import dataclasses

import torch

from . import linalg as la
from . import tables as D
from . import sampling as S
from .gather import take_rows
from .texture import eval_scalar_texture, eval_texture

PI = S.PI


@dataclasses.dataclass
class Shade:
    """Per-lane shading context gathered once per bounce."""

    mtype: torch.Tensor  # [B] int32
    base_color: torch.Tensor  # [B,3]
    roughness: torch.Tensor  # [B] (metal/glass textured roughness)
    params: torch.Tensor  # [B,N_PARAMS] (principled; ior shared with glass)
    emission: torch.Tensor  # [B,3] (light family)
    ng: torch.Tensor  # [B,3] geometric normal, front-face flipped
    ns: torch.Tensor  # [B,3] shading normal (normal-mapped for diffuse)
    front: torch.Tensor  # [B] bool
    point: torch.Tensor  # [B,3]
    mat_types: tuple = ()  # families present (empty = assume all)


_ALL_TYPES = (D.MAT_DIFFUSE, D.MAT_METAL, D.MAT_GLASS, D.MAT_PRINCIPLED, D.MAT_LIGHT)


def _types(sh: Shade):
    return sh.mat_types if sh.mat_types else _ALL_TYPES


def make_shade(sd: "D.SceneData", mat_id, u, v, point, ng, ns, front) -> Shade:
    mat_types = sd.mat_types if sd.mat_types else _ALL_TYPES
    mat_id = mat_id.to(torch.int64)
    mtype = sd.mat_type[mat_id]
    tex_id = sd.mat_tex[mat_id]
    params = take_rows(sd.mat_params, mat_id)
    base_color = eval_texture(sd, tex_id, u, v, point)
    needs_rough = (D.MAT_METAL in mat_types) or (D.MAT_GLASS in mat_types)
    if needs_rough and sd.rough_all_solid:
        # every roughness texture is SOLID: its value is a per-material constant
        rough_col = sd.tex_rgb[torch.clamp(sd.mat_rough_tex, min=0).to(torch.int64), 0]
        roughness = rough_col[mat_id]
    elif needs_rough:
        roughness = eval_scalar_texture(sd, sd.mat_rough_tex[mat_id], u, v, point)
    else:
        roughness = torch.zeros_like(u)
    if D.MAT_LIGHT in mat_types:
        # emission = the material texture evaluated as color (material.rs:184-186)
        emission = torch.where((mtype == D.MAT_LIGHT)[..., None], base_color, 0.0)
    else:
        emission = torch.zeros_like(base_color)
    return Shade(mtype, base_color, roughness, params, emission, ng, ns, front, point, mat_types)


def _etas(sh: Shade, ior):
    """(eta_i, eta_o) by front_face; ior floored at 0.01 for non-glass rows (P_IOR = 0)."""
    ior = la.clamp_min(ior, 0.01)
    eta_i = torch.where(sh.front, 1.0, ior)
    eta_o = torch.where(sh.front, ior, 1.0)
    return eta_i, eta_o


def _half_vector(v, l, eta_i, eta_o, reflect):
    """Half vector from reflect/refract branch (glass.rs:103-107, principled.rs:294-298)."""
    h_refl = la.scale3(la.normalize3(la.add3(v, l), eps=1e-30), torch.sign(v[2]))
    h_refr = la.neg3(
        la.normalize3(
            (
                l[0] * eta_o + v[0] * eta_i,
                l[1] * eta_o + v[1] * eta_i,
                l[2] * eta_o + v[2] * eta_i,
            ),
            eps=1e-30,
        )
    )
    return la.where3(reflect, h_refl, h_refr)


def _vndf_pdf_h(v, h, roughness):
    """VNDF density over half-vectors: G1 |v.h| D / |v.z|."""
    return (
        S.ggx_G1(v, roughness)
        * torch.abs(la.dot3(v, h))
        * S.ggx_D(h, roughness)
        / la.clamp_min(torch.abs(v[2]), 1e-12)
    )


# ===========================================================================
# Diffuse (bsdf/diffuse.rs) — shading normal
# ===========================================================================


def _diffuse_sample(ns, e1, e2):
    d = la.to_world3(ns, S.cosine_sample_hemisphere(e1, e2))
    return d, torch.ones_like(e1, dtype=torch.bool)


def _diffuse_pdf(ns, l):
    return torch.abs(la.dot3(ns, l)) / PI


def _diffuse_eval(base, ns, l):
    lz = torch.abs(la.dot3(ns, l)) / PI
    return (lz * base[0], lz * base[1], lz * base[2])


# ===========================================================================
# Metal (bsdf/metal.rs) — shading normal, textured roughness
# ===========================================================================


def _metal_sample(ns, rough, v_world, e1, e2):
    v = la.to_local3(ns, v_world)
    h = S.ggx_sample_microfacet_normal(v, rough, e1, e2)
    d = la.to_world3(ns, la.reflect3(la.neg3(v), h))
    valid = la.dot3(d, ns) > 0.0  # metal.rs:49-53
    return d, valid


def _metal_pdf(ns, rough, v_world, l_world):
    v = la.to_local3(ns, v_world)
    l = la.to_local3(ns, l_world)
    h = la.normalize3(la.add3(v, l), eps=1e-30)
    jac = 1.0 / la.clamp_min(4.0 * torch.abs(la.dot3(l, h)), 1e-15)
    return _vndf_pdf_h(v, h, rough) * jac


def _metal_eval(base, ns, rough, v_world, l_world):
    v = la.to_local3(ns, v_world)
    l = la.to_local3(ns, l_world)
    h = la.normalize3(la.add3(v, l), eps=1e-30)
    d = S.ggx_D(h, rough)
    g = S.ggx_G(v, l, rough)
    f = S.fresnel_schlick3(base, la.dot3(l, h))
    lz = torch.abs(l[2])
    vz = torch.abs(v[2])
    k = lz * (g * d / la.clamp_min(4.0 * lz * vz, 1e-15))
    return (k * f[0], k * f[1], k * f[2])


# ===========================================================================
# Glass (bsdf/glass.rs) — shading normal, exact dielectric fresnel
# ===========================================================================


def _glass_sample(sh: Shade, ns, rough, v_world, e1, e2, fresnel_u):
    ior = sh.params[..., D.P_IOR]
    v = la.to_local3(ns, v_world)
    h = S.ggx_sample_microfacet_normal(v, rough, e1, e2)
    eta_i, eta_o = _etas(sh, ior)
    f = S.fresnel_dielectric3(v, h, eta_i, eta_o)
    refl = la.reflect3(la.neg3(v), h)
    refr = la.refract3(la.neg3(v), h, eta_i / eta_o)
    tir = la.dot3(refr, refr) == 0.0  # refract returned 0 -> reflect (glass.rs:85-87)
    trans = la.where3(tir, refl, refr)
    d_local = la.where3(fresnel_u < f, refl, trans)
    return la.to_world3(ns, d_local), torch.ones_like(e1, dtype=torch.bool)


def _glass_pdf_eval(sh: Shade, ns, rough, v_world, l_world):
    """pdf and eval share every term (glass.rs:92-163); compute once."""
    ior = sh.params[..., D.P_IOR]
    v = la.to_local3(ns, v_world)
    l = la.to_local3(ns, l_world)
    reflect = l[2] * v[2] > 0.0
    eta_i, eta_o = _etas(sh, ior)
    h = _half_vector(v, l, eta_i, eta_o, reflect)

    f = S.fresnel_dielectric3(v, h, eta_i, eta_o)
    v_dot_h = la.dot3(v, h)
    l_dot_h = la.dot3(l, h)
    rd = eta_i * v_dot_h + eta_o * l_dot_h
    refr_denom = rd * rd

    pdf_h = _vndf_pdf_h(v, h, rough)
    jac_refl = f / la.clamp_min(4.0 * torch.abs(l_dot_h), 1e-15)
    jac_refr = (1.0 - f) * (eta_o * eta_o * torch.abs(l_dot_h)) / la.clamp_min(refr_denom, 1e-15)
    pdf = pdf_h * torch.where(reflect, jac_refl, jac_refr)

    d = S.ggx_D(h, rough)
    g = S.ggx_G(v, l, rough)
    lz = torch.abs(l[2])
    vz = torch.abs(v[2])
    fac_refl = f * g * d / la.clamp_min(4.0 * lz * vz, 1e-15)
    term1 = torch.abs((l_dot_h * v_dot_h) / la.clamp_min(torch.abs(l[2] * v[2]), 1e-15))
    term2 = (eta_o * eta_o) / la.clamp_min(refr_denom, 1e-15)
    fac_refr = term1 * term2 * (1.0 - f) * g * d
    ev = torch.where(reflect, fac_refl, fac_refr) * lz
    return pdf, ev  # eval is achromatic (glass.rs:153,160)


# ===========================================================================
# Principled (bsdf/principled.rs) — geometric normal, 4 lobes
# ===========================================================================


def _principled_lobes(params):
    """Lobe weights + normalized probabilities (principled.rs:79-100)."""
    metallic = params[..., D.P_METALLIC]
    spec_trans = params[..., D.P_SPEC_TRANS]
    clearcoat = params[..., D.P_CLEARCOAT]
    diffuse_wt = (1.0 - metallic) * (1.0 - spec_trans)
    specular_wt = 1.0 - spec_trans * (1.0 - metallic)
    glass_wt = spec_trans * (1.0 - metallic)
    clearcoat_wt = 0.25 * clearcoat
    inv_total = 1.0 / (diffuse_wt + specular_wt + glass_wt + clearcoat_wt)
    wts = (diffuse_wt, specular_wt, glass_wt, clearcoat_wt)
    probs = tuple(w * inv_total for w in wts)
    return wts, probs


def _principled_alpha_g(params):
    """principled.rs:75-77."""
    cg = params[..., D.P_CLEARCOAT_GLOSS]
    return (1.0 - cg) * 0.1 + cg * 0.001


def _principled_sample(sh: Shade, n, v_world, lobe_u, e1, e2, fresnel_u):
    params = sh.params
    roughness = params[..., D.P_ROUGHNESS]
    ior = params[..., D.P_IOR]
    _, (p_d, p_s, p_g, _) = _principled_lobes(params)
    v = la.to_local3(n, v_world)

    d_diff = la.to_world3(n, S.cosine_sample_hemisphere(e1, e2))

    h_ggx = S.ggx_sample_microfacet_normal(v, roughness, e1, e2)
    d_spec = la.to_world3(n, la.reflect3(la.neg3(v), h_ggx))
    spec_ok = la.dot3(d_spec, n) > 0.0

    eta_i, eta_o = _etas(sh, ior)
    f = S.fresnel_dielectric3(v, h_ggx, eta_i, eta_o)
    refl = la.reflect3(la.neg3(v), h_ggx)
    refr = la.refract3(la.neg3(v), h_ggx, eta_i / eta_o)
    tir = la.dot3(refr, refr) == 0.0
    trans = la.where3(tir, refl, refr)
    d_glass = la.to_world3(n, la.where3(fresnel_u < f, refl, trans))

    h_cc = S.gtr1_sample_microfacet_normal(torch.full_like(roughness, 0.25), e1, e2)
    d_cc = la.to_world3(n, la.reflect3(la.neg3(v), h_cc))
    cc_ok = la.dot3(d_cc, n) > 0.0

    use_d = lobe_u < p_d
    use_s = ~use_d & (lobe_u < p_d + p_s)
    use_g = ~use_d & ~use_s & (lobe_u < p_d + p_s + p_g)
    use_c = ~use_d & ~use_s & ~use_g

    direction = la.where3(use_d, d_diff, la.where3(use_s, d_spec, la.where3(use_g, d_glass, d_cc)))
    valid = use_d | (use_s & spec_ok) | use_g | (use_c & cc_ok)
    return direction, valid


def _principled_pdf(sh: Shade, n, v_world, l_world):
    params = sh.params
    roughness = params[..., D.P_ROUGHNESS]
    ior = params[..., D.P_IOR]
    _, (p_d, p_s, p_g, p_c) = _principled_lobes(params)
    v = la.to_local3(n, v_world)
    l = la.to_local3(n, l_world)
    reflect = l[2] * v[2] > 0.0
    eta_i, eta_o = _etas(sh, ior)
    h = _half_vector(v, l, eta_i, eta_o, reflect)

    l_dot_h = la.dot3(l, h)
    v_dot_h = la.dot3(v, h)
    jac_refl = 1.0 / la.clamp_min(4.0 * torch.abs(l_dot_h), 1e-15)

    pdf_diffuse = torch.abs(l[2]) / PI
    pdf_spec = _vndf_pdf_h(v, h, roughness) * jac_refl

    f = S.fresnel_dielectric3(v, h, eta_i, eta_o)
    rd = eta_i * v_dot_h + eta_o * l_dot_h
    refr_denom = rd * rd
    jac_glass = torch.where(
        reflect,
        f * jac_refl,
        (1.0 - f) * (eta_o * eta_o * torch.abs(l_dot_h)) / la.clamp_min(refr_denom, 1e-15),
    )
    pdf_glass = _vndf_pdf_h(v, h, roughness) * jac_glass

    quarter = torch.full_like(roughness, 0.25)
    pdf_cc_h = (
        S.ggx_G1(v, quarter)
        * torch.abs(v_dot_h)
        * S.gtr1_D(torch.abs(l_dot_h), _principled_alpha_g(params))
        / la.clamp_min(torch.abs(v[2]), 1e-12)
    )
    pdf_cc = pdf_cc_h * jac_refl

    pdf = torch.zeros_like(pdf_diffuse)
    pdf = pdf + torch.where((p_d > 0.0) & reflect, p_d * pdf_diffuse, 0.0)
    pdf = pdf + torch.where((p_s > 0.0) & reflect, p_s * pdf_spec, 0.0)
    pdf = pdf + torch.where(p_g > 0.0, p_g * pdf_glass, 0.0)
    pdf = pdf + torch.where((p_c > 0.0) & reflect, p_c * pdf_cc, 0.0)
    return pdf


def _lerp(a, b, t):
    return a + (b - a) * t


def _principled_eval(sh: Shade, n, v_world, l_world):
    params = sh.params
    base = la.unpack3(sh.base_color)
    roughness = params[..., D.P_ROUGHNESS]
    ior = params[..., D.P_IOR]
    (w_d, w_s, w_g, w_c), (p_d, p_s, p_g, p_c) = _principled_lobes(params)
    v = la.to_local3(n, v_world)
    l = la.to_local3(n, l_world)
    reflect = l[2] * v[2] > 0.0
    eta_i, eta_o = _etas(sh, ior)
    h = _half_vector(v, l, eta_i, eta_o, reflect)
    l_dot_h = la.dot3(l, h)
    v_dot_h = la.dot3(v, h)
    lz, vz = l[2], v[2]

    # ---- diffuse + retro + subsurface + sheen (principled.rs:196-213,341-345) ----
    rr = 2.0 * roughness * l_dot_h * l_dot_h
    fl = S.schlick_weight(lz)
    fv = S.schlick_weight(vz)
    f_retro = rr * (fl + fv + fl * fv * (rr - 1.0))
    f_d = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    fss90 = 0.5 * rr
    f_ss = _lerp(1.0, fss90, fl) * _lerp(1.0, fss90, fv)
    svz = lz + vz
    svz = torch.where(torch.abs(svz) > 1e-12, svz, la.signed(svz < 0.0, 1e-12, svz))
    ss = 1.25 * (f_ss * (1.0 / svz - 0.5) + 0.5)
    subsurface = params[..., D.P_SUBSURFACE]
    k_diff = _lerp(f_d + f_retro, ss, subsurface) / PI
    c_tint = S.tint3(base)
    sheen_tint = params[..., D.P_SHEEN_TINT]
    sheen_w = params[..., D.P_SHEEN] * S.schlick_weight(torch.abs(l_dot_h))
    diffuse_rgb = tuple(
        base[j] * k_diff + sheen_w * _lerp(1.0, c_tint[j], sheen_tint) for j in range(3)
    )

    # ---- specular with metallic-lerped fresnel (principled.rs:347-356) ----
    metallic = params[..., D.P_METALLIC]
    spec_tint = params[..., D.P_SPECULAR_TINT]
    spec_amt = params[..., D.P_SPECULAR] * S.r0_from_eta(eta_i / eta_o)
    c0 = tuple(
        _lerp(spec_amt * _lerp(1.0, c_tint[j], spec_tint), base[j], metallic) for j in range(3)
    )
    metal_f = S.fresnel_schlick3(c0, l_dot_h)
    diel_f = S.fresnel_dielectric3(v, h, eta_i, eta_o)
    fresnel = tuple(_lerp(diel_f, metal_f[j], metallic) for j in range(3))
    d_ggx = S.ggx_D(h, roughness)
    g_ggx = S.ggx_G(v, l, roughness)
    denom4 = la.clamp_min(4.0 * torch.abs(lz) * torch.abs(vz), 1e-15)
    k_spec = g_ggx * d_ggx / denom4
    spec_rgb = tuple(fresnel[j] * k_spec for j in range(3))

    # ---- glass (principled.rs:226-246), achromatic ----
    rd = eta_i * v_dot_h + eta_o * l_dot_h
    refr_denom = rd * rd
    fac_refl = diel_f * g_ggx * d_ggx / denom4
    pvz = lz * vz
    pvz = torch.where(torch.abs(pvz) > 1e-12, pvz, la.signed(pvz < 0.0, 1e-12, pvz))
    term1 = torch.abs((l_dot_h * v_dot_h) / pvz)
    term2 = (eta_o * eta_o) / la.clamp_min(refr_denom, 1e-15)
    fac_refr = term1 * term2 * (1.0 - diel_f) * g_ggx * d_ggx
    glass_k = torch.where(reflect, fac_refl, fac_refr)

    # ---- clearcoat (principled.rs:248-258), with the reference's extra |l.z| ----
    d_cc = S.gtr1_D(torch.abs(l_dot_h), _principled_alpha_g(params))
    quarter = torch.full_like(roughness, 0.25)
    g_cc = S.ggx_G(v, l, quarter)
    r0 = torch.full_like(lz, S.R0_15)
    f_cc = S.fresnel_schlick3((r0, r0, r0), l_dot_h)
    k_cc = torch.abs(lz) * d_cc * g_cc / denom4
    cc_rgb = tuple(f_cc[j] * k_cc for j in range(3))

    m_d = (p_d > 0.0) & reflect
    m_s = (p_s > 0.0) & reflect
    m_g = p_g > 0.0
    m_c = (p_c > 0.0) & reflect
    out = []
    for j in range(3):
        acc = torch.where(m_d, w_d * diffuse_rgb[j], 0.0)
        acc = acc + torch.where(m_s, w_s * spec_rgb[j], 0.0)
        acc = acc + torch.where(m_g, w_g * glass_k, 0.0)
        acc = acc + torch.where(m_c, w_c * cc_rgb[j], 0.0)
        out.append(acc * torch.abs(lz))
    return tuple(out)


# ===========================================================================
# dispatch (by the families present in the scene)
# ===========================================================================


def _select_by_type(sh, cases, default):
    """cases: list of (mat_type, value) for present types; value [B] or 3-tuple."""
    out = default
    for t, val in cases:
        m = sh.mtype == t
        if isinstance(out, tuple):
            out = la.where3(m, val, out)
        else:
            out = torch.where(m, val, out)
    return out


def bsdf_sample(sh: Shade, v_world, lobe_u, e1, e2, fresnel_u):
    """Sample an incident direction; returns (dir [B,3], valid [B] bool).

    valid=False kills the path (camera.rs:209-211); DiffuseLight always returns
    invalid (material.rs:167-169).
    """
    types = _types(sh)
    ns = la.unpack3(sh.ns)
    ng = la.unpack3(sh.ng)
    vw = la.unpack3(v_world)
    zeros = torch.zeros_like(e1)
    dir_cases, ok_cases = [], []
    if D.MAT_DIFFUSE in types:
        d, ok = _diffuse_sample(ns, e1, e2)
        dir_cases.append((D.MAT_DIFFUSE, d))
        ok_cases.append((D.MAT_DIFFUSE, ok))
    if D.MAT_METAL in types:
        d, ok = _metal_sample(ns, sh.roughness, vw, e1, e2)
        dir_cases.append((D.MAT_METAL, d))
        ok_cases.append((D.MAT_METAL, ok))
    if D.MAT_GLASS in types:
        d, ok = _glass_sample(sh, ns, sh.roughness, vw, e1, e2, fresnel_u)
        dir_cases.append((D.MAT_GLASS, d))
        ok_cases.append((D.MAT_GLASS, ok))
    if D.MAT_PRINCIPLED in types:
        d, ok = _principled_sample(sh, ng, vw, lobe_u, e1, e2, fresnel_u)
        dir_cases.append((D.MAT_PRINCIPLED, d))
        ok_cases.append((D.MAT_PRINCIPLED, ok))
    direction = _select_by_type(sh, dir_cases, (zeros, zeros, torch.ones_like(e1)))
    valid = _select_by_type(sh, ok_cases, torch.zeros_like(e1, dtype=torch.bool))
    return la.pack3(direction), valid


def bsdf_pdf(sh: Shade, v_world, l_world):
    """BxDFMaterial::pdf dispatch; DiffuseLight pdf = 1 (material.rs:171-173)."""
    types = _types(sh)
    ns = la.unpack3(sh.ns)
    ng = la.unpack3(sh.ng)
    vw = la.unpack3(v_world)
    lw = la.unpack3(l_world)
    cases = []
    if D.MAT_DIFFUSE in types:
        cases.append((D.MAT_DIFFUSE, _diffuse_pdf(ns, lw)))
    if D.MAT_METAL in types:
        cases.append((D.MAT_METAL, _metal_pdf(ns, sh.roughness, vw, lw)))
    if D.MAT_GLASS in types:
        pdf, _ = _glass_pdf_eval(sh, ns, sh.roughness, vw, lw)
        cases.append((D.MAT_GLASS, pdf))
    if D.MAT_PRINCIPLED in types:
        cases.append((D.MAT_PRINCIPLED, _principled_pdf(sh, ng, vw, lw)))
    return _select_by_type(sh, cases, torch.ones_like(sh.roughness))


def bsdf_eval(sh: Shade, v_world, l_world):
    """BxDFMaterial::eval dispatch; DiffuseLight eval = ONE (material.rs:175-178)."""
    types = _types(sh)
    ns = la.unpack3(sh.ns)
    ng = la.unpack3(sh.ng)
    vw = la.unpack3(v_world)
    lw = la.unpack3(l_world)
    base = la.unpack3(sh.base_color)
    ones = torch.ones_like(sh.roughness)
    cases = []
    if D.MAT_DIFFUSE in types:
        cases.append((D.MAT_DIFFUSE, _diffuse_eval(base, ns, lw)))
    if D.MAT_METAL in types:
        cases.append((D.MAT_METAL, _metal_eval(base, ns, sh.roughness, vw, lw)))
    if D.MAT_GLASS in types:
        _, ev = _glass_pdf_eval(sh, ns, sh.roughness, vw, lw)
        cases.append((D.MAT_GLASS, (ev, ev, ev)))
    if D.MAT_PRINCIPLED in types:
        cases.append((D.MAT_PRINCIPLED, _principled_eval(sh, ng, vw, lw)))
    return la.pack3(_select_by_type(sh, cases, (ones, ones, ones)))
