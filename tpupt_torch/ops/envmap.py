"""Environment lighting: constant color, LDR map, or f32 HDR map with importance sampling.

Counterpart of ``tpupt/ops/envmap.py``. The reference looks the map up only on ray
miss (camera.rs:140-151) and quantizes .hdr files to u8. The HDR path keeps the map
in f32 and makes the environment a light member of the NEE/MIS mixture, sampled in
O(1) per lane through a Vose alias table over luminance*sin(theta) texel weights.

Mapping (camera.rs:144-149):
    theta = arccos(d.y)            v = 1 - theta/pi
    phi   = atan2(d.z, d.x)        u = (phi + pi) / (2 pi)
so row j covers theta in [j pi/H, (j+1) pi/H] and col i covers phi in
[-pi + 2 pi i/W, ...]. A texel's solid angle is (2 pi/W)(pi/H) sin(theta_j).

The reference package's polynomial atan2/arccos switch (a default-off TPU probe)
is not carried: the equirect trig here is torch's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import linalg as la
from ..core.dtypes import NP_REAL, REAL
from .gather import take_rows
from .texture import eval_texture

PI = la.f32(math.pi)


def _dir_to_theta_phi(direction):
    """Direction [B,3] -> (theta, phi) of the equirect mapping (camera.rs:144-149)."""
    y = la.clip(direction[..., 1], -1.0, 1.0)
    return torch.arccos(y), torch.atan2(direction[..., 2], direction[..., 0])


def _texel_from_dir(sd, direction):
    """Direction [B,3] -> (texel index [B], row j, col i) of the HDR env map."""
    w, h = sd.env_wh_host
    theta, phi = _dir_to_theta_phi(direction)
    u = (phi + PI) / (2.0 * PI)
    vv = theta / PI  # == 1 - v, the flipped row coordinate of the lookup
    i = torch.clamp(torch.floor(u * float(w)).to(torch.int32), 0, w - 1)
    j = torch.clamp(torch.floor(vv * float(h)).to(torch.int32), 0, h - 1)
    return j * w + i, j, i


def sample_environment(sd, direction):
    """Radiance along a miss ray -> [B,3]."""
    if sd.env_is_hdr:
        texel, _, _ = _texel_from_dir(sd, direction)
        return take_rows(sd.env_img, texel)
    if not sd.env_is_map:
        return sd.env_color.expand(direction.shape)
    theta, phi = _dir_to_theta_phi(direction)
    u = (phi + PI) / (2.0 * PI)
    v = 1.0 - theta / PI
    if sd.env_map_w > 0:
        # the env is one plain image: the texture lookup with its atlas
        # coordinates known on the host (same arithmetic as texture._image_lookup)
        w = float(sd.env_map_w)
        h = float(sd.env_map_h)
        uu = la.clip(u, 0.0, 1.0)
        vv = 1.0 - la.clip(v, 0.0, 1.0)
        i = torch.clamp(torch.floor(uu * w).to(torch.int32), max=sd.env_map_w - 1)
        j = torch.clamp(torch.floor(vv * h).to(torch.int32), max=sd.env_map_h - 1)
        return take_rows(sd.atlas, sd.env_map_off + j * sd.env_map_w + i)
    tid = sd.env_tex.expand(u.shape)
    return eval_texture(sd, tid, u, v, direction)


def sample_env_light(sd, u1, u2):
    """Importance-sample a direction from the HDR env -> (x, y, z) components [B] each.

    Alias draw: u1 picks the slot, u2 the accept/alias coin; the direction is the
    texel's centre. One row gather of the packed (prob, alias, pdf) table.
    """
    n = sd.env_sam.shape[0]
    slot = torch.clamp((u1 * n).to(torch.int32), max=n - 1)
    row = take_rows(sd.env_sam, slot)
    prob = row[..., 0]
    alias = row[..., 1].to(torch.int32)  # f32-exact: n < 2^24 (compile assert)
    texel = torch.where(u2 < prob, slot, alias)

    w, h = sd.env_wh_host
    j = torch.div(texel, w, rounding_mode="floor")
    i = texel - j * w
    theta = (j.to(REAL) + 0.5) / float(h) * PI
    phi = (i.to(REAL) + 0.5) / float(w) * (2.0 * PI) - PI
    st = torch.sin(theta)
    return (st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi))


def pdf_env_light(sd, direction):
    """Solid-angle pdf of sample_env_light for `direction` [B,3] -> [B]."""
    texel, _, _ = _texel_from_dir(sd, direction)
    return take_rows(sd.env_sam, texel)[..., 2]


def build_env_tables(img: np.ndarray):
    """Host-side: f32 [H,W,3] env map -> (alias [N] i32, prob [N] f32, pdf [N] f32).

    Texel weights are luminance * sin(theta_row) (the equirect area element); pdf
    is the solid-angle density w / (integral * texel solid angle). The alias table
    comes from Vose's O(N) method, popping and pushing in the reference package's
    order, so the tables are the same bits.
    """
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    sin_t = np.sin((np.arange(h, dtype=np.float64) + 0.5) / h * np.pi)
    wgt = np.maximum(lum.astype(np.float64), 0.0) * sin_t[:, None]
    flat = wgt.reshape(-1)
    total = flat.sum()
    if total <= 0.0:
        flat = np.ones_like(flat)
        total = flat.sum()
    p = flat / total  # texel selection probabilities
    n = p.size

    # solid-angle pdf per texel: p / omega, omega = (2pi/w)(pi/h) sin(theta)
    omega = (2.0 * np.pi / w) * (np.pi / h) * np.repeat(sin_t, w)
    pdf = p / np.maximum(omega, 1e-12)

    # Vose alias method
    scaled = (p * n).tolist()
    alias = np.zeros(n, dtype=np.int32)
    prob = np.ones(n, dtype=np.float64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in large + small:
        prob[i] = 1.0

    return alias, prob.astype(NP_REAL), pdf.astype(NP_REAL)
