"""Branchless texture evaluation over the interned texture table.

Counterpart of ``tpupt/ops/texture.py``: checker nodes resolve to a child id by
world-position parity (texture.rs:43-54), then solid/image leaves evaluate in one
pass. Checker nesting is one level deep (all reference scenes use solid children).
"""

from __future__ import annotations

import torch

from . import linalg as la
from . import tables as D
from .gather import take_rows


def _image_lookup(sd, offset, w, h, u, v):
    """Nearest-neighbor atlas lookup (texture.rs:73-91): u clamped, v flipped."""
    uu = la.clip(u, 0.0, 1.0)
    vv = 1.0 - la.clip(v, 0.0, 1.0)
    # truncating cast like Rust's `as u32`; clamp to the last texel at u == 1
    i = torch.minimum(torch.floor(uu * w.to(u.dtype)).to(torch.int32), w - 1)
    j = torch.minimum(torch.floor(vv * h.to(u.dtype)).to(torch.int32), h - 1)
    # lanes of non-image textures (w = h = 0) compute index -1; keep every index
    # in range, their value is discarded by the caller's select
    idx = torch.clamp(offset + j * w + i, 0, sd.atlas.shape[0] - 1)
    return take_rows(sd.atlas, idx)


def eval_texture(sd: "D.SceneData", tid, u, v, point):
    """Evaluate color texture `tid` [B] at (u, v, world point) -> [B, 3].

    `tid` may contain -1 (unused slots); those lanes return row 0's value and
    must be masked by the caller.
    """
    tid = torch.clamp(tid, min=0).to(torch.int64)
    if sd.has_checker:
        ttype = sd.tex_type[tid]
        inv_scale = sd.tex_inv_scale[tid]
        # Rust's `(x+y+z) % 2 == 0`: odd sums give +-1 there and 1 here, both != 0
        cell = (
            torch.floor(point[..., 0] * inv_scale).to(torch.int32)
            + torch.floor(point[..., 1] * inv_scale).to(torch.int32)
            + torch.floor(point[..., 2] * inv_scale).to(torch.int32)
        )
        child_rows = sd.tex_child[tid]
        child = torch.where((cell % 2) == 0, child_rows[..., 0], child_rows[..., 1])
        rid = torch.where(ttype == D.TEX_CHECKER, torch.clamp(child, min=0).to(torch.int64), tid)
    else:
        rid = tid
    solid = take_rows(sd.tex_rgb, rid)
    if sd.has_image_textures:
        img = take_rows(sd.tex_img, rid)
        image = _image_lookup(sd, img[..., 0], img[..., 1], img[..., 2], u, v)
        return torch.where((sd.tex_type[rid] == D.TEX_IMAGE)[..., None], image, solid)
    return solid


def eval_scalar_texture(sd, tid, u, v, point):
    """Scalar texture (reference Texture<f64>, e.g. roughness): red channel."""
    return eval_texture(sd, tid, u, v, point)[..., 0]
