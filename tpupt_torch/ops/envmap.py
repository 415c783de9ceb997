"""Environment lighting on ray miss: constant color or an LDR map (camera.rs:140-151).

Counterpart of ``sample_environment`` in ``tpupt/ops/envmap.py``. Mapping:
    theta = arccos(d.y)            v = 1 - theta/pi
    phi   = atan2(d.z, d.x)        u = (phi + pi) / (2 pi)
The HDR map with importance sampling (``sample_env_light`` / ``pdf_env_light``)
waits for its port (ROADMAP).
"""

from __future__ import annotations

import math

import torch

from ..core import linalg as la
from .gather import take_rows
from .texture import eval_texture

PI = la.f32(math.pi)


def sample_environment(sd, direction):
    """Radiance along a miss ray -> [B,3]."""
    if not sd.env_is_map:
        return sd.env_color.expand(direction.shape)
    y = torch.clamp(direction[..., 1], -1.0, 1.0)
    theta = torch.arccos(y)
    phi = torch.atan2(direction[..., 2], direction[..., 0])
    u = (phi + PI) / (2.0 * PI)
    v = 1.0 - theta / PI
    if sd.env_map_w > 0:
        # the env is one plain image: the texture lookup with its atlas
        # coordinates known on the host (same arithmetic as texture._image_lookup)
        w = float(sd.env_map_w)
        h = float(sd.env_map_h)
        uu = torch.clamp(u, 0.0, 1.0)
        vv = 1.0 - torch.clamp(v, 0.0, 1.0)
        i = torch.clamp(torch.floor(uu * w).to(torch.int32), max=sd.env_map_w - 1)
        j = torch.clamp(torch.floor(vv * h).to(torch.int32), max=sd.env_map_h - 1)
        return take_rows(sd.atlas, sd.env_map_off + j * sd.env_map_w + i)
    tid = sd.env_tex.expand(u.shape)
    return eval_texture(sd, tid, u, v, direction)
