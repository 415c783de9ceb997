"""Environment radiance along a miss ray: a constant colour, or the 8-bit latlong map
(camera.rs:140-151):

    theta = arccos(d.y)            v = 1 - theta/pi
    phi   = atan2(d.z, d.x)        u = (phi + pi) / (2 pi)

looked up nearest-neighbour in the atlas with u clamped and v flipped (texture.rs:73-91).
"""

from __future__ import annotations

import math

import torch

from . import linalg as la
from .gather import take_rows

PI = la.f32(math.pi)


def sample_environment(sd, direction):
    """Radiance along a miss ray -> [B,3]."""
    if not sd.env_is_map:
        return sd.env_color.expand(direction.shape)
    y = la.clip(direction[..., 1], -1.0, 1.0)
    theta, phi = torch.arccos(y), torch.atan2(direction[..., 2], direction[..., 0])
    u = (phi + PI) / (2.0 * PI)
    v = 1.0 - theta / PI
    w, h = float(sd.env_map_w), float(sd.env_map_h)
    uu = la.clip(u, 0.0, 1.0)
    vv = 1.0 - la.clip(v, 0.0, 1.0)
    i = torch.clamp(torch.floor(uu * w).to(torch.int32), max=sd.env_map_w - 1)
    j = torch.clamp(torch.floor(vv * h).to(torch.int32), max=sd.env_map_h - 1)
    return take_rows(sd.atlas, sd.env_map_off + j * sd.env_map_w + i)
