"""Camera model and primary rays (the Rust reference's camera.rs:22-77,132-168).

The basis is derived on the host in float64 and stored as float32. ``generate_rays``
takes the basis either as one camera's vectors [3] or as one row a lane [B,3], so
that rays of many calls, each with its own camera, are traced in one batch; the
arithmetic per lane is the same either way.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import linalg as la
from . import rng
from .tables import NP_REAL, REAL


@dataclasses.dataclass
class CameraBasis:
    center: torch.Tensor  # [3] or [B,3]
    pixel00: torch.Tensor
    pixel_du: torch.Tensor
    pixel_dv: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    defocus_radius: torch.Tensor  # [] or [B,1]
    blur_strength: torch.Tensor  # [] or [B,1]

    @staticmethod
    def stack(bases, index):
        """Per-lane rows: lane i takes bases[index[i]]."""
        out = {}
        for f in dataclasses.fields(CameraBasis):
            rows = torch.stack([getattr(b, f.name).reshape(-1) for b in bases])
            out[f.name] = rows.index_select(0, index.to(torch.int64))
        return CameraBasis(**out)


@dataclasses.dataclass
class Camera:
    aspect_ratio: float = 1.0
    image_width: int = 600
    samples_per_pixel: int = 100
    max_depth: int = 50
    vfov: float = 40.0
    look_from: tuple = (0.0, 0.0, 0.0)
    look_at: tuple = (0.0, 0.0, -1.0)
    vup: tuple = (0.0, 1.0, 0.0)
    blur_strength: float = 0.5
    focal_length: float = 10.0
    defocus_angle: float = 0.0

    @property
    def image_height(self) -> int:
        return int(self.image_width / self.aspect_ratio)  # camera.rs:52

    def basis(self, device) -> CameraBasis:
        """Camera::init (camera.rs:51-77)."""
        w, h = self.image_width, self.image_height
        look_from = np.asarray(self.look_from, dtype=np.float64)
        look_at = np.asarray(self.look_at, dtype=np.float64)
        vup = np.asarray(self.vup, dtype=np.float64)
        hh = math.tan(math.radians(self.vfov) / 2.0)
        viewport_height = 2.0 * hh * self.focal_length
        viewport_width = viewport_height * (w / h)
        forward = look_from - look_at
        forward = forward / np.linalg.norm(forward)
        right = np.cross(vup, forward)
        right = right / np.linalg.norm(right)
        up = np.cross(forward, right)
        viewport_u = right * viewport_width
        viewport_v = up * -viewport_height
        pixel_du = viewport_u / w
        pixel_dv = viewport_v / h
        upperleft = look_from - forward * self.focal_length - viewport_u / 2.0 - viewport_v / 2.0
        pixel00 = upperleft + (pixel_du + pixel_dv) * 0.5
        defocus_radius = math.tan(math.radians(self.defocus_angle / 2.0)) * self.focal_length

        def real(x):
            return torch.as_tensor(np.asarray(x, dtype=NP_REAL), device=device)

        return CameraBasis(real(look_from), real(pixel00), real(pixel_du), real(pixel_dv), real(right),
                           real(up), real(defocus_radius), real(self.blur_strength))


_TWO_PI = 2.0 * la.f32(math.pi)


def _unit_disk(u_radius, u_angle):
    """Camera::random_offsets (camera.rs:132-138): r = sqrt(u), angle uniform."""
    radius = torch.sqrt(u_radius)
    angle = u_angle * _TWO_PI
    return radius * torch.cos(angle), radius * torch.sin(angle)


def generate_rays(cam: CameraBasis, rows, cols, pixel_ids, sample_ids, seed):
    """Camera::generate_ray (camera.rs:153-168), with its quirk that the blur offset's x
    component scales pixel_dv (the row axis) and its y component pixel_du."""
    a1, a2, d1, d2 = rng.uniform4(seed, pixel_ids, sample_ids, rng.CTR_CAMERA)
    time = rng.uniform(seed, pixel_ids, sample_ids, rng.CTR_TIME)
    blur = cam.blur_strength[..., 0] if cam.blur_strength.dim() else cam.blur_strength
    bx, by = _unit_disk(a1, a2)
    bx = bx * blur
    by = by * blur
    loc = (
        cam.pixel00
        + cam.pixel_dv * (rows.to(REAL) + bx)[..., None]
        + cam.pixel_du * (cols.to(REAL) + by)[..., None]
    )
    px, py = _unit_disk(d1, d2)
    origin = (
        cam.center
        + (cam.right * cam.defocus_radius) * px[..., None]
        + (cam.up * cam.defocus_radius) * py[..., None]
    )
    direction = la.normalize(loc - origin, eps=1e-30)
    return origin, direction, time
