"""Camera model + primary-ray generation (reference camera.rs:22-77,132-168).

Counterpart of ``tpupt/render/camera.py``. The basis is derived host-side in float64
(pixel00 accumulates several subtractions of large vectors) and stored as float32
tensors on the render device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import linalg as la
from ..core import rng
from ..core.device import resolve_device
from ..core.dtypes import NP_REAL, REAL
from ..scene.data import CameraData


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

    def init(self, device=None) -> CameraData:
        """Derive the viewport basis (Camera::init, camera.rs:51-77) on `device`."""
        dev = resolve_device(device)
        w = self.image_width
        h = self.image_height
        look_from = np.asarray(self.look_from, dtype=np.float64)
        look_at = np.asarray(self.look_at, dtype=np.float64)
        vup = np.asarray(self.vup, dtype=np.float64)

        theta = math.radians(self.vfov)
        hh = math.tan(theta / 2.0)
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
            return torch.as_tensor(np.asarray(x, dtype=NP_REAL), device=dev)

        return CameraData(
            center=real(look_from),
            pixel00=real(pixel00),
            pixel_du=real(pixel_du),
            pixel_dv=real(pixel_dv),
            right=real(right),
            up=real(up),
            defocus_radius=real(defocus_radius),
            blur_strength=real(self.blur_strength),
        )


_TWO_PI = 2.0 * la.f32(math.pi)


def _unit_disk(u_radius, u_angle):
    """Camera::random_offsets (camera.rs:132-138): r = sqrt(u), angle uniform."""
    radius = torch.sqrt(u_radius)
    angle = u_angle * _TWO_PI
    return radius * torch.cos(angle), radius * torch.sin(angle)


def generate_rays(cam: CameraData, rows, cols, pixel_ids, sample_ids, seed):
    """Primary rays with AA jitter, defocus blur, and motion-blur time.

    Matches Camera::generate_ray (camera.rs:153-168) including its quirk that the
    blur offset's x component scales pixel_dv (the row axis) and y scales pixel_du.
    """
    a1, a2, d1, d2 = rng.uniform4(seed, pixel_ids, sample_ids, rng.CTR_CAMERA)
    time = rng.uniform(seed, pixel_ids, sample_ids, rng.CTR_TIME)

    bx, by = _unit_disk(a1, a2)
    bx = bx * cam.blur_strength
    by = by * cam.blur_strength
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
