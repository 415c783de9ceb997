"""Bytes that kernel K1 (``csrc/hit_kernel.cu``: closest sphere or quad hit of each ray)
must move, from its arguments' shapes: each input byte read once, each output byte
written once, whatever the kernel reads again.

    closest_sphere_quad(o [B,3] f32, d [B,3] f32, time [B] f32, sph [7,S] f32, quad [16,Q] f32)
        -> t [B] f32, kind [B] int32, idx [B] int32

    bytes = B * (12 + 12 + 4) + 4 * (7 S + 16 Q) + B * (4 + 4 + 4)
          = 40 B + 4 (7 S + 16 Q)

Against the H100 SXM's 3.35e12 B/s of HBM (NVIDIA's data sheet, at its 700 W power
limit; a card set below 700 W reaches less, so a run names the card's limit beside
the share). K1 does few operations a byte on these tables (Cornell: 1 sphere and 18
quads), and the bytes are the bound that cannot move with a better cull.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
RAY_IN = 12 + 12 + 4  # o, d, time
RAY_OUT = 4 + 4 + 4  # t, kind, idx


def bytes_moved(b: int, spheres: int, quads: int) -> int:
    return b * (RAY_IN + RAY_OUT) + 4 * (7 * spheres + 16 * quads)


def least_ms(b: int, spheres: int, quads: int) -> float:
    return 1e3 * bytes_moved(b, spheres, quads) / PEAK_BYTES_PER_S
