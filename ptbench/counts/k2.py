"""Bytes that kernel K2 (``csrc/tri_kernel.cu``, ``closest_tri_flat_kernel``: closest
triangle of each ray over SAH clusters in one table) must move, from its arguments'
shapes: each input byte read once, each output byte written once.

    closest_tri_flat(o [B,3] f32, d [B,3] f32, t_in [B] f32,
                     scl [SC,8] f32, cl [C,8] f32, geo [C,10,64] f32, attr [C,16,64] f32)
        -> t [B] f32, idx [B] int32, ns_raw [B,3] f32, u [B] f32, v [B] f32, mat [B] int32

    bytes = B * (12 + 12 + 4) + 4 * (8 SC + 8 C + 640 C + 1024 C) + B * (4 + 4 + 12 + 4 + 4 + 4)
          = 60 B + 4 (8 SC + 1672 C)

Against the H100 SXM's 3.35e12 B/s of HBM (NVIDIA's data sheet, at its 700 W power
limit). The operations K2 does depend on its cull, so they are not counted: a later
cull that tests fewer triangles would read above a count tied to today's.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
RAY_IN = 12 + 12 + 4  # o, d, t_in
RAY_OUT = 4 + 4 + 12 + 4 + 4 + 4  # t, idx, ns_raw, u, v, mat


def bytes_moved(b: int, superclusters: int, clusters: int) -> int:
    return b * (RAY_IN + RAY_OUT) + 4 * (8 * superclusters + (8 + 10 * 64 + 16 * 64) * clusters)


def least_ms(b: int, superclusters: int, clusters: int) -> float:
    return 1e3 * bytes_moved(b, superclusters, clusters) / PEAK_BYTES_PER_S
