"""Counter-based stateless sampler: every draw is a pure function of
``(seed, pixel, sample, counter)``, bit-equal to ``tpupt/core/rng.py``.

The hash is PCG4D (Jarzynski & Olano, JCGT 2020). PyTorch has no unsigned 32-bit
add or shift, so the uint32 arithmetic is emulated in int64 and reduced with
``& 0xFFFFFFFF`` after every step. A product of two 32-bit values overflows
int64, so variable-by-variable products split one factor into 16-bit halves.

Draw-site counter map (one PCG4D call yields 4 independent uniforms):

    CTR_CAMERA    -> (aa_r, aa_theta, dof_r, dof_theta)
    CTR_TIME      -> (time, _, _, _)
    bounce_ctr(b)+SLOT_CTRL   -> (rr_u, mis_r, light_pick, lobe_r)
    bounce_ctr(b)+SLOT_BSDF   -> (e1, e2, fresnel_u, _)
    bounce_ctr(b)+SLOT_LIGHT  -> (u, v, _, _)
"""

from __future__ import annotations

import torch

from .tables import REAL

CTR_CAMERA = 0
CTR_TIME = 1
BOUNCE_BASE = 8
SLOTS_PER_BOUNCE = 4
SLOT_CTRL = 0
SLOT_BSDF = 1
SLOT_LIGHT = 2

_M32 = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223


def bounce_ctr(bounce):
    """First counter owned by bounce `bounce` (int or int tensor)."""
    return BOUNCE_BASE + bounce * SLOTS_PER_BOUNCE


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding uint32 values."""
    lo = a * (b & 0xFFFF)  # < 2^48
    hi = ((a * (b >> 16)) & 0xFFFF) << 16  # only the low 16 bits survive the shift
    return (lo + hi) & _M32


def _u32(x, like):
    if torch.is_tensor(x):
        return x.to(torch.int64) & _M32
    return torch.full_like(like, int(x) & _M32)


def _pcg4d(a, b, c, d):
    """PCG4D hash over int64 tensors holding uint32 values."""
    a = (a * _MUL + _INC) & _M32  # _MUL < 2^21: the product fits int64
    b = (b * _MUL + _INC) & _M32
    c = (c * _MUL + _INC) & _M32
    d = (d * _MUL + _INC) & _M32
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    return a, b, c, d


def _to_unit_float(u):
    """uint32 (in int64) -> float32 in [0, 1) from the top 24 bits."""
    return (u >> 8).to(REAL) * (1.0 / (1 << 24))


def uniform4(seed, pixel, sample, ctr):
    """Four independent uniforms in [0,1) per element.

    pixel and sample are integer tensors of one shape; seed and ctr are ints or
    integer tensors broadcastable to it. Values are taken mod 2^32, like the
    reference's uint32 cast.
    """
    pixel = pixel.to(torch.int64) & _M32
    sample, ctr, seed = (_u32(x, pixel) for x in (sample, ctr, seed))
    pixel, sample, ctr, seed = torch.broadcast_tensors(pixel, sample, ctr, seed)
    a, b, c, d = _pcg4d(pixel, sample, ctr, seed)
    return (_to_unit_float(a), _to_unit_float(b), _to_unit_float(c), _to_unit_float(d))


def uniform(seed, pixel, sample, ctr):
    """One uniform in [0,1) per element."""
    return uniform4(seed, pixel, sample, ctr)[0]
