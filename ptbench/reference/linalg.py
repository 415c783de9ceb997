"""Vector math over REAL tensors (float32, or float64 under the oracle): ``[..., 3]``
arrays and component 3-tuples.

Counterpart of ``tpupt/core/linalg.py``. Sums over xyz are written out left to
right (x + y) + z so their rounding is fixed and matches the reference's.
"""

from __future__ import annotations

import torch

from .tables import NP_REAL

BIG = float(NP_REAL(3.0e38))  # stand-in for +inf distances (keeps f32 arithmetic finite)

_bounds: dict = {}  # 0-d bound tensors by (value, dtype, device), made once


def _bound(x, value):
    key = (value, x.dtype, x.device)
    t = _bounds.get(key)
    if t is None:
        t = _bounds[key] = torch.tensor(value, dtype=x.dtype, device=x.device)
    return t


def signed(neg, value, like):
    """-value where neg, else value, in like's dtype (torch.where of two Python scalars
    would give the default float32 even under the f64 oracle)."""
    return torch.where(neg, _bound(like, -value), _bound(like, value))


def clamp_min(x, lo):
    """max(x, lo) as the reference computes it, gradient included: at a tie x == lo
    half the gradient reaches x (torch.clamp would pass all of it)."""
    return torch.maximum(x, _bound(x, lo))


def clip(x, lo, hi):
    """min(max(x, lo), hi), the reference's clip, with its half gradient at either tie."""
    return torch.minimum(torch.maximum(x, _bound(x, lo)), _bound(x, hi))


def length_sq(a):
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(a, eps=0.0):
    """a / |a|; eps floors the squared length."""
    n2 = length_sq(a)[..., None]
    if eps:
        n2 = clamp_min(n2, eps)
    return a / torch.sqrt(n2)


def luminance(c):
    """Rec.709 luma."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


# ---------------------------------------------------------------------------
# Component forms: 3-tuples of [B] tensors.
# ---------------------------------------------------------------------------


def unpack3(v):
    return v[..., 0], v[..., 1], v[..., 2]


def pack3(t):
    return torch.stack(t, dim=-1)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def neg3(a):
    return (-a[0], -a[1], -a[2])


def where3(m, a, b):
    return (
        torch.where(m, a[0], b[0]),
        torch.where(m, a[1], b[1]),
        torch.where(m, a[2], b[2]),
    )


def normalize3(a, eps=0.0):
    n2 = dot3(a, a)
    if eps:
        n2 = clamp_min(n2, max(eps, 1e-24))
    inv = 1.0 / torch.sqrt(n2)
    return scale3(a, inv)


def reflect3(i, n):
    """i - 2*dot(i,n)*n."""
    k = 2.0 * dot3(i, n)
    return (i[0] - k * n[0], i[1] - k * n[1], i[2] - k * n[2])


def refract3(i, n, eta):
    """GLSL refract; 0 on total internal reflection. i normalized, eta per-lane [B]."""
    ni = dot3(n, i)
    k = 1.0 - eta * eta * (1.0 - ni * ni)
    coef = eta * ni + torch.sqrt(clamp_min(k, 1e-20))
    ok = k >= 0.0
    return (
        torch.where(ok, eta * i[0] - coef * n[0], 0.0),
        torch.where(ok, eta * i[1] - coef * n[1], 0.0),
        torch.where(ok, eta * i[2] - coef * n[2], 0.0),
    )


def _quat_to_z3(n):
    """Quaternion (qx, qy, 0, qw) rotating n onto +z; n.z < -0.99999 flips about x."""
    x = n[1]
    y = -n[0]
    w = 1.0 + n[2]
    norm = torch.sqrt(clamp_min(x * x + y * y + w * w, 1e-24))
    degenerate = n[2] < -0.99999
    safe = clamp_min(norm, 1e-20)
    qx = torch.where(degenerate, 1.0, x / safe)
    qy = torch.where(degenerate, 0.0, y / safe)
    qw = torch.where(degenerate, 0.0, w / safe)
    return qx, qy, qw


def _quat_rotate3(qx, qy, qw, v):
    """Rotate v by unit quaternion (qx, qy, 0, qw): v + 2 q x (q x v + w v)."""
    q = (qx, qy, torch.zeros_like(qx))
    t = add3(cross3(q, v), scale3(v, qw))
    return add3(v, scale3(cross3(q, t), 2.0))


def to_local3(n, v):
    """World -> shading-local frame where n is +z."""
    qx, qy, qw = _quat_to_z3(n)
    return _quat_rotate3(qx, qy, qw, v)


def to_world3(n, v):
    """Shading-local -> world."""
    qx, qy, qw = _quat_to_z3(n)
    return _quat_rotate3(-qx, -qy, qw, v)


def f32(x) -> float:
    """A Python float holding x rounded to REAL: float32, or float64 under the oracle (a
    scalar that rounds like the reference's NP_REAL constants)."""
    return float(NP_REAL(x))
