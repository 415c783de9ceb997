"""Sphere + quad closest hit: the hand-written CUDA kernel ``csrc/hit_kernel.cu``
and its plain PyTorch version.

Replaces ``tpupt/ops/pallas_hit.py::_hit_kernel`` (see the kernel source for the
contract, its bound and its design). ``closest_sphere_quad`` launches the kernel
for CUDA tensors and runs the plain version for CPU tensors; there is no fallback
from one to the other. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import linalg as la

BIG = la.BIG
KIND_SPHERE = 0
KIND_QUAD = 1
SPH_ROWS = 7
QUAD_ROWS = 16
PLAIN_BLOCK = 64  # primitives per step of the plain version's sweep

launches = 0  # kernel launches since the last reset (plain-version calls not counted)


def tables(sd):
    """Scene tables in the reference kernel's layout: sph [7,S], quad [16,Q] f32.

    Cached on the SceneData: the tables are constant for a compiled scene.
    """
    cached = getattr(sd, "_hit_tables", None)
    if cached is None:
        sph = torch.cat([sd.sph_c1.T, sd.sph_c2.T, sd.sph_r[None, :]], dim=0).contiguous()
        quad = torch.cat(
            [sd.quad_n.T, sd.quad_q.T, sd.quad_u.T, sd.quad_v.T, sd.quad_w.T, sd.quad_d[None, :]],
            dim=0,
        ).contiguous()
        cached = (sph, quad)
        sd._hit_tables = cached
    return cached


def _check(o, d, time, sph, quad):
    b = o.shape[0] if o.dim() == 2 else -1
    if o.shape != (b, 3) or d.shape != (b, 3) or time.shape != (b,):
        raise ValueError(
            f"closest_sphere_quad: need o [B,3], d [B,3], time [B]; got "
            f"{tuple(o.shape)}, {tuple(d.shape)}, {tuple(time.shape)}"
        )
    if sph.dim() != 2 or sph.shape[0] != SPH_ROWS or quad.dim() != 2 or quad.shape[0] != QUAD_ROWS:
        raise ValueError(
            f"closest_sphere_quad: need sph [7,S] and quad [16,Q]; got "
            f"{tuple(sph.shape)}, {tuple(quad.shape)}"
        )
    for name, x in (("o", o), ("d", d), ("time", time), ("sph", sph), ("quad", quad)):
        if x.dtype != torch.float32:
            raise TypeError(f"closest_sphere_quad: {name} must be float32, got {x.dtype}")
        if x.device != o.device:
            raise ValueError(f"closest_sphere_quad: {name} is on {x.device}, o on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"closest_sphere_quad: {name} must be contiguous")
    if b >= 2**31 or sph.shape[1] >= 2**31 or quad.shape[1] >= 2**31:
        raise ValueError("closest_sphere_quad: sizes must fit int32")


def closest_sphere_quad(o, d, time, sph, quad, tmin=1e-3):
    """Closest sphere/quad hit per ray -> (t [B] f32, kind [B] int32, idx [B] int32).

    CUDA tensors launch the kernel; CPU tensors run `closest_sphere_quad_plain`.
    """
    _check(o, d, time, sph, quad)
    if o.device.type == "cpu":
        return closest_sphere_quad_plain(o, d, time, sph, quad, tmin)
    if o.device.type != "cuda":
        raise ValueError(f"closest_sphere_quad: unsupported device {o.device}")
    return _launch(o, d, time, sph, quad, tmin)


def _launch(o, d, time, sph, quad, tmin):
    global launches
    from .. import build

    lib = build.load("hit_kernel")
    fn = lib.tpupt_closest_sphere_quad
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    b = o.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=o.device)
    kind = torch.empty(b, dtype=torch.int32, device=o.device)
    idx = torch.empty(b, dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(
        o.data_ptr(), d.data_ptr(), time.data_ptr(),
        sph.data_ptr(), sph.shape[1], quad.data_ptr(), quad.shape[1], float(tmin),
        t.data_ptr(), kind.data_ptr(), idx.data_ptr(), b, stream,
    )
    if err != 0:
        raise RuntimeError(f"closest_sphere_quad: CUDA launch failed with error {err}")
    launches += 1
    return t, kind, idx


def closest_sphere_quad_plain(o, d, time, sph, quad, tmin=1e-3):
    """The kernel's function in eager PyTorch, operation for operation.

    Sweeps the tables in blocks of PLAIN_BLOCK primitives ([B, block] per step):
    within a block the first minimal t wins, across blocks only a strictly smaller
    t replaces the best, which is the kernel's sequential strict-< rule.
    """
    b = o.shape[0]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    tm = time[:, None]
    best_t = torch.full((b,), BIG, dtype=torch.float32, device=o.device)
    best_k = torch.zeros(b, dtype=torch.int32, device=o.device)
    best_i = torch.zeros(b, dtype=torch.int32, device=o.device)

    def fold(t, ok, base, kind):
        nonlocal best_t, best_k, best_i
        m, am = torch.where(ok, t, BIG).min(dim=1)
        better = m < best_t
        best_t = torch.where(better, m, best_t)
        best_k = torch.where(better, kind, best_k)
        best_i = torch.where(better, (am + base).to(torch.int32), best_i)

    for base in range(0, sph.shape[1], PLAIN_BLOCK):
        c1x, c1y, c1z, c2x, c2y, c2z, r = (row[None, :] for row in sph[:, base : base + PLAIN_BLOCK])
        cx = c1x + (c2x - c1x) * tm
        cy = c1y + (c2y - c1y) * tm
        cz = c1z + (c2z - c1z) * tm
        lx, ly, lz = cx - ox, cy - oy, cz - oz
        s = lx * dx + ly * dy + lz * dz
        l2 = lx * lx + ly * ly + lz * lz
        r2 = r * r
        d2 = l2 - s * s
        q = torch.sqrt(torch.clamp(r2 - d2, min=1e-20))
        t = torch.where(l2 > r2, s - q, s + q)
        miss = ((s < 0.0) & (l2 > r2)) | (d2 > r2) | (r < 0.0)
        fold(t, ~miss & (t > tmin), base, KIND_SPHERE)

    for base in range(0, quad.shape[1], PLAIN_BLOCK):
        (nx, ny, nz, qx, qy, qz, ux, uy, uz, vx, vy, vz, wx, wy, wz, dd) = (
            row[None, :] for row in quad[:, base : base + PLAIN_BLOCK]
        )
        nd = nx * dx + ny * dy + nz * dz
        no = nx * ox + ny * oy + nz * oz
        parallel = torch.abs(nd) < 1e-8
        t = (dd - no) / torch.where(parallel, 1.0, nd)
        px = ox + t * dx - qx
        py = oy + t * dy - qy
        pz = oz + t * dz - qz
        alpha = wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz) + wz * (px * vy - py * vx)
        beta = wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz) + wz * (ux * py - uy * px)
        miss = parallel | (alpha < 0.0) | (alpha > 1.0) | (beta < 0.0) | (beta > 1.0)
        fold(t, ~miss & (t > tmin), base, KIND_QUAD)

    return best_t, best_k, best_i
