"""Sphere + quad closest hit: the hand-written CUDA kernel ``csrc/hit_kernel.cu``
and its plain PyTorch version.

Replaces ``tpupt/ops/pallas_hit.py::_hit_kernel`` (see the kernel source for the
contract, its bound and its design). ``closest_sphere_quad`` launches the kernel
for CUDA tensors and runs the plain version for CPU tensors; there is no fallback
from one to the other. ``launches`` counts kernel launches; a call under CUDA graph
capture launches nothing and counts in ``captured`` (render/graph.py turns the
captured calls into launches as the graph runs them). The tables are never made
under capture: that raises.

Callers hand over the tables in the reference's layout (``tables``: sph [7,S],
quad [16,Q], padded at the tail). The kernel reads them packed primitive-major and
cut after the last real row (``pack_tables``); the packed pair is made at a table's
first use and kept with it, beside the boxes of the sphere table's tiles
(``sphere_tile_boxes``): a ray tests a tile of CULL_TILE consecutive spheres only if
it enters the tile's box, in the kernel and in the plain version alike.

What the cull saves is counted where a caller asks (``closest_sphere_quad(counts=...)``,
the render's stage runners): K1_COUNTS, summed over the calls into an int64 tensor, by the
kernel's culled variant and by the plain version alike. A table of one tile, which is
swept whole, counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import linalg as la
from ..core.dtypes import REAL

BIG = la.BIG
KIND_SPHERE = 0
KIND_QUAD = 1
SPH_ROWS = 7
QUAD_ROWS = 16
SPH_PACKED = 8  # floats of a packed sphere: c1 xyz, r, c2-c1 xyz, r*r
QUAD_PACKED = 16  # floats of a packed quad: n xyz, d, q xyz, u xyz, v xyz, w xyz
PLAIN_BLOCK = 64  # quads per step of the plain version's sweep
CULL_TILE = 8  # consecutive spheres under one box (the kernel's CULL_TILE)
BOX_FLOATS = 12  # a tile's box: lo xyz, 0, hi xyz, 0, centre xyz, half diagonal
PAD_BOX = 1.0e30  # lo = hi of a tile without a real sphere: no ray of the scene gets there
# Why the cull drops no hit. The sweep calls a ray a hit when its computed d2 = l2 - s*s
# is at most r*r. In float32 that d2 is the squared distance of the ray's line to the
# centre, less at most about (12 ulp + | |d|^2 - 1 |) l2, where l is the origin's distance
# to the centre and an ulp is 6e-8. So a hit's line passes within sqrt(r^2 + that error),
# which is at most r + sqrt(error), of the centre, at a point that lies on the half-line
# or as near to its origin. A box widened by sqrt(12 * 6e-8 + CULL_DIR) l = 3.3e-3 l
# still holds that point. CULL_MARGIN is larger, and for l stands an upper bound: the
# 1-norm distance of the origin to the box's centre plus the box's half diagonal. A ray
# whose |d|^2 is further than CULL_DIR from 1, whose time lies outside [0,1] (the span
# the boxes cover) or whose origin is not finite and below CULL_ORIGIN tests every tile.
CULL_MARGIN = 4.0e-3
CULL_DIR = 1.0e-5
CULL_ORIGIN = 1.0e30  # |o|_1 of a ray that may cull: keeps the box test finite

# the cull's counts, in the order of the kernel's counts buffer: rays; rays x the table's
# tiles; the tiles each ray enters (every tile for a ray that may not cull); over warps of 32
# consecutive rays, the tiles the warp swept (one of its rays entered them) x its rays
K1_COUNTS = ("k1_lanes", "k1_tile_slots", "k1_tiles_entered", "k1_tiles_swept")

launches = 0  # kernel launches since the last reset (plain-version calls not counted)
captured = 0  # calls recorded into a CUDA graph under capture since render/graph.py's last reset


_TABLE_FIELDS = ("sph_c1", "sph_c2", "sph_r", "quad_n", "quad_q", "quad_u", "quad_v", "quad_w", "quad_d")


def tables(sd):
    """Scene tables in the reference kernel's layout: sph [7,S], quad [16,Q] f32.

    Cached on the SceneData, with the kernel's packed tables, and made anew when a field
    they are made from was replaced or edited in place (its tensor or its version moved).
    """
    src = tuple(getattr(sd, f) for f in _TABLE_FIELDS)
    versions = tuple(t._version for t in src)
    cached = getattr(sd, "_hit_tables", None)
    if cached is None or any(a is not b for a, b in zip(cached[0], src)) or cached[1] != versions:
        _not_under_capture("the scene's tables")
        sph = torch.cat([sd.sph_c1.T, sd.sph_c2.T, sd.sph_r[None, :]], dim=0).contiguous()
        quad = torch.cat(
            [sd.quad_n.T, sd.quad_q.T, sd.quad_u.T, sd.quad_v.T, sd.quad_w.T, sd.quad_d[None, :]],
            dim=0,
        ).contiguous()
        if sph.device.type == "cuda":
            _packed(sph, quad)
        cached = (src, versions, (sph, quad))
        sd._hit_tables = cached
    return cached[2]


def real_rows(sph, quad):
    """(sphere rows, quad rows) up to and including the last real one.

    A sphere row with r < 0 and a quad row with a zero normal are pads: by the
    kernel's rules they hit nothing, so the rows after the last real one need no
    visit. Pads sit at the tail (scene/compile.py); one between real rows is kept,
    so that no index moves, and misses as before.
    """
    real_s = sph[6] >= 0
    real_q = (quad[0:3] != 0).any(dim=0)
    rows = torch.arange(1, max(sph.shape[1], quad.shape[1]) + 1, device=sph.device)
    last = torch.stack([(rows[: m.shape[0]] * m).max() if m.shape[0] else rows.new_zeros(())
                        for m in (real_s, real_q)])
    n_s, n_q = last.tolist()  # one host sync for both counts
    return n_s, n_q


def pack_tables(sph, quad):
    """The kernel's tables -> (sph_packed [n_s, 8], quad_packed [n_q, 16]), n = real_rows.

    Primitive-major, so that a slot is a few 16-byte reads: a sphere is c1 xyz, r,
    c2-c1 xyz, r*r; a quad n xyz, d, q xyz, u xyz, v xyz, w xyz. c2-c1 and r*r are
    the sweep's own float32 operations done once, so their bits are the inline ones.
    """
    n_s, n_q = real_rows(sph, quad)
    c1, c2, r = sph[0:3, :n_s], sph[3:6, :n_s], sph[6:7, :n_s]
    sph_packed = torch.cat([c1, r, c2 - c1, r * r], dim=0).T.contiguous()
    quad_packed = torch.cat([quad[0:3, :n_q], quad[15:16, :n_q], quad[3:15, :n_q]], dim=0).T.contiguous()
    return sph_packed, quad_packed


def sphere_tile_boxes(sph):
    """Boxes of the tiles of CULL_TILE consecutive spheres of sph [7,S]
    -> [ceil(S / CULL_TILE), 12]: lo xyz, 0, hi xyz, 0, centre xyz, half diagonal.

    A box holds its tile's real spheres at every time in [0,1]: the centre the sweep
    computes, c1 + (c2-c1)*time, lies between c1 and c1 + (c2-c1), since rounding is
    monotone. Spheres that can hit nothing (r < 0, a centre that is not finite) are
    left out; a tile of such rows gets a box at PAD_BOX.
    """
    n = -(-sph.shape[1] // CULL_TILE)
    c1, r = sph[0:3], sph[6:7]
    end = c1 + (sph[3:6] - c1)
    lo, hi = torch.minimum(c1, end) - r, torch.maximum(c1, end) + r
    real = (r >= 0) & torch.isfinite(lo).all(dim=0, keepdim=True) & torch.isfinite(hi).all(dim=0, keepdim=True)
    pad = (0, n * CULL_TILE - sph.shape[1])
    lo = torch.nn.functional.pad(torch.where(real, lo, torch.inf), pad, value=torch.inf)
    hi = torch.nn.functional.pad(torch.where(real, hi, -torch.inf), pad, value=-torch.inf)
    lo = lo.reshape(3, n, CULL_TILE).amin(dim=2)
    hi = hi.reshape(3, n, CULL_TILE).amax(dim=2)
    empty = (lo[0:1] > hi[0:1]).expand(3, n)
    lo, hi = torch.where(empty, PAD_BOX, lo), torch.where(empty, PAD_BOX, hi)
    zero = torch.zeros_like(lo[0:1])
    half = 0.5 * (hi - lo)
    return torch.cat([lo, zero, hi, zero, lo + half, half.norm(dim=0, keepdim=True)], dim=0).T.contiguous()


def _packed(sph, quad):
    """(sph_packed, quad_packed, boxes of sph_packed's tiles), made once and kept on the
    sph tensor beside the quad tensor and both tensors' versions, so that an edit in
    place packs anew."""
    cached = getattr(sph, "_hit_packed", None)
    if cached is None or cached[0] is not quad or cached[1] != (sph._version, quad._version):
        _not_under_capture("the packed tables")
        sph_packed, quad_packed = pack_tables(sph, quad)
        boxes = sphere_tile_boxes(sph[:, : sph_packed.shape[0]])
        cached = (quad, (sph._version, quad._version), (sph_packed, quad_packed, boxes))
        sph._hit_packed = cached
    return cached[2]


def _not_under_capture(what):
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"closest_sphere_quad: {what} would be made under CUDA graph capture (their "
                           "build reads the host); make them before the capture")


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
    real = torch.float32 if o.device.type == "cuda" else REAL  # the kernel is float32
    for name, x in (("o", o), ("d", d), ("time", time), ("sph", sph), ("quad", quad)):
        if x.dtype != real:
            raise TypeError(f"closest_sphere_quad: {name} must be {real}, got {x.dtype}")
        if x.device != o.device:
            raise ValueError(f"closest_sphere_quad: {name} is on {x.device}, o on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"closest_sphere_quad: {name} must be contiguous")
    if sph.requires_grad or quad.requires_grad:
        raise ValueError("closest_sphere_quad: geometry takes no gradient; sph and quad must not require grad")
    # the kernel's ray indices run up to a block's rays past B
    if b >= 2**31 - 2**25 or sph.shape[1] >= 2**27 or quad.shape[1] >= 2**27:
        raise ValueError("closest_sphere_quad: sizes must fit int32")


def closest_sphere_quad(o, d, time, sph, quad, tmin=1e-3, counts=None):
    """Closest sphere/quad hit per ray -> (t [B] f32, kind [B] int32, idx [B] int32).

    CUDA tensors launch the kernel; CPU tensors run `closest_sphere_quad_plain`.
    Either way the outputs carry no gradient: the rays are taken detached, and
    tables that require grad raise. counts, if given, is an int64 tensor [4] on the
    rays' device to which the call adds its K1_COUNTS; the hits do not depend on it.
    """
    _check(o, d, time, sph, quad)
    if counts is not None and (counts.shape != (len(K1_COUNTS),) or counts.dtype != torch.int64
                               or counts.device != o.device or not counts.is_contiguous()):
        raise ValueError(f"closest_sphere_quad: counts must be a contiguous int64 [{len(K1_COUNTS)}] tensor "
                         f"on {o.device}")
    o, d, time = o.detach(), d.detach(), time.detach()
    if o.device.type == "cpu":
        if counts is None:
            return closest_sphere_quad_plain(o, d, time, sph, quad, tmin)
        mine = {}
        out = closest_sphere_quad_plain(o, d, time, sph, quad, tmin, counts=mine)
        counts += torch.tensor([mine.get(key, 0) for key in K1_COUNTS], dtype=torch.int64)
        return out
    if o.device.type != "cuda":
        raise ValueError(f"closest_sphere_quad: unsupported device {o.device}")
    return _launch(o, d, time, sph, quad, tmin, counts)


def _launch(o, d, time, sph, quad, tmin, counts=None):
    global launches, captured
    from .. import build

    lib = build.load("hit_kernel")
    fn = lib.tpupt_closest_sphere_quad
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    sph_packed, quad_packed, boxes = _packed(sph, quad)
    b = o.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=o.device)
    kind = torch.empty(b, dtype=torch.int32, device=o.device)
    idx = torch.empty(b, dtype=torch.int32, device=o.device)
    if b == 0:
        return t, kind, idx  # nothing to launch, nothing counted
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(
        o.data_ptr(), d.data_ptr(), time.data_ptr(),
        sph_packed.data_ptr(), boxes.data_ptr(), sph_packed.shape[0],
        quad_packed.data_ptr(), quad_packed.shape[0], float(tmin),
        t.data_ptr(), kind.data_ptr(), idx.data_ptr(), b, None if counts is None else counts.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"closest_sphere_quad: CUDA launch failed with error {err}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return t, kind, idx


def _inv(dc):
    """Sign-preserving flush |d| < 1e-20 -> +-1e-20, then 1/d."""
    return 1.0 / torch.where(torch.abs(dc) < 1e-20, la.signed(dc < 0, 1e-20, dc), dc)


def closest_sphere_quad_plain(o, d, time, sph, quad, tmin=1e-3, counts=None, cull=True):
    """The kernel's function in eager PyTorch, operation for operation.

    Spheres go tile by tile (CULL_TILE rows under one box of `sphere_tile_boxes`): a ray
    tests a tile's spheres unless it may cull (time in [0,1], |d|^2 within CULL_DIR of 1,
    |o|_1 below CULL_ORIGIN) and misses the tile's box widened by CULL_MARGIN times its
    origin's distance to the box; a table whose real rows fit one tile is swept whole.
    Quads go in blocks of PLAIN_BLOCK. Within a tile or
    block the first minimal t wins, across them only a strictly smaller t replaces the
    best, which is the kernel's sequential strict-< rule. cull=False tests every tile:
    the same hits (the boxes are conservative), which the tests hold. counts (a dict)
    gets the ray x box, ray x sphere and ray x quad tests made over the rows up to the
    last real one, warp_sphere_tests: the ray x sphere tests when 32 consecutive
    rays sweep every tile that one of them enters, as the kernel's warps do, and, where the
    table is culled, the cull's K1_COUNTS as the kernel's culled variant counts them, its
    warps being 32 consecutive rays, the last one short where B is not a multiple of 32.
    """
    b = o.shape[0]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    tm = time[:, None]
    best_t = torch.full((b,), BIG, dtype=o.dtype, device=o.device)
    best_k = torch.zeros(b, dtype=torch.int32, device=o.device)
    best_i = torch.zeros(b, dtype=torch.int32, device=o.device)
    n_s, n_q = real_rows(sph, quad)
    cull = cull and n_s > CULL_TILE
    if counts is not None:
        counts.update(box_tests=0, sphere_tests=0, warp_sphere_tests=0, quad_tests=b * n_q)
        if cull:
            tiles = -(-n_s // CULL_TILE)
            counts.update(k1_lanes=b, k1_tile_slots=b * tiles)
            # the rays of each warp of 32 consecutive rays, the last one short
            warp_lanes = torch.full((-(-b // 32),), 32, dtype=torch.int64, device=o.device)
            warp_lanes[-1:] = b - 32 * (warp_lanes.shape[0] - 1)
            entered = swept = 0

    def fold(t, ok, base, kind):
        nonlocal best_t, best_k, best_i
        m, am = torch.where(ok, t, BIG).min(dim=1)
        better = m < best_t
        best_t = torch.where(better, m, best_t)
        best_k = torch.where(better, kind, best_k)
        best_i = torch.where(better, (am + base).to(torch.int32), best_i)

    if cull:
        boxes = sphere_tile_boxes(sph)
        may_cull = (
            (tm >= 0.0) & (tm <= 1.0)
            & (torch.abs(dx * dx + dy * dy + dz * dz - 1.0) <= CULL_DIR)
            & (torch.abs(ox) + torch.abs(oy) + torch.abs(oz) < CULL_ORIGIN)
        )
        ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
    step = CULL_TILE if cull else PLAIN_BLOCK
    for base in range(0, sph.shape[1], step):
        c1x, c1y, c1z, c2x, c2y, c2z, r = (row[None, :] for row in sph[:, base : base + step])
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
        ok = ~miss & (t > tmin)
        if cull:
            lo_x, lo_y, lo_z, _, hi_x, hi_y, hi_z, _, c_x, c_y, c_z, rad = boxes[base // CULL_TILE]
            m = CULL_MARGIN * (torch.abs(ox - c_x) + torch.abs(oy - c_y) + torch.abs(oz - c_z) + rad)
            t1x, t2x = (lo_x - m - ox) * ix, (hi_x + m - ox) * ix
            t1y, t2y = (lo_y - m - oy) * iy, (hi_y + m - oy) * iy
            t1z, t2z = (lo_z - m - oz) * iz, (hi_z + m - oz) * iz
            tn = torch.maximum(
                torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z)
            )
            tf = torch.minimum(
                torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z)
            )
            enters = ~may_cull | ((tn <= tf) & (tf >= 0.0))
            ok = ok & enters
        if counts is not None and base < n_s:
            rows = min(n_s, base + step) - base
            counts["box_tests"] += b if cull else 0
            counts["sphere_tests"] += (int(enters.sum()) if cull else b) * rows
            # what a kernel whose warp of 32 consecutive rays sweeps a tile together executes
            live = enters[:, 0] if cull else torch.ones(b, dtype=torch.bool, device=o.device)
            warps = torch.nn.functional.pad(live, (0, -b % 32)).reshape(-1, 32).any(dim=1)
            counts["warp_sphere_tests"] += int(warps.sum()) * 32 * rows
            if cull:
                entered = entered + live.sum()
                swept = swept + (warps * warp_lanes).sum()
        fold(t, ok, base, KIND_SPHERE)
    if counts is not None and cull:
        counts.update(k1_tiles_entered=int(entered), k1_tiles_swept=int(swept))

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
