"""Closest triangle over SAH clusters: the hand-written CUDA kernels of
``csrc/tri_kernel.cu``, their plain PyTorch versions, and the cluster packing.

Replaces ``tpupt/ops/pallas_tri.py``: ``_tri_cluster_kernel`` (the flat kernel
here, tables of at most FLAT_MAX_CLUSTERS clusters in superclusters of SC_FLAT)
and ``_tri_cluster_kernel_hbm`` (the two-level kernel, larger tables in
superclusters of at most MAX_SC_SIZE). Both cull three levels of boxes: top
boxes (unions of TOP_GROUP consecutive superclusters, derived from ``tri_scl``),
superclusters, clusters. See the kernel source for the contract, the bound and
the design.

``closest_tri`` routes by the scene compiler's flags; ``closest_tri_flat`` and
``closest_tri_two_level`` launch their kernel for CUDA tensors and run the plain
version for CPU tensors, with no fallback from one to the other. ``launches``
counts kernel launches per kernel; a call under CUDA graph capture launches nothing
and counts in ``captured`` (render/graph.py turns the captured calls into launches as
the graph runs them).

Packed layout (per cluster of up to 64 triangles, contiguous in SAH order):
  tri_cl   [Cp, 8]       cluster AABB: min xyz, max xyz, 0, 0 (pad rows at +1e30)
  tri_scl  [SCp, 8]      supercluster AABBs (unions of sc_size consecutive clusters)
  tri_geo  [Cp, 10, 64]  v0 xyz, e1 xyz, e2 xyz, triangle id (as float) per slot
  tri_attr [Cp, 16, 64]  n0, n1, n2 (xyz each), uv0, uv1, uv2, mat + HAS_UV_FLAG
Pad slots have zero edges (|a| < 1e-8 rejects them) and id BIG_IDF. The boxes
equal the reference's ``pack_clusters`` output; the blocks hold the same values
as its ``pk``/``pk2``, laid out component-major (``from_reference_packing``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import linalg as la
from ..core.dtypes import ORACLE_X64
from .bvh import CLUSTER_MAX

BIG = la.BIG
BIG_IDF = float(1 << 24)  # id of pad slots, exact in f32
HAS_UV_FLAG = float(1 << 20)  # added to the mat field when the triangle has UVs
SLOTS = CLUSTER_MAX  # triangle slots per cluster
GEO_ROWS = 10
ATTR_ROWS = 16
SC_FLAT = 64  # supercluster size of flat-kernel tables (the reference's VMEM grouping)
SC_TWO_LEVEL = 16  # supercluster size of two-level tables (the reference's TPUPT_SC_HBM)
FLAT_MAX_CLUSTERS = 768  # flat-kernel cut (the reference's CQX_MAX_CLUSTERS)
MAX_CLUSTERS = 32768  # two-level cut (the reference's MAX_HBM_CLUSTERS)
MAX_SC_SIZE = 32  # two-level tables: a supercluster's clusters fit one lane each
TOP_GROUP = 8  # superclusters per top box
PAD_BOX = 1e30  # every coordinate of a pad box

PLAIN_ELEMS = 1 << 22  # elements per [rays, boxes] or [pairs, 64] step of the plain versions

launches = {"flat": 0, "two_level": 0}  # kernel launches (plain-version calls not counted)
captured = {"flat": 0, "two_level": 0}  # calls recorded into a CUDA graph under capture


# ---------------------------------------------------------------------------
# packing (host, numpy)
# ---------------------------------------------------------------------------


def pack_clusters(tri_v0, tri_e1, tri_e2, clusters, tri_n0, tri_n1, tri_n2,
                  tri_uv0, tri_uv1, tri_uv2, tri_has_uv, tri_mat, sc_size=SC_FLAT):
    """Pack SAH clusters -> (cl_box [Cp,8], geo [Cp,10,64], attr [Cp,16,64], sc_box [SCp,8]).

    Inputs are the triangle tables in SAH order. Cp is the cluster count plus at
    least one pad cluster, rounded up to a whole supercluster (the reference's
    rule); SCp is the supercluster count rounded up to a multiple of 8.
    """
    if sc_size % 8 or not 8 <= sc_size:
        raise ValueError(f"sc_size must be a positive multiple of 8, got {sc_size}")
    c_real = clusters["start"].shape[0]
    cp = max(sc_size, ((c_real + 1 + sc_size - 1) // sc_size) * sc_size)

    cl_box = np.zeros((cp, 8), dtype=np.float32)
    cl_box[:, 0:6] = 1e30  # pad rows: a far point box no slab test passes
    cl_box[:c_real, 0:3] = clusters["bmin"]
    cl_box[:c_real, 3:6] = clusters["bmax"]

    n_sc = (cp + sc_size - 1) // sc_size
    sc_box = np.zeros((max(8, ((n_sc + 7) // 8) * 8), 8), dtype=np.float32)
    sc_box[:, 0:6] = 1e30
    for s in range(n_sc):
        lo, hi = s * sc_size, min((s + 1) * sc_size, c_real)
        if lo < hi:
            sc_box[s, 0:3] = clusters["bmin"][lo:hi].min(0)
            sc_box[s, 3:6] = clusters["bmax"][lo:hi].max(0)

    n = tri_v0.shape[0]
    if n >= 1 << 24:
        raise ValueError(f"{n} triangles: ids are stored as float32, exact below 2^24")
    local = np.arange(SLOTS)
    valid = local[None, :] < clusters["count"].astype(np.int64)[:, None]  # [C,64]
    gi = clusters["start"].astype(np.int64)[:, None] + np.where(valid, local[None, :], 0)
    geo_f = np.concatenate([tri_v0, tri_e1, tri_e2], axis=1).astype(np.float32)  # [N,9]
    matf = tri_mat.astype(np.float32) + tri_has_uv.astype(np.float32) * np.float32(HAS_UV_FLAG)
    attr_f = np.concatenate(
        [tri_n0, tri_n1, tri_n2, tri_uv0, tri_uv1, tri_uv2, matf[:, None]], axis=1
    ).astype(np.float32)  # [N,16]

    geo = np.zeros((cp, GEO_ROWS, SLOTS), dtype=np.float32)
    geo[:, 9, :] = BIG_IDF
    geo[:c_real, :9, :] = np.where(valid[:, None, :], geo_f[gi].transpose(0, 2, 1), 0.0)
    geo[:c_real, 9, :] = np.where(valid, gi, BIG_IDF)
    attr = np.zeros((cp, ATTR_ROWS, SLOTS), dtype=np.float32)
    attr[:c_real] = np.where(valid[:, None, :], attr_f[gi].transpose(0, 2, 1), 0.0)
    return cl_box, geo, attr, sc_box


def from_reference_packing(pk: np.ndarray, pk2: np.ndarray):
    """The reference's (Cp*8, 128) blocks -> (geo [Cp,10,64], attr [Cp,16,64]).

    The reference stores local triangle l of cluster c at row c*8 + l%8 and lanes
    (l//8)*16 + field; this is the same data, component-major.
    """
    cp = pk.shape[0] // 8

    def relayout(a):
        return np.ascontiguousarray(a.reshape(cp, 8, 8, 16).transpose(0, 3, 2, 1).reshape(cp, 16, SLOTS))

    return relayout(np.asarray(pk, np.float32))[:, :GEO_ROWS].copy(), relayout(np.asarray(pk2, np.float32))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def closest_tri(sd, o, d, t_in, tmin):
    """Closest triangle strictly closer than the seed t_in -> (t [B], idx [B] int32, aux).

    The contract of the reference's ``pallas_closest_tri``: only triangles with
    tmin < t < t_in count; misses have t = BIG and idx 0; idx indexes the
    SAH-ordered triangle tables; aux holds the winner's interpolated attributes,
    ns_raw [B,3] (unnormalised shading normal), u [B], v [B] (UVs when the
    triangle has them, else barycentrics) and mat [B] int32. Ties in t go to the
    lower triangle index.
    """
    if sd.has_tri_clusters:
        return closest_tri_flat(o, d, t_in, tmin, sd.tri_scl, sd.tri_cl, sd.tri_geo, sd.tri_attr)
    if sd.has_tri_clusters_hbm:
        return closest_tri_two_level(
            o, d, t_in, tmin, sd.tri_scl, sd.tri_cl, sd.tri_geo, sd.tri_attr, sd.tri_sc_size
        )
    raise ValueError("closest_tri: the scene was not compiled to cluster tables")


def _check(name, o, d, t_in, scl, cl, geo, attr, sc_size):
    if ORACLE_X64:
        raise NotImplementedError(
            f"{name}: the cluster routes order hits by float32 bits and do not run under the f64 "
            "oracle; compile meshes with bvh=None or bvh=True there (the stackless BVH)"
        )
    b = o.shape[0] if o.dim() == 2 else -1
    if o.shape != (b, 3) or d.shape != (b, 3) or t_in.shape != (b,):
        raise ValueError(
            f"{name}: need o [B,3], d [B,3], t_in [B]; got "
            f"{tuple(o.shape)}, {tuple(d.shape)}, {tuple(t_in.shape)}"
        )
    cp = cl.shape[0]
    if (cl.dim() != 2 or cl.shape[1] != 8 or geo.shape != (cp, GEO_ROWS, SLOTS)
            or attr.shape != (cp, ATTR_ROWS, SLOTS)):
        raise ValueError(
            f"{name}: need cl [C,8], geo [C,10,64], attr [C,16,64]; got "
            f"{tuple(cl.shape)}, {tuple(geo.shape)}, {tuple(attr.shape)}"
        )
    if scl.dim() != 2 or scl.shape[1] != 8:
        raise ValueError(f"{name}: need scl [S,8]; got {tuple(scl.shape)}")
    n_sc = cp // sc_size if sc_size > 0 else 0
    if n_sc < 1 or n_sc * sc_size != cp or scl.shape[0] < n_sc:
        raise ValueError(
            f"{name}: sc_size {sc_size} must divide the {cp} clusters, with one scl row per "
            f"supercluster (got {scl.shape[0]})"
        )
    tensors = (("o", o), ("d", d), ("t_in", t_in), ("scl", scl), ("cl", cl), ("geo", geo),
               ("attr", attr))
    for tname, x in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {x.dtype}")
        if x.device != o.device:
            raise ValueError(f"{name}: {tname} is on {x.device}, o on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    for tname, x in tensors[3:]:
        if x.requires_grad:
            raise ValueError(f"{name}: geometry takes no gradient; {tname} must not require grad")
    if b >= 2**31 or cp * SLOTS >= 2**31:
        raise ValueError(f"{name}: sizes must fit int32")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {o.device}")


def closest_tri_flat(o, d, t_in, tmin, scl, cl, geo, attr):
    """Cull over at most FLAT_MAX_CLUSTERS clusters in superclusters of SC_FLAT -> (t, idx, aux).

    CUDA tensors launch the flat kernel; CPU tensors run `closest_tri_flat_plain`.
    The outputs carry no gradient: the rays are taken detached, and tables that
    require grad raise.
    """
    if cl.dim() == 2 and cl.shape[0] > FLAT_MAX_CLUSTERS:
        raise ValueError(
            f"closest_tri_flat: {cl.shape[0]} clusters, the flat kernel takes at most "
            f"{FLAT_MAX_CLUSTERS}; use closest_tri_two_level"
        )
    _check("closest_tri_flat", o, d, t_in, scl, cl, geo, attr, SC_FLAT)
    o, d, t_in = o.detach(), d.detach(), t_in.detach()
    if o.device.type == "cpu":
        return closest_tri_flat_plain(o, d, t_in, tmin, scl, cl, geo, attr)
    return _launch("flat", o, d, t_in, tmin, scl, cl, geo, attr, SC_FLAT)


def closest_tri_two_level(o, d, t_in, tmin, scl, cl, geo, attr, sc_size):
    """Cull over superclusters of sc_size <= MAX_SC_SIZE clusters -> (t, idx, aux).

    CUDA tensors launch the two-level kernel; CPU tensors run
    `closest_tri_two_level_plain`. No gradient, as closest_tri_flat.
    """
    if not 0 < sc_size <= MAX_SC_SIZE:
        raise ValueError(f"closest_tri_two_level: sc_size {sc_size} must be in [1, {MAX_SC_SIZE}]")
    _check("closest_tri_two_level", o, d, t_in, scl, cl, geo, attr, sc_size)
    o, d, t_in = o.detach(), d.detach(), t_in.detach()
    if o.device.type == "cpu":
        return closest_tri_two_level_plain(o, d, t_in, tmin, scl, cl, geo, attr, sc_size)
    return _launch("two_level", o, d, t_in, tmin, scl, cl, geo, attr, sc_size)


_entry: dict[str, object] = {}  # the library's C functions, bound at first use
_counters: dict[tuple, torch.Tensor] = {}  # the kernels' packet counter of each (device, stream)


def _launch(which, o, d, t_in, tmin, scl, cl, geo, attr, sc_size):
    from .. import build

    if which not in _entry:
        lib = build.load("tri_kernel")
        P, I = ctypes.c_void_p, ctypes.c_int
        tables = [P, I] if which == "flat" else [I, I, P, I]  # cl, n_cl | n_sc, sc_size, cl, n_cl
        fn = getattr(lib, f"tpupt_closest_tri_{which}")
        # rays, tmin, scl | tables | geo, attr | t, id, ns, u, v, mat | n_rays, counter, stream
        fn.argtypes = [P, P, P, ctypes.c_float, P] + tables + [P] * 8 + [I, P, P]
        fn.restype = ctypes.c_int
        _entry[which] = fn
    b = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    i32 = dict(dtype=torch.int32, device=o.device)
    t, idx, ns = torch.empty(b, **f32), torch.empty(b, **i32), torch.empty((b, 3), **f32)
    u, v, mat = torch.empty(b, **f32), torch.empty(b, **f32), torch.empty(b, **i32)
    if which == "flat":
        tables = [cl.data_ptr(), cl.shape[0]]
    else:
        tables = [cl.shape[0] // sc_size, sc_size, cl.data_ptr(), cl.shape[0]]
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        # Launches on one stream run in turn, so they share a counter; each zeroes it first
        # (a memset node when captured).
        capturing = torch.cuda.is_current_stream_capturing()
        counter = _counters.get((o.device.index, stream))
        if counter is None:
            if capturing:
                raise RuntimeError(f"closest_tri_{which}: no packet counter for the capture stream; launch "
                                   "once on it before the capture")
            counter = _counters[(o.device.index, stream)] = torch.empty(1, **i32)
        err = _entry[which](
            o.data_ptr(), d.data_ptr(), t_in.data_ptr(), float(tmin), scl.data_ptr(), *tables,
            geo.data_ptr(), attr.data_ptr(), t.data_ptr(), idx.data_ptr(), ns.data_ptr(),
            u.data_ptr(), v.data_ptr(), mat.data_ptr(), b, counter.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"closest_tri_{which}: CUDA launch failed with error {err}")
    (captured if capturing else launches)[which] += 1
    return t, idx, dict(ns_raw=ns, u=u, v=v, mat=mat)


# ---------------------------------------------------------------------------
# plain versions (eager PyTorch, operation for operation with the kernels)
# ---------------------------------------------------------------------------


def _inv(dc):
    """Sign-preserving flush |d| < 1e-20 -> +-1e-20, then 1/d."""
    return 1.0 / torch.where(torch.abs(dc) < 1e-20, la.signed(dc < 0, 1e-20, dc), dc)


def _slab(box, ox, oy, oz, ix, iy, iz, tmin, limit):
    """Slab test; box [..., 8] broadcasts against the ray columns -> hit bool."""
    t1x = (box[..., 0] - ox) * ix
    t2x = (box[..., 3] - ox) * ix
    t1y = (box[..., 1] - oy) * iy
    t2y = (box[..., 4] - oy) * iy
    t1z = (box[..., 2] - oz) * iz
    t2z = (box[..., 5] - oz) * iz
    tn = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.maximum(torch.minimum(t1z, t2z), tmin),
    )
    tf = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.minimum(torch.maximum(t1z, t2z), limit),
    )
    return tn <= tf


def _mt(g, ox, oy, oz, dx, dy, dz, tmin, limit):
    """Möller–Trumbore (mesh.rs:50-82) with the kernels' rules -> (ok, t, u, v).

    g holds the geometry rows (v0 xyz, e1 xyz, e2 xyz) along dim 1.
    """
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (g[:, k] for k in range(9))
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(torch.abs(a) < 1e-8, 1.0, a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (
        (torch.abs(a) >= 1e-8) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
        & (u + v <= 1.0) & (t > tmin) & (t < limit)
    )
    return ok, t, u, v


_NO_HIT = torch.iinfo(torch.int64).max


def _sort_key(t):
    """float32 -> int64 whose order is t's order (for the (t, slot) lexicographic min)."""
    b = t.view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF).to(torch.int64)


class _Plain:
    """Shared state of a plain-version call: the rays, their running best (t, slot)
    key, and the counts of box and triangle tests."""

    def __init__(self, o, d, t_in, tmin, geo, counts):
        self.o, self.d, self.t_in, self.geo = o, d, t_in, geo
        self.tmin = torch.tensor(tmin, dtype=torch.float32, device=o.device)
        self.inv = torch.stack([_inv(d[:, k]) for k in range(3)], dim=1)
        self.best = torch.full((o.shape[0],), _NO_HIT, dtype=torch.int64, device=o.device)
        self.counts = counts
        if counts is not None:
            counts.setdefault("box_tests", 0)
            counts.setdefault("tri_tests", 0)
            self.real = (geo[:, 9, :] < BIG_IDF).sum(dim=1)  # real triangles per cluster

    def box_hits(self, rows, box, exists=None):
        """rows [R] ray ids, box [R or 1, K, 8] -> hit [R, K] against the seed.

        exists [R, K] bool (optional) marks the boxes that are there to test."""
        o, inv = self.o[rows, :, None], self.inv[rows, :, None]
        hit = _slab(box, o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2],
                    self.tmin, self.t_in[rows, None])
        if exists is not None:
            hit = hit & exists
        if self.counts is not None:
            self.counts["box_tests"] += hit.numel() if exists is None else int(exists.sum())
        return hit

    def clusters(self, rows, scs, cl, sc_size):
        """Cull the sc_size cluster boxes of (ray, supercluster) pairs, then test the
        triangles of the pairs that pass."""
        step = max(1, PLAIN_ELEMS // sc_size)
        for lo in range(0, rows.shape[0], step):
            r, s = rows[lo : lo + step], scs[lo : lo + step]
            cand = s[:, None] * sc_size + torch.arange(sc_size, device=s.device)
            pr, pk = torch.nonzero(self.box_hits(r, cl[cand]), as_tuple=True)
            self.triangles(r[pr], cand[pr, pk])

    def triangles(self, rows, clusters):
        """Fold the triangles of (ray, cluster) pairs into each ray's best key."""
        step = max(1, PLAIN_ELEMS // SLOTS)
        for lo in range(0, rows.shape[0], step):
            r, c = rows[lo : lo + step], clusters[lo : lo + step]
            o, d = self.o[r, :, None], self.d[r, :, None]
            ok, t, _, _ = _mt(self.geo[c], o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                              self.tmin, self.t_in[r, None])
            slot = c[:, None].to(torch.int64) * SLOTS + torch.arange(SLOTS, device=c.device)
            key = torch.where(ok, _sort_key(t) * 2**32 + slot, _NO_HIT).amin(dim=1)
            self.best.scatter_reduce_(0, r, key, reduce="amin")
            if self.counts is not None:
                self.counts["tri_tests"] += int(self.real[c].sum())

    def result(self, attr):
        """The winners' t, id and interpolated attributes (zeros where none won)."""
        found = self.best != _NO_HIT
        slot = torch.where(found, self.best & 0xFFFFFFFF, 0)
        c, j = slot // SLOTS, slot % SLOTS
        g = self.geo[c, :, j]  # [B,10]
        o, d = self.o, self.d
        _, t, u, v = _mt(g[:, :9, None], o[:, 0:1], o[:, 1:2], o[:, 2:3],
                         d[:, 0:1], d[:, 1:2], d[:, 2:3], self.tmin, self.t_in[:, None])
        t, u, v = t[:, 0], u[:, 0], v[:, 0]
        a = attr[c, :, j]  # [B,16]
        w = 1.0 - u - v
        ns = torch.stack(
            [a[:, k] * w + a[:, 3 + k] * u + a[:, 6 + k] * v for k in range(3)], dim=1
        )
        matf = a[:, 15]
        has_uv = matf >= HAS_UV_FLAG
        uu = torch.where(has_uv, a[:, 9] * w + a[:, 11] * u + a[:, 13] * v, u)
        vv = torch.where(has_uv, a[:, 10] * w + a[:, 12] * u + a[:, 14] * v, v)
        mat = torch.where(has_uv, matf - HAS_UV_FLAG, matf).to(torch.int32)
        zero = torch.zeros_like(u)
        aux = dict(
            ns_raw=torch.where(found[:, None], ns, 0.0),
            u=torch.where(found, uu, zero),
            v=torch.where(found, vv, zero),
            mat=torch.where(found, mat, 0),
        )
        t_out = torch.where(found, t, BIG)
        idx = torch.where(found, g[:, 9].to(torch.int32), 0)
        return t_out, idx, aux


def _ray_chunks(b, k, device):
    step = max(1, PLAIN_ELEMS // max(k, 1))
    for lo in range(0, b, step):
        yield torch.arange(lo, min(lo + step, b), device=device)


def top_boxes(scl, n_sc):
    """Unions of TOP_GROUP consecutive supercluster boxes -> [ceil(n_sc / TOP_GROUP), 8].

    Pad rows (min x at PAD_BOX) are left out; a group of pad rows gives a pad box.
    The kernels derive the same boxes in shared memory.
    """
    n_top = (n_sc + TOP_GROUP - 1) // TOP_GROUP
    rows = scl.new_full((n_top * TOP_GROUP, 8), PAD_BOX)
    rows[:n_sc] = scl[:n_sc]
    rows = rows.view(n_top, TOP_GROUP, 8)
    real = rows[:, :, 0:1] < PAD_BOX
    lo = torch.where(real, rows[:, :, 0:3], PAD_BOX).amin(dim=1)
    hi = torch.where(real, rows[:, :, 3:6], -PAD_BOX).amax(dim=1)
    hi = torch.where(hi[:, 0:1] < lo[:, 0:1], PAD_BOX, hi)
    return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], dim=1)


def _cull_plain(o, d, t_in, tmin, scl, cl, geo, attr, sc_size, counts):
    """Both kernels' function in eager PyTorch: top boxes, then the TOP_GROUP
    superclusters of each (ray, top box) pair that passes, then the sc_size clusters
    of each (ray, supercluster) pair that passes, then Möller–Trumbore on the (ray,
    cluster) pairs that pass. Each ray keeps the smallest (t, slot) key, which is
    the kernels' strict-< rule over clusters and slots in index order.
    """
    n_sc = cl.shape[0] // sc_size
    top = top_boxes(scl, n_sc)
    p = _Plain(o, d, t_in, tmin, geo, counts)
    step = max(1, PLAIN_ELEMS // TOP_GROUP)
    for rows in _ray_chunks(o.shape[0], top.shape[0], o.device):
        r, g = torch.nonzero(p.box_hits(rows, top[None]), as_tuple=True)
        r = rows[r]
        for lo in range(0, r.shape[0], step):
            rr, gg = r[lo : lo + step], g[lo : lo + step]
            cand = gg[:, None] * TOP_GROUP + torch.arange(TOP_GROUP, device=o.device)
            exists = cand < n_sc  # the last group may be short
            cand = cand.clamp(max=n_sc - 1)
            pr, pk = torch.nonzero(p.box_hits(rr, scl[cand], exists), as_tuple=True)
            p.clusters(rr[pr], cand[pr, pk], cl, sc_size)
    return p.result(attr)


def closest_tri_flat_plain(o, d, t_in, tmin, scl, cl, geo, attr, counts=None):
    """The flat kernel's function in eager PyTorch (`_cull_plain` over superclusters
    of SC_FLAT). `counts` (a dict) accumulates box_tests and tri_tests."""
    return _cull_plain(o, d, t_in, tmin, scl, cl, geo, attr, SC_FLAT, counts)


def closest_tri_two_level_plain(o, d, t_in, tmin, scl, cl, geo, attr, sc_size, counts=None):
    """The two-level kernel's function in eager PyTorch (`_cull_plain` over
    superclusters of sc_size): a ray tests a cluster's triangles when its top box,
    its supercluster box and its cluster box all pass, as in the kernel.
    """
    return _cull_plain(o, d, t_in, tmin, scl, cl, geo, attr, sc_size, counts)
