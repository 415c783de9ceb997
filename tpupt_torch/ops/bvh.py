"""Triangle BVHs: the Morton and binned-SAH builds (host side, numpy), the cut into
clusters, and the stackless traversal's plain version.

Counterpart of ``tpupt/ops/bvh.py``. The reference builds a full-sweep SAH tree
per mesh (bvh.rs:24-120, mesh.rs:195); here the standard 16-bin approximation
gives the same tree quality at O(n) per level. The tree is cut at subtrees of at
most CLUSTER_MAX triangles; the cluster kernels (ops/tri_kernel.py) cull whole
clusters against a warp of rays and test every triangle inside, so cluster AABB
tightness is what buys their speed.

Both builds emit the nodes in DFS pre-order with an escape ("skip") index per
node, which the stackless traversal walks with one cursor a ray: ``i + 1`` enters
a node's subtree, ``skip[i]`` passes it by, and a leaf (count > 0) holds up to
LEAF_SIZE contiguous triangles. ``bvh_closest_tri_plain`` is that walk in eager
PyTorch; the CUDA kernel of ``ops/bvh_kernel.py`` gives the same answers from a
4-wide collapse of the tree.
``count_node_visits`` is the reference's per-ray numpy instrumentation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import NP_REAL

LEAF_SIZE = 4  # the reference's leaf bound (bvh.rs:22)
CLUSTER_MAX = 64  # triangles per cluster (the kernels' packed block width)
SAH_BINS = 16  # binned-SAH bin count
AABB_PAD = 1e-3  # the reference pads every AABB by 1e-3 (aabb.rs:16-21)


# ---------------------------------------------------------------------------
# Morton build
# ---------------------------------------------------------------------------


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton codes. x: [N,3] in [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])


def build_tri_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, native: bool = True):
    """Morton build over [N] triangles -> (order [N], nodes dict of arrays).

    order is the Morton sort order (apply it to every per-triangle table); the nodes
    are bmin/bmax [M,3], skip [M], start [M], count [M] (count == 0 marks internal
    nodes; node 0 is the root), a balanced binary tree over the sorted range.
    Prefers the host library (tpupt_torch/native.py); this numpy version is the
    fallback and gives identical output.
    """
    if native:
        from .. import native as _native

        out = _native.build_tri_bvh(np.asarray(v0), np.asarray(e1), np.asarray(e2))
        if out is not None:
            return out
    n = v0.shape[0]
    v1 = v0 + e1
    v2 = v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2) - AABB_PAD
    hi = np.maximum(np.maximum(v0, v1), v2) + AABB_PAD
    cen = 0.5 * (lo + hi)
    span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
    order = np.argsort(_morton3((cen - cen.min(0)) / span), kind="stable").astype(np.int32)
    lo = lo[order]
    hi = hi[order]

    # pre-order emission with an explicit stack (meshes reach 10^4+ triangles)
    bmin, bmax, start, count = [], [], [], []
    work = [(0, n)]
    while work:
        a, b = work.pop()
        bmin.append(lo[a:b].min(0))
        bmax.append(hi[a:b].max(0))
        if b - a <= LEAF_SIZE:
            start.append(a)
            count.append(b - a)
        else:
            start.append(0)
            count.append(0)
            mid = (a + b) // 2
            work.append((mid, b))  # right below left: left pops first (pre-order)
            work.append((a, mid))

    # skip[i] = the first node after i's subtree: walk the same splits again with
    # each range's subtree node count (memoised by range size)
    sizes = {}

    def subtree_nodes(t: int) -> int:
        if t <= LEAF_SIZE:
            return 1
        if t not in sizes:
            m = t // 2
            sizes[t] = 1 + subtree_nodes(m) + subtree_nodes(t - m)
        return sizes[t]

    skip = np.zeros(len(bmin), dtype=np.int32)
    stack = [(0, n)]
    cursor = 0
    while stack:
        a, b = stack.pop()
        skip[cursor] = cursor + subtree_nodes(b - a)
        cursor += 1
        if b - a > LEAF_SIZE:
            mid = (a + b) // 2
            stack.append((mid, b))
            stack.append((a, mid))

    nodes = dict(
        bmin=np.asarray(bmin, dtype=NP_REAL),
        bmax=np.asarray(bmax, dtype=NP_REAL),
        skip=skip,
        start=np.asarray(start, dtype=np.int32),
        count=np.asarray(count, dtype=np.int32),
    )
    return order, nodes


# ---------------------------------------------------------------------------
# binned-SAH build and the cluster cut
# ---------------------------------------------------------------------------


def _half_area(lo: np.ndarray, hi: np.ndarray) -> float:
    d = np.maximum(hi - lo, 0.0)
    return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def build_tri_bvh_sah(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, native: bool = True):
    """Binned-SAH build -> (order [N], nodes dict, clusters dict).

    - order [N]: DFS leaf order (old index per new slot); apply it to every
      per-triangle table;
    - nodes: the stackless escape-index arrays bmin/bmax [M,3], skip/start/count [M]
      (count == 0 marks internal nodes; node 0 is the root);
    - clusters: the tree cut at subtrees of <= CLUSTER_MAX triangles, adjacent
      small ones merged: start [C], count [C], bmin [C,3], bmax [C,3]; the
      ranges are contiguous, sorted, and cover [0, N).

    Prefers the host library (tpupt_torch/native.py); this numpy version is the
    fallback and gives identical output.
    """
    if native:
        from .. import native as _native

        out = _native.build_tri_bvh_sah(np.asarray(v0), np.asarray(e1), np.asarray(e2))
        if out is not None:
            return out
    n = v0.shape[0]
    v1 = v0 + e1
    v2 = v0 + e2
    lo = (np.minimum(np.minimum(v0, v1), v2) - AABB_PAD).astype(np.float64)
    hi = (np.maximum(np.maximum(v0, v1), v2) + AABB_PAD).astype(np.float64)
    cen = 0.5 * (lo + hi)
    idx = np.arange(n, dtype=np.int64)

    bmin, bmax, start, count, skip = [], [], [], [], []
    cl_start, cl_count, cl_min, cl_max = [], [], [], []

    def _split(a: int, b: int) -> int:
        """Partition idx[a:b] in place by the cheapest SAH bin split -> split point."""
        seg = idx[a:b]
        c = cen[seg]
        cmin = c.min(0)
        cmax = c.max(0)
        slo = lo[seg]
        shi = hi[seg]
        best_cost = np.inf
        best = None  # (axis, split bin, bins)
        for axis in range(3):
            ext = cmax[axis] - cmin[axis]
            if ext < 1e-12:
                continue
            bins = np.minimum(
                ((c[:, axis] - cmin[axis]) * (SAH_BINS / ext)).astype(np.int64), SAH_BINS - 1
            )
            counts = np.bincount(bins, minlength=SAH_BINS)
            blo = np.full((SAH_BINS, 3), np.inf)
            bhi = np.full((SAH_BINS, 3), -np.inf)
            np.minimum.at(blo, bins, slo)
            np.maximum.at(bhi, bins, shi)
            # prefix (left of the split) and suffix (right) unions and counts
            plo = np.minimum.accumulate(blo, axis=0)
            phi = np.maximum.accumulate(bhi, axis=0)
            qlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            qhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            pc = np.cumsum(counts)
            n_seg = b - a
            for s in range(SAH_BINS - 1):  # split after bin s
                nl = pc[s]
                nr = n_seg - nl
                if nl == 0 or nr == 0:
                    continue
                cost = _half_area(plo[s], phi[s]) * nl + _half_area(qlo[s + 1], qhi[s + 1]) * nr
                if cost < best_cost:
                    best_cost = cost
                    best = (axis, s, bins)
        if best is not None:
            _, s, bins = best
            mask = bins <= s
        else:
            # degenerate (all centroids equal): median split on the largest axis
            axis = int(np.argmax(cmax - cmin)) if (cmax - cmin).max() > 0 else 0
            order_ax = np.argsort(c[:, axis], kind="stable")
            mask = np.zeros(b - a, dtype=bool)
            mask[order_ax[: (b - a) // 2]] = True
        left = seg[mask]
        right = seg[~mask]
        idx[a : a + len(left)] = left
        idx[a + len(left) : b] = right
        return a + len(left)

    # explicit-stack DFS pre-order emission; skip is patched when a subtree closes
    work = [("node", 0, n, False)]
    while work:
        tag, a, b, in_cluster = work.pop()
        if tag == "close":
            skip[a] = len(count)  # a is the node id here
            continue
        node_id = len(count)
        seg = idx[a:b]
        bmin.append(lo[seg].min(0))
        bmax.append(hi[seg].max(0))
        skip.append(0)
        work.append(("close", node_id, 0, False))
        if not in_cluster and (b - a) <= CLUSTER_MAX:
            cl_start.append(a)
            cl_count.append(b - a)
            cl_min.append(bmin[-1])
            cl_max.append(bmax[-1])
            in_cluster = True
        if b - a <= LEAF_SIZE:
            start.append(a)
            count.append(b - a)
        else:
            start.append(0)
            count.append(0)
            mid = _split(a, b)
            work.append(("node", mid, b, in_cluster))  # right below left
            work.append(("node", a, mid, in_cluster))

    nodes = dict(
        bmin=np.asarray(bmin, dtype=NP_REAL),
        bmax=np.asarray(bmax, dtype=NP_REAL),
        skip=np.asarray(skip, dtype=np.int32),
        start=np.asarray(start, dtype=np.int32),
        count=np.asarray(count, dtype=np.int32),
    )
    clusters = _merge_clusters(
        np.asarray(cl_start, dtype=np.int64),
        np.asarray(cl_count, dtype=np.int64),
        np.asarray(cl_min, dtype=np.float64),
        np.asarray(cl_max, dtype=np.float64),
    )
    return idx.astype(np.int32), nodes, clusters


def _merge_clusters(cl_start, cl_count, cl_min, cl_max):
    """Greedily merge adjacent clusters while the union stays <= CLUSTER_MAX.

    SAH cuts can leave small subtrees; merging adjacent (DFS-contiguous, hence
    spatially related) ranges cuts the pad waste of the fixed-64 packed blocks.
    """
    ms, mc, mlo, mhi = [], [], [], []
    for s, c, lo_, hi_ in zip(cl_start, cl_count, cl_min, cl_max):
        if ms and mc[-1] + c <= CLUSTER_MAX:
            mc[-1] += c
            mlo[-1] = np.minimum(mlo[-1], lo_)
            mhi[-1] = np.maximum(mhi[-1], hi_)
        else:
            ms.append(int(s))
            mc.append(int(c))
            mlo.append(lo_)
            mhi.append(hi_)
    return dict(
        start=np.asarray(ms, dtype=np.int32),
        count=np.asarray(mc, dtype=np.int32),
        bmin=np.asarray(mlo, dtype=NP_REAL),
        bmax=np.asarray(mhi, dtype=NP_REAL),
    )


# ---------------------------------------------------------------------------
# the stackless traversal
# ---------------------------------------------------------------------------


def count_node_visits(nodes, v0, e1, e2, o, d, tmin=1e-3, tmax=3e38):
    """Host-side traversal instrumentation -> (node visits a ray, leaf triangle tests a ray).

    The stackless walk of bvh_closest_tri_plain in numpy, one ray at a time; used
    to compare build quality.
    """
    visits = 0
    tri_tests = 0
    n_nodes = nodes["skip"].shape[0]
    for r in range(o.shape[0]):
        oo, dd = o[r], d[r]
        inv = 1.0 / np.where(np.abs(dd) < 1e-20, np.where(dd < 0, -1e-20, 1e-20), dd)
        best = tmax
        i = 0
        while i < n_nodes:
            visits += 1
            t1 = (nodes["bmin"][i] - oo) * inv
            t2 = (nodes["bmax"][i] - oo) * inv
            tn = max(np.minimum(t1, t2).max(), tmin)
            tf = min(np.maximum(t1, t2).min(), best)
            hit = tn <= tf
            if hit and nodes["count"][i] > 0:
                s, c = nodes["start"][i], nodes["count"][i]
                for k in range(s, s + c):
                    tri_tests += 1
                    h = np.cross(dd, e2[k])
                    a = float(e1[k] @ h)
                    if abs(a) < 1e-8:
                        continue
                    f = 1.0 / a
                    sv = oo - v0[k]
                    u = f * (sv @ h)
                    q = np.cross(sv, e1[k])
                    v = f * (dd @ q)
                    t = f * (e2[k] @ q)
                    if 0 <= u <= 1 and v >= 0 and u + v <= 1 and tmin < t < best:
                        best = t
            i = i + 1 if (hit and nodes["count"][i] == 0) else int(nodes["skip"][i])
    b = o.shape[0]
    return visits / b, tri_tests / b


def bvh_closest_tri_plain(o, d, t_in, tmin, nodes, tris, attr, counts=None):
    """Closest triangle by the stackless walk, in eager PyTorch -> (t [B], idx [B] int32, aux).

    nodes: (bmin [M,3], bmax [M,3], skip [M], start [M], count [M]); tris: (v0, e1,
    e2) [T,3] and attr: (n0, n1, n2 [T,3], uv0, uv1, uv2 [T,2], has_uv [T] bool, mat
    [T] int32), both in the tree's order; t_in [B] is each ray's tmax. Each ray
    carries a cursor from node 0: the slab test (1/d after the sign-preserving flush
    |d| < 1e-20 -> +-1e-20) passes when max(slabs, tmin) <= min(slabs, min(best t,
    t_in)), with min and max propagating NaN; a passed leaf tests its triangles in
    order by Möller–Trumbore and takes t when tmin < t < t_in and t < best, so a tie
    goes to the first triangle the walk meets; then the cursor moves to i + 1 from a
    passed internal node and to skip[i] otherwise. The loop runs on the host while
    any cursor is below M, over the rays still walking. A miss gives t = BIG and idx
    0; a NaN ray, and a ray with t_in = 0 (a dead lane), misses. aux holds the
    winner's attributes as the cluster kernels return them (``winner_attributes``).
    counts (a dict) accumulates box_tests (node visits) and tri_tests.
    """
    from ..core.linalg import BIG
    from .tri_kernel import _inv, _mt

    bmin, bmax, skip, start, count = nodes
    v0, e1, e2 = tris
    geo = torch.cat([v0, e1, e2], dim=1)  # [T,9], the rows _mt reads
    b, n_nodes = o.shape[0], skip.shape[0]
    dev, real = o.device, o.dtype
    tmin_t = torch.tensor(tmin, dtype=real, device=dev)
    inv = torch.stack([_inv(d[:, k]) for k in range(3)], dim=1)
    best_t = torch.full((b,), BIG, dtype=real, device=dev)
    best_i = torch.zeros(b, dtype=torch.int32, device=dev)
    best_u = torch.zeros(b, dtype=real, device=dev)
    best_v = torch.zeros(b, dtype=real, device=dev)
    cursor = torch.zeros(b, dtype=torch.int64, device=dev)
    skip, start, count = skip.long(), start.long(), count.long()
    if counts is not None:
        counts.setdefault("box_tests", 0)
        counts.setdefault("tri_tests", 0)
    rows = torch.arange(b, device=dev)
    while True:
        rows = rows[cursor[rows] < n_nodes]
        if rows.numel() == 0:
            break
        i = cursor[rows]
        oo, iv = o[rows], inv[rows]
        t1 = (bmin[i] - oo) * iv
        t2 = (bmax[i] - oo) * iv
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), torch.maximum(lo[:, 2], tmin_t))
        tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                           torch.minimum(hi[:, 2], torch.minimum(best_t[rows], t_in[rows])))
        hit = tn <= tf
        n = count[i]
        for k in range(LEAF_SIZE):
            on = hit & (k < n)
            r = rows[on]
            if r.numel() == 0:
                continue
            ti = start[i[on]] + k
            oo, dd = o[r], d[r]
            limit = best_t[r]
            ok, t, u, v = _mt(geo[ti], oo[:, 0], oo[:, 1], oo[:, 2], dd[:, 0], dd[:, 1], dd[:, 2],
                              tmin_t, limit)
            ok = ok & (t < t_in[r])
            best_t[r] = torch.where(ok, t, limit)
            best_i[r] = torch.where(ok, ti.to(torch.int32), best_i[r])
            best_u[r] = torch.where(ok, u, best_u[r])
            best_v[r] = torch.where(ok, v, best_v[r])
            if counts is not None:
                counts["tri_tests"] += int(r.numel())
        if counts is not None:
            counts["box_tests"] += int(rows.numel())
        cursor[rows] = torch.where(hit & (n == 0), i + 1, skip[i])
    return best_t, best_i, winner_attributes(best_t < BIG, best_i, best_u, best_v, attr)


def winner_attributes(found, idx, u, v, attr):
    """The winners' interpolated attributes, as the cluster kernels return them ->
    dict(ns_raw [B,3], u [B], v [B], mat [B] int32), zeros where found is false.

    idx indexes the attribute tables attr = (n0, n1, n2, uv0, uv1, uv2, has_uv, mat);
    u, v are the winners' barycentrics. With w = 1 - u - v: ns_raw = n0 w + n1 u + n2 v,
    and (u, v) become the interpolated UVs where the triangle has them.
    """
    n0, n1, n2, uv0, uv1, uv2, has_uv, mat = attr
    i = torch.where(found, idx, 0).long()
    w = 1.0 - u - v
    ns = n0[i] * w[:, None] + n1[i] * u[:, None] + n2[i] * v[:, None]
    a0, a1, a2, uv = uv0[i], uv1[i], uv2[i], has_uv[i]
    uu = torch.where(uv, a0[:, 0] * w + a1[:, 0] * u + a2[:, 0] * v, u)
    vv = torch.where(uv, a0[:, 1] * w + a1[:, 1] * u + a2[:, 1] * v, v)
    zero = torch.zeros_like(u)
    return dict(ns_raw=torch.where(found[:, None], ns, 0.0), u=torch.where(found, uu, zero),
                v=torch.where(found, vv, zero), mat=torch.where(found, mat[i], 0).to(torch.int32))
