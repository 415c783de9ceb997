"""Binned-SAH build of the triangle table and its cut into clusters (host side, numpy).

Counterpart of the build half of ``tpupt/ops/bvh.py``. The reference builds a
full-sweep SAH tree per mesh (bvh.rs:24-120, mesh.rs:195); here the standard
16-bin approximation gives the same tree quality at O(n) per level. The tree is
cut at subtrees of at most CLUSTER_MAX triangles; the cluster kernels
(ops/tri_kernel.py) cull whole clusters against a warp of rays and test every
triangle inside, so cluster AABB tightness is what buys their speed.

The stackless traversal (``bvh_closest_tri``), the Morton build and
``count_node_visits`` of the reference module wait for their port (ROADMAP).
"""

from __future__ import annotations

import numpy as np

from ..core.dtypes import NP_REAL

LEAF_SIZE = 4  # the reference's leaf bound (bvh.rs:22)
CLUSTER_MAX = 64  # triangles per cluster (the kernels' packed block width)
SAH_BINS = 16  # binned-SAH bin count
AABB_PAD = 1e-3  # the reference pads every AABB by 1e-3 (aabb.rs:16-21)


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
