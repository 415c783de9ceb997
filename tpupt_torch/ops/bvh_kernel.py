"""Closest triangle by the BVH walk: the hand-written CUDA kernel
``csrc/bvh_kernel.cu`` (K4) and the packing of its tables.

Replaces ``tpupt/ops/bvh.py::bvh_closest_tri`` (a ``lax.while_loop``, not a Pallas
kernel; see the kernel source for the contract, the bound and the design). The
plain version is ``ops/bvh.py::bvh_closest_tri_plain``, the reference's stackless
walk of the binary tree. ``closest_tri_bvh`` launches the kernel for CUDA tensors
and runs the plain version for CPU tensors, with no fallback from one to the
other; ``launches`` counts kernel launches, ``captured`` the calls made under CUDA graph
capture (render/graph.py turns them into launches as the graph runs them).

The kernel walks a 4-wide collapse of the binary tree (``pack_wide``) with a short
stack, and gives the binary walk's answers bit for bit: every node's box is the
min/max union of the triangle boxes below it, so a child's slab interval lies
inside its parent's and a subtree the binary walk prunes holds only leaves that
fail their own test; the wide walk reaches every leaf whose exact box passes, in
the binary tree's DFS order, and tests that box against the running best before
its triangles, as the binary walk does. The tables are packed at their first use
on the card and kept with them:
  wide [W, 32] f32  a wide node in one 128-byte line: the children's boxes as SoA
                    (min x, max x, min y, max y, min z, max z: four floats each,
                    child k in lane k), then the children's references (int bits):
                    a wide node's index (>= 0), or ~(start * 8 + count) for a leaf;
                    an empty slot has NaN bounds, which no slab test passes.
  rows [T, 12] f32  v0, 0, e1, 0, e2, 0: a triangle in three float4.
  attr [T, 16] f32  n0, n1, n2, uv0, uv1, uv2, mat + HAS_UV_FLAG (the cluster
                    kernels' attribute rows), read once a ray, for the winner.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .bvh import LEAF_SIZE, bvh_closest_tri_plain
from .tri_kernel import HAS_UV_FLAG

launches = 0  # kernel launches since the last reset (plain-version calls not counted)
captured = 0  # calls recorded into a CUDA graph under capture since render/graph.py's last reset

WIDTH = 4  # children a wide node
STACK = 64  # entries of the kernel's per-thread stack (csrc/bvh_kernel.cu)
NODE_FLOATS = 8 * WIDTH  # a wide node: 6 * WIDTH bounds, WIDTH references, padded to whole lines
_COUNT_BITS = 3  # start * 8 + count: a leaf holds at most LEAF_SIZE < 8 triangles
assert LEAF_SIZE < 1 << _COUNT_BITS
ATTR_NAMES = ("n0", "n1", "n2", "uv0", "uv1", "uv2", "has_uv", "mat")


def scene_nodes(sd):
    """(nodes, tris, attr) of a SceneData, the table arguments closest_tri_bvh takes."""
    return ((sd.bvh_min, sd.bvh_max, sd.bvh_skip, sd.bvh_start, sd.bvh_count),
            (sd.tri_v0, sd.tri_e1, sd.tri_e2),
            (sd.tri_n0, sd.tri_n1, sd.tri_n2, sd.tri_uv0, sd.tri_uv1, sd.tri_uv2, sd.tri_has_uv, sd.tri_mat))


def wide_tree(skip, count, bmin, bmax):
    """Collapse a binary DFS tree -> (slots, stack bound).

    slots[w] lists the binary nodes that are wide node w's children, in the binary
    tree's DFS order; wide node 0 holds the root's children (or the root, when it is a
    leaf), and a slot that is an internal binary node is the next wide node in
    breadth-first order. A wide node starts from its binary node's children and
    replaces the internal child of largest surface area by its own children, in
    place, while they fit in WIDTH. The stack bound is the deepest stack a walk
    can reach when every child passes: each wide node pushes all its children, last
    first, and pops the first.
    """
    skip = np.asarray(skip).tolist()
    count = np.asarray(count).tolist()
    ext = np.maximum(np.asarray(bmax, np.float64) - np.asarray(bmin, np.float64), 0.0)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]).tolist()

    def kids(i):
        out, c = [], i + 1
        while c < skip[i]:
            out.append(c)
            c = skip[c]
        return out

    def expand(i):
        slots = kids(i)
        while True:
            pick = -1
            for j, s in enumerate(slots):
                if count[s] == 0 and len(slots) - 1 + len(kids(s)) <= WIDTH and (
                        pick < 0 or area[s] > area[slots[pick]]):
                    pick = j
            if pick < 0:
                return slots
            slots[pick : pick + 1] = kids(slots[pick])

    wide = [[0] if count[0] > 0 else expand(0)]
    first = [0]  # the stack depth when each wide node is fetched
    deepest = 0
    q = 0
    while q < len(wide):
        k = len(wide[q])
        deepest = max(deepest, first[q] + k)
        for j, s in enumerate(wide[q]):
            if count[s] == 0:
                wide.append(expand(s))
                first.append(first[q] + k - 1 - j)
        q += 1
    return wide, deepest


def pack_wide(nodes):
    """Binary node arrays -> (wide [W, NODE_FLOATS] float32 on the nodes' device, stack bound)."""
    bmin, bmax, skip, start, count = (x.cpu().numpy() for x in nodes)
    slots, deepest = wide_tree(skip, count, bmin, bmax)
    w = len(slots)
    node = np.full((w, WIDTH), -1, np.int64)
    for i, s in enumerate(slots):
        node[i, : len(s)] = s
    real = node >= 0
    at = np.where(real, node, 0)
    child = np.zeros((w, WIDTH), np.int64)  # each internal slot's wide node, in BFS order
    internal = real & (count[at] == 0)
    child[internal] = np.arange(1, int(internal.sum()) + 1)
    leaf = ~((start[at].astype(np.int64) << _COUNT_BITS) + count[at])
    ref = np.where(real, np.where(internal, child, leaf), -1).astype(np.int32)
    out = np.zeros((w, NODE_FLOATS), np.float32)
    for k, (table, axis) in enumerate(((bmin, 0), (bmax, 0), (bmin, 1), (bmax, 1), (bmin, 2), (bmax, 2))):
        out[:, WIDTH * k : WIDTH * (k + 1)] = np.where(real, table[at, axis], np.nan)
    out[:, 6 * WIDTH : 7 * WIDTH] = ref.view(np.float32)
    return torch.from_numpy(out).to(nodes[0].device), deepest


def pack_rows(tris) -> torch.Tensor:
    """(v0, e1, e2) [T,3] -> [T, 12] float32: v0, 0, e1, 0, e2, 0."""
    zero = torch.zeros_like(tris[0][:, :1])
    return torch.cat([x for v in tris for x in (v, zero)], dim=1).contiguous()


def pack_attr(attr) -> torch.Tensor:
    """The attribute tables -> [T, 16] float32 rows: n0, n1, n2, uv0, uv1, uv2, mat +
    HAS_UV_FLAG where the triangle has UVs (the cluster kernels' attribute rows)."""
    n0, n1, n2, uv0, uv1, uv2, has_uv, mat = attr
    matf = mat.to(torch.float32) + has_uv.to(torch.float32) * HAS_UV_FLAG
    return torch.cat([n0, n1, n2, uv0, uv1, uv2, matf[:, None]], dim=1).contiguous()


def _packed(nodes, tris, attr):
    """(wide, rows, attr rows) of the tables, made once and kept on the bmin tensor with
    the versions of every table, so that an edit in place packs anew. Raises when the
    tree needs a deeper stack than the kernel holds."""
    tables = (*nodes, *tris, *attr)
    key = tuple(x._version for x in tables)
    cached = getattr(nodes[0], "_bvh_packed", None)
    if cached is None or cached[0] != key or any(a is not b for a, b in zip(cached[1], tables[1:])):
        if nodes[0].is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("closest_tri_bvh: the wide tree would be packed under CUDA graph capture (the "
                               "packing reads the host); pack it before the capture")
        wide, deepest = pack_wide(nodes)
        if deepest > STACK:
            raise ValueError(f"closest_tri_bvh: the tree needs a stack of {deepest} entries, the kernel "
                             f"holds {STACK}")
        cached = (key, tables[1:], (wide, pack_rows(tris), pack_attr(attr)))
        nodes[0]._bvh_packed = cached
    return cached[2]


def _check(o, d, t_in, nodes, tris, attr):
    b = o.shape[0] if o.dim() == 2 else -1
    if o.shape != (b, 3) or d.shape != (b, 3) or t_in.shape != (b,):
        raise ValueError(f"closest_tri_bvh: need o [B,3], d [B,3], t_in [B]; got {tuple(o.shape)}, "
                         f"{tuple(d.shape)}, {tuple(t_in.shape)}")
    bmin, bmax, skip, start, count = nodes
    m = skip.shape[0]
    if bmin.shape != (m, 3) or bmax.shape != (m, 3) or start.shape != (m,) or count.shape != (m,):
        raise ValueError("closest_tri_bvh: need bmin, bmax [M,3] and skip, start, count [M]")
    t = tris[0].shape[0]
    if any(x.shape != (t, 3) for x in tris):
        raise ValueError("closest_tri_bvh: need v0, e1, e2 [T,3]")
    shapes = ((t, 3),) * 3 + ((t, 2),) * 3 + ((t,),) * 2
    if len(attr) != len(ATTR_NAMES) or any(x.shape != s for x, s in zip(attr, shapes)):
        raise ValueError("closest_tri_bvh: need attr n0, n1, n2 [T,3], uv0, uv1, uv2 [T,2], has_uv, mat [T]")
    if attr[6].dtype != torch.bool or attr[7].dtype != torch.int32:
        raise TypeError("closest_tri_bvh: has_uv must be bool and mat int32")
    real = torch.float32 if o.device.type == "cuda" else o.dtype
    floats = (("o", o), ("d", d), ("t_in", t_in), ("bmin", bmin), ("bmax", bmax),
              *zip(("v0", "e1", "e2"), tris), *zip(ATTR_NAMES[:6], attr[:6]))
    for name, x in floats:
        if x.dtype != real or x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"closest_tri_bvh: {name} must be float32 (or the CPU oracle's float64 "
                            f"throughout), got {x.dtype}")
    for name, x in (("o", o), ("d", d), ("t_in", t_in), *zip(("bmin", "bmax", "skip", "start", "count"), nodes),
                    *zip(("v0", "e1", "e2"), tris), *zip(ATTR_NAMES, attr)):
        if x.device != o.device:
            raise ValueError(f"closest_tri_bvh: {name} is on {x.device}, o on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"closest_tri_bvh: {name} must be contiguous")
    for name, x in floats[3:]:
        if x.requires_grad:
            raise ValueError(f"closest_tri_bvh: geometry takes no gradient; {name} must not require grad")
    if b >= 2**31 or t << _COUNT_BITS >= 2**31:
        raise ValueError("closest_tri_bvh: sizes must fit int32")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"closest_tri_bvh: unsupported device {o.device}")


def closest_tri_bvh(o, d, t_in, tmin, nodes, tris, attr):
    """Closest triangle hit by the BVH walk -> (t [B], idx [B] int32, aux).

    The contract of the cluster kernels' ``tri_kernel.closest_tri``: only triangles
    with tmin < t < t_in count, so a lane with t_in = 0 (dead) misses; a miss gives t =
    BIG, idx 0 and zero attributes; idx indexes the tree-ordered triangle tables; aux
    holds the winner's ns_raw [B,3], u, v [B] and mat [B] int32. nodes: (bmin [M,3],
    bmax [M,3], skip, start, count [M]); tris: (v0, e1, e2) [T,3]; attr: (n0, n1, n2,
    uv0, uv1, uv2, has_uv, mat) (``scene_nodes``). CUDA tensors launch the kernel;
    CPU tensors run `ops/bvh.py::bvh_closest_tri_plain`. The outputs carry no
    gradient: the rays are taken detached, and geometry that requires grad raises.
    """
    _check(o, d, t_in, nodes, tris, attr)
    o, d, t_in = o.detach(), d.detach(), t_in.detach()
    if o.device.type == "cpu":
        return bvh_closest_tri_plain(o, d, t_in, tmin, nodes, tris, attr)
    return _launch(o, d, t_in, tmin, nodes, tris, attr)[:3]


def walk_counts(o, d, t_in, tmin, nodes, tris, attr) -> dict:
    """One launch of the kernel's counting build on CUDA tensors -> the sums over the rays
    of wide-node fetches, triangle tests and steps (turns of the walk's loop), the most
    steps of one ray, and the deepest stack a ray reached."""
    _check(o, d, t_in, nodes, tris, attr)
    if o.device.type != "cuda":
        raise ValueError("walk_counts: the kernel's counts need CUDA tensors")
    per_ray = _launch(o.detach(), d.detach(), t_in.detach(), tmin, nodes, tris, attr, count=True)[3]
    sums = per_ray.to(torch.int64).sum(dim=0).tolist()
    most = per_ray.max(dim=0).values.tolist() if len(per_ray) else [0] * 4
    return dict(node_fetches=sums[0], tri_tests=sums[1], steps=sums[3], longest_walk=most[3],
                deepest_stack=most[2])


_entry: dict[bool, object] = {}  # the library's C functions, bound at first use
_counters: dict[tuple, torch.Tensor] = {}  # the kernel's packet counter of each (device, stream)


def _launch(o, d, t_in, tmin, nodes, tris, attr, count=False):
    global launches, captured
    from .. import build

    if count not in _entry:
        fn = getattr(build.load("bvh_kernel"), "tpupt_closest_tri_bvh_counts" if count else "tpupt_closest_tri_bvh")
        P, I = ctypes.c_void_p, ctypes.c_int
        # rays, tmin | wide, n_wide, rows, attr | t, idx, ns, u, v, mat | n_rays, counter, [counts], stream
        fn.argtypes = [P, P, P, ctypes.c_float, P, I, P, P] + [P] * 6 + [I, P] + [P] * count + [P]
        fn.restype = ctypes.c_int
        _entry[count] = fn
    wide, rows, attr_rows = _packed(nodes, tris, attr)
    b = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    i32 = dict(dtype=torch.int32, device=o.device)
    t, idx, ns = torch.empty(b, **f32), torch.empty(b, **i32), torch.empty((b, 3), **f32)
    u, v, mat = torch.empty(b, **f32), torch.empty(b, **f32), torch.empty(b, **i32)
    per_ray = torch.zeros((b, 4), **i32) if count else None
    if b == 0:
        return t, idx, dict(ns_raw=ns, u=u, v=v, mat=mat), per_ray  # nothing to launch, nothing counted
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        # Launches on one stream run in turn, so they share a counter; each zeroes it first
        # (a memset node when captured).
        capturing = torch.cuda.is_current_stream_capturing()
        counter = _counters.get((o.device.index, stream))
        if counter is None:
            if capturing:
                raise RuntimeError("closest_tri_bvh: no packet counter for the capture stream; launch once "
                                   "on it before the capture")
            counter = _counters[(o.device.index, stream)] = torch.empty(1, **i32)
        err = _entry[count](
            o.data_ptr(), d.data_ptr(), t_in.data_ptr(), float(tmin), wide.data_ptr(), wide.shape[0],
            rows.data_ptr(), attr_rows.data_ptr(), t.data_ptr(), idx.data_ptr(), ns.data_ptr(), u.data_ptr(),
            v.data_ptr(), mat.data_ptr(), b, counter.data_ptr(), *([per_ray.data_ptr()] if count else []), stream,
        )
    if err != 0:
        raise RuntimeError(f"closest_tri_bvh: CUDA launch failed with error {err}")
    if capturing:
        captured += 1
    else:
        launches += 1
    return t, idx, dict(ns_raw=ns, u=u, v=v, mat=mat), per_ray
