"""Closest triangle by the stackless BVH walk: the hand-written CUDA kernel
``csrc/bvh_kernel.cu`` (K4) and the packing of its nodes.

Replaces ``tpupt/ops/bvh.py::bvh_closest_tri`` (a ``lax.while_loop``, not a Pallas
kernel; see the kernel source for the contract, the bound and the design). The
plain version is ``ops/bvh.py::bvh_closest_tri_plain``. ``closest_tri_bvh``
launches the kernel for CUDA tensors and runs the plain version for CPU tensors,
with no fallback from one to the other; ``launches`` counts kernel launches.

The kernel reads the nodes packed as two float4 a node (``pack_nodes``): bmin xyz
and skip, bmax xyz and start * 8 + count, the integers as their bits. The pack is
made at a node table's first use on the card and kept with it.
"""

from __future__ import annotations

import ctypes

import torch

from .bvh import LEAF_SIZE, bvh_closest_tri_plain

launches = 0  # kernel launches since the last reset (plain-version calls not counted)

_COUNT_BITS = 3  # start * 8 + count: a leaf holds at most LEAF_SIZE < 8 triangles
assert LEAF_SIZE < 1 << _COUNT_BITS


def scene_nodes(sd):
    """(bmin, bmax, skip, start, count) and (v0, e1, e2) of a SceneData, the
    arguments closest_tri_bvh takes."""
    return ((sd.bvh_min, sd.bvh_max, sd.bvh_skip, sd.bvh_start, sd.bvh_count),
            (sd.tri_v0, sd.tri_e1, sd.tri_e2))


def pack_nodes(nodes) -> torch.Tensor:
    """Node arrays -> [M, 8] float32: bmin xyz, skip | bmax xyz, start * 8 + count,
    the integers stored as their int32 bits."""
    bmin, bmax, skip, start, count = nodes
    leaf = start.to(torch.int32) * (1 << _COUNT_BITS) + count.to(torch.int32)
    rows = torch.cat([bmin.contiguous().view(torch.int32), skip.to(torch.int32)[:, None],
                      bmax.contiguous().view(torch.int32), leaf[:, None]], dim=1)
    return rows.contiguous().view(torch.float32)


def _packed(nodes) -> torch.Tensor:
    """pack_nodes(nodes), made once and kept on the bmin tensor with the versions of
    the five arrays, so that an edit in place packs anew."""
    key = tuple(x._version for x in nodes)
    cached = getattr(nodes[0], "_bvh_packed", None)
    if cached is None or cached[0] != key or any(a is not b for a, b in zip(cached[1], nodes[1:])):
        cached = (key, tuple(nodes[1:]), pack_nodes(nodes))
        nodes[0]._bvh_packed = cached
    return cached[2]


def _check(o, d, nodes, tris):
    b = o.shape[0] if o.dim() == 2 else -1
    if o.shape != (b, 3) or d.shape != (b, 3):
        raise ValueError(f"closest_tri_bvh: need o [B,3], d [B,3]; got {tuple(o.shape)}, {tuple(d.shape)}")
    bmin, bmax, skip, start, count = nodes
    m = skip.shape[0]
    if bmin.shape != (m, 3) or bmax.shape != (m, 3) or start.shape != (m,) or count.shape != (m,):
        raise ValueError("closest_tri_bvh: need bmin, bmax [M,3] and skip, start, count [M]")
    t = tris[0].shape[0]
    if any(x.shape != (t, 3) for x in tris):
        raise ValueError("closest_tri_bvh: need v0, e1, e2 [T,3]")
    real = torch.float32 if o.device.type == "cuda" else o.dtype
    for name, x in (("o", o), ("d", d), ("bmin", bmin), ("bmax", bmax), ("v0", tris[0]), ("e1", tris[1]),
                    ("e2", tris[2])):
        if x.dtype != real or x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"closest_tri_bvh: {name} must be float32 (or the CPU oracle's float64 "
                            f"throughout), got {x.dtype}")
    for name, x in (("o", o), ("d", d), *zip(("bmin", "bmax", "skip", "start", "count"), nodes),
                    *zip(("v0", "e1", "e2"), tris)):
        if x.device != o.device:
            raise ValueError(f"closest_tri_bvh: {name} is on {x.device}, o on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"closest_tri_bvh: {name} must be contiguous")
    for name, x in (("bmin", bmin), ("bmax", bmax), ("v0", tris[0]), ("e1", tris[1]), ("e2", tris[2])):
        if x.requires_grad:
            raise ValueError(f"closest_tri_bvh: geometry takes no gradient; {name} must not require grad")
    if b >= 2**31 or 2 * m >= 2**31 or t << _COUNT_BITS >= 2**31:
        raise ValueError("closest_tri_bvh: sizes must fit int32")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"closest_tri_bvh: unsupported device {o.device}")


def closest_tri_bvh(o, d, tmin, tmax, nodes, tris):
    """Closest triangle hit by the stackless walk -> (t [B], idx [B] int32).

    nodes: (bmin [M,3], bmax [M,3], skip, start, count [M]); tris: (v0, e1, e2) [T,3]
    (``scene_nodes``). idx indexes the tree-ordered triangle tables; a miss gives t =
    BIG and idx 0. CUDA tensors launch the kernel; CPU tensors run
    `ops/bvh.py::bvh_closest_tri_plain`. The outputs carry no gradient: the rays are
    taken detached, and geometry that requires grad raises.
    """
    _check(o, d, nodes, tris)
    o, d = o.detach(), d.detach()
    if o.device.type == "cpu":
        return bvh_closest_tri_plain(o, d, tmin, tmax, nodes, tris)
    return _launch(o, d, tmin, tmax, nodes, tris)


_entry = []  # the library's C function, bound at first use


def _launch(o, d, tmin, tmax, nodes, tris):
    global launches
    from .. import build

    if not _entry:
        fn = build.load("bvh_kernel").tpupt_closest_tri_bvh
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, F, F, P, I, P, P, P, P, P, I, P]
        fn.restype = ctypes.c_int
        _entry.append(fn)
    packed = _packed(nodes)
    b = o.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=o.device)
    idx = torch.empty(b, dtype=torch.int32, device=o.device)
    if b == 0:
        return t, idx  # nothing to launch, nothing counted
    v0, e1, e2 = tris
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = _entry[0](
        o.data_ptr(), d.data_ptr(), float(tmin), float(tmax), packed.data_ptr(), packed.shape[0],
        v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), t.data_ptr(), idx.data_ptr(), b, stream,
    )
    if err != 0:
        raise RuntimeError(f"closest_tri_bvh: CUDA launch failed with error {err}")
    launches += 1
    return t, idx
