"""The condition of a wavefront stage: the hand-written CUDA kernel of
``csrc/loop_cond.cu``, its plain PyTorch version, and the bindings of the launch's
graph of conditional WHILE nodes (render/graph.py builds it).

Replaces the condition of the reference's compaction stages, each a
``lax.while_loop`` on the device (``tpupt/render/integrator.py:306-322``).
``stage_cond`` launches the kernel for CUDA tensors and runs ``stage_cond_plain`` for
CPU tensors, with no fallback from one to the other. ``launches`` counts the kernel's
launches: the wrapper's own, and those inside a launch's graph, which render/graph.py
adds from the graph's device counters after every launch of it.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0  # kernel launches since the last reset (plain-version calls not counted)

# cudaGraphNodeType values (driver_types.h) that a stage's captured body may hold
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait event", 7: "event record", 8: "external semaphore signal",
              9: "external semaphore wait", 10: "memory allocation", 11: "memory free",
              12: "batch memop", 13: "conditional"}
BODY_NODE_TYPES = ("kernel", "memcpy", "memset", "empty", "graph")

_lib = None


def lib() -> ctypes.CDLL:
    """The built library, its functions' signatures declared."""
    global _lib
    if _lib is None:
        from .. import build

        lib_ = build.load("loop_cond")
        P, I = ctypes.c_void_p, ctypes.c_int
        sig = {
            "tpupt_stage_cond": [P, P, P, I, I, I, I, P, P, P, I, P],
            "tpupt_loop_graph_create": [ctypes.POINTER(ctypes.c_void_p)],
            "tpupt_loop_graph_add_child": [P, P],
            "tpupt_loop_graph_add_while": [P, P, P, P, P, I, I, I, I, P, P, P],
            "tpupt_loop_graph_instantiate": [P],
            "tpupt_loop_graph_launch": [P, P],
            "tpupt_loop_graph_destroy": [P],
            "tpupt_graph_census": [P, ctypes.POINTER(ctypes.c_int), I],
        }
        for name, args in sig.items():
            fn = getattr(lib_, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib_.tpupt_cuda_error_string.argtypes = [I]
        lib_.tpupt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib_
    return _lib


def check(err: int, what: str) -> None:
    """Raise RuntimeError naming `what` when a CUDA call returned an error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib().tpupt_cuda_error_string(err).decode()})")


def _check(alive, sample, sample0, k, spp_limit, thr):
    n = alive.shape[0] if alive.dim() == 1 else -1
    if alive.shape != (n,) or sample.shape != (n,) or sample0.shape != (n,):
        raise ValueError(f"stage_cond: need alive, sample, sample0 [n]; got {tuple(alive.shape)}, "
                         f"{tuple(sample.shape)}, {tuple(sample0.shape)}")
    for name, x, dtype in (("alive", alive, torch.bool), ("sample", sample, torch.int32),
                           ("sample0", sample0, torch.int32)):
        if x.dtype != dtype:
            raise TypeError(f"stage_cond: {name} must be {dtype}, got {x.dtype}")
        if x.device != alive.device:
            raise ValueError(f"stage_cond: {name} is on {x.device}, alive on {alive.device}")
        if not x.is_contiguous():
            raise ValueError(f"stage_cond: {name} must be contiguous")
    if not (0 <= thr < 2**31 and 0 < k < 2**31 and 0 <= spp_limit < 2**31 and n < 2**31):
        raise ValueError("stage_cond: thr, k, spp_limit and n must fit int32 (thr >= 0, k > 0)")
    if alive.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stage_cond: unsupported device {alive.device}")


def stage_cond(alive, sample, sample0, k, spp_limit, thr, iters=None, bump=False, out=None, scratch=None):
    """The stage's condition -> out [2] int64: the lanes with work, and go = (that count
    > thr). bump adds one to iters ([1] int64). CUDA tensors launch the kernel (which in
    a graph also sets the WHILE node's condition); CPU tensors run `stage_cond_plain`.
    On CUDA, out ([2] int64) and scratch ([2] int32, zero, and left zero by the kernel)
    may be given, else they are made for the call."""
    _check(alive, sample, sample0, k, spp_limit, thr)
    if bump and (iters is None or iters.shape != (1,) or iters.dtype != torch.int64
                 or iters.device != alive.device):
        raise ValueError("stage_cond: bump needs iters, a [1] int64 tensor on the lanes' device")
    if alive.device.type == "cpu":
        return stage_cond_plain(alive, sample, sample0, k, spp_limit, thr, iters, bump)
    return _launch(alive, sample, sample0, k, spp_limit, thr, iters, bump, out, scratch)


def _launch(alive, sample, sample0, k, spp_limit, thr, iters, bump, out, scratch):
    global launches
    dev = alive.device
    if scratch is None:
        scratch = torch.zeros(2, dtype=torch.int32, device=dev)
    if out is None:
        out = torch.empty(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib().tpupt_stage_cond(
        alive.data_ptr(), sample.data_ptr(), sample0.data_ptr(), alive.shape[0], k, spp_limit, thr,
        scratch.data_ptr(), iters.data_ptr() if iters is not None else None, out.data_ptr(), int(bump), stream,
    )
    check(err, "stage_cond: the launch")
    launches += 1
    return out


def work_mask(alive, sample, sample0, k, spp_limit):
    """Lanes with work: a path in flight, or samples left (render/integrator.py)."""
    return alive | ((sample < k) & ((sample0 + sample) < spp_limit))


def stage_cond_plain(alive, sample, sample0, k, spp_limit, thr, iters=None, bump=False):
    """The kernel's function in eager PyTorch."""
    n = work_mask(alive, sample, sample0, k, spp_limit).sum()
    if bump:
        iters.add_(1)
    return torch.stack([n, (n > thr).to(torch.int64)])
