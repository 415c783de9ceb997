"""The conditions of the loops that run on the card (K5): the hand-written CUDA kernels of
``csrc/loop_cond.cu``, their plain PyTorch versions, and the bindings of the graphs of
conditional WHILE nodes (render/graph.py builds them).

- ``stage_cond``: a wavefront stage of the render, the condition of the reference's
  compaction stages, each a ``lax.while_loop`` on the device
  (``tpupt/render/integrator.py:306-322``);
- ``grad_gate``: a forward trip of the gradient pass, the reference's segment gate
  ``lax.cond(has_work, ...)`` (``tpupt/render/diff.py:232-244``), with the trip cap and
  the end of a chunk of trips;
- ``grad_countdown``: a backward trip, the reverse walk of the VJP of its ``lax.scan``
  (``tpupt/render/diff.py:246-248``).

Each launches its kernel for CUDA tensors and runs its ``*_plain`` version for CPU
tensors, with no fallback from one to the other. ``launches``, ``gate_launches`` and
``countdown_launches`` count the kernels' launches: the wrappers' own, and those inside
a graph, which render/graph.py adds from the graph's device counters after every launch
of it. ``stamp_launches`` counts apart the stamps of the card's clock in the chains
(``tpupt_loop_graph_add_stamp``; tpupt_torch/trace.py reads them).
"""

from __future__ import annotations

import ctypes

import torch

launches = 0  # stage condition launches since the last reset (plain-version calls not counted)
gate_launches = 0  # the gradient pass's gate, the same way
countdown_launches = 0  # the gradient pass's countdown, the same way
stamp_launches = 0  # stamps of the card's clock run in the chains (never counted in the above)

# the CUDA runtime's cudaGraphNodeType values; a loop's captured body may hold BODY_NODE_TYPES
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
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sig = {
            "tpupt_stage_cond": [P, P, P, I, I, I, I, P, P, P, P, I, P],
            "tpupt_grad_gate": [P, P, P, I, I, I, I, L, P, P, P, P, I, P],
            "tpupt_grad_countdown": [P, P, P, P, I, P],
            "tpupt_loop_graph_create": [ctypes.POINTER(ctypes.c_void_p)],
            "tpupt_loop_graph_add_child": [P, P],
            "tpupt_loop_graph_add_while": [P, P, P, P, P, I, I, I, I, P, P, P, P],
            "tpupt_loop_graph_add_stamp": [P, P, I, P, I],
            "tpupt_stamp": [P, I, P],
            "tpupt_loop_graph_add_gate_while": [P, P, P, P, P, I, I, I, I, L, P, P, P, P],
            "tpupt_loop_graph_add_countdown_while": [P, P, P, P, P, P],
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


def _check(alive, sample, sample0, k, spp_limit, thr, who="stage_cond"):
    n = alive.shape[0] if alive.dim() == 1 else -1
    if alive.shape != (n,) or sample.shape != (n,) or sample0.shape != (n,):
        raise ValueError(f"{who}: need alive, sample, sample0 [n]; got {tuple(alive.shape)}, "
                         f"{tuple(sample.shape)}, {tuple(sample0.shape)}")
    for name, x, dtype in (("alive", alive, torch.bool), ("sample", sample, torch.int32),
                           ("sample0", sample0, torch.int32)):
        if x.dtype != dtype:
            raise TypeError(f"{who}: {name} must be {dtype}, got {x.dtype}")
        if x.device != alive.device:
            raise ValueError(f"{who}: {name} is on {x.device}, alive on {alive.device}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if not (0 <= thr < 2**31 and 0 < k < 2**31 and 0 <= spp_limit < 2**31 and n < 2**31):
        raise ValueError(f"{who}: thr, k, spp_limit and n must fit int32 (thr >= 0, k > 0)")
    if alive.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {alive.device}")


def _check_counters(who, device, **counters):
    """Each counter a [size] int64 tensor on `device`, contiguous."""
    for name, (x, size) in counters.items():
        if x.shape != (size,) or x.dtype != torch.int64 or x.device != device or not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous [{size}] int64 tensor on {device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")


def stage_cond(alive, sample, sample0, k, spp_limit, thr, iters=None, bump=False, out=None, scratch=None,
               work=None):
    """The stage's condition -> out [2] int64: the lanes with work, and go = (that count
    > thr). bump adds one to iters ([1] int64); when go, the count is added to work ([1]
    int64), if given. CUDA tensors launch the kernel (which in a graph also sets the WHILE
    node's condition); CPU tensors run `stage_cond_plain`. On CUDA, out ([2] int64) and
    scratch ([2] int32, zero, and left zero by the kernel) may be given, else they are made
    for the call."""
    _check(alive, sample, sample0, k, spp_limit, thr)
    if bump and (iters is None or iters.shape != (1,) or iters.dtype != torch.int64
                 or iters.device != alive.device):
        raise ValueError("stage_cond: bump needs iters, a [1] int64 tensor on the lanes' device")
    if work is not None:
        _check_counters("stage_cond", alive.device, work=(work, 1))
    if alive.device.type == "cpu":
        return stage_cond_plain(alive, sample, sample0, k, spp_limit, thr, iters, bump, work)
    return _launch(alive, sample, sample0, k, spp_limit, thr, iters, bump, out, scratch, work)


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def _launch(alive, sample, sample0, k, spp_limit, thr, iters, bump, out, scratch, work):
    global launches
    dev = alive.device
    if scratch is None:
        scratch = torch.zeros(2, dtype=torch.int32, device=dev)
    if out is None:
        out = torch.empty(2, dtype=torch.int64, device=dev)
    stream = _stream(dev)
    err = lib().tpupt_stage_cond(
        alive.data_ptr(), sample.data_ptr(), sample0.data_ptr(), alive.shape[0], k, spp_limit, thr,
        scratch.data_ptr(), iters.data_ptr() if iters is not None else None,
        work.data_ptr() if work is not None else None, out.data_ptr(), int(bump), stream,
    )
    check(err, "stage_cond: the launch")
    launches += 1
    return out


def work_mask(alive, sample, sample0, k, spp_limit):
    """Lanes with work: a path in flight, or samples left (render/integrator.py)."""
    return alive | ((sample < k) & ((sample0 + sample) < spp_limit))


def stage_cond_plain(alive, sample, sample0, k, spp_limit, thr, iters=None, bump=False, work=None):
    """The kernel's function in eager PyTorch."""
    n = work_mask(alive, sample, sample0, k, spp_limit).sum()
    if bump:
        iters.add_(1)
    go = n > thr
    if work is not None:
        work.add_(torch.where(go, n, 0))
    return torch.stack([n, go.to(torch.int64)])


def grad_gate(alive, sample, sample0, k, spp_limit, segment, cap, trips, chunk, bump=False, out=None,
              scratch=None):
    """The gradient pass's gate after a forward trip -> out [2] int64: the lanes with work, and
    go. bump adds one to trips ([1] int64, the trips run); then go = trips < cap and trips <
    chunk[1] (chunk [2] int64: the chunk's first trip and its end) and, at a segment boundary
    (trips % segment == 0), some lane has work. CUDA tensors launch the kernel (which in a
    graph also sets the WHILE node's condition); CPU tensors run `grad_gate_plain`. out and
    scratch as in `stage_cond`."""
    _check(alive, sample, sample0, k, spp_limit, 0, "grad_gate")
    _check_counters("grad_gate", alive.device, trips=(trips, 1), chunk=(chunk, 2))
    if not (0 < segment < 2**31 and 0 <= cap < 2**62):
        raise ValueError(f"grad_gate: need 0 < segment < 2^31 and 0 <= cap < 2^62, got {segment}, {cap}")
    if alive.device.type == "cpu":
        return grad_gate_plain(alive, sample, sample0, k, spp_limit, segment, cap, trips, chunk, bump)
    global gate_launches
    dev = alive.device
    scratch = torch.zeros(2, dtype=torch.int32, device=dev) if scratch is None else scratch
    out = torch.empty(2, dtype=torch.int64, device=dev) if out is None else out
    err = lib().tpupt_grad_gate(
        alive.data_ptr(), sample.data_ptr(), sample0.data_ptr(), alive.shape[0], k, spp_limit, segment, cap,
        trips.data_ptr(), chunk.data_ptr(), scratch.data_ptr(), out.data_ptr(), int(bump), _stream(dev),
    )
    check(err, "grad_gate: the launch")
    gate_launches += 1
    return out


def grad_gate_plain(alive, sample, sample0, k, spp_limit, segment, cap, trips, chunk, bump=False):
    """The gate kernel's function in eager PyTorch."""
    n = work_mask(alive, sample, sample0, k, spp_limit).sum()
    if bump:
        trips.add_(1)
    t = trips[0]
    go = (t < cap) & (t < chunk[1]) & ((t % segment != 0) | (n > 0))
    return torch.stack([n, go.to(torch.int64)])


def grad_countdown(index, chunk, replays, bump=False, out=None):
    """The gradient pass's countdown after a backward trip -> out [2] int64: the trip index and
    go. bump takes one from index ([1] int64, the trip to replay next) and adds one to
    replays ([1] int64); then go = index >= chunk[0], the chunk's first trip. CUDA tensors
    launch the kernel; CPU tensors run `grad_countdown_plain`."""
    _check_counters("grad_countdown", index.device, index=(index, 1), chunk=(chunk, 2), replays=(replays, 1))
    if index.device.type == "cpu":
        return grad_countdown_plain(index, chunk, replays, bump)
    if index.device.type != "cuda":
        raise ValueError(f"grad_countdown: unsupported device {index.device}")
    global countdown_launches
    out = torch.empty(2, dtype=torch.int64, device=index.device) if out is None else out
    err = lib().tpupt_grad_countdown(index.data_ptr(), chunk.data_ptr(), replays.data_ptr(), out.data_ptr(),
                                     int(bump), _stream(index.device))
    check(err, "grad_countdown: the launch")
    countdown_launches += 1
    return out


def grad_countdown_plain(index, chunk, replays, bump=False):
    """The countdown kernel's function in eager PyTorch."""
    if bump:
        index.sub_(1)
        replays.add_(1)
    return torch.cat([index, (index >= chunk[0]).to(torch.int64)])
