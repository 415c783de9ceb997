"""A launch of the render as one device program: CUDA graphs whose loops run on the card.

Counterpart of how the reference runs a launch: ``_chunk_film = jax.jit(...)``
(``tpupt/render/renderer.py:104``) compiles it whole, and each compaction stage of its
wavefront is a ``lax.while_loop`` on the device (``tpupt/render/integrator.py:306-322``).
Here the parts of ``StreamStages`` (render/integrator.py) are captured once with
``torch.cuda.CUDAGraph`` and chained in one CUDA graph (``csrc/loop_cond.cu``): each
stage a conditional WHILE node, whose body is the captured iteration followed by the
condition kernel, set once before the node as well, since ``lax.while_loop`` tests its
condition before the first body; the captured compactions between the stages. A
launch is one replay of a small captured reset and one ``cudaGraphLaunch`` of the
chain; the host reads the launch's counters (rays, iterations a stage) once.

The first launch of a shape runs its first wavefront iteration eagerly, which builds
what the kernels keep between calls (K1's packed tables, K4's wide tree, the packet
counters of the capture stream; none of which may be made under capture), then
captures and launches the chain from there. Later launches replay from the reset.

The captured parts share one memory pool, replayed in the order they were captured.
Graphs live as long as their ``LaunchGraphs`` (one ``render_image`` call). A failure to
capture, instantiate or launch raises and names the part; nothing falls back to the
eager loop. Kernel launch counts stay true: a wrapper called under capture counts the
call as captured, not launched, and each launch of the chain adds the captured calls
of a stage's body times the iterations the stage ran on the card.
"""

from __future__ import annotations

import ctypes
import time as _time

import torch

from ..core.dtypes import REAL
from ..ops import bvh_kernel, hit_kernel, loop_cond, tri_kernel
from .integrator import StreamStages


def _captured() -> dict:
    return {"K1": hit_kernel.captured, "K2": tri_kernel.captured["flat"],
            "K3": tri_kernel.captured["two_level"], "K4": bvh_kernel.captured}


def _zero_captured():
    hit_kernel.captured = 0
    tri_kernel.captured.update(flat=0, two_level=0)
    bvh_kernel.captured = 0


def _add_launches(n: dict):
    hit_kernel.launches += n["K1"]
    tri_kernel.launches["flat"] += n["K2"]
    tri_kernel.launches["two_level"] += n["K3"]
    bvh_kernel.launches += n["K4"]


def _node_types(graph: torch.cuda.CUDAGraph) -> dict:
    """{node type name: count} of a captured graph (``keep_graph=True``), its child
    graphs' nodes included."""
    counts = (ctypes.c_int * 32)()
    loop_cond.check(loop_cond.lib().tpupt_graph_census(graph.raw_cuda_graph(), counts, 32),
                    "census of a captured graph")
    return {loop_cond.NODE_TYPES.get(t, f"type {t}"): n for t, n in enumerate(counts) if n}


class LaunchGraphs:
    """The captured launches of one render call, by the arguments that stay constant
    over it. Use as a context manager, or call ``close()``."""

    def __init__(self):
        self._launches: dict[tuple, _Launch] = {}
        self.capture_s = 0.0  # capture and instantiation, host seconds

    def run(self, sd, cam, pix, rows, cols, lane_sample0, n_work0, *, spp_limit, seed, k, r, max_depth,
            has_lights):
        """One launch -> (film sum [B/r, 3] on the device, rays int, iterations int).

        pix, rows, cols, lane_sample0 [B] are the launch's lanes (r lanes a pixel);
        n_work0 is the count of lanes that start with a sample to take (lane_sample0 <
        spp_limit), known to the host. The film is a buffer of the graphs: valid until the
        next launch of the same shape.
        """
        if n_work0 == 0:  # no lane starts a sample: nothing to trace
            return torch.zeros((pix.shape[0] // r, 3), dtype=REAL, device=pix.device), 0, 0
        key = (id(sd), id(cam), pix.shape[0], spp_limit, seed, k, r, max_depth, has_lights)
        launch = self._launches.get(key)
        if launch is None:
            launch = self._launches[key] = _Launch(self, sd, cam, pix.shape[0], spp_limit, seed, k, r,
                                                   max_depth, has_lights, pix.device)
        return launch.run(pix, rows, cols, lane_sample0, n_work0)

    def close(self):
        for launch in self._launches.values():
            launch.close()
        self._launches.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Launch:
    """The graphs of one launch shape."""

    def __init__(self, owner, sd, cam, b, spp_limit, seed, k, r, max_depth, has_lights, device):
        self.owner = owner
        self.sd, self.cam = sd, cam  # the graphs read their tensors
        self.r = r
        self.st = StreamStages(sd, cam, b, spp_limit, seed, k, max_depth, has_lights, device)
        self.film = torch.empty((b // r, 3), dtype=self.st.bank.dtype, device=device)
        self.scratch = torch.zeros(2, dtype=torch.int32, device=device)  # the condition kernel's
        self.cond_out = torch.zeros(2, dtype=torch.int64, device=device)
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.reset_graph = None
        self.bodies, self.compactions, self.finish = [], [], None
        self.per_iteration = []  # kernel calls captured in each stage's body
        self.parents: dict[int, ctypes.c_void_p] = {}  # chains by their first stage

    # -- capture ---------------------------------------------------------------------

    def _capture(self, what, fn, keep_graph=True):
        g = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        _zero_captured()
        g.capture_begin(pool=self.pool)
        try:
            fn()
        except BaseException as e:
            try:
                g.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated; the first error is the one to report
            raise RuntimeError(f"render graph: capturing {what} failed: {e}") from e
        g.capture_end()
        return g, _captured()

    def _capture_all(self):
        st = self.st
        n = len(st.states)
        self.reset_graph, _ = self._capture("the launch's reset", st.reset, keep_graph=False)
        for i in range(n):
            body, calls = self._capture(f"the iteration of stage {i}", lambda i=i: st.step(i))
            kinds = _node_types(body)
            bad = sorted(set(kinds) - set(loop_cond.BODY_NODE_TYPES))
            if bad:
                raise RuntimeError(f"render graph: the iteration of stage {i} captured {bad} nodes "
                                   f"({kinds}); a WHILE node's body takes kernel, memcpy and memset nodes")
            self.bodies.append(body)
            self.per_iteration.append(calls)
            if i + 1 < n:
                self.compactions.append(self._capture(f"the compaction after stage {i}",
                                                      lambda i=i: st.compact(i))[0])

        def finish():
            st.finish()
            self.film.copy_(st.bank.reshape(self.r, -1, 3).sum(dim=0))

        self.finish, _ = self._capture("the launch's film", finish)

    def _parent(self, start):
        """The chain of stages start.. and the film, instantiated (made at first use)."""
        handle = self.parents.get(start)
        if handle is not None:
            return handle
        t0 = _time.perf_counter()
        lib, st = loop_cond.lib(), self.st
        handle = ctypes.c_void_p()
        loop_cond.check(lib.tpupt_loop_graph_create(ctypes.byref(handle)), "render graph: creating the chain")
        try:
            for i in range(start, len(st.states)):
                s = st.states[i]
                loop_cond.check(lib.tpupt_loop_graph_add_while(
                    handle, self.bodies[i].raw_cuda_graph(), s["alive"].data_ptr(), s["sample"].data_ptr(),
                    s["sample0"].data_ptr(), s["alive"].shape[0], st.k, st.spp_limit, st.thresholds[i],
                    self.scratch.data_ptr(), st.iters[i : i + 1].data_ptr(), self.cond_out.data_ptr(),
                ), f"render graph: adding the WHILE node of stage {i}")
                if i < len(self.compactions):
                    loop_cond.check(lib.tpupt_loop_graph_add_child(handle, self.compactions[i].raw_cuda_graph()),
                                    f"render graph: adding the compaction after stage {i}")
            loop_cond.check(lib.tpupt_loop_graph_add_child(handle, self.finish.raw_cuda_graph()),
                            "render graph: adding the launch's film")
            loop_cond.check(lib.tpupt_loop_graph_instantiate(handle), "render graph: instantiating the chain")
        except BaseException:
            lib.tpupt_loop_graph_destroy(handle)
            raise
        self.parents[start] = handle
        self.owner.capture_s += _time.perf_counter() - t0
        return handle

    # -- launches --------------------------------------------------------------------

    def _first(self, n_work0):
        """The first launch of the shape up to its first iteration, eagerly on the capture
        stream, then the capture of every part -> the stage the chain starts at."""
        st = self.st
        start = next(i for i, thr in enumerate(st.thresholds) if n_work0 > thr)
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            st.reset()
            for i in range(start):  # stages whose condition fails at once (known to the host)
                st.compact(i)
            st.step(start)  # the launch's first iteration, with every kernel launched for real
            st.iters[start] += 1
            torch.cuda.synchronize()
            t0 = _time.perf_counter()
            try:
                self._capture_all()
            except BaseException:  # no half-captured launch is kept: the next launch starts over
                self.reset_graph, self.bodies, self.compactions, self.per_iteration = None, [], [], []
                raise
            self.owner.capture_s += _time.perf_counter() - t0
        torch.cuda.current_stream().wait_stream(self.stream)
        return start

    def run(self, pix, rows, cols, lane_sample0, n_work0):
        st = self.st
        st.set_inputs(pix, rows, cols, lane_sample0)
        eager = [0] * len(st.states)
        if self.reset_graph is None:
            start = self._first(n_work0)
            eager[start] = 1
        else:
            start = 0
            self.reset_graph.replay()
        parent = self._parent(start)
        stream = torch.cuda.current_stream().cuda_stream
        loop_cond.check(loop_cond.lib().tpupt_loop_graph_launch(parent, stream), "render graph: launching the chain")
        counts = torch.cat([st.rays, st.iters]).tolist()  # the one host read of the launch
        rays, iters = counts[0], counts[1:]
        on_card = [n - e for n, e in zip(iters, eager)]
        calls = {key: sum(c[key] * n for c, n in zip(self.per_iteration, on_card)) for key in self.per_iteration[0]}
        _add_launches(calls)
        loop_cond.launches += (len(iters) - start) + sum(on_card)
        return self.film, rays, sum(iters)

    def close(self):
        if self.parents:
            torch.cuda.synchronize()
        for start, handle in list(self.parents.items()):
            del self.parents[start]
            loop_cond.check(loop_cond.lib().tpupt_loop_graph_destroy(handle), "render graph: destroying a chain")
        self.bodies, self.compactions, self.finish, self.reset_graph = [], [], None, None
