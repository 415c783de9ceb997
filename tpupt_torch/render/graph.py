"""The reference's jitted programs as device programs: CUDA graphs whose loops run on the card.

Counterpart of how the reference runs a launch: ``_chunk_film = jax.jit(...)``
(``tpupt/render/renderer.py:104``) compiles it whole, and each compaction stage of its
wavefront is a ``lax.while_loop`` on the device (``tpupt/render/integrator.py:306-322``).
Here the parts of ``StreamStages`` (render/integrator.py) are captured once with
``torch.cuda.CUDAGraph`` and chained in one CUDA graph (``csrc/loop_cond.cu``): each
stage a conditional WHILE node, whose body is the captured iteration followed by the
condition kernel, set once before the node as well, since ``lax.while_loop`` tests its
condition before the first body; the captured compactions between the stages. A
launch is one replay of a small captured reset and one ``cudaGraphLaunch`` of the
chain; the host reads the launch's counters (rays, K1's counts of its tile cull,
iterations and lanes with work a stage) once, and with them the chain's stamps of the
card's clock: at its head, after each stage's WHILE node and after the film
(tpupt_torch/trace.py places them on the host's clock as ``card.chain`` and
``card.stage{i}``, a stage with the compaction before it).

The first launch of a shape runs its first wavefront iteration eagerly, which builds
what the kernels keep between calls (K1's packed tables, K4's wide tree, the packet
counters of the capture stream; none of which may be made under capture), then
captures and launches the chain from there. As ``jax.jit`` keeps ``_chunk_film``'s
program, ``launch_graphs`` keeps the graphs on the compiled scene, keyed by what fixes
a launch's work (lanes, spp_limit, k, r, max_depth, has_lights); lanes, seed and camera
are inputs copied into static tensors, so later launches and later calls replay from
the reset, with no capture and no eager iteration. Graphs whose scene moved (``_stamp``:
a tensor edited in place or replaced, a static field) are made anew.

The captured parts share one memory pool, replayed in the order they were captured. A
failure to capture, instantiate or launch raises and names the part; nothing falls back
to the eager loop. Kernel launch counts stay true: a wrapper called under capture counts
the call as captured, not launched, and each launch of the chain adds the captured calls
of a stage's body times the iterations the stage ran on the card.

The gradient passes (``GradGraphs``) are the counterparts of the reference's jitted
``_film_grads_step`` (``tpupt/render/diff.py:252-276``; ``FilmScanStages``), of its jitted
``_value_and_grad_call`` over the masked scan (``:434-442``; ``RadianceScanStages``,
render_grads) and of its jitted ``shard_map`` gradient step (``tpupt/parallel/sharding.py:
98-145``; segmented_film_vjp), a stage runner's parts captured the same way, in two chains.
The forward chain is a WHILE node whose body is one trip (its carry saved into the staging
buffer) and the segment gate, launched once a chunk of trips; the host reads the trips run
and the lanes with work once a chunk, and copies the chunk's saved rows out when another
chunk follows. The backward chain is a WHILE node whose body is one trip's replay with its
``autograd.grad``, counting down, launched once a chunk, newest first, after the chunk's
rows are copied back; under a mesh once a segment, each segment's gradient sums then taken
by a captured copy and all-reduced outside the graphs (a WHILE body takes kernel, memcpy
and memset nodes only). Each chain stamps the card's clock at its head and its tail: the
forward chain's stamps ride in the chunk's host read, the backward chain's (at a device
cursor, one launch after another) in the call's last read (``card.forward``,
``card.backward``). The first call of a configuration runs its first forward trip and
its first replay eagerly (they make what may not be made under capture) and captures; the
graphs stay on the compiled scene or the SceneData (``grad_graphs``, ``radiance_graphs``),
so later calls with another seed, cotangent or parameter values replay them, unless the
scene's geometry moved, which makes them anew.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import time as _time
import weakref

import torch

from .. import trace
from ..core.dtypes import REAL
from ..ops import bvh_kernel, hit_kernel, loop_cond, tri_kernel, wavefront_kernel
from .diff import DIFF_FIELDS, RADIANCE_SAVED, FilmScanStages, RadianceScanStages, chunk_trips
from .integrator import StreamStages


def _captured() -> dict:
    return {"K1": hit_kernel.captured, "K2": tri_kernel.captured["flat"],
            "K3": tri_kernel.captured["two_level"], "K4": bvh_kernel.captured,
            "regen": wavefront_kernel.captured["regen"], "shade": wavefront_kernel.captured["shade"]}


def _zero_captured():
    hit_kernel.captured = 0
    tri_kernel.captured.update(flat=0, two_level=0)
    bvh_kernel.captured = 0
    wavefront_kernel.captured.update(regen=0, shade=0)


def _add_launches(n: dict):
    hit_kernel.launches += n["K1"]
    tri_kernel.launches["flat"] += n["K2"]
    tri_kernel.launches["two_level"] += n["K3"]
    bvh_kernel.launches += n["K4"]
    wavefront_kernel.launches["regen"] += n["regen"]
    wavefront_kernel.launches["shade"] += n["shade"]


def _node_types(graph: torch.cuda.CUDAGraph) -> dict:
    """{node type name: count} of a captured graph (``keep_graph=True``), its child
    graphs' nodes included."""
    counts = (ctypes.c_int * 32)()
    loop_cond.check(loop_cond.lib().tpupt_graph_census(graph.raw_cuda_graph(), counts, 32),
                    "census of a captured graph")
    return {loop_cond.NODE_TYPES.get(t, f"type {t}"): n for t, n in enumerate(counts) if n}


def _capture(what, fn, pool, keep_graph=True):
    """fn captured into a CUDA graph in `pool` (None: a pool of its own) -> (graph, kernel
    calls captured). A failure raises RuntimeError naming `what`.

    Python's cyclic garbage collector is off during the capture: graphs kept in reference
    cycles (a LaunchGraphs and its launches) are freed only by it, and freeing a graph makes
    CUDA calls that a capture forbids, which would invalidate the capture."""
    g = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    _zero_captured()
    collecting = gc.isenabled()
    gc.disable()
    try:
        g.capture_begin(pool=pool)
        try:
            fn()
        except BaseException as e:
            try:
                g.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated; the first error is the one to report
            raise RuntimeError(f"{what} failed: {e}") from e
        try:
            g.capture_end()
        except RuntimeError as e:
            raise RuntimeError(f"{what} failed: {e}") from e
    finally:
        if collecting:
            gc.enable()
    return g, _captured()


def _body(what, graph) -> dict:
    """A captured loop body's census ({node type name: count}); raises unless it holds only
    the node types a WHILE node's body takes."""
    kinds = _node_types(graph)
    bad = sorted(set(kinds) - set(loop_cond.BODY_NODE_TYPES))
    if bad:
        raise RuntimeError(f"{what} captured {bad} nodes ({kinds}); a WHILE node's body takes kernel, "
                           "memcpy and memset nodes")
    return kinds


def _stamp(sd, inputs=DIFF_FIELDS) -> tuple:
    """What captured graphs assume of a SceneData besides the values of the fields in
    `inputs` (copied in at each call): the object, each other tensor's address and version,
    every static field's value, the inputs' shapes. The gradient graphs take the parameters
    as inputs; the render's graphs read every field where it lies (inputs=())."""
    out = [id(sd)]
    for f in dataclasses.fields(sd):
        v = getattr(sd, f.name)
        if f.name in inputs:
            out.append(tuple(v.shape))
        elif torch.is_tensor(v):
            out.append((v.data_ptr(), v._version))
        else:
            out.append(repr(v))
    return tuple(out)


def _destroy(chains: dict):
    """Free instantiated chains (on close, or when their owner is collected)."""
    for name in list(chains):
        loop_cond.lib().tpupt_loop_graph_destroy(chains.pop(name))


class LaunchGraphs:
    """Captured launches by the arguments that fix a launch's work: lanes, spp_limit, k, r,
    max_depth, has_lights. Seed, camera and lanes are inputs copied into static tensors at
    each launch, so a later launch or call of the same shape replays. ``launch_graphs``
    keeps one on a compiled scene; made alone, use it as a context manager or call
    ``close()``."""

    def __init__(self):
        self._launches: dict[tuple, _Launch] = {}
        self.capture_s = 0.0  # capture and instantiation, host seconds, summed over launches

    def run(self, sd, cam, pix, rows, cols, lane_sample0, n_work0, *, spp_limit, seed, k, r, max_depth,
            has_lights, counts=None):
        """One launch -> (film sum [B/r, 3] on the device, rays int, iterations int).

        pix, rows, cols, lane_sample0 [B] are the launch's lanes (r lanes a pixel);
        n_work0 is the count of lanes that start with a sample to take (lane_sample0 <
        spp_limit), known to the host. The film is a buffer of the graphs: valid until the
        next launch of the same shape. Graphs whose scene moved since their capture
        (``_stamp``) are dropped and made anew. counts (a dict), if given, gets the launch's
        "work_lanes", "lane_slots", "device_s", "fused_iterations" and K1's counts
        (``hit_kernel.K1_COUNTS``) added (``_Launch.run``).
        """
        if n_work0 == 0:  # no lane starts a sample: nothing to trace
            return torch.zeros((pix.shape[0] // r, 3), dtype=REAL, device=pix.device), 0, 0
        key = (pix.shape[0], spp_limit, k, r, max_depth, has_lights)
        launch = self._launches.get(key)
        if launch is not None and launch.stamp != _stamp(sd, inputs=()):
            launch.close()
            launch = None
        if launch is None:
            launch = self._launches[key] = _Launch(self, sd, cam, pix.shape[0], spp_limit, k, r, max_depth,
                                                   has_lights, pix.device)
        try:
            return launch.run(pix, rows, cols, lane_sample0, n_work0, seed, cam, counts)
        except BaseException:
            if launch.reset_graph is None:  # its capture failed: the next launch makes new graphs
                del self._launches[key]
                launch.close()
            raise

    def close(self):
        for launch in self._launches.values():
            launch.close()
        self._launches.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def launch_graphs(compiled) -> LaunchGraphs:
    """The render's launch graphs kept on `compiled` (the counterpart of ``_chunk_film``'s
    jit cache): made at first use, freed with the compiled scene."""
    graphs = compiled.__dict__.get("_launch_graphs")
    if graphs is None:
        graphs = compiled.__dict__["_launch_graphs"] = LaunchGraphs()
    return graphs


class _Launch:
    """The graphs of one launch shape."""

    def __init__(self, owner, sd, cam, b, spp_limit, k, r, max_depth, has_lights, device):
        self.owner = owner
        self.stamp = _stamp(sd, inputs=())
        self.sd = sd  # the graphs read its tensors
        self.r = r
        self.st = StreamStages(sd, cam, b, spp_limit, k, max_depth, has_lights, device)
        self.film = torch.empty((b // r, 3), dtype=self.st.bank.dtype, device=device)
        self.scratch = torch.zeros(2, dtype=torch.int32, device=device)  # the condition kernel's
        self.cond_out = torch.zeros(2, dtype=torch.int64, device=device)
        # the card's clock at the chain's head (0), after stage i's WHILE node (i + 1), after the film
        self.stamps = torch.zeros(len(self.st.states) + 2, dtype=torch.int64, device=device)
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.reset_graph = None
        self.bodies, self.compactions, self.finish = [], [], None
        self.per_iteration = []  # kernel calls captured in each stage's body
        self.body_nodes = []  # each stage's body: its graph's nodes, all types
        self.parents: dict[int, ctypes.c_void_p] = {}  # chains by their first stage
        weakref.finalize(self, _destroy, self.parents)

    # -- capture ---------------------------------------------------------------------

    def _capture(self, what, fn, keep_graph=True):
        return _capture(f"render graph: capturing {what}", fn, self.pool, keep_graph)

    def _capture_all(self):
        st = self.st
        n = len(st.states)
        self.reset_graph, _ = self._capture("the launch's reset", st.reset, keep_graph=False)
        for i in range(n):
            body, calls = self._capture(f"the iteration of stage {i}", lambda i=i: st.step(i))
            self.body_nodes.append(sum(_body(f"render graph: the iteration of stage {i}", body).values()))
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
        with trace.span("render.capture"):
            return self._make_parent(start)

    def _make_parent(self, start):
        t0 = _time.perf_counter()
        lib, st = loop_cond.lib(), self.st
        handle = ctypes.c_void_p()
        loop_cond.check(lib.tpupt_loop_graph_create(ctypes.byref(handle)), "render graph: creating the chain")
        n = len(st.states)

        def stamp(slot):
            loop_cond.check(lib.tpupt_loop_graph_add_stamp(handle, self.stamps.data_ptr(), slot, None, 0),
                            f"render graph: adding the stamp of slot {slot}")

        try:
            stamp(0)
            for i in range(start, n):
                s = st.states[i]
                loop_cond.check(lib.tpupt_loop_graph_add_while(
                    handle, self.bodies[i].raw_cuda_graph(), s["alive"].data_ptr(), s["sample"].data_ptr(),
                    s["sample0"].data_ptr(), s["alive"].shape[0], st.k, st.spp_limit, st.thresholds[i],
                    self.scratch.data_ptr(), st.iters[i : i + 1].data_ptr(), st.work[i : i + 1].data_ptr(),
                    self.cond_out.data_ptr(),
                ), f"render graph: adding the WHILE node of stage {i}")
                stamp(i + 1)
                if i < len(self.compactions):
                    loop_cond.check(lib.tpupt_loop_graph_add_child(handle, self.compactions[i].raw_cuda_graph()),
                                    f"render graph: adding the compaction after stage {i}")
            loop_cond.check(lib.tpupt_loop_graph_add_child(handle, self.finish.raw_cuda_graph()),
                            "render graph: adding the launch's film")
            stamp(n + 1)
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
            st.work[start] += n_work0  # what the stage's condition would have counted
            torch.cuda.synchronize()
            t0 = _time.perf_counter()
            try:
                self._capture_all()
            except BaseException:  # nothing half-captured is kept (LaunchGraphs drops this launch)
                self.reset_graph, self.bodies, self.compactions, self.per_iteration = None, [], [], []
                self.body_nodes = []
                raise
            self.owner.capture_s += _time.perf_counter() - t0
        torch.cuda.current_stream().wait_stream(self.stream)
        return start

    def run(self, pix, rows, cols, lane_sample0, n_work0, seed, cam, counts=None):
        st = self.st
        n = len(st.states)
        with trace.span("render.inputs"):
            st.set_inputs(pix, rows, cols, lane_sample0, seed, cam)
        eager = [0] * n
        if self.reset_graph is None:
            with trace.span("render.capture") as sp:
                start = self._first(n_work0)
                if sp is not None:
                    sp.attrs["body_nodes"] = list(self.body_nodes)
            eager[start] = 1
        else:
            start = 0
            self.reset_graph.replay()
        parent = self._parent(start)
        stream = torch.cuda.current_stream().cuda_stream
        with trace.span("render.wait") as wait:
            loop_cond.check(loop_cond.lib().tpupt_loop_graph_launch(parent, stream),
                            "render graph: launching the chain")
            # the one host read of the launch
            read = torch.cat([st.rays, st.k1_counts, st.iters, st.work, self.stamps]).tolist()
        m = 1 + len(hit_kernel.K1_COUNTS)
        rays, k1, read = read[0], read[1:m], read[m:]
        iters, work, stamps = read[:n], read[n : 2 * n], read[2 * n :]
        on_card = [i - e for i, e in zip(iters, eager)]
        calls = {key: sum(c[key] * i for c, i in zip(self.per_iteration, on_card)) for key in self.per_iteration[0]}
        _add_launches(calls)
        loop_cond.launches += (n - start) + sum(on_card)
        loop_cond.stamp_launches += n - start + 2
        slots = [i * size for i, size in zip(iters, st.sizes)]
        if counts is not None:
            counts["work_lanes"] = counts.get("work_lanes", 0) + sum(work)
            counts["lane_slots"] = counts.get("lane_slots", 0) + sum(slots)
            counts["device_s"] = counts.get("device_s", 0.0) + 1e-9 * (stamps[n + 1] - stamps[0])
            counts["fused_iterations"] = counts.get("fused_iterations", 0) + (sum(iters) if st.fused else 0)
            for key, c in zip(hit_kernel.K1_COUNTS, k1):
                counts[key] = counts.get(key, 0) + c
        if wait is not None:
            trace.card(wait, "card.chain", stamps[0], stamps[n + 1], first_stage=start)
            for i in range(start, n):
                trace.card(wait, f"card.stage{i}", stamps[0] if i == start else stamps[i], stamps[i + 1],
                           iterations=iters[i], work_lanes=work[i], lane_slots=slots[i])
        return self.film, rays, sum(iters)

    def close(self):
        if self.parents:
            torch.cuda.synchronize()
        _destroy(self.parents)
        self.bodies, self.compactions, self.finish, self.reset_graph = [], [], None, None


# ---- the gradient passes -----------------------------------------------------------------


class _Kept(dict):
    """Graphs by configuration, kept on the object whose id is ``owner``."""

    def __init__(self, owner):
        super().__init__()
        self.owner = id(owner)


def _kept(owner, name, key, stamp, make):
    """The graphs kept on `owner` under `name` and `key`, made by make() at first use. Graphs
    whose scene moved since their capture (their stamp is not `stamp`) or that were closed
    are dropped and made anew. The cache belongs to `owner` alone: a shallow copy of it
    (``apply_params`` copies a SceneData) starts its own."""
    cache = owner.__dict__.get(name)
    if cache is None or cache.owner != id(owner):
        cache = owner.__dict__[name] = _Kept(owner)
    graphs = cache.get(key)
    if graphs is not None and (graphs.closed or graphs.stamp != stamp):
        graphs.close()
        graphs = None
    if graphs is None:
        graphs = cache[key] = make()
    return graphs


def grad_graphs(compiled, camera, cam, lanes, spp, k, r, segment_size) -> GradGraphs:
    """render_film_grads' graphs of one configuration of `compiled`: kept on it, keyed by the
    lanes, k, r, spp, max_depth, has_lights, segment_size, the chunk and the camera; made at
    the configuration's first call and replayed by the later ones. Graphs whose scene moved
    since their capture (``_stamp``: an edit in place, a replaced tensor or field) are
    dropped and made anew. cam is the camera's data on the scene's device."""
    sd = compiled.data
    chunk = chunk_trips(lanes, k, camera.max_depth, segment_size)
    key = (lanes, k, r, spp, camera.max_depth, compiled.has_lights, segment_size, chunk, repr(camera))
    return _kept(compiled, "_grad_graphs", key, _stamp(sd), lambda: GradGraphs(sd, lambda: FilmScanStages(
        sd, cam, lanes, spp, k, camera.max_depth, compiled.has_lights, sd.device, segment_size, chunk)))


def radiance_graphs(owner, sd, cam, lanes, max_depth, has_lights, segment_size) -> GradGraphs:
    """The masked scan's graphs (``RadianceScanStages``) of one configuration, kept on `owner`
    (render_grads: the compiled scene; segmented_film_vjp: the SceneData), keyed by the
    lanes, max_depth, has_lights, segment_size and the chunk; remade as ``grad_graphs``' are.
    Lanes, seed, cotangent, parameter values and the camera are inputs."""
    chunk = chunk_trips(lanes, 1, max_depth, segment_size or max(max_depth, 1), saved=RADIANCE_SAVED)
    key = (lanes, max_depth, has_lights, segment_size, chunk)
    return _kept(owner, "_radiance_graphs", key, _stamp(sd), lambda: GradGraphs(sd, lambda: RadianceScanStages(
        sd, cam, lanes, max_depth, has_lights, sd.device, segment_size, chunk)))


class GradGraphs:
    """The captured gradient pass of one configuration, over a stage runner (``TripStages``:
    ``FilmScanStages`` or ``RadianceScanStages``, made by make() on the graphs' stream).

    A call is ``forward(*inputs)`` (-> trips; inputs as the runner's ``set_inputs``), then
    ``backward(mesh=None)`` (-> output, grads, rays). capture_s, host_reads, chunks, trips,
    device_forward_s and device_backward_s (the card's time in the chains, from their
    stamps) describe the last call.
    """

    def __init__(self, sd, make):
        self.stamp = _stamp(sd)
        self.stream = torch.cuda.Stream(sd.device)
        with torch.cuda.stream(self.stream):
            self.st = make()
        self.pool = torch.cuda.graph_pool_handle()
        self.reset_graph = self.take_graph = None
        # the card's clock at the forward chain's head and tail; the backward chain's, a launch
        # after another at a cursor that the reset zeroes (a launch a chunk, or a segment)
        dev = sd.device
        self.stamps_forward = torch.zeros(2, dtype=torch.int64, device=dev)
        self.stamps_backward = torch.zeros(2 * (self.st.cap // self.st.segment), dtype=torch.int64, device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.bodies, self.calls = {}, {}  # "forward", "backward": captured body, kernel calls in it
        self.chains: dict[str, ctypes.c_void_p] = {}  # "forward", "backward": instantiated chain
        weakref.finalize(self, _destroy, self.chains)
        self.closed = False
        self.capture_s, self.host_reads, self.chunks, self.trips = 0.0, 0, 0, 0
        self.device_forward_s = self.device_backward_s = 0.0
        self._chunks, self._eager_replays, self._backward_launches = [], 0, 0
        self._backward_spans = []  # the span open at each backward launch (a recording on)

    # -- capture ---------------------------------------------------------------------

    def _capture_body(self, name, fn):
        body, calls = _capture(f"gradient graph: capturing the {name} trip", fn, self.pool)
        _body(f"gradient graph: the {name} trip", body)
        self.bodies[name], self.calls[name] = body, calls

    def _chain(self, name):
        """The chain of one loop over the body `name`, instantiated."""
        lib, st = loop_cond.lib(), self.st
        handle = ctypes.c_void_p()
        loop_cond.check(lib.tpupt_loop_graph_create(ctypes.byref(handle)), f"gradient graph: creating the {name} chain")
        if name == "forward":
            stamps, slots, cursor = self.stamps_forward, (0, 1), None
        else:
            stamps, slots, cursor = self.stamps_backward, (0, 0), self.cursor.data_ptr()

        def stamp(slot):
            loop_cond.check(lib.tpupt_loop_graph_add_stamp(handle, stamps.data_ptr(), slot, cursor, stamps.shape[0]),
                            f"gradient graph: adding a stamp to the {name} chain")

        try:
            stamp(slots[0])
            body = self.bodies[name].raw_cuda_graph()
            if name == "forward":
                alive, sample, sample0, k, spp_limit = st.gate_lanes()
                err = lib.tpupt_loop_graph_add_gate_while(
                    handle, body, alive.data_ptr(), sample.data_ptr(), sample0.data_ptr(), st.b, k, spp_limit,
                    st.segment, st.cap, st.trips.data_ptr(), st.chunk.data_ptr(), st.scratch.data_ptr(),
                    st.cond_out.data_ptr())
            else:
                err = lib.tpupt_loop_graph_add_countdown_while(
                    handle, body, st.index.data_ptr(), st.chunk.data_ptr(), st.replays.data_ptr(),
                    st.cond_out.data_ptr())
            loop_cond.check(err, f"gradient graph: adding the WHILE node of the {name} trips")
            stamp(slots[1])
            loop_cond.check(lib.tpupt_loop_graph_instantiate(handle), f"gradient graph: instantiating the {name} chain")
        except BaseException:
            lib.tpupt_loop_graph_destroy(handle)
            raise
        self.chains[name] = handle

    def _first(self, name, trip, cond, capture):
        """A call's first trip of a loop that has no chain yet: eagerly, with every kernel
        launched for real (it makes K1's tables, K4's wide tree and the packet counters of
        the capture stream, none of which may be made under capture), then the capture."""
        with trace.span("grads.capture"):
            trip()
            cond(bump=True)
            torch.cuda.synchronize()
            t0 = _time.perf_counter()
            try:
                capture()
                self._chain(name)
            except BaseException:  # nothing half-captured is kept: the next call makes new graphs
                self.close()
                raise
            self.capture_s += _time.perf_counter() - t0

    def _launch(self, name):
        loop_cond.check(loop_cond.lib().tpupt_loop_graph_launch(self.chains[name], self.stream.cuda_stream),
                        f"gradient graph: launching the {name} trips")
        loop_cond.stamp_launches += 2

    def _reset(self):
        self.st.reset()
        self.cursor.zero_()

    # -- a call ----------------------------------------------------------------------

    def _forward_chunk(self, c0):
        st = self.st
        with trace.span("grads.forward.chunk") as sp:
            st.begin_chunk(c0)
            eager = 0
            if "forward" not in self.chains:
                def capture():
                    self.reset_graph, _ = _capture("gradient graph: capturing the reset", self._reset, self.pool,
                                                   keep_graph=False)
                    self._capture_body("forward", st.forward_trip)

                self._first("forward", st.forward_trip, st.cond_forward, capture)
                eager = 1
            self._launch("forward")
            # the host read of the chunk
            trips, n_work, t0, t1 = torch.cat([st.trips, st.cond_out[:1], self.stamps_forward]).tolist()
        self.device_forward_s += 1e-9 * (t1 - t0)
        trace.card(sp, "card.forward", t0, t1, first_trip=c0, trips=trips - c0)
        self.host_reads += 1
        self.chunks += 1
        self.trips = trips
        on_card = trips - c0 - eager
        _add_launches({key: n * on_card for key, n in self.calls["forward"].items()})
        loop_cond.gate_launches += 1 + on_card
        return trips, n_work

    def _replay(self):
        """The countdown from the device's index to chunk[0]: one launch of the backward chain."""
        st = self.st
        if "backward" not in self.chains:
            self._first("backward", st.backward_trip, st.cond_backward,
                        lambda: self._capture_body("backward", st.backward_trip))
            self._eager_replays = 1
        self._launch("backward")
        self._backward_launches += 1
        self._backward_spans.append(trace.current())

    def _take(self):
        """The runner's ``take()`` (a segment's gradient sums into its flat tensor, the sums
        zeroed) by a captured graph -> the flat tensor."""
        if self.take_graph is None:
            self.take_graph, _ = _capture("gradient graph: capturing the take of the sums", self.st.take,
                                          None, keep_graph=False)
        self.take_graph.replay()
        return self.st.flat

    def forward(self, *inputs) -> int:
        """The forward trips of a call -> trips run. inputs as the runner's ``set_inputs``."""
        if self.closed:
            raise RuntimeError("gradient graph: these graphs were closed")
        st = self.st
        self.capture_s, self.host_reads, self.chunks = 0.0, 0, 0
        self.device_forward_s = self.device_backward_s = 0.0
        self._eager_replays = self._backward_launches = 0
        self._backward_spans = []
        caller = torch.cuda.current_stream()
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            with trace.span("grads.inputs"):
                st.set_inputs(*inputs)
            if self.reset_graph is None:
                self._reset()
            else:
                self.reset_graph.replay()
            self._chunks = st.forward_pass(self._forward_chunk)
        caller.wait_stream(self.stream)
        return self.trips

    def backward(self, mesh=None):
        """The call's backward trips -> (output [B,3], grads by DIFF_FIELDS name, rays int), the
        caller's own tensors. mesh: each segment's gradient all-reduced over it as its replay
        ends, outside the graphs (``TripStages.backward_pass``)."""
        st = self.st
        caller = torch.cuda.current_stream()
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            total = st.backward_pass(self._chunks, self._replay, mesh, self._take)
            with trace.span("grads.read") as sp:
                # the call's last host read
                trips, rays, replays, *stamps = torch.cat([st.counters, self.stamps_backward]).tolist()
                grads = ({n: g.clone() for n, g in st.grads.items()} if total is None
                         else st.split(total))
                out = st.output().clone()
        for span, t0, t1 in zip(self._backward_spans, stamps[0::2], stamps[1::2]):
            self.device_backward_s += 1e-9 * (t1 - t0)
            trace.card(span, "card.backward", t0, t1)
        self.host_reads += 1
        caller.wait_stream(self.stream)
        if replays != trips:
            raise RuntimeError(f"gradient graph: the backward pass replayed {replays} of {trips} trips")
        on_card = replays - self._eager_replays
        _add_launches({key: n * on_card for key, n in self.calls.get("backward", {}).items()})
        loop_cond.countdown_launches += self._backward_launches + on_card
        return out, grads, rays

    def close(self):
        if self.chains:
            torch.cuda.synchronize()
        _destroy(self.chains)
        self.bodies, self.calls, self.reset_graph, self.take_graph, self.closed = {}, {}, None, None, True
