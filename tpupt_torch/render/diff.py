"""Differentiable rendering: the detached-sampling reverse-mode pass over the path tracer.

Counterpart of ``tpupt/render/diff.py``. Pixel gradients with respect to the Disney
parameter table, the texture colors (which carry base colors and light emission),
the environment color, the f32 HDR environment map and the image atlas, computed by
autograd through the same estimator as the forward pass.

Design (the detached estimator):

- The bounce loop is a Python loop of trips; every trip runs under non-reentrant
  ``torch.utils.checkpoint``, so the backward pass keeps only each trip's carry
  (about 80 B a lane) and replays the trip to rebuild its graph. The RNG is
  counter-based, so there is no torch RNG state to preserve, and the hand-written
  kernels are deterministic, so a replayed trip takes the forward trip's branches.
- Trips run in segments of SEGMENT, each gated on the host by whether any lane has
  work left (one device read a segment, in place of the reference's ``lax.cond``);
  segments after the last live lane are skipped both ways.
- On CUDA, ``render_film_grads`` runs the same trips as one device program, as the
  reference runs its jitted ``_film_grads_step``: ``FilmScanStages`` holds the pass's
  state in static tensors, saves each forward trip's carry into a staging buffer and
  replays the trips newest first, one ``autograd.grad`` a trip; render/graph.py
  captures its parts into CUDA graphs whose forward and backward loops, and the segment
  gate, run on the card (K5, ops/loop_cond.py). ``render_grads`` and
  ``segmented_film_vjp`` (the sharded gradient step) run the masked scan the same way,
  over ``RadianceScanStages``, as the reference jits ``_value_and_grad_call`` and its
  ``shard_map`` step. The eager routes above are the CPU's and the graphs' plain
  versions on the card (``plain_grads``).
- ``bounce_step(detach=True)`` detaches every sampling-derived quantity (sampled
  direction, mixture pdf, russian-roulette probability), so gradients flow only
  through integrand factors, and a zero pdf kills its lane.
- Geometry is not differentiable: the intersection kernels take detached rays and
  refuse tables that require grad (ops/hit_kernel.py, ops/tri_kernel.py,
  ops/bvh_kernel.py).

Same estimator and RNG stream as the forward renderer, no compaction. On the GPU
the gathers' backward (index_add_) accumulates with atomics, so two runs may differ
in the last bits of a gradient.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time as _time

import torch
from torch.utils.checkpoint import checkpoint

from .. import trace
from ..core.dtypes import REAL
from ..ops import bvh_kernel, hit_kernel, loop_cond, tri_kernel
from .camera import generate_rays
from .integrator import (STEP_KEYS, _mis_probs, _radiance_step, _stream_step, copy_camera, reset_stream_state,
                         static_camera, stream_state)

# SceneData fields exposed as differentiable parameters
DIFF_FIELDS = ("mat_params", "tex_rgb", "env_color", "env_img", "atlas")

SEGMENT = 8  # trips per early-exit segment

# The carry a forward trip saves and its replay loads, (field, dtype, values a lane): 77 B a
# lane. The 4-byte fields first, so that each starts 4-byte aligned in a trip's row.
SAVED = (("o", REAL, 3), ("d", REAL, 3), ("throughput", REAL, 3), ("radiance", REAL, 3), ("film", REAL, 3),
         ("time", REAL, 1), ("bounce", torch.int32, 1), ("sample", torch.int32, 1),
         ("cur_sample", torch.int32, 1), ("alive", torch.bool, 1))
# The most bytes the staging buffer of saved trips may hold (FilmScanStages): it sets the
# trips of a chunk, and so the host reads of a CUDA gradient pass (one a chunk, and one).
STAGING_BYTES = 256 << 20

_plain = False  # CUDA gradient passes run the eager route (plain_grads)


@contextlib.contextmanager
def plain_grads():
    """Within the block, render_film_grads, render_grads and segmented_film_vjp on CUDA run
    the eager route (checkpointed trips driven from the host) instead of the graphs: the
    plain version that the tests and chip_smoke.py hold the graphs against, film and
    radiance bit for bit."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def init_params(sd) -> dict:
    """The differentiable parameters of a SceneData, by field name."""
    return {name: getattr(sd, name) for name in DIFF_FIELDS}


def apply_params(sd, params: dict):
    """A SceneData with the differentiable fields swapped for `params`.

    A shallow copy: geometry tensors and the caches kept on the SceneData (the
    kernels' packed tables, the host copies of small tables) are shared.
    """
    out = copy.copy(sd)
    for name, value in params.items():
        if name not in DIFF_FIELDS:
            raise KeyError(f"apply_params: {name} is not a differentiable field {DIFF_FIELDS}")
        setattr(out, name, value)
    return out


def _leaves(params: dict) -> dict:
    """Fresh leaf tensors that require grad, sharing the parameters' storage."""
    return {n: v.detach().requires_grad_(True) for n, v in params.items()}


def _grads(loss, params: dict) -> dict:
    """d loss / d params by autograd; fields the loss does not reach get zeros."""
    names = list(params)
    got = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, got)}


def _trip(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _kernel_launches() -> dict:
    return {"K1": hit_kernel.launches, "K2": tri_kernel.launches["flat"],
            "K3": tri_kernel.launches["two_level"], "K4": bvh_kernel.launches}


def _radiance_segment(sd, lane_args, carry, seg, segment_size, max_depth, has_lights):
    """Bounces [seg*segment_size, (seg+1)*segment_size) of the masked scan, each a
    checkpointed trip -> (carry, rays); bounces past max_depth are no-ops and not run."""
    o, d, T, L, alive = carry
    rays = torch.zeros((), dtype=torch.int64, device=o.device)
    for bounce in range(seg * segment_size, min((seg + 1) * segment_size, max_depth)):
        o, d, T, L, alive, n = _trip(
            _radiance_step, sd, lane_args, o, d, T, L, alive, bounce, has_lights, True
        )
        rays = rays + n
    return (o, d, T, L, alive), rays


def trace_radiance_scan(
    sd, cam, pixel_ids, rows, cols, sample_ids, seed, max_depth, has_lights,
    segment_size=SEGMENT, with_rays=False,
):
    """Differentiable twin of trace_radiance: one (pixel, sample) path a lane.

    Same estimator, same RNG stream, radiance [B,3]; bounces run in segments of
    `segment_size` gated on any lane alive (0: no gate, every bounce runs).
    with_rays=True also returns the traced-ray count (scene intersections of live
    lanes) as an int.
    """
    o, d, time = generate_rays(cam, rows, cols, pixel_ids, sample_ids, seed)
    b = pixel_ids.shape[0]
    carry = (
        o, d, torch.ones((b, 3), dtype=REAL, device=o.device),
        torch.zeros((b, 3), dtype=REAL, device=o.device),
        torch.ones(b, dtype=torch.bool, device=o.device),
    )
    lane_args = (time, pixel_ids, sample_ids, seed)
    size = segment_size or max_depth
    rays = 0
    for seg in range(-(-max_depth // size)):
        if segment_size and not bool(carry[4].any()):
            break
        carry, n = _radiance_segment(sd, lane_args, carry, seg, size, max_depth, has_lights)
        rays = rays + n
    L = carry[3]
    return (L, int(rays)) if with_rays else L


def trace_film_scan(
    sd, cam, pixel_ids, rows, cols, sample0, spp_limit, seed, k, max_depth,
    has_lights, segment_size=SEGMENT, with_rays=False, stats=None,
):
    """Differentiable twin of trace_film_streamed: path regeneration over trips.

    Each lane streams its own k-sample slice of one pixel (sample0 [B] is the
    slice's first sample id): when a path ends, the lane starts its next camera ray
    in the next trip. At most k * max_depth trips run, in segments of segment_size
    gated on any lane having work left. Radiance lands in a per-lane film sum, so
    gradients take a per-lane film cotangent. Per-sample radiance and the RNG
    stream are those of trace_film_streamed.

    Returns film_sum [B,3] (with_rays=True: (film_sum, rays int)). stats (a dict),
    if given, gets "trips": the trips run.
    """
    if segment_size < 1:
        raise ValueError(f"trace_film_scan: segment_size must be >= 1, got {segment_size}")
    s = stream_state(pixel_ids, rows, cols, sample0)
    p_light, p_bsdf = _mis_probs(has_lights)
    rays = torch.zeros((), dtype=torch.int64, device=pixel_ids.device)
    trips = reads = 0
    for _ in range(-(-(k * max_depth) // segment_size)):
        work = loop_cond.work_mask(s["alive"], s["sample"], s["sample0"], k, spp_limit)
        reads += 1
        if not bool(work.any()):  # the one host read of the segment
            break
        for _ in range(segment_size):
            s, n = _trip(
                _stream_step, s, sd, cam, spp_limit, seed, k, max_depth, has_lights,
                p_light, p_bsdf, True,
            )
            rays = rays + n
        trips += segment_size
    if stats is not None:
        stats["trips"] = stats.get("trips", 0) + trips
        stats["host_reads"] = stats.get("host_reads", 0) + reads + with_rays
    return (s["film"], int(rays)) if with_rays else s["film"]


def trip_cap(k, max_depth, segment_size):
    """The most trips trace_film_scan runs: every segment of k * max_depth trips."""
    return -(-(k * max_depth) // segment_size) * segment_size


def chunk_trips(lanes, k, max_depth, segment_size, budget=None, saved=SAVED):
    """Trips a chunk of a stage runner: the most whole segments whose saved carries (`saved`:
    SAVED for FilmScanStages, RADIANCE_SAVED for RadianceScanStages) fit the staging budget
    (STAGING_BYTES), at least one segment, at most the trip cap."""
    budget = STAGING_BYTES if budget is None else budget
    fit = budget // _row_bytes(lanes, saved) // segment_size * segment_size
    return max(segment_size, min(trip_cap(k, max_depth, segment_size), fit))


def _row_bytes(lanes, saved=SAVED):
    """Bytes of one trip's saved carry, rounded up to 16."""
    n = sum(lanes * width * dtype.itemsize for _, dtype, width in saved)
    return -(-n // 16) * 16


class TripStages:
    """What the gradient pass's stage runners share: a scan of trips over static state whose
    forward trips save their carry into a staging buffer and whose backward trips replay the
    saved trips newest first, one ``autograd.grad`` a trip, the loops decided on the device.

    The counterpart of the VJP of the reference's checkpointed ``lax.scan`` of trips, in parts
    that render/graph.py captures. Every tensor is made once and updated in place: the
    parameter leaves (static tensors that require grad, into which each call copies the
    caller's values); the cotangent, the seed (a 0-d int64 tensor), the gradient sums, the
    cotangents of the carry's throughput and radiance (``ct_T``, ``ct_L``), and the counters
    (trips, rays, replays) on the device. A staging buffer holds the carries of up to
    ``chunk_trips`` trips, a trip's carry in one row, so that a chunk's rows are one
    contiguous copy. A subclass makes its state and defines ``reset``, ``forward_trip``,
    ``backward_trip``, ``gate_lanes`` and ``output``:

    - ``reset()``: the state before the first trip; gradient sums, cotangents and counters zero;
    - ``begin_chunk(c0)``: the forward chunk from trip c0 (its end c0 + chunk_trips on the device);
    - ``forward_trip()``: saves the carry at the device's trip index, then one trip without
      autograd, its rays added on the device;
    - ``cond_forward(bump)``: the segment gate (K5, ``loop_cond.grad_gate``) over ``gate_lanes()``;
    - ``begin_backward(c0, n, store)``: a chunk's rows back into the staging buffer (unless
      they never left it) and the device's trip index at its newest trip;
    - ``backward_trip()``: loads the saved trip at the device's index, replays it with
      autograd over the leaves and the carry's throughput and radiance, adds the leaves'
      gradient to the sums and keeps the rest as the next (earlier) trip's ct_T and ct_L;
    - ``cond_backward(bump)``: the countdown (K5, ``loop_cond.grad_countdown``) to chunk[0];
    - ``take()``: the gradient sums into one flat tensor, then the sums zeroed (a mesh's
      chunk a segment).

    ``forward_pass`` and ``backward_pass`` walk the chunks, with a function that runs one
    chunk's trips: ``run()`` passes host loops, one read of the condition a trip (the stage
    runner on the CPU, which the tests hold against the eager routes); render/graph.py passes
    graph launches, one host read a chunk. Every trip's carry is saved, as the reference's
    scan saves a checkpoint a trip; the chunks' rows wait in stores of their own size, so
    memory follows the trips run, as the eager routes' checkpoints do.
    """

    def _init_trips(self, sd, b, segment, cap, chunk, saved, device):
        if chunk < 1 or chunk % segment:
            raise ValueError(f"{type(self).__name__}: a chunk must be whole segments of {segment} trips, "
                             f"got {chunk}")
        self.b, self.segment, self.cap, self.chunk_trips = b, segment, cap, chunk
        i64 = dict(dtype=torch.int64, device=device)
        self.leaves = {n: torch.empty_like(getattr(sd, n)).requires_grad_(True) for n in DIFF_FIELDS}
        self.sdp = apply_params(sd, self.leaves)
        self.grads = {n: torch.zeros_like(v, requires_grad=False) for n, v in self.leaves.items()}
        self.flat = torch.zeros(sum(v.numel() for v in self.grads.values()), dtype=REAL, device=device)
        self.cot = torch.zeros((b, 3), dtype=REAL, device=device)
        self.ct_T = torch.zeros((b, 3), dtype=REAL, device=device)
        self.ct_L = torch.zeros((b, 3), dtype=REAL, device=device)
        self.seed = torch.zeros((), **i64)
        self.counters = torch.zeros(3, **i64)  # trips run, rays, trips replayed
        self.trips, self.rays, self.replays = (self.counters[i : i + 1] for i in range(3))
        self.index = torch.zeros(1, **i64)  # the trip a backward replays next
        self.chunk = torch.zeros(2, **i64)  # where the countdown stops, and where the chunk ends
        self.base = torch.zeros(1, **i64)  # the trip in the staging buffer's first row
        self.row = torch.zeros(1, **i64)  # the staging row of the trip at hand
        self.scratch = torch.zeros(2, dtype=torch.int32, device=device)  # the gate kernel's
        self.cond_out = torch.zeros(2, **i64)
        self.row_bytes = _row_bytes(b, saved)
        self.staging = torch.empty((chunk, self.row_bytes), dtype=torch.uint8, device=device)
        self.saved, off = {}, 0
        for key, dtype, width in saved:
            size = b * width * dtype.itemsize
            view = self.staging[:, off : off + size].view(dtype)
            self.saved[key] = view.view(chunk, b, width) if width > 1 else view
            off += size

    def _set_params(self, params, cot, seed):
        """Parameter values by DIFF_FIELDS name (copied into the leaves, never aliased), the
        lanes' cotangent [B,3] and the seed into the static tensors."""
        with torch.no_grad():
            for n, leaf in self.leaves.items():
                if params[n].shape != leaf.shape:
                    raise ValueError(f"{type(self).__name__}: {n} has shape {tuple(params[n].shape)}, the "
                                     f"stages were made for {tuple(leaf.shape)}")
                leaf.copy_(params[n])
        self.cot.copy_(cot)
        self.seed.fill_(seed)

    def _reset_sums(self):
        self.counters.zero_()
        for g in self.grads.values():
            g.zero_()
        self.ct_T.zero_()
        self.ct_L.zero_()

    def begin_chunk(self, c0):
        self.base.fill_(c0)
        self.chunk[0].fill_(c0)
        self.chunk[1].fill_(c0 + self.chunk_trips)

    def save_carry(self, state):
        """The carry of `state` into the staging row of the device's trip counter."""
        torch.sub(self.trips, self.base, out=self.row)
        for key, buf in self.saved.items():
            buf.index_copy_(0, self.row, state[key].unsqueeze(0))

    def load_carry(self) -> dict:
        """The saved carry of the trip at the device's index."""
        torch.sub(self.index, self.base, out=self.row)
        return {key: torch.index_select(buf, 0, self.row)[0] for key, buf in self.saved.items()}

    def _add_grads(self, T_in, L_in, loss):
        """d loss / d (leaves, T_in, L_in): the leaves' part into the sums, the rest the next
        (earlier) trip's ct_T and ct_L. Under enable_grad."""
        names = list(self.leaves)
        got = torch.autograd.grad(loss, [self.leaves[n] for n in names] + [T_in, L_in], allow_unused=True)
        for n, g in zip(names, got):
            if g is not None:
                self.grads[n].add_(g)
        for ct, g in ((self.ct_T, got[-2]), (self.ct_L, got[-1])):
            if g is None:
                ct.zero_()
            else:
                ct.copy_(g)

    def cond_forward(self, bump=False):
        alive, sample, sample0, k, spp_limit = self.gate_lanes()
        return loop_cond.grad_gate(alive, sample, sample0, k, spp_limit, self.segment, self.cap, self.trips,
                                   self.chunk, bump, out=self.cond_out, scratch=self.scratch)

    def cond_backward(self, bump=False):
        return loop_cond.grad_countdown(self.index, self.chunk, self.replays, bump, out=self.cond_out)

    def stash(self, n):
        """The first n staging rows copied into a store of their own (one copy)."""
        with trace.span("grads.stash"):
            store = torch.empty((n, self.row_bytes), dtype=torch.uint8, device=self.staging.device)
            store.copy_(self.staging[:n])
        return store

    def begin_backward(self, c0, n, store=None):
        if store is not None:
            self.staging[:n].copy_(store)
        self.base.fill_(c0)
        self.chunk[0].fill_(c0)
        self.chunk[1].fill_(c0 + n)
        self.index.fill_(c0 + n - 1)

    def take(self):
        """The gradient sums into ``flat`` (in DIFF_FIELDS order), then the sums zeroed -> flat."""
        torch.cat([g.reshape(-1) for g in self.grads.values()], out=self.flat)
        for g in self.grads.values():
            g.zero_()
        return self.flat

    def split(self, flat) -> dict:
        """A flat gradient (``take``'s layout) by DIFF_FIELDS name."""
        sizes = [g.numel() for g in self.grads.values()]
        return {n: x.reshape(g.shape) for (n, g), x in zip(self.grads.items(), flat.split(sizes))}

    def forward_pass(self, run_chunk):
        """The forward trips, a chunk at a time: run_chunk(c0) runs the chunk from trip c0 and
        returns (trips run in all, lanes with work at the last gate). -> the chunks,
        (first trip, trips, store of its rows or None: the newest, left in the staging buffer)."""
        chunks, c0 = [], 0
        while True:
            trips, n_work = run_chunk(c0)
            more = trips == c0 + self.chunk_trips and trips < self.cap and n_work > 0
            if trips > c0:
                chunks.append((c0, trips - c0, self.stash(trips - c0) if more else None))
            if not more:
                return chunks
            c0 = trips

    def backward_pass(self, chunks, replay, mesh=None, take=None):
        """The backward trips, newest first, over forward_pass's chunks: replay() runs the
        countdown from the device's index down to chunk[0], the chunk's rows in the staging
        buffer. Without a mesh, one replay a chunk -> None (the total is in the sums).

        With a mesh (the reference's psum inside its scan): one replay a segment, newest
        first, its countdown stopped at the segment's first trip; then take() -> the
        segment's gradient sums as one flat tensor (the sums zeroed), a copy of which is
        all-reduced over the mesh at once, asynchronously. A segment that the forward gate
        skipped gives zeros, so every rank issues one collective a segment. -> the flat
        total, the segments summed newest first, as segmented_film_vjp sums them."""
        if mesh is None:
            while chunks:
                c0, n, store = chunks.pop()
                with trace.span("grads.backward.chunk"):
                    self.begin_backward(c0, n, store)
                    replay()
            return None
        ran = chunks[-1][0] + chunks[-1][1] if chunks else 0
        reduced, staged = [], None
        for t0 in reversed(range(0, self.cap, self.segment)):
            if t0 >= ran:
                flat = torch.zeros_like(self.flat)
            else:
                with trace.span("grads.backward.chunk"):
                    if staged is None or t0 < staged:
                        c0, n, store = chunks.pop()
                        self.begin_backward(c0, n, store)
                        staged = c0
                    self.chunk[0].fill_(t0)
                    replay()
                flat = take().clone()
            reduced.append((flat, mesh.all_reduce(flat, async_op=True)))
        total = torch.zeros_like(self.flat)
        for i, (flat, handle) in enumerate(reduced):
            if handle is not None:
                handle.wait()
            total = flat if i == 0 else total + flat
        return total

    def run(self, log=None, mesh=None):
        """The whole pass driven from the host -> (output [B,3], grads by DIFF_FIELDS name, rays
        int, trips int); with a mesh, the grads summed over it (``backward_pass``). log (a
        list), if given, gets ("forward" or "backward", the trip counter or index, lanes with
        work or the index, go) at every read of a condition."""

        def loop(cond, phase):
            bump = False
            while True:
                a, go = cond(bump).tolist()
                if log is not None:
                    log.append((phase, int(self.trips if phase == "forward" else self.index), a, go))
                if not go:
                    return a
                (self.forward_trip if phase == "forward" else self.backward_trip)()
                bump = True

        def forward_chunk(c0):
            self.begin_chunk(c0)
            n_work = loop(self.cond_forward, "forward")
            return int(self.trips), n_work

        self.reset()
        chunks = self.forward_pass(forward_chunk)
        total = self.backward_pass(chunks, lambda: loop(self.cond_backward, "backward"), mesh, self.take)
        trips, rays, replays = self.counters.tolist()
        if replays != trips:
            raise RuntimeError(f"{type(self).__name__}: the backward pass replayed {replays} of {trips} trips")
        return self.output(), self.grads if total is None else self.split(total), rays, trips


class FilmScanStages(TripStages):
    """trace_film_scan and its backward pass over static state: the gradient pass as device steps.

    The counterpart of the reference's jitted ``_film_grads_step`` (jax.vjp over the
    trips' ``lax.scan``, each trip checkpointed), as ``integrator.StreamStages`` is for the
    render. Its state is the trip state of ``stream_state``; a trip saves SAVED, 77 B a
    lane; the cotangent is the lanes' film cotangent, which every replayed trip adds to
    its loss (T.ct_T + L.ct_L + film.cot).
    """

    def __init__(self, sd, cam, b, spp_limit, k, max_depth, has_lights, device, segment_size=SEGMENT,
                 chunk=None):
        if segment_size < 1:
            raise ValueError(f"FilmScanStages: segment_size must be >= 1, got {segment_size}")
        self.cam = cam
        self.spp_limit, self.k, self.max_depth, self.has_lights = spp_limit, k, max_depth, has_lights
        self.p_light, self.p_bsdf = _mis_probs(has_lights)
        chunk = chunk_trips(b, k, max_depth, segment_size) if chunk is None else chunk
        self._init_trips(sd, b, segment_size, trip_cap(k, max_depth, segment_size), chunk, SAVED, device)
        i32 = dict(dtype=torch.int32, device=device)
        proto = stream_state(torch.zeros(1, **i32), torch.zeros(1, **i32), torch.zeros(1, **i32),
                             torch.zeros(1, **i32))
        self.state = {key: torch.empty((b, *v.shape[1:]), dtype=v.dtype, device=device) for key, v in proto.items()}

    def set_inputs(self, pixel_ids, rows, cols, sample0, params, cot, seed):
        """The call's inputs into the static tensors: lanes, parameter values by DIFF_FIELDS
        name, the lanes' film cotangent [B,3], the seed."""
        s = self.state
        for key, val in (("pix", pixel_ids), ("row", rows), ("col", cols), ("sample0", sample0)):
            s[key].copy_(val)
        self._set_params(params, cot, seed)

    def reset(self):
        reset_stream_state(self.state)
        self._reset_sums()

    def gate_lanes(self):
        s = self.state
        return s["alive"], s["sample"], s["sample0"], self.k, self.spp_limit

    def output(self):
        return self.state["film"]

    def _step(self, s, sd):
        return _stream_step(s, sd, self.cam, self.spp_limit, self.seed, self.k, self.max_depth,
                            self.has_lights, self.p_light, self.p_bsdf, True)

    def forward_trip(self):
        s = self.state
        self.save_carry(s)
        with torch.no_grad():
            out, n_rays = self._step(s, self.sdp)
        for key in STEP_KEYS:
            s[key].copy_(out[key])
        self.rays.add_(n_rays)

    def backward_trip(self):
        s = dict(self.state, **self.load_carry())
        T_in = s["throughput"] = s["throughput"].detach().requires_grad_(True)
        L_in = s["radiance"] = s["radiance"].detach().requires_grad_(True)
        with torch.enable_grad():
            out, _ = self._step(s, self.sdp)
            loss = ((out["throughput"] * self.ct_T).sum() + (out["radiance"] * self.ct_L).sum()
                    + (out["film"] * self.cot).sum())
            self._add_grads(T_in, L_in, loss)


# The carry a forward trip of the masked scan saves and its replay loads, as SAVED: 49 B a lane.
RADIANCE_SAVED = (("o", REAL, 3), ("d", REAL, 3), ("throughput", REAL, 3), ("radiance", REAL, 3),
                  ("alive", torch.bool, 1))


class RadianceScanStages(TripStages):
    """trace_radiance_scan and its backward pass over static state: one (pixel, sample) path
    a lane, the counterpart of the reference's jitted ``_value_and_grad_call`` over its masked
    scan (``tpupt/render/diff.py:79-142,434-442``), and of the scan inside its sharded
    gradient step.

    Its state: the lanes (pixel, row, col, sample id; inputs), the camera (a static copy each
    call copies into), the rays' time, and the carry (o, d, T, L, alive) that a trip saves,
    RADIANCE_SAVED. A trip's bounce is the device's trip counter (the index in a replay).
    K5's gate decides the trips: its work predicate with k = 1 and spp_limit = 0 is
    ``alive``, so a segment runs while a lane is alive, as the eager route's host read
    decides; the cap is max_depth (bounces past it are not run). segment_size 0: no gate,
    every bounce runs (one segment of max_depth trips). The cotangent is the lanes'
    radiance cotangent: ``reset`` starts ct_L at it, and a replayed trip's loss is T.ct_T +
    L.ct_L.
    """

    def __init__(self, sd, cam, b, max_depth, has_lights, device, segment_size=SEGMENT, chunk=None):
        if segment_size < 0:
            raise ValueError(f"RadianceScanStages: segment_size must be >= 0, got {segment_size}")
        segment = segment_size or max(max_depth, 1)
        self.cam = static_camera(cam, device)
        self.max_depth, self.has_lights = max_depth, has_lights
        chunk = chunk_trips(b, 1, max_depth, segment, saved=RADIANCE_SAVED) if chunk is None else chunk
        self._init_trips(sd, b, segment, max_depth, chunk, RADIANCE_SAVED, device)
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=REAL, device=device)
        self.state = dict(
            pix=torch.zeros(b, **i32), row=torch.zeros(b, **i32), col=torch.zeros(b, **i32),
            sample=torch.zeros(b, **i32), time=torch.zeros(b, **f32),
            o=torch.zeros((b, 3), **f32), d=torch.zeros((b, 3), **f32), throughput=torch.zeros((b, 3), **f32),
            radiance=torch.zeros((b, 3), **f32), alive=torch.zeros(b, dtype=torch.bool, device=device),
        )
        self.no_samples = torch.zeros(b, **i32)  # the gate's sample and first sample: no lane has any left

    def set_inputs(self, pixel_ids, rows, cols, sample_ids, params, cot, seed, cam=None):
        """The call's inputs into the static tensors: lanes, parameter values by DIFF_FIELDS
        name, the lanes' radiance cotangent [B,3], the seed and the camera's values."""
        s = self.state
        for key, val in (("pix", pixel_ids), ("row", rows), ("col", cols), ("sample", sample_ids)):
            s[key].copy_(val)
        self._set_params(params, cot, seed)
        if cam is not None:
            copy_camera(self.cam, cam)

    def reset(self):
        s = self.state
        o, d, time = generate_rays(self.cam, s["row"], s["col"], s["pix"], s["sample"], self.seed)
        s["o"].copy_(o)
        s["d"].copy_(d)
        s["time"].copy_(time)
        s["throughput"].fill_(1.0)
        s["radiance"].zero_()
        s["alive"].fill_(True)
        self._reset_sums()
        self.ct_L.copy_(self.cot)

    def gate_lanes(self):
        return self.state["alive"], self.no_samples, self.no_samples, 1, 0

    def output(self):
        return self.state["radiance"]

    def _step(self, c, bounce):
        s = self.state
        return _radiance_step(self.sdp, (s["time"], s["pix"], s["sample"], self.seed), c["o"], c["d"],
                              c["throughput"], c["radiance"], c["alive"], bounce, self.has_lights, True)

    def forward_trip(self):
        s = self.state
        self.save_carry(s)
        with torch.no_grad():
            *out, n_rays = self._step(s, self.trips)
        for key, v in zip(("o", "d", "throughput", "radiance", "alive"), out):
            s[key].copy_(v)
        self.rays.add_(n_rays)

    def backward_trip(self):
        c = self.load_carry()
        T_in = c["throughput"] = c["throughput"].detach().requires_grad_(True)
        L_in = c["radiance"] = c["radiance"].detach().requires_grad_(True)
        with torch.enable_grad():
            _, _, T, L, _, _ = self._step(c, self.index)
            self._add_grads(T_in, L_in, (T * self.ct_T).sum() + (L * self.ct_L).sum())


@dataclasses.dataclass
class GradStats:
    """What one render_film_grads call did."""

    rays: int = 0  # forward scene intersections of live lanes
    trips: int = 0  # forward trips; the backward pass replays each once
    lanes: int = 0
    forward_s: float = 0.0
    backward_s: float = 0.0
    # kernel launches by kernel (K1, K2, K3, K4) in the forward trips and in the
    # backward pass's replays of them
    launches_forward: dict = dataclasses.field(default_factory=dict)
    launches_backward: dict = dataclasses.field(default_factory=dict)
    # host seconds spent capturing and instantiating graphs (CUDA route; part of forward_s
    # and backward_s; 0 when the call replayed graphs kept from an earlier call)
    capture_s: float = 0.0
    host_reads: int = 0  # reads of device values by the host: a segment (eager), a chunk + 1 (graphs)
    chunks: int = 0  # chunks of forward trips (graphs; the eager route has none)
    # the card's time in the forward and backward chains, from their stamps of the card's clock
    # (graphs; 0 on the eager route)
    device_forward_s: float = 0.0
    device_backward_s: float = 0.0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def film_lanes(camera, spp, replicas=None, cotangent=None, device=None):
    """render_film_grads' lanes: r lanes a pixel, lane j*npix + i taking pixel i's samples
    from j*k -> (pixel ids, rows, cols, first samples [B] int32, the lanes' film cotangent
    [B,3] (cotangent [H*W,3], default ones, over spp), r, k). replicas (r) defaults to about
    2^18 lanes, lowered until it divides spp."""
    w = camera.image_width
    npix = w * camera.image_height
    if replicas is None:
        replicas = max(1, min((1 << 18) // npix, spp))
    while spp % replicas:  # k must be exact: every sample traced exactly once
        replicas -= 1
    r = replicas
    k = spp // r
    pix = torch.arange(npix, dtype=torch.int32, device=device).repeat(r)
    rows, cols = pix // w, pix % w
    lane_sample0 = torch.repeat_interleave(torch.arange(r, dtype=torch.int32, device=device) * k, npix)
    if cotangent is None:
        cot_pix = torch.ones((npix, 3), dtype=REAL, device=device)
    else:
        cot_pix = torch.as_tensor(cotangent, dtype=REAL, device=device).reshape(npix, 3)
    return pix, rows, cols, lane_sample0, cot_pix.repeat(r, 1) / spp, r, k


def render_film_grads(
    compiled, camera, spp: int | None = None, seed: int = 0, cotangent=None,
    replicas: int | None = None, segment_size=SEGMENT, return_stats=False,
):
    """Whole-image film and parameter gradients through the regenerating scan.

    Renders the image at `spp` (default camera.samples_per_pixel) with r lanes a
    pixel, each streaming spp/r samples, and returns (mean radiance [H,W,3], grads
    of sum_pixels cotangent . mean radiance by DIFF_FIELDS name). cotangent is
    per pixel [H*W,3] (default ones: the gradient of the image sum). replicas (r)
    defaults to about 2^18 lanes, lowered until it divides spp. return_stats=True
    appends a GradStats.

    On CUDA the pass runs as CUDA graphs (render/graph.py, ``grad_graphs``), kept on the
    compiled scene for later calls of the same configuration (seed, cotangent and the
    parameters' values are inputs); within ``plain_grads()``, and on the CPU, it runs the
    eager route, as one forward and one backward chunk. The film and the gradients are the
    caller's own tensors either way.
    """
    with trace.span("grads") as call:
        sd = compiled.data
        dev = sd.device
        w, h = camera.image_width, camera.image_height
        spp = camera.samples_per_pixel if spp is None else spp
        npix = w * h
        with trace.span("grads.inputs"):
            cam = camera.init(dev)
            pix, rows, cols, lane_sample0, cot, r, k = film_lanes(camera, spp, replicas, cotangent, dev)
            params = init_params(sd)
        stats = GradStats(lanes=pix.shape[0])
        before = _kernel_launches()
        t0 = _time.perf_counter()
        if dev.type == "cuda" and not _plain:
            from .graph import grad_graphs

            with trace.span("grads.inputs"):
                graphs = grad_graphs(compiled, camera, cam, pix.shape[0], spp, k, r, segment_size)
            stats.trips = graphs.forward(pix, rows, cols, lane_sample0, params, cot, seed)
            t1 = _time.perf_counter()
            mid = _kernel_launches()
            film, grads, stats.rays = graphs.backward()
            stats.capture_s, stats.host_reads, stats.chunks = graphs.capture_s, graphs.host_reads, graphs.chunks
            stats.device_forward_s, stats.device_backward_s = graphs.device_forward_s, graphs.device_backward_s
        else:
            params = _leaves(params)
            scan_stats = {}
            with torch.enable_grad():
                with trace.span("grads.forward.chunk"):
                    film, stats.rays = trace_film_scan(
                        apply_params(sd, params), cam, pix, rows, cols, lane_sample0, spp, seed, k,
                        camera.max_depth, compiled.has_lights, segment_size=segment_size,
                        with_rays=True, stats=scan_stats,
                    )
                    _sync(dev)
                t1 = _time.perf_counter()
                mid = _kernel_launches()
                with trace.span("grads.backward.chunk"):
                    grads = _grads((film * cot).sum(), params)
            stats.trips, stats.host_reads = scan_stats["trips"], scan_stats["host_reads"]
        _sync(dev)
        stats.backward_s = _time.perf_counter() - t1
        stats.forward_s = t1 - t0
        after = _kernel_launches()
        stats.launches_forward = {n: mid[n] - before[n] for n in before}
        stats.launches_backward = {n: after[n] - mid[n] for n in before}
        mean = (film.detach().reshape(r, npix, 3).sum(0) / spp).reshape(h, w, 3)
        if call is not None:
            call.attrs.update(dataclasses.asdict(stats))
    if return_stats:
        return mean, grads, stats
    return mean, grads


def segmented_film_vjp(
    params, sd, cam, pixel_ids, rows, cols, sample_ids, seed, max_depth,
    has_lights, cotangent, *, segment_size=SEGMENT, mesh=None,
):
    """Radiance and parameter grads through an explicitly segmented backward pass.

    Same estimator and gradients as autograd of trace_radiance_scan, but the
    forward pass keeps only the carries at segment boundaries (no graph), and the
    backward pass replays one segment at a time, newest first, taking that
    segment's parameter gradients and the cotangents of its input carry.

    mesh (a parallel.sharding.Mesh; the counterpart of the reference's psum_axis):
    each segment's gradient chunk is all-reduced over the mesh as soon as its replay
    ends, asynchronously, so the collective overlaps the next (earlier) segment's
    backward; the handles are waited on at the end. The segment gate stays per rank:
    a rank whose lanes are all dead in a segment joins that segment's collective
    with zeros. cotangent is per lane [B,3]. Returns (radiance [B,3], grads by
    DIFF_FIELDS name (params' names), summed over the mesh).

    On CUDA the pass runs as CUDA graphs over ``RadianceScanStages`` (render/graph.py,
    ``radiance_graphs``, kept on `sd`): the forward trips one chain, the backward one
    launch a segment under a mesh (the collectives between the launches, outside the
    graphs), else one a chunk. Within ``plain_grads()``, and on the CPU, it runs the eager
    route below.
    """
    if pixel_ids.device.type == "cuda" and not _plain:
        from .graph import radiance_graphs

        if segment_size < 1:
            raise ValueError(f"segmented_film_vjp: segment_size must be >= 1, got {segment_size}")
        graphs = radiance_graphs(sd, sd, cam, pixel_ids.shape[0], max_depth, has_lights, segment_size)
        graphs.forward(pixel_ids, rows, cols, sample_ids, {**init_params(sd), **params}, cotangent, seed, cam)
        radiance, grads, _ = graphs.backward(mesh)
        return radiance, {n: grads[n] for n in params}
    o, d, time = generate_rays(cam, rows, cols, pixel_ids, sample_ids, seed)
    b = pixel_ids.shape[0]
    lane_args = (time, pixel_ids, sample_ids, seed)
    n_seg = -(-max_depth // segment_size)

    def seg_f(p, carry, seg):
        if not bool(carry[4].any()):
            return carry  # skipped segment: the identity, both ways
        return _radiance_segment(
            apply_params(sd, p), lane_args, carry, seg, segment_size, max_depth, has_lights
        )[0]

    # ---- forward: the carries at segment boundaries ----
    carry = (o, d, torch.ones((b, 3), dtype=REAL, device=o.device),
             torch.zeros((b, 3), dtype=REAL, device=o.device),
             torch.ones(b, dtype=torch.bool, device=o.device))
    carries = [carry]
    with torch.no_grad():
        for seg in range(n_seg):
            carry = seg_f(params, carry, seg)
            carries.append(carry)
    radiance = carry[3]

    # ---- backward: one segment's replay at a time ----
    # o and d carry no gradient (the sampled directions are detached), so only the
    # throughput and radiance cotangents flow between segments
    ct_T = torch.zeros((b, 3), dtype=REAL, device=o.device)
    ct_L = torch.as_tensor(cotangent, dtype=REAL, device=o.device)
    grads = {n: torch.zeros_like(v) for n, v in params.items()}
    chunks = []  # (flat gradient chunk, its all-reduce handle) a segment, under a mesh
    for seg in reversed(range(n_seg)):
        o_s, d_s, T_s, L_s, alive_s = carries[seg]
        if not bool(alive_s.any()):
            g = {n: torch.zeros_like(v) for n, v in params.items()}
        else:
            p = _leaves(params)
            T_s, L_s = T_s.detach().requires_grad_(True), L_s.detach().requires_grad_(True)
            with torch.enable_grad():
                _, _, T_o, L_o, _ = seg_f(p, (o_s, d_s, T_s, L_s, alive_s), seg)
                loss = (T_o * ct_T).sum() + (L_o * ct_L).sum()
                g = _grads(loss, dict(p, _T=T_s, _L=L_s))
            ct_T, ct_L = g.pop("_T"), g.pop("_L")
        if mesh is None:
            for n in grads:
                grads[n] = grads[n] + g[n]
        else:  # one collective a segment, started now and waited on at the end
            flat = torch.cat([g[n].reshape(-1) for n in grads])
            chunks.append((flat, mesh.all_reduce(flat, async_op=True)))
    if chunks:
        for _, handle in chunks:
            if handle is not None:
                handle.wait()
        total = chunks[0][0]
        for flat, _ in chunks[1:]:  # in the order of the loop above, as without a mesh
            total = total + flat
        sizes = [v.numel() for v in grads.values()]
        grads = {n: x.reshape(v.shape) for (n, v), x in zip(grads.items(), total.split(sizes))}
    return radiance, grads


def make_pixel_fn(compiled, camera, with_rays=False, segment_size=SEGMENT):
    """Build `f(params, pixel_ids, rows, cols, sample_ids, seed) -> radiance [B,3]`.

    f is differentiable in `params` (a dict by DIFF_FIELDS name) by autograd. Sample
    averaging is the caller's: pass (pixel, sample) pairs flattened along the batch
    axis. with_rays=True makes it return (radiance, rays traced).
    """
    sd = compiled.data
    cam = camera.init(sd.device)
    max_depth = camera.max_depth
    has_lights = compiled.has_lights

    def f(params, pixel_ids, rows, cols, sample_ids, seed):
        return trace_radiance_scan(
            apply_params(sd, params), cam, pixel_ids, rows, cols, sample_ids, seed,
            max_depth, has_lights, segment_size=segment_size, with_rays=with_rays,
        )

    return f


def render_grads(
    compiled, camera, pixel_ids, spp: int, seed: int = 0, cotangent=None,
    segment_size=SEGMENT, return_stats=False,
):
    """Pixel radiances and parameter gradients for a pixel block.

    Returns (radiance [npix,3] averaged over spp, grads of sum(cotangent * radiance)
    by DIFF_FIELDS name); cotangent [npix,3] defaults to ones. return_stats=True
    appends the traced-ray count.

    On CUDA the masked scan and its backward run as CUDA graphs over
    ``RadianceScanStages`` (render/graph.py, ``radiance_graphs``), kept on the compiled
    scene for later calls of the same configuration (pixel ids, seed, cotangent, the
    parameters' values and the camera are inputs), as the reference jits
    ``_value_and_grad_call``; within ``plain_grads()``, and on the CPU, it runs the eager
    route (checkpointed trips, autograd). The outputs are the caller's own tensors either way.
    """
    with trace.span("grads"):
        return _render_grads(compiled, camera, pixel_ids, spp, seed, cotangent, segment_size, return_stats)


def _render_grads(compiled, camera, pixel_ids, spp, seed, cotangent, segment_size, return_stats):
    sd = compiled.data
    dev = sd.device
    w = camera.image_width
    ids = torch.as_tensor(pixel_ids, dtype=torch.int32, device=dev)
    npix = ids.shape[0]
    pix = torch.repeat_interleave(ids, spp)
    rows, cols = pix // w, pix % w
    samp = torch.arange(spp, dtype=torch.int32, device=dev).repeat(npix)
    if cotangent is None:
        cot = torch.ones((npix, spp, 3), dtype=REAL, device=dev) / spp
    else:
        c = torch.as_tensor(cotangent, dtype=REAL, device=dev)
        cot = c[:, None, :].expand(npix, spp, 3) / spp

    if dev.type == "cuda" and not _plain:
        from .graph import radiance_graphs

        cam = camera.init(dev)
        graphs = radiance_graphs(compiled, sd, cam, pix.shape[0], camera.max_depth, compiled.has_lights,
                                 segment_size)
        graphs.forward(pix, rows, cols, samp, init_params(sd), cot.reshape(-1, 3), seed, cam)
        val, grads, rays = graphs.backward()
    else:
        fn = make_pixel_fn(compiled, camera, with_rays=True, segment_size=segment_size)
        params = _leaves(init_params(sd))
        with torch.enable_grad():
            val, rays = fn(params, pix, rows, cols, samp, seed)
            grads = _grads((val * cot.reshape(-1, 3)).sum(), params)
    radiance = val.detach().reshape(npix, spp, 3).mean(dim=1)
    if return_stats:
        return radiance, grads, rays
    return radiance, grads
