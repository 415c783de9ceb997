"""Host-side render driver: chunks the (pixel, sample) space into launches.

Counterpart of ``tpupt/render/renderer.py``. The (pixel, sample) space is flattened
into lanes of fixed-size launches; each launch runs the path-regeneration wavefront
and its film is added into a float64 film that lives on the scene's device. On a CUDA
device a launch is one device program, as the reference's jitted launch is: CUDA graphs
whose wavefront loops run on the card (render/graph.py), captured at the first launch of
a shape and kept on the compiled scene, as ``jax.jit`` keeps ``_chunk_film``: later
launches and later calls, with any seed and camera, replay them. The CPU runs the eager
loop (integrator.trace_film_streamed), which is also the graphs' plain version
(``plain_launches``). Runs on the compiled scene's device; with a mesh
(parallel/sharding.py), each process traces its own sample slice of every launch on its
device and the film is all-reduced once a launch, outside the graphs.

The film stays on the device (ops/film_kernel.py): each launch's film is added in at its
pixel ids there, and once a call the film is resolved there into the mean radiance and
the quantized image, the two arrays that cross to the host. A launch schedule's inputs
(the Morton order's pixel blocks, their lanes and first samples) are made on the device
at their first use and kept on the compiled scene, so a repeated call uploads nothing and
runs nothing over pixels on the host. The film crosses to the host only where an option
asks for it: ``checkpoint_path`` (the film), ``on_launch`` (the mean so far), and
``debug_checks`` reads one flag a launch, and the bad pixels' ids only when it is set.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import time as _time

import numpy as np
import torch

from .. import trace
from ..ops import film_kernel, hit_kernel
from ..scene.compile import CompiledScene
from .camera import Camera
from ..parallel.sharding import Mesh, all_reduce_film
from .graph import LaunchGraphs, launch_graphs
from .integrator import trace_film_streamed


@dataclasses.dataclass
class RenderStats:
    wall_s: float = 0.0
    paths: int = 0
    rays: int = 0  # scene intersections of live lanes (every bounce counts)
    launches: int = 0
    # wavefront iterations (on the CPU each costs one host sync; on CUDA they run on the
    # card, counted there); under a mesh, this rank's own
    iterations: int = 0
    # host seconds spent capturing and instantiating launch graphs in this call (CUDA; part of
    # wall_s; 0 when every launch replayed graphs kept from an earlier call)
    capture_s: float = 0.0
    work_lanes: int = 0  # lanes with work, summed over every wavefront iteration
    lane_slots: int = 0  # each stage's lanes times its iterations, summed: work_lanes' most
    # the card's seconds in the launches' chains, from their stamps of the card's clock (CUDA
    # graphs; 0 on the eager loop)
    device_s: float = 0.0
    # iterations whose step ran on the regeneration and shading kernels (CUDA graphs; 0 on the
    # eager loop)
    fused_iterations: int = 0
    # K1's tile cull (ops/hit_kernel.py, K1_COUNTS), summed over its calls in the wavefront; 0
    # where the sphere table is one tile, swept whole: the rays K1 took; those rays times the
    # table's tiles; the tiles the rays entered; the tiles their warps swept times the warps' rays
    k1_lanes: int = 0
    k1_tile_slots: int = 0
    k1_tiles_entered: int = 0
    k1_tiles_swept: int = 0
    # launches that took their inputs from the kept buffers (made by an earlier call) and
    # added their film on the device with no host copy of it
    host_free_launches: int = 0

    @property
    def paths_per_s(self) -> float:
        return self.paths / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.wall_s if self.wall_s > 0 else 0.0


class TransientLaunchError(RuntimeError):
    """A launch failure worth one retry (raised by the fault hook in tests).

    Only this type is retried: a kernel build or launch error is a RuntimeError
    of another type and propagates at once.
    """


# Fault-injection hook (tests only): called as _fault_hook(launch_index) before
# every launch attempt; raising TransientLaunchError from it simulates a
# transient launch failure.
_fault_hook = None

_plain = False  # CUDA launches run the eager loop (plain_launches)


@contextlib.contextmanager
def plain_launches():
    """Within the block, CUDA launches run the eager loop (trace_film_streamed, one host
    sync an iteration) instead of the graphs: the plain version that the tests and
    chip_smoke.py hold the graphs against, film bit for bit."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def _morton_pixel_order(w: int, h: int) -> np.ndarray:
    """Pixel ids in Z-order (Morton) instead of scanline order.

    Neighbouring lanes then hold neighbouring pixels (16x8 tiles per 128 lanes),
    whose rays stay coherent for longer. The film scatter is by explicit pixel id
    and per-pixel radiance is RNG-counter deterministic, so the image does not
    depend on the order.
    """

    def part1by1(x):
        x = x.astype(np.uint64)
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
        return x

    cols = np.tile(np.arange(w, dtype=np.int64), h)
    rows = np.repeat(np.arange(h, dtype=np.int64), w)
    code = part1by1(cols) | (part1by1(rows) << np.uint64(1))
    return np.argsort(code, kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=8)
def _pixel_order(w: int, h: int) -> np.ndarray:
    """``_morton_pixel_order(w, h)``, made once per (w, h) and kept read-only: the host's copy
    of the order, whose ids the errors quote."""
    order = _morton_pixel_order(w, h)
    order.flags.writeable = False
    return order


def lane_first_samples(pb, n_valid, r, k, sample0, spp_limit) -> np.ndarray:
    """Each lane's first sample id [r*pb] int32, on the host: lane j*pb + i takes pixel i's
    samples from sample0 + j*k; lanes past n_valid (padding) start at spp_limit."""
    first = sample0 + np.repeat(np.arange(r, dtype=np.int64) * k, pb)
    return np.where(np.tile(np.arange(pb) < n_valid, r), first, spp_limit).astype(np.int32)


def _lanes(ids, r, width):
    """A pixel block's lanes, r a pixel (lane j*pb + i is pixel i's) -> (pix, rows, cols) on
    the ids' device."""
    pix = ids.repeat(r)
    return pix, pix // width, pix % width


def _first_samples(pb, n_valid, r, k, sample0, spp_limit, device):
    """``lane_first_samples`` on `device` -> (lane_sample0, n_work0: the count of lanes with
    a first sample to take)."""
    first = lane_first_samples(pb, n_valid, r, k, sample0, spp_limit)
    return torch.from_numpy(first).to(device), int((first < spp_limit).sum())


class _Schedule:
    """The inputs of one launch schedule's launches on the scene's device, each made at its
    first use and kept: a pixel block's ids (the Morton order's slice, padded with id 0) and
    lanes, a launch's first samples. A later call of the schedule uploads nothing."""

    def __init__(self, order, device, pb, r, k, spp, spl, dev_sample0, width):
        self.order, self.device, self.pb, self.r, self.k = order, device, pb, r, k
        self.spp, self.spl, self.dev_sample0, self.width = spp, spl, dev_sample0, width
        self._blocks: dict[int, tuple] = {}
        self._launches: dict[tuple, tuple] = {}

    def launch(self, pblk, schunk):
        """-> (ids [pb] int32 on the device, n_valid, (pix, rows, cols, lane_sample0, n_work0),
        kept): kept False when this call made any of them."""
        kept = True
        lo = pblk * self.pb
        n_valid = min(self.pb, self.order.shape[0] - lo)
        block = self._blocks.get(pblk)
        if block is None:
            kept = False
            ids = np.zeros(self.pb, np.int32)  # padded lanes take id 0 and never start a path
            ids[:n_valid] = self.order[lo : lo + n_valid]
            ids = torch.from_numpy(ids).to(self.device)
            block = self._blocks[pblk] = (ids, *_lanes(ids, self.r, self.width))
        first = self._launches.get((pblk, schunk))
        if first is None:
            kept = False
            first = self._launches[(pblk, schunk)] = _first_samples(
                self.pb, n_valid, self.r, self.k, schunk * self.spl + self.dev_sample0, self.spp, self.device)
        ids, *lanes = block
        return ids, n_valid, (*lanes, *first), kept


KEPT_SCHEDULES = 4  # launch schedules kept on a compiled scene; the least recently used goes


def _schedule(compiled, w, h, pb, r, k, spp, spl, n_dev, dev_sample0) -> _Schedule:
    """The launch schedule's kept inputs on `compiled` (made at first use, freed with it or
    when KEPT_SCHEDULES later-used schedules are kept)."""
    kept = compiled.__dict__.setdefault("_render_schedules", collections.OrderedDict())
    key = (w, h, pb, r, k, spp, n_dev, dev_sample0)
    sched = kept.pop(key, None)
    if sched is None:
        sched = _Schedule(_pixel_order(w, h), compiled.data.device, pb, r, k, spp, spl, dev_sample0, w)
    kept[key] = sched
    while len(kept) > KEPT_SCHEDULES:
        kept.popitem(last=False)
    return sched


def _chunk_film(sd, cam, pixel_ids, n_valid, sample0, spp_limit, seed, *, k, r, max_depth,
                has_lights, width, graphs=None, counts=None):
    """Film sums of up to r*k samples per pixel in `pixel_ids` -> ([pb,3], rays, iterations).

    r lanes per pixel, each streaming its own k-sample slice (replica j takes
    samples [sample0 + j*k, ...)). Lanes past n_valid (padding of the final pixel
    block) start at spp_limit, so they never start a path. See ``_trace_launch``.
    """
    with trace.span("render.inputs"):
        inputs = (*_lanes(pixel_ids, r, width),
                  *_first_samples(pixel_ids.shape[0], n_valid, r, k, sample0, spp_limit, pixel_ids.device))
    return _trace_launch(sd, cam, inputs, spp_limit, seed, k=k, r=r, max_depth=max_depth,
                         has_lights=has_lights, graphs=graphs, counts=counts)


def _trace_launch(sd, cam, inputs, spp_limit, seed, *, k, r, max_depth, has_lights, graphs=None,
                  counts=None):
    """One launch -> (film sums [pb,3], rays, iterations). inputs: (pix, rows, cols,
    lane_sample0, n_work0), the launch's lanes (r a pixel) on the scene's device and the count
    of those with a first sample to take. On CUDA the launch runs as graphs: those of
    `graphs` (a LaunchGraphs), else graphs made for this launch alone; the film is then a
    buffer of the graphs, valid until their next launch. counts (a dict), if given, gets the
    launch's "work_lanes", "lane_slots", "device_s", "fused_iterations" and K1's counts
    (``hit_kernel.K1_COUNTS``) added.
    """
    pix, rows, cols, lane_sample0, n_work0 = inputs
    pb = pix.shape[0] // r
    dev = pix.device
    if dev.type == "cuda" and not _plain:
        args = (sd, cam, pix, rows, cols, lane_sample0, n_work0)
        kw = dict(spp_limit=spp_limit, seed=seed, k=k, r=r, max_depth=max_depth, has_lights=has_lights,
                  counts=counts)
        if graphs is not None:
            return graphs.run(*args, **kw)
        with LaunchGraphs() as own:
            return own.run(*args, **kw)
    stages = []
    k1 = torch.zeros(len(hit_kernel.K1_COUNTS), dtype=torch.int64, device=dev) if counts is not None else None
    with trace.span("render.eager"):
        film, rays, iters = trace_film_streamed(
            sd, cam, pix, rows, cols, lane_sample0, spp_limit, seed, k, max_depth, has_lights, stages=stages,
            k1_counts=k1,
        )
    if counts is not None:
        counts["work_lanes"] = counts.get("work_lanes", 0) + sum(work for _, _, work in stages)
        counts["lane_slots"] = counts.get("lane_slots", 0) + sum(lanes * ran for lanes, ran, _ in stages)
        for key, n in zip(hit_kernel.K1_COUNTS, k1.tolist()):
            counts[key] = counts.get(key, 0) + n
    return film.reshape(r, pb, 3).sum(dim=0), rays, iters


def render_image(
    compiled: CompiledScene,
    camera: Camera,
    seed: int = 0,
    rays_per_launch: int = 1 << 20,
    samples_per_launch: int = 128,
    progress: bool = True,
    checkpoint_path: str | None = None,
    on_launch=None,
    profile_dir: str | None = None,
    debug_checks: bool = False,
    mesh=None,
):
    """Render -> (uint8 image [H,W,3], float32 mean radiance [H,W,3], RenderStats).

    Runs on the device the scene was compiled for (``Scene.compile(device=...)``). On a
    CUDA device each launch runs as CUDA graphs whose wavefront loops run on the card
    (render/graph.py): captured at the first launch of a shape (stats.capture_s), kept on
    the compiled scene and replayed by later launches and calls (made anew when the
    scene's fields move), one host read a launch; a failure to capture or launch them
    raises. The CPU runs the eager loop.

    rays_per_launch bounds the lane count (pixel block size) of a launch;
    samples_per_launch bounds how many samples each lane streams per launch.

    The float64 film lives on the scene's device: each launch's film is added in there,
    and the call's end resolves it there into the image and the mean, two arrays that
    cross to the host once and belong to the caller (fresh at every call). The launch
    schedule's inputs (about 16 B a lane) are kept on the compiled scene, for its
    last KEPT_SCHEDULES schedules, so a repeated call uploads none.

    checkpoint_path: persist (film accumulator, launch cursor, stats) after every
    launch, the film copied to the host for it, and resume from it when the file
    exists (the film back onto the device). Resuming is exact: the
    counter-based RNG makes a resumed render bit-identical to an uninterrupted
    one. The config fingerprint is verified on load; a mismatch raises.

    on_launch(mean_so_far [H,W,3] f32, samples_done_fraction) is called after
    every launch, with the film so far over its samples copied to the host.

    profile_dir: trace the render with torch.profiler (CPU, and CUDA on a card) and
    write a Chrome trace, ``render_rank{i}.json`` (i = the mesh index, 0 without a
    mesh), into the directory, with the program's spans and the card's intervals
    (tpupt_torch/trace.py) merged in on the profiler's clock: those of the recording in
    progress (from its start), else of one made for this call.

    debug_checks: validate every launch's film for NaN/Inf on the device (one flag read a
    launch) and raise with the launch coordinates and the first bad pixels' ids.

    mesh: a parallel.sharding.Mesh to scale the render over (one process a device;
    every rank of the mesh calls render_image). Each rank traces its own r*k-sample
    slice of every launch with the same streamed wavefront; the film and the ray
    count are all-reduced once a launch, so every rank returns the same image. Only
    index 0 writes the checkpoint; every rank resumes from it.

    Spans (with a recording on): ``render`` (the call; its attrs the RenderStats), and in
    it ``render.order``, ``render.inputs``, ``render.capture``, ``render.wait`` (CUDA
    graphs: from the chain's launch to the launch's host read; the card's ``card.chain``
    and ``card.stage{i}`` under it) or ``render.eager`` (the eager loop),
    ``render.all_reduce``, ``render.accumulate`` (the film's add on the device, the checks,
    the checkpoint, ``on_launch``), ``render.tonemap`` (the film resolved on the device) and
    ``render.readback`` (the film or the mean so far to the host for a checkpoint or
    ``on_launch``; the image and the mean at the call's end).
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"render_image: mesh must be a parallel.sharding.Mesh, got {type(mesh).__name__}")
    args = (compiled, camera, seed, rays_per_launch, samples_per_launch, progress, checkpoint_path, on_launch,
            debug_checks, mesh)
    if profile_dir is None:
        return _render_image(*args)
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if compiled.data.device.type == "cuda" else [])
    rec = trace.active()
    with contextlib.ExitStack() as stack:
        if rec is None:
            rec = stack.enter_context(trace.recording())
        prof = stack.enter_context(profile(activities=acts))
        out = _render_image(*args)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"render_rank{0 if mesh is None else mesh.index}.json")
    prof.export_chrome_trace(path)
    trace.merge_chrome_trace(path, rec)
    return out


def _render_image(compiled, camera, seed, rays_per_launch, samples_per_launch, progress, checkpoint_path,
                  on_launch, debug_checks, mesh):
    with trace.span("render") as call:
        img, mean, stats = _render_launches(compiled, camera, seed, rays_per_launch, samples_per_launch, progress,
                                            checkpoint_path, on_launch, debug_checks, mesh)
        if call is not None:
            call.attrs.update(dataclasses.asdict(stats))
    return img, mean, stats


def _render_launches(compiled, camera, seed, rays_per_launch, samples_per_launch, progress, checkpoint_path,
                     on_launch, debug_checks, mesh):
    sd = compiled.data
    dev = sd.device
    cam = camera.init(dev)
    w, h = camera.image_width, camera.image_height
    spp = camera.samples_per_pixel
    npix = w * h
    n_dev = 1 if mesh is None else mesh.size

    pb = min(npix, rays_per_launch)
    # launch schedule, inherited from the reference package (not yet re-derived
    # for this card): replicate pixels across lanes only while the pixel block is
    # below LANE_TARGET lanes, and keep each lane's sample slice k as long as
    # samples_per_launch allows. r and k are per device: a launch covers
    # n_dev * r * k samples a pixel.
    LANE_TARGET = 1 << 18
    if pb >= LANE_TARGET:
        r = 1
    else:
        r = max(1, min(LANE_TARGET // pb + 1, rays_per_launch // pb, spp // 8))
    k = min((spp + n_dev * r - 1) // (n_dev * r), samples_per_launch)
    spl = n_dev * r * k  # samples per pixel per launch
    n_pixel_blocks = (npix + pb - 1) // pb
    n_sample_chunks = (spp + spl - 1) // spl
    total_launches = n_pixel_blocks * n_sample_chunks

    # the reference's fingerprint layout (..., n_dev, Morton pixel order = 1)
    fingerprint = np.array([w, h, spp, seed, pb, k, r, camera.max_depth, n_dev, 1], dtype=np.int64)
    film = torch.zeros((npix, 3), dtype=torch.float64, device=dev)
    stats = RenderStats()
    start_it = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if not np.array_equal(ck["fingerprint"], fingerprint):
            raise ValueError(
                f"checkpoint {checkpoint_path} was written for a different render "
                f"config ({ck['fingerprint']} vs {fingerprint})"
            )
        film = torch.tensor(ck["film"], dtype=torch.float64, device=dev)
        start_it = int(ck["next_it"])
        stats.launches = start_it
        stats.paths = int(ck["paths"])
        stats.rays = int(ck["rays"])
        if progress:
            print(f"  resuming at launch {start_it}/{total_launches}", flush=True)

    # this rank's first sample of a launch, after the launch's first sample
    dev_sample0 = 0 if mesh is None else mesh.index * r * k
    with trace.span("render.order"):
        order = _pixel_order(w, h)
        sched = _schedule(compiled, w, h, pb, r, k, spp, spl, n_dev, dev_sample0)
    graphs = launch_graphs(compiled) if dev.type == "cuda" and not _plain else None
    capture0 = graphs.capture_s if graphs is not None else 0.0
    counts = {}
    t0 = _time.perf_counter()
    for it in range(start_it, total_launches):
        pblk, schunk = divmod(it, n_sample_chunks)
        with trace.span("render.inputs"):
            ids, n_valid, inputs, kept = sched.launch(pblk, schunk)
        for attempt in (0, 1):  # one launch-level retry on a transient failure
            try:
                if _fault_hook is not None:
                    _fault_hook(it)
                out, rays, iters = _trace_launch(
                    sd, cam, inputs, spp, seed, k=k, r=r, max_depth=camera.max_depth,
                    has_lights=compiled.has_lights, graphs=graphs, counts=counts,
                )
                break
            except TransientLaunchError:
                if attempt == 1:
                    raise
                if progress:
                    print(f"  launch {it} failed transiently; retrying", flush=True)
        if mesh is not None:  # after the retry scope: every rank joins once a launch
            with trace.span("render.all_reduce"):
                out, rays = all_reduce_film(mesh, out, rays)
        with trace.span("render.accumulate"):
            if debug_checks:
                bad = ~torch.isfinite(out[:n_valid]).all(dim=-1)
                if bool(bad.any()):  # the one flag a launch; the ids only when it is set
                    lanes = torch.nonzero(bad).flatten().cpu().numpy()
                    raise FloatingPointError(
                        f"non-finite film at launch {it} (pixel block {pblk}, sample "
                        f"chunk {schunk}): {len(lanes)} pixels, first ids "
                        f"{order[pblk * pb + lanes[:8]].tolist()}"
                    )
            film_kernel.add(film, out, ids, n_valid)
            stats.launches += 1
            stats.paths += n_valid * min(spl, spp - schunk * spl)
            stats.rays += rays
            stats.iterations += iters
            copied = False
            if checkpoint_path is not None and (mesh is None or mesh.index == 0):
                with trace.span("render.readback"):
                    host_film = film.cpu().numpy()
                copied = True
                tmp = checkpoint_path + ".tmp.npz"
                np.savez(
                    tmp,
                    film=host_film,
                    next_it=np.int64(it + 1),
                    paths=np.int64(stats.paths),
                    rays=np.int64(stats.rays),
                    fingerprint=fingerprint,
                )
                os.replace(tmp, checkpoint_path)  # atomic: partial writes never land
            if checkpoint_path is not None and mesh is not None:
                mesh.barrier()  # no rank runs ahead of the launch the checkpoint holds
            if on_launch is not None:
                done_spp = min((schunk + 1) * spl, spp)
                with trace.span("render.readback"):
                    so_far = (film / max(done_spp, 1)).reshape(h, w, 3).to(torch.float32).cpu().numpy()
                copied = True
                on_launch(so_far, (it + 1) / total_launches)
            stats.host_free_launches += int(kept and not copied)
            if progress and schunk == n_sample_chunks - 1:
                print(f"  pixel block {pblk + 1}/{n_pixel_blocks} done", flush=True)

    stats.wall_s = _time.perf_counter() - t0
    stats.capture_s = graphs.capture_s - capture0 if graphs is not None else 0.0
    stats.work_lanes = counts.get("work_lanes", 0)
    stats.lane_slots = counts.get("lane_slots", 0)
    stats.device_s = counts.get("device_s", 0.0)
    stats.fused_iterations = counts.get("fused_iterations", 0)
    for key in hit_kernel.K1_COUNTS:
        setattr(stats, key, counts.get(key, 0))
    with trace.span("render.tonemap"):
        img, mean = film_kernel.resolve(film, spp)
    with trace.span("render.readback"):  # fresh host arrays, the caller's own
        return img.cpu().numpy().reshape(h, w, 3), mean.cpu().numpy().reshape(h, w, 3), stats
