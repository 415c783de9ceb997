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

import copy
import dataclasses
import time as _time

import torch
from torch.utils.checkpoint import checkpoint

from ..core.dtypes import REAL
from ..ops import bvh_kernel, hit_kernel, tri_kernel
from .camera import generate_rays
from .integrator import _mis_probs, _radiance_step, _stream_step, stream_state

# SceneData fields exposed as differentiable parameters
DIFF_FIELDS = ("mat_params", "tex_rgb", "env_color", "env_img", "atlas")

SEGMENT = 8  # trips per early-exit segment


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
    trips = 0
    for _ in range(-(-(k * max_depth) // segment_size)):
        work = s["alive"] | ((s["sample"] < k) & ((s["sample0"] + s["sample"]) < spp_limit))
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
    return (s["film"], int(rays)) if with_rays else s["film"]


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


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    """
    sd = compiled.data
    dev = sd.device
    cam = camera.init(dev)
    w, h = camera.image_width, camera.image_height
    spp = camera.samples_per_pixel if spp is None else spp
    npix = w * h
    if replicas is None:
        replicas = max(1, min((1 << 18) // npix, spp))
    while spp % replicas:  # k must be exact: every sample traced exactly once
        replicas -= 1
    r = replicas
    k = spp // r

    pix = torch.arange(npix, dtype=torch.int32, device=dev).repeat(r)
    rows, cols = pix // w, pix % w
    lane_sample0 = torch.repeat_interleave(torch.arange(r, dtype=torch.int32, device=dev) * k, npix)
    if cotangent is None:
        cot_pix = torch.ones((npix, 3), dtype=REAL, device=dev)
    else:
        cot_pix = torch.as_tensor(cotangent, dtype=REAL, device=dev).reshape(npix, 3)
    cot = cot_pix.repeat(r, 1) / spp

    params = _leaves(init_params(sd))
    stats = GradStats(lanes=pix.shape[0])
    scan_stats = {}
    before = _kernel_launches()
    t0 = _time.perf_counter()
    with torch.enable_grad():
        film, stats.rays = trace_film_scan(
            apply_params(sd, params), cam, pix, rows, cols, lane_sample0, spp, seed, k,
            camera.max_depth, compiled.has_lights, segment_size=segment_size,
            with_rays=True, stats=scan_stats,
        )
        _sync(dev)
        t1 = _time.perf_counter()
        mid = _kernel_launches()
        grads = _grads((film * cot).sum(), params)
    _sync(dev)
    stats.forward_s, stats.backward_s = t1 - t0, _time.perf_counter() - t1
    after = _kernel_launches()
    stats.trips = scan_stats["trips"]
    stats.launches_forward = {n: mid[n] - before[n] for n in before}
    stats.launches_backward = {n: after[n] - mid[n] for n in before}
    mean = (film.detach().reshape(r, npix, 3).sum(0) / spp).reshape(h, w, 3)
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
    DIFF_FIELDS name, summed over the mesh).
    """
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
    """
    sd = compiled.data
    dev = sd.device
    fn = make_pixel_fn(compiled, camera, with_rays=True, segment_size=segment_size)
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

    params = _leaves(init_params(sd))
    with torch.enable_grad():
        val, rays = fn(params, pix, rows, cols, samp, seed)
        grads = _grads((val * cot.reshape(-1, 3)).sum(), params)
    radiance = val.detach().reshape(npix, spp, 3).mean(dim=1)
    if return_stats:
        return radiance, grads, rays
    return radiance, grads
