"""The path-tracing integrator (counterpart of ``tpupt/render/integrator.py``).

Reproduces the estimator of Camera::trace (camera.rs:170-228):

  for bounce in 0..max_depth:
      hit = intersect everything in (1e-3, inf)
      miss  -> radiance += T * environment; stop
      radiance += T * emitted
      bounce > 5 -> russian roulette with p = clamp(luminance(T), 0.01, 1)
      one-sample MIS: with prob p_light sample the light list, else the BSDF
      (sample = None -> stop)
      pdf  = p_bsdf * bsdf_pdf + p_light * light_pdf   (mixture, camera.rs:212-214)
      T   *= eval / pdf
      next origin = hit + 1e-3 * sign(dir . ng) * ng   (camera.rs:217-222)

Every lane carries an `alive` mask and the wavefront iterates until all lanes are
done. In ``trace_film_streamed`` (the plain version, and the CPU's route) the loop
condition is read on the host, one device-to-host sync an iteration.
``StreamStages`` runs the same wavefront over state at fixed addresses, updated in
place, with its condition and counters on the device: render/graph.py captures its
parts into the CUDA graph of a launch, in which the loop runs on the card. Division
by a zero pdf is left unguarded like the reference (NaNs quantize to black in
film.py).

p_light is 0.5 iff the scene has lights (camera.rs:199); without lights the
light-sampling branch is skipped entirely. With an HDR environment the
environment is a light member, so p_light is 0.5 then too (scene/compile.py).

``bounce_step(detach=True)`` is the detached estimator of the gradient
integrators (render/diff.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import linalg as la
from ..core import rng
from ..core.dtypes import REAL
from ..ops import lights as light_ops
from ..ops.bsdf import bsdf_eval, bsdf_pdf, bsdf_sample, make_shade
from ..ops.envmap import sample_environment
from ..ops.intersect import closest_hit, hit_kernels
from ..ops import hit_kernel, loop_cond, wavefront_kernel
from ..scene import data as D
from .camera import generate_rays

T_MIN = la.f32(1e-3)  # camera.rs:171
T_MAX = la.BIG
EPS = la.f32(1e-3)  # bsdf/mod.rs:19
MIN_BOUNCES = 5  # camera.rs:172


def bounce_step(
    sd, o, d, time, T, L, alive, bounce, pixel_ids, sample_ids, seed, p_light, p_bsdf, has_lights,
    *, detach=False, k1_counts=None,
):
    """One bounce of the reference estimator (camera.rs:177-226) over a lane batch.

    `bounce` is an int or a per-lane int tensor. Returns (o_next, d_next, T, L,
    alive); callers mask o/d updates by `alive`.

    detach=True builds the detached-sampling estimator for reverse-mode gradients:
    every sampling-derived quantity (the sampled direction, the mixture pdf, the
    russian-roulette survival probability) is detached, so pixel gradients flow only
    through the integrand factors (bsdf eval, emission, environment); with the pdf
    carrying no gradient, E[d(f)/p] = d E[f/p]. It also guards the pdf division: a
    zero pdf kills the lane instead of making a NaN, which would poison the backward
    pass even where a mask drops it. detach=False is the forward estimator.
    k1_counts, if given, gets K1's counts of its tile cull added (``closest_hit``).
    """
    sg = torch.Tensor.detach if detach else (lambda x: x)

    hit = closest_hit(sd, o, d, time, T_MIN, T_MAX, alive=alive, k1_counts=k1_counts)

    # miss -> environment (camera.rs:180-183)
    env = sample_environment(sd, d)
    missed = alive & ~hit.valid
    L = L + torch.where(missed[..., None], T * env, 0.0)
    alive = alive & hit.valid

    # emission from the hit (camera.rs:186-187)
    shade = make_shade(sd, hit.mat_id, hit.u, hit.v, hit.point, hit.ng, hit.ns, hit.front)
    L = L + torch.where(alive[..., None], T * shade.emission, 0.0)

    # per-bounce uniforms
    ctrl = rng.bounce_ctr(bounce)
    rr_u, mis_r, light_pick, lobe_u = rng.uniform4(seed, pixel_ids, sample_ids, ctrl + rng.SLOT_CTRL)
    e1, e2, fresnel_u, _ = rng.uniform4(seed, pixel_ids, sample_ids, ctrl + rng.SLOT_BSDF)

    # russian roulette after MIN_BOUNCES (camera.rs:190-196)
    p = sg(la.clip(la.luminance(T), 0.01, 1.0))
    rr_on = alive & (bounce > MIN_BOUNCES)
    die = rr_on & (rr_u > p)
    alive = alive & ~die
    T = torch.where((rr_on & alive)[..., None], T / p[..., None], T)

    # one-sample MIS between light and BSDF sampling (camera.rs:198-211)
    view = -d
    b_dir, b_ok = bsdf_sample(shade, view, lobe_u, e1, e2, fresnel_u)
    if has_lights:
        lu1, lu2, _, _ = rng.uniform4(seed, pixel_ids, sample_ids, ctrl + rng.SLOT_LIGHT)
        l_dir, l_is_env = light_ops.sample_lights(sd, hit.point, time, light_pick, lu1, lu2)
        if sd.env_is_hdr:
            # the env member aimed below the shading horizon of an opaque lane: the
            # reference's |cos| eval would transmit, so it counts as a failed sample
            # (sample() -> None ends the path, camera.rs:209-211) and the estimator
            # integrates the clamped BRDF. Glass and principled keep such directions.
            opaque = (shade.mtype == D.MAT_DIFFUSE) | (shade.mtype == D.MAT_METAL)
            below = la.dot(l_dir, hit.ns) <= 0.0
            l_ok = ~(l_is_env & opaque & below)
        else:
            l_ok = torch.ones_like(b_ok)
        use_light = mis_r < p_light
        new_dir = torch.where(use_light[..., None], l_dir, b_dir)
        ok = torch.where(use_light, l_ok, b_ok)
    else:
        new_dir = b_dir
        ok = b_ok
    new_dir = sg(new_dir)
    alive = alive & ok

    # mixture pdf + eval (camera.rs:212-216)
    pdf_b = bsdf_pdf(shade, view, new_dir)
    if has_lights:
        pdf_l = light_ops.pdf_lights(sd, hit.point, new_dir, time)
        pdf = p_bsdf * pdf_b + p_light * pdf_l
    else:
        pdf = p_bsdf * pdf_b
    brdf = bsdf_eval(shade, view, new_dir)
    if detach:
        pdf = sg(pdf)
        alive = alive & (pdf > 0.0)
        atten = brdf / torch.where(pdf > 0.0, pdf, 1.0)[..., None]
    else:
        atten = brdf / pdf[..., None]  # unguarded, like the reference (camera.rs:216)
    T = torch.where(alive[..., None], T * atten, T)

    # offset next origin along the geometric normal (camera.rs:217-222)
    eps = EPS * torch.sign(la.dot(new_dir, hit.ng))
    o_next = hit.point + eps[..., None] * hit.ng
    d_next = la.normalize(new_dir, eps=1e-30)  # Ray::new normalizes (ray.rs:26)

    return o_next, d_next, T, L, alive


def _mis_probs(has_lights):
    p_light = 0.5 if has_lights else 0.0
    return p_light, 1.0 - p_light


def trace_radiance(sd, cam, pixel_ids, rows, cols, sample_ids, seed, max_depth, has_lights):
    """Trace one path per lane -> (radiance [B,3], rays_traced int).

    rays_traced counts the scene intersections of live lanes.
    """
    o, d, time = generate_rays(cam, rows, cols, pixel_ids, sample_ids, seed)
    b = pixel_ids.shape[0]
    dev = o.device
    T = torch.ones((b, 3), dtype=REAL, device=dev)
    L = torch.zeros((b, 3), dtype=REAL, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    bounce = 0
    while bounce < max_depth and bool(alive.any()):
        o, d, T, L, alive, n_rays = _radiance_step(
            sd, (time, pixel_ids, sample_ids, seed), o, d, T, L, alive, bounce, has_lights
        )
        rays = rays + n_rays
        bounce += 1
    return L, int(rays)


def _radiance_step(sd, lane_args, o, d, T, L, alive, bounce, has_lights, detach=False):
    """One bounce of every lane's single path -> (o, d, T, L, alive, rays traced).

    lane_args is (time, pixel_ids, sample_ids, seed). Also the trip of the
    differentiable masked scan (render/diff.py), with detach=True.
    """
    time, pixel_ids, sample_ids, seed = lane_args
    p_light, p_bsdf = _mis_probs(has_lights)
    n_rays = alive.sum()
    o_next, d_next, T, L, alive = bounce_step(
        sd, o, d, time, T, L, alive, bounce, pixel_ids, sample_ids, seed,
        p_light, p_bsdf, has_lights, detach=detach,
    )
    o = torch.where(alive[..., None], o_next, o)
    d = torch.where(alive[..., None], d_next, d)
    return o, d, T, L, alive, n_rays


def compaction_thresholds(b: int, clusters: bool = False) -> list[int]:
    """Lane counts at which the streamed wavefront compacts its live lanes.

    The reference package's schedules, not yet re-derived for this card. Without
    cluster kernels: b/2, b/8, b/32, each kept only at 4096 lanes or more, then 0.
    With them (a dead lane costs the cluster kernel about as much as a live one
    on the TPU): a sqrt(2) ladder in whole 1024-lane rows down to 2048, then 0.
    Either way the schedule changes no per-sample result.
    """
    if not clusters:
        return [t for t in (b // 2, b // 8, b // 32) if t >= 4096] + [0]
    thresholds = []
    t = b
    while True:
        t = int(t / 1.4142135624) & ~1023
        if t < 2048:
            break
        if not thresholds or t < thresholds[-1]:
            thresholds.append(t)
    return thresholds + [0]


def trace_film_streamed(
    sd, cam, pixel_ids, rows, cols, sample0, spp_limit, seed, k, max_depth, has_lights, log=None, stages=None,
    k1_counts=None,
):
    """Path-regeneration wavefront: each lane streams up to k samples of its pixel.

    Per sample identical to trace_radiance (same counter-based RNG stream per
    (pixel, sample) path); only the schedule differs:

    - *regeneration*: a lane that finishes sample s immediately starts sample s+1;
    - *tail compaction*: once the lanes with work left drop to a threshold
      (compaction_thresholds), the state is stably sorted work-first and cut to
      that many lanes. Each lane carries its origin index so films scatter back
      exactly (lane ids are unique, so index_add_ is deterministic).

    sample0 is a per-lane tensor. Returns (film_sum [B,3] in the caller's lane
    order, rays_traced int, wavefront iterations int). log (a list), if given, gets
    (stage, lanes with work) at every host read; stages (a list), if given, gets (lanes,
    iterations, lanes with work summed over those iterations) of each stage. k1_counts
    (an int64 tensor [4]), if given, gets K1's counts of its tile cull added.
    """
    b = pixel_ids.shape[0]
    dev = pixel_ids.device
    f32 = dict(dtype=REAL, device=dev)
    s = stream_state(pixel_ids, rows, cols, sample0)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    p_light, p_bsdf = _mis_probs(has_lights)

    def work_mask(s):
        return s["alive"] | ((s["sample"] < k) & ((s["sample0"] + s["sample"]) < spp_limit))

    bank = torch.zeros((b, 3), **f32)
    iterations = 0
    for stage, thr in enumerate(compaction_thresholds(b, sd.has_tri_clusters or sd.has_tri_clusters_hbm)):
        ran = work = 0
        while True:
            n_work = int(work_mask(s).sum())  # the one host sync of the iteration
            if log is not None:
                log.append((stage, n_work))
            if n_work == 0 or n_work <= thr:
                break
            s, n_rays = _stream_step(
                s, sd, cam, spp_limit, seed, k, max_depth, has_lights, p_light, p_bsdf, k1_counts=k1_counts
            )
            rays = rays + n_rays
            ran += 1
            work += n_work
        iterations += ran
        if stages is not None:
            stages.append((s["alive"].shape[0], ran, work))
        if thr:
            keep = torch.argsort((~work_mask(s)).to(torch.int8), stable=True)[:thr]
            bank.index_add_(0, s["lane"], s["film"])
            s = {key: val.index_select(0, keep) for key, val in s.items()}
            s["film"] = torch.zeros((thr, 3), **f32)
    bank.index_add_(0, s["lane"], s["film"])
    return bank, int(rays), iterations


def stream_state(pixel_ids, rows, cols, sample0) -> dict:
    """The path-regeneration wavefront's state before its first iteration: no lane
    has a path yet; sample0 [B] is each lane's first sample id."""
    b = pixel_ids.shape[0]
    dev = pixel_ids.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=REAL, device=dev)
    d0 = torch.zeros((b, 3), **f32)
    d0[:, 2] = 1.0
    return dict(
        pix=pixel_ids,
        row=rows,
        col=cols,
        sample0=sample0,
        lane=torch.arange(b, **i32),
        o=torch.zeros((b, 3), **f32),
        d=d0,
        time=torch.zeros(b, **f32),
        bounce=torch.zeros(b, **i32),
        sample=torch.zeros(b, **i32),  # per-lane sample cursor (samples started)
        cur_sample=torch.zeros(b, **i32),  # sample id of the in-flight path
        throughput=torch.ones((b, 3), **f32),
        radiance=torch.zeros((b, 3), **f32),
        film=torch.zeros((b, 3), **f32),
        alive=torch.zeros(b, dtype=torch.bool, device=dev),
    )


# the state an iteration writes (the rest of a stage's state is fixed between compactions)
STEP_KEYS = ("o", "d", "time", "bounce", "sample", "cur_sample", "throughput", "radiance", "film", "alive")


def reset_stream_state(s):
    """stream_state's values written in place into a state of static tensors (its pixels,
    rows, cols and first samples, the inputs, are left as they are)."""
    torch.arange(s["lane"].shape[0], out=s["lane"])
    for key in ("o", "d", "time", "bounce", "sample", "cur_sample", "radiance", "film"):
        s[key].zero_()
    s["d"][:, 2] = 1.0
    s["throughput"].fill_(1.0)
    s["alive"].zero_()


class StreamStages:
    """trace_film_streamed over static state: each stage's state at fixed addresses.

    Stage i runs on state of n_i lanes (n_0 = B, then each compaction threshold), held in
    tensors made once and updated in place, so that every part of a launch is a fixed
    sequence of device work on fixed shapes and addresses, which render/graph.py captures:

    - ``set_inputs(...)``: the launch's inputs into static tensors: pixels, rows, cols and
      first samples, the seed (a 0-d int64 tensor) and the camera's values (the stages
      keep a copy of the camera's tensors), so that one capture serves every seed and
      camera of the launch's shape;
    - ``reset()``: stage 0 to the state before the first iteration; the film bank and the
      counters to zero;
    - ``step(i)``: one iteration of stage i, its ray count added to ``rays`` and K1's counts
      of its tile cull to ``k1_counts`` (``hit_kernel.K1_COUNTS``) on the device.
      On the card (``fused``) the regeneration kernel, the hit kernels and the shading
      kernel (``ops/wavefront_kernel.py``) update the state in place; on the CPU
      ``_stream_step`` runs, then ``copy_`` back into the state;
    - ``cond(i, bump)``: the stage's condition on the device, the lanes with work > its
      threshold (``ops/loop_cond.py``); bump adds the iteration just run to ``iters[i]``;
      when it goes on, the lanes with work are added to ``work[i]``;
    - ``compact(i)``: the live lanes work-first into stage i+1's state, stage i's films
      into the bank;
    - ``finish()``: the last stage's films into the bank.

    ``run()`` drives them from the host, one read of the condition an iteration: the
    stage runner on the CPU, which the tests hold bit-equal to trace_film_streamed.
    """

    def __init__(self, sd, cam, b, spp_limit, k, max_depth, has_lights, device):
        self.sd, self.cam = sd, static_camera(cam, device)
        self.spp_limit, self.k, self.max_depth, self.has_lights = spp_limit, k, max_depth, has_lights
        self.seed = torch.zeros((), dtype=torch.int64, device=device)
        self.p_light, self.p_bsdf = _mis_probs(has_lights)
        self.thresholds = compaction_thresholds(b, sd.has_tri_clusters or sd.has_tri_clusters_hbm)
        self.sizes = sizes = [b] + self.thresholds[:-1]  # each stage's lanes
        i32 = dict(dtype=torch.int32, device=device)
        proto = stream_state(torch.zeros(1, **i32), torch.zeros(1, **i32), torch.zeros(1, **i32),
                             torch.zeros(1, **i32))
        self.states = [{key: torch.empty((n, *v.shape[1:]), dtype=v.dtype, device=device)
                        for key, v in proto.items()} for n in sizes]
        self.bank = torch.zeros((b, 3), dtype=REAL, device=device)
        self.rays = torch.zeros(1, dtype=torch.int64, device=device)
        self.k1_counts = torch.zeros(len(hit_kernel.K1_COUNTS), dtype=torch.int64, device=device)
        self.iters = torch.zeros(len(sizes), dtype=torch.int64, device=device)
        self.work = torch.zeros(len(sizes), dtype=torch.int64, device=device)  # lanes with work, summed
        self.fused = torch.device(device).type == "cuda"

    def set_inputs(self, pixel_ids, rows, cols, sample0, seed, cam=None):
        s = self.states[0]
        for key, val in (("pix", pixel_ids), ("row", rows), ("col", cols), ("sample0", sample0)):
            s[key].copy_(val)
        self.seed.fill_(seed)
        if cam is not None:
            copy_camera(self.cam, cam)

    def reset(self):
        reset_stream_state(self.states[0])
        self.bank.zero_()
        self.rays.zero_()
        self.k1_counts.zero_()
        self.iters.zero_()
        self.work.zero_()

    def step(self, i):
        s = self.states[i]
        if self.fused:
            wavefront_kernel.regenerate(s, self.cam, self.seed, self.k, self.spp_limit, self.rays)
            hits = hit_kernels(self.sd, s["o"], s["d"], s["time"], T_MIN, T_MAX, s["alive"], self.k1_counts)
            wavefront_kernel.shade(s, self.sd, hits, self.seed, self.max_depth, self.has_lights, self.p_light,
                                   self.p_bsdf)
            return
        out, n_rays = _stream_step(s, self.sd, self.cam, self.spp_limit, self.seed, self.k, self.max_depth,
                                   self.has_lights, self.p_light, self.p_bsdf, k1_counts=self.k1_counts)
        for key in STEP_KEYS:
            s[key].copy_(out[key])
        self.rays.add_(n_rays)

    def cond(self, i, bump=False):
        s = self.states[i]
        return loop_cond.stage_cond(s["alive"], s["sample"], s["sample0"], self.k, self.spp_limit,
                                    self.thresholds[i], self.iters[i : i + 1], bump, work=self.work[i : i + 1])

    def compact(self, i):
        s, t = self.states[i], self.states[i + 1]
        work = loop_cond.work_mask(s["alive"], s["sample"], s["sample0"], self.k, self.spp_limit)
        keep = torch.argsort((~work).to(torch.int8), stable=True)[: self.thresholds[i]]
        self.bank.index_add_(0, s["lane"], s["film"])
        for key, val in s.items():
            if key != "film":
                torch.index_select(val, 0, keep, out=t[key])
        t["film"].zero_()

    def finish(self):
        last = self.states[-1]
        self.bank.index_add_(0, last["lane"], last["film"])

    def run(self, log=None):
        """The whole launch driven from the host -> (bank [B,3], rays int, iterations int).
        log (a list), if given, gets (stage, lanes with work, go, iterations so far) at
        every read of the condition."""
        self.reset()
        for i in range(len(self.states)):
            bump = False
            while True:
                out = self.cond(i, bump)
                n_work, go = out.tolist()  # the one host read of the iteration
                if log is not None:
                    log.append((i, n_work, go, int(self.iters.sum())))
                if not go:
                    break
                self.step(i)
                bump = True
            if i + 1 < len(self.states):
                self.compact(i)
        self.finish()
        return self.bank, int(self.rays), int(self.iters.sum())


def static_camera(cam, device):
    """A copy of a CameraData on `device` whose tensors a captured graph may read: the
    stage runners keep one and copy each call's camera into it (``copy_camera``)."""
    return dataclasses.replace(cam, **{f.name: getattr(cam, f.name).to(device, copy=True)
                                       for f in dataclasses.fields(cam)})


def copy_camera(dst, src):
    """src's values into dst's tensors, in place."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def _stream_step(s, sd, cam, spp_limit, seed, k, max_depth, has_lights, p_light, p_bsdf,
                 detach=False, k1_counts=None):
    """One wavefront iteration: regenerate exhausted lanes, bounce, flush films.

    Also the trip of the differentiable film scan (render/diff.py), with detach=True.
    k1_counts, if given, gets K1's counts of its tile cull added (``bounce_step``).
    """
    o, d, time = s["o"], s["d"], s["time"]
    T, L, film, alive = s["throughput"], s["radiance"], s["film"], s["alive"]
    bounce, sample, cur_sample = s["bounce"], s["sample"], s["cur_sample"]
    sample0 = s["sample0"]

    # ---- regenerate lanes whose path is finished and have samples left ----
    need = (~alive) & (sample < k) & ((sample0 + sample) < spp_limit)
    new_sample = sample0 + sample
    o_new, d_new, t_new = generate_rays(cam, s["row"], s["col"], s["pix"], new_sample, seed)
    nm = need[..., None]
    o = torch.where(nm, o_new, o)
    d = torch.where(nm, d_new, d)
    time = torch.where(need, t_new, time)
    T = torch.where(nm, 1.0, T)
    L = torch.where(nm, 0.0, L)
    bounce = torch.where(need, 0, bounce)
    cur_sample = torch.where(need, new_sample, cur_sample)
    sample = sample + need.to(torch.int32)
    alive = alive | need
    n_rays = alive.sum()

    # ---- one bounce (identical estimator to trace_radiance) ----
    o_next, d_next, T, L, alive_h = bounce_step(
        sd, o, d, time, T, L, alive, bounce, s["pix"], cur_sample, seed,
        p_light, p_bsdf, has_lights, detach=detach, k1_counts=k1_counts,
    )
    bounce = bounce + 1
    # max_depth exit: the reference loop just stops after max_depth iterations
    alive_h = alive_h & (bounce < max_depth)

    # ---- flush finished paths into the per-lane film ----
    died = alive & ~alive_h
    film = film + torch.where(died[..., None], L, 0.0)

    out = dict(
        s,
        o=torch.where(alive_h[..., None], o_next, o),
        d=torch.where(alive_h[..., None], d_next, d),
        time=time,
        bounce=bounce,
        sample=sample,
        cur_sample=cur_sample,
        throughput=T,
        radiance=L,
        film=film,
        alive=alive_h,
    )
    return out, n_rays
