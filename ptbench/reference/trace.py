"""Paths traced one a lane, and the film as ``render_image`` sums it.

``bounce_step`` is one bounce of the Rust reference's estimator (Camera::trace,
camera.rs:177-226): closest hit, environment on a miss, emission, russian roulette
after 5 bounces, one-sample MIS between the light list and the BSDF (p_light 0.5
iff the scene has lights), the mixture pdf, and the next origin offset 1e-3 along
the geometric normal. Every draw comes from the counter-based sampler keyed on
(seed, pixel, sample, counter), so a path's radiance depends on those four alone and
any subset of a frame's paths can be traced by itself. ``detach=True`` builds the
estimator whose gradients flow only through the integrand (the sampled direction,
the mixture pdf and the survival probability are detached), and guards the pdf
division.

``pixel_means`` gives what ``render_image`` returns for chosen pixels: each pixel's
samples split into r slices of k (the schedule of render_image for the frame's size),
each slice summed in float32 in sample order, the slices added, and the sum divided by
spp in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from . import linalg as la
from . import lights as light_ops
from . import rng
from .bsdf import bsdf_eval, bsdf_pdf, bsdf_sample, make_shade
from .camera import CameraBasis, generate_rays
from .envmap import sample_environment
from .intersect import closest_hit
from .tables import REAL

T_MIN = la.f32(1e-3)  # camera.rs:171
T_MAX = la.BIG
EPS = la.f32(1e-3)  # bsdf/mod.rs:19
MIN_BOUNCES = 5  # camera.rs:172
LANES_PER_BATCH = 1 << 20


def bounce_step(
    sd, o, d, time, T, L, alive, bounce, pixel_ids, sample_ids, seed, p_light, p_bsdf, has_lights,
    *, detach=False,
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
    """
    sg = torch.Tensor.detach if detach else (lambda x: x)

    hit = closest_hit(sd, o, d, time, T_MIN, T_MAX)

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
        l_dir, _ = light_ops.sample_lights(sd, hit.point, time, light_pick, lu1, lu2)
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


def launch_schedule(width, height, spp, rays_per_launch=1 << 20, samples_per_launch=128):
    """(r, k) of render_image on one device: r lanes a pixel, each streaming k samples."""
    npix = width * height
    pb = min(npix, rays_per_launch)
    lane_target = 1 << 18
    r = 1 if pb >= lane_target else max(1, min(lane_target // pb + 1, rays_per_launch // pb, spp // 8))
    k = min((spp + r - 1) // r, samples_per_launch)
    if r * k < spp:
        raise ValueError("the reference follows frames of one launch a pixel block only")
    return r, k


def trace_paths(sd, cam, rows, cols, pixel_ids, sample_ids, seed, max_depth, has_lights, state_dtype=None):
    """One path a lane -> radiance [B,3] float32. Lanes are compacted to the live ones
    after every bounce. state_dtype (the control) rounds each bounce's ray and path state
    to that type."""
    p_light = 0.5 if has_lights else 0.0
    p_bsdf = 1.0 - p_light
    o, d, time = generate_rays(cam, rows, cols, pixel_ids, sample_ids, seed)
    b = pixel_ids.shape[0]
    out = torch.zeros((b, 3), dtype=REAL, device=o.device)
    lane = torch.arange(b, device=o.device)
    T = torch.ones((b, 3), dtype=REAL, device=o.device)
    L = torch.zeros((b, 3), dtype=REAL, device=o.device)
    pix, smp = pixel_ids, sample_ids
    for bounce in range(max_depth):
        if lane.numel() == 0:
            break
        alive = torch.ones(lane.shape, dtype=torch.bool, device=o.device)
        o, d, T, L, alive = bounce_step(sd, o, d, time, T, L, alive, bounce, pix, smp, seed, p_light, p_bsdf,
                                        has_lights)
        if state_dtype is not None:
            o, d, T, L = (x.to(state_dtype).to(REAL) for x in (o, d, T, L))
        out[lane] = L
        keep = torch.nonzero(alive, as_tuple=True)[0]
        lane, o, d, time, T, L, pix, smp = (x[keep] for x in (lane, o, d, time, T, L, pix, smp))
        if torch.is_tensor(seed) and seed.dim():
            seed = seed[keep]
        if cam.center.dim() > 1:
            cam = CameraBasis(**{f: getattr(cam, f)[keep] for f in cam.__dataclass_fields__})
    return out


def pixel_means(sd, has_lights, jobs, width, height, spp, max_depth, state_dtype=None):
    """jobs: [(seed, CameraBasis, pixel ids as int64 numpy)], one a rendered frame or call
    -> [float32 numpy [P,3]], the mean radiance render_image gives for those pixels."""
    r, k = launch_schedule(width, height, spp)
    dev = sd.device
    job_of, pix, smp = [], [], []
    for j, (_, _, ids) in enumerate(jobs):
        n = len(ids)
        job_of.append(np.full(n * spp, j, np.int64))
        pix.append(np.repeat(np.asarray(ids, np.int64), spp))
        smp.append(np.tile(np.arange(spp, dtype=np.int64), n))
    job_of, pix, smp = (np.concatenate(a) for a in (job_of, pix, smp))
    seeds = np.array([s for s, _, _ in jobs], dtype=np.int64)
    radiance = torch.empty((len(pix), 3), dtype=REAL, device=dev)
    for lo in range(0, len(pix), LANES_PER_BATCH):
        sl = slice(lo, lo + LANES_PER_BATCH)
        jj = torch.as_tensor(job_of[sl], device=dev)
        p = torch.as_tensor(pix[sl], device=dev).to(torch.int32)
        s = torch.as_tensor(smp[sl], device=dev).to(torch.int32)
        cam = CameraBasis.stack([c for _, c, _ in jobs], jj)
        seed = torch.as_tensor(seeds, device=dev)[jj]
        radiance[sl] = trace_paths(sd, cam, p // width, p % width, p, s, seed, max_depth, has_lights,
                                   state_dtype)
    means, at = [], 0
    for _, _, ids in jobs:
        n = len(ids)
        paths = radiance[at:at + n * spp].reshape(n, spp, 3)
        at += n * spp
        film = None
        for j in range(r):
            part = torch.zeros((n, 3), dtype=REAL, device=dev)
            for s in range(j * k, min((j + 1) * k, spp)):
                part = part + paths[:, s]
            film = part if film is None else film + part
        means.append((film.double() / spp).float().cpu().numpy())
    return means
