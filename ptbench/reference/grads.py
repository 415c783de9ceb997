"""Whole-image film and parameter gradients of the detached estimator, by autograd.

The film is render_film_grads': each pixel's spp samples summed in float32 in sample
order over the mean; the gradients are those of sum over pixels of cotangent . mean
with respect to the scene's differentiable tables (material parameter rows, texture
colours, the environment colour, the atlas), through ``trace.bounce_step(detach=True)``:
the sampled directions, the mixture pdf and the survival probability carry no gradient.
Pixels go in blocks, each traced and differentiated on its own, so that autograd's
saved tensors of one block fit; the blocks' gradients add.
"""

from __future__ import annotations

import torch

from .camera import CameraBasis, generate_rays
from .tables import REAL
from .trace import bounce_step

LEAVES = ("mat_params", "tex_rgb", "env_color", "atlas")
PIXELS_PER_BLOCK = 1 << 16


def _paths(sd, cam, rows, cols, pix, smp, seed, max_depth, has_lights, state_dtype):
    """Detached-estimator radiance of one path a lane [B,3], differentiable in the leaves."""
    p_light = 0.5 if has_lights else 0.0
    p_bsdf = 1.0 - p_light
    o, d, time = generate_rays(cam, rows, cols, pix, smp, seed)
    b = pix.shape[0]
    lane = torch.arange(b, device=o.device)
    T = torch.ones((b, 3), dtype=REAL, device=o.device)
    L = torch.zeros((b, 3), dtype=REAL, device=o.device)
    done_lane, done_L = [], []
    for bounce in range(max_depth):
        if lane.numel() == 0:
            break
        alive = torch.ones(lane.shape, dtype=torch.bool, device=o.device)
        o, d, T, L, alive = bounce_step(sd, o, d, time, T, L, alive, bounce, pix, smp, seed, p_light, p_bsdf,
                                        has_lights, detach=True)
        if state_dtype is not None:
            o, d, T, L = (x.to(state_dtype).to(REAL) for x in (o, d, T, L))
        if bounce == max_depth - 1:
            alive = torch.zeros_like(alive)
        dead = torch.nonzero(~alive, as_tuple=True)[0]
        done_lane.append(lane[dead])
        done_L.append(L[dead])
        keep = torch.nonzero(alive, as_tuple=True)[0]
        lane, o, d, time, T, L, pix, smp = (x[keep] for x in (lane, o, d, time, T, L, pix, smp))
    lanes, Ls = torch.cat(done_lane), torch.cat(done_L)
    return torch.zeros((b, 3), dtype=REAL, device=Ls.device).index_put((lanes,), Ls)


def film_and_grads(sd, has_lights, cam: CameraBasis, width, height, spp, max_depth, seed, cotangent=None,
                   state_dtype=None):
    """-> (mean [H*W,3] float32, {leaf: gradient} or None without a cotangent [H*W,3])."""
    dev = sd.device
    npix = width * height
    leaves = {}
    if cotangent is not None:
        for name in LEAVES:
            leaves[name] = getattr(sd, name).detach().clone().requires_grad_(True)
            setattr(sd, name, leaves[name])
    mean = torch.empty((npix, 3), dtype=REAL, device=dev)
    try:
        for lo in range(0, npix, PIXELS_PER_BLOCK):
            ids = torch.arange(lo, min(lo + PIXELS_PER_BLOCK, npix), device=dev)
            n = ids.shape[0]
            pix = ids.repeat_interleave(spp).to(torch.int32)
            smp = torch.arange(spp, device=dev, dtype=torch.int32).repeat(n)
            with torch.set_grad_enabled(cotangent is not None):
                L = _paths(sd, cam, pix // width, pix % width, pix, smp, seed, max_depth, has_lights,
                           state_dtype).reshape(n, spp, 3)
                film = L[:, 0]
                for s in range(1, spp):
                    film = film + L[:, s]
                mean[lo:lo + n] = (film / spp).detach()
                if cotangent is not None:
                    cot = cotangent[lo:lo + n].to(REAL) / spp
                    (film * cot).sum().backward()
    finally:
        for name, leaf in leaves.items():
            setattr(sd, name, leaf.detach())
    grads = None if cotangent is None else {
        n: (v.grad if v.grad is not None else torch.zeros_like(v)).detach() for n, v in leaves.items()}
    return mean, grads
