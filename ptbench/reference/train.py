"""The reference's inverse-rendering steps: Adam on the scene's differentiable tables,
driven by the L2 loss of each step's film against a target film.

What both sides are handed (``plan``, made by the benchmark from the run's seed): the
RNG seeds of the target film, of step 0 and of each step, and a perturbation of the
material parameters of the Principled rows. ``follow`` works out everything else
again: its tables from the configuration, the target film at the published
parameters, step 0's film at the perturbed ones, and then each step: the cotangent is
the loss's gradient at the previous step's film, 2 (film - target) / n, the step's
film and gradients come from ``grads.film_and_grads``, and Adam updates every leaf,
clamped to its bounds. ``one_step`` works out a later step again from the program's
parameters and cotangent of that step: the only place where the reference takes the
program's state, and only as the input of the step it judges.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tables as D
from .grads import LEAVES, film_and_grads
from .scene import build_tables, camera

P_COLS = [c for c in range(D.N_PARAMS) if c != D.P_IOR]


def bounds(name, published):
    """Per-entry (lo, hi) of a leaf: material parameters in [0, 1] and indices of refraction
    in [1.01, 3], colours in [0, max(1, published)]; an entry published outside keeps its
    value in range."""
    p = published
    lo = torch.zeros_like(p)
    hi = torch.ones_like(p)
    if name == "mat_params":
        lo[:, D.P_IOR], hi[:, D.P_IOR] = 1.01, 3.0
    else:
        hi = torch.maximum(hi, p)
    return torch.minimum(lo, p), torch.maximum(hi, p)


def perturbed(mat_params, mat_type, delta):
    """mat_params with the Principled rows' parameters (not the index of refraction) moved
    by delta [rows, N_PARAMS-1], in row order, clamped to [0, 1]."""
    out = mat_params.clone()
    rows = torch.nonzero(mat_type == D.MAT_PRINCIPLED, as_tuple=True)[0]
    d = torch.as_tensor(np.asarray(delta), dtype=out.dtype, device=out.device)[: rows.numel()]
    cols = torch.tensor(P_COLS, device=out.device)
    block = out[rows][:, cols] + d
    out[rows.unsqueeze(1), cols.unsqueeze(0)] = block.clamp(0.0, 1.0)
    return out


class Adam:
    """Adam on a dict of leaves, each step clamped to per-entry bounds (the same arithmetic
    as the harness's)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, lo=None, hi=None):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.lo, self.hi, self.t = lo, hi, 0

    def step(self, params, grads):
        self.t += 1
        out = {}
        for n, p in params.items():
            g = grads[n]
            self.m[n] = self.b1 * self.m[n] + (1.0 - self.b1) * g
            self.v[n] = self.b2 * self.v[n] + (1.0 - self.b2) * g * g
            mhat = self.m[n] / (1.0 - self.b1 ** self.t)
            vhat = self.v[n] / (1.0 - self.b2 ** self.t)
            q = p - self.lr * mhat / (torch.sqrt(vhat) + self.eps)
            out[n] = torch.minimum(torch.maximum(q, self.lo[n]), self.hi[n])
        return out


def follow(cfg, asset_dir, device, plan, steps, state_dtype=None):
    """The first `steps` steps of the plan -> dict(loss [per step], grad1 {leaf: tensor},
    change {leaf: tensor} after the last step)."""
    sd, has_lights = build_tables(cfg, asset_dir, device)
    cam = camera(cfg, samples_per_pixel=plan["spp"])
    basis = cam.basis(device)
    w, h = cam.image_width, cam.image_height
    n = w * h * 3

    def render(seed, cot=None):
        return film_and_grads(sd, has_lights, basis, w, h, plan["spp"], cam.max_depth, seed, cot, state_dtype)

    target, _ = render(plan["target_seed"])
    published = {name: getattr(sd, name).clone() for name in LEAVES}
    lo_hi = {name: bounds(name, published[name]) for name in LEAVES}
    sd.mat_params = perturbed(sd.mat_params, sd.mat_type, plan["delta"])
    p0 = {name: getattr(sd, name).clone() for name in LEAVES}
    opt = Adam(p0, plan["lr"], tuple(plan["betas"]), plan["eps"],
               {k: v[0] for k, v in lo_hi.items()}, {k: v[1] for k, v in lo_hi.items()})
    prev, _ = render(plan["step_seeds"][0])
    losses, grad1 = [], None
    for i in range(1, steps + 1):
        cot = 2.0 * (prev - target) / n
        film, grads = render(plan["step_seeds"][i], cot)
        losses.append(float(((film.double() - target.double()) ** 2).mean()))
        params = opt.step({name: getattr(sd, name) for name in LEAVES}, grads)
        for name, value in params.items():
            setattr(sd, name, value)
        if i == 1:
            grad1 = {name: opt.m[name] / (1.0 - opt.b1) for name in LEAVES}
        prev = film
    change = {name: getattr(sd, name) - p0[name] for name in LEAVES}
    return dict(loss=losses, grad1=grad1, change=change)


def one_step(cfg, asset_dir, device, spp, handed, state_dtype=None):
    """handed: {"seed", "params" {leaf: tensor}, "cotangent" [H*W,3]} -> (film, {leaf: gradient})
    of that step, from this package's own tables with the handed values of the leaves."""
    sd, has_lights = build_tables(cfg, asset_dir, device)
    for name in LEAVES:
        mine, theirs = getattr(sd, name), handed["params"][name]
        if tuple(mine.shape) != tuple(theirs.shape):
            raise ValueError(f"{name}: the program's table is {tuple(theirs.shape)}, the reference's {tuple(mine.shape)}")
        setattr(sd, name, theirs.to(device=device, dtype=mine.dtype))
    cam = camera(cfg, samples_per_pixel=spp)
    return film_and_grads(sd, has_lights, cam.basis(device), cam.image_width, cam.image_height, spp, cam.max_depth,
                          handed["seed"], handed["cotangent"].to(device), state_dtype)
