"""Inverse-rendering steps: a closed loop of one caller, as an optimisation loop runs.

Set-up builds one training object: the warm call renders the target film at the
published parameters (the program captures its gradient graphs there); the Principled
rows' material parameters are then moved by the cell's perturbation, and step 0 renders
the film they give. The perturbation is the same in every run (drawn from the cell's
"perturb_seed"): it sets the materials the optimisation passes through, and with them the
paths' lengths, so a perturbation drawn from the run's seed would change the work from
seed to seed. The run's seed draws the RNG seeds of the target, of step 0 and of each step. Each step of the window takes as its cotangent
the L2 loss's gradient at the previous step's film, 2 (film - target) / n, runs one
render_film_grads at its own RNG seed, and applies Adam to every differentiable table,
clamped to its bounds and written into the compiled scene's tables in place (which the
program's kept graphs read as inputs, so steps replay).

The check: the reference follows the window's first "follow" steps from the seed alone
(each step's loss, the first gradient as Adam holds it, the parameters' change), and
works out again the window's last step from the parameters and the cotangent that the
program was handed there (its film and gradients).
Parameters ("params"): "spp", "segment", "lr", "perturb", "perturb_seed", "follow".
"""

import time

import numpy as np

from ptbench.core import compare, renders
from ptbench.reference import train as T
from ptbench.reference.grads import LEAVES


def plan(run):
    """What both sides are handed: RNG seeds from the run's seed, and the cell's perturbation."""
    p = run.workload["params"]
    gen = np.random.default_rng([p["perturb_seed"], 5])
    delta = gen.uniform(-p["perturb"], p["perturb"], size=(8, len(T.P_COLS)))
    return {"spp": p["spp"], "target_seed": run.call_seed(-1), "delta": delta, "lr": p["lr"],
            "betas": [0.9, 0.999], "eps": 1e-8,
            "step_seeds": [run.call_seed(-2)] + [_seed(run, i) for i in range(p["follow"])]}


def _seed(run, i):
    """The RNG seed of the window's step i."""
    return run.call_seed(1 + i)


def setup(run):
    renders.setup(run, spp=run.workload["params"]["spp"])


def _grads(run, seed, cot):
    import torch
    from tpupt_torch.render.diff import render_film_grads

    prog = run.program
    w, h = run.image_size
    if cot is None:
        cot = torch.zeros((w * h, 3), dtype=torch.float32, device=run.device)
    mean, grads, stats = render_film_grads(prog["compiled"], prog["camera"], seed=seed, cotangent=cot,
                                           segment_size=run.workload["params"]["segment"], return_stats=True)
    return mean.reshape(-1, 3), grads, stats


def warm(run):
    pl = plan(run)
    prog = run.program
    sd = prog["compiled"].data
    prog["target"], _, stats = _grads(run, pl["target_seed"], None)
    run.layer["graph_capture_s"] = stats.capture_s
    lo_hi = {name: T.bounds(name, getattr(sd, name)) for name in LEAVES}
    sd.mat_params.copy_(T.perturbed(sd.mat_params, sd.mat_type, pl["delta"]))
    prog["p0"] = {name: getattr(sd, name).clone() for name in LEAVES}
    prog["opt"] = T.Adam(prog["p0"], pl["lr"], tuple(pl["betas"]), pl["eps"],
                         {k: v[0] for k, v in lo_hi.items()}, {k: v[1] for k, v in lo_hi.items()})
    prog["prev"], _, _ = _grads(run, pl["step_seeds"][0], None)
    run.train = {"plan": pl, "loss": []}


def _step(run, i, keep=True):
    """Step i of the window -> (loss of its film, its stats). The first "follow" steps keep
    what the reference follows; every kept step keeps what it was handed and gave, so that
    the last one can be worked out again."""
    prog, tr = run.program, run.train
    sd = prog["compiled"].data
    seed = _seed(run, i)
    cot = 2.0 * (prog["prev"] - prog["target"]) / prog["target"].numel()
    handed = {name: getattr(sd, name).clone() for name in LEAVES} if keep else None
    film, grads, stats = _grads(run, seed, cot)
    loss = float(((film.double() - prog["target"].double()) ** 2).mean())
    params = prog["opt"].step({name: getattr(sd, name) for name in LEAVES}, grads)
    for name, value in params.items():
        getattr(sd, name).copy_(value)
    prog["prev"] = film
    if keep:
        tr["last"] = {"seed": seed, "params": handed, "cotangent": cot, "film": film.clone(),
                      "grads": {name: g.clone() for name, g in grads.items()}}
    if keep and i < run.workload["params"]["follow"]:
        tr["loss"].append(loss)
        opt = prog["opt"]
        if i == 0:
            tr["grad1"] = {name: opt.m[name] / (1.0 - opt.b1) for name in LEAVES}
        tr["change"] = {name: getattr(sd, name) - prog["p0"][name] for name in LEAVES}
    return loss, stats


def call(run, i, keep=True):
    rec = {"ok": False, "start": time.perf_counter()}
    try:
        loss, stats = _step(run, i, keep)
    except RuntimeError as e:
        rec.update(end=time.perf_counter(), error=repr(e))
        return rec
    rec.update(end=time.perf_counter(), ok=True, loss=loss, forward_s=stats.forward_s,
               backward_s=stats.backward_s, trips=stats.trips, capture_s=stats.capture_s)
    return rec


def traced(run):
    """The profiler's window: one more step, after the window's last (which the check keeps)."""
    call(run, 10**6, keep=False)


def check(run, state_dtype=None):
    """The reference follows the window's first steps and works out its last step again ->
    the training numbers (compare.py). state_dtype puts the reference at that precision in
    the program's place (the control)."""
    import torch

    from ptbench import reference

    tr = run.train
    steps = len(tr["loss"])
    dev = torch.device(run.device)

    def reference_side(dtype):
        out = reference.follow_steps(run.cfg, run.asset_dir, dev, tr["plan"], steps, state_dtype=dtype)
        film, grads = reference.one_step(run.cfg, run.asset_dir, dev, tr["plan"]["spp"], tr["last"], state_dtype=dtype)
        out["last"] = {"film": film, "grads": grads}
        return out

    ref = reference_side(None)
    got = tr if state_dtype is None else reference_side(state_dtype)
    return compare.train_numbers(got, ref)
