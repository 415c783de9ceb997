"""What the render cells share: the program's scene and camera, one render_image call
and its record, and the output check against the plain reference.

Every call returns its image to the host. Of each call, the mean radiance of a sample of
pixels drawn from the run's seed is kept; once the window has closed and the program's
state is freed, the reference traces those pixels' paths again (same seed, pixel and
sample ids, so the same paths) and the two are compared.
"""

from __future__ import annotations

import time

import numpy as np

from . import compare
from .scenes import build_scene, camera


def setup(run, spp=None):
    """Build and compile the configuration's scene on the run's device; the camera at `spp`."""
    import torch

    scene = build_scene(run.cfg, run.asset_dir)
    t0 = time.perf_counter()
    compiled = scene.compile(device=run.device)
    if run.on_card:
        torch.cuda.synchronize()
    run.layer["scene_compile_s"] = time.perf_counter() - t0
    over = {} if spp is None else {"samples_per_pixel": spp}
    cam = camera(run.cfg, **over)
    run.program = {"compiled": compiled, "camera": cam}


def call(run, cam, seed, over, keep):
    """One render_image call -> its record; keeps the mean radiance of `keep` pixels."""
    from tpupt_torch.render.renderer import render_image

    rec = {"seed": seed, "over": over, "ok": False}
    rec["start"] = time.perf_counter()
    try:
        _, mean, stats = render_image(run.program["compiled"], cam, seed=seed, progress=False)
    except RuntimeError as e:
        rec["end"] = time.perf_counter()
        rec["error"] = repr(e)
        return rec
    rec["end"] = time.perf_counter()
    flat = mean.reshape(-1, 3)
    rec.update(ok=True, paths=stats.paths, iterations=stats.iterations, wall_s=stats.wall_s,
               capture_s=stats.capture_s, pixels=keep, values=flat[keep].astype(np.float64))
    return rec


def pixel_sample(run, index, n):
    """The pixels of call `index` that the check compares, drawn from the run's seed."""
    w, h = run.image_size
    gen = np.random.default_rng([run.seed_u64, 2, index & 0xFFFFFFFF])
    return np.sort(gen.choice(w * h, size=min(n, w * h), replace=False)).astype(np.int64)


def check(run, state_dtype=None):
    """Compare the kept pixels of every call with the reference -> {number: value}.
    state_dtype runs the reference at that precision in the program's place (the control)."""
    import torch

    from ptbench import reference

    recs = [r for r in run.calls if r["ok"]]
    jobs = [(r["seed"], r["over"], r["pixels"]) for r in recs]
    dev = torch.device(run.device)
    want = reference.render_means(run.cfg, run.asset_dir, dev, jobs)
    if state_dtype is None:
        got = [r["values"] for r in recs]
    else:
        got = reference.render_means(run.cfg, run.asset_dir, dev, jobs, state_dtype=state_dtype)
    return compare.film_numbers(np.concatenate(got), np.concatenate(want))
