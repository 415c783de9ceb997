"""Interactive previews: a closed loop of one caller, as a user dragging a viewport.

Each call renders the configuration at "spp" samples a pixel with an RNG seed of its own
and the camera's look_from moved along an arc about look_at's vertical axis: the angle of
call i is a0 + amp * sin(2 pi i / period + phase), with a0 (within 0.02 rad) and the
phase drawn from the run's seed. A window holds many periods, so every seed gives about
the same mix of views, in another order. The camera is an input of the program's kept
graphs, so calls replay them.
Parameters ("params"): "spp", "arc_amp_rad", "arc_period", "check_pixels".
"""

import math

import numpy as np

from ptbench.core import renders


def _over(run, i):
    p = run.workload["params"]
    gen = np.random.default_rng([run.seed_u64, 3])
    a0, phase = gen.uniform(-0.02, 0.02), gen.uniform(0.0, 2.0 * math.pi)
    angle = a0 + p["arc_amp_rad"] * math.sin(2.0 * math.pi * i / p["arc_period"] + phase)
    cam = run.cfg["camera"]
    at = np.asarray(cam["look_at"], dtype=np.float64)
    rel = np.asarray(cam["look_from"], dtype=np.float64) - at
    c, s = math.cos(angle), math.sin(angle)
    moved = at + np.array([c * rel[0] + s * rel[2], rel[1], -s * rel[0] + c * rel[2]])
    return {"samples_per_pixel": p["spp"], "look_from": [float(x) for x in moved]}


def setup(run):
    renders.setup(run, spp=run.workload["params"]["spp"])


def _call(run, i, n_keep):
    over = _over(run, i)
    cam = renders.camera(run.cfg, **over)
    return renders.call(run, cam, run.call_seed(i), over, renders.pixel_sample(run, i, n_keep))


def warm(run):
    rec = _call(run, -1, 1)
    if not rec["ok"]:
        raise RuntimeError(f"the warm call failed: {rec['error']}")
    run.layer["graph_capture_s"] = rec["capture_s"]


def call(run, i):
    return _call(run, i, run.workload["params"]["check_pixels"])


def traced(run):
    """The profiler's window: 20 more calls."""
    for i in range(20):
        _call(run, 10**6 + i, 1)


check = renders.check
