"""Full frames, back to back: a closed loop of one caller.

Each call is a whole render_image of the configuration's camera at its own spp, with an
RNG seed of its own drawn from the run's seed and the frame's index; the camera is fixed
and each image returns to the host. Parameters (workloads/<cell>.json, "params"):
"check_pixels", the pixels of each frame that the output check compares.
"""

from ptbench.core import renders


def setup(run):
    renders.setup(run)


def warm(run):
    """The set-up's call at the cell's own shape: builds its graphs (kept for the window)."""
    rec = renders.call(run, run.program["camera"], run.call_seed(-1), {}, renders.pixel_sample(run, -1, 1))
    if not rec["ok"]:
        raise RuntimeError(f"the warm call failed: {rec['error']}")
    run.layer["graph_capture_s"] = rec["capture_s"]


def call(run, i):
    keep = renders.pixel_sample(run, i, run.workload["params"]["check_pixels"])
    return renders.call(run, run.program["camera"], run.call_seed(i), {}, keep)


def traced(run):
    """The profiler's window: one more frame."""
    renders.call(run, run.program["camera"], run.call_seed(10**6), {}, renders.pixel_sample(run, 10**6, 1))


check = renders.check
