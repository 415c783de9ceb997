"""grad_step_ms: the window's wall time over its inverse-rendering steps, in ms. A step is
the cotangent, one render_film_grads and the Adam update written into the scene."""


def read(run):
    if run.workload["traffic"] != "grad_steps" or not run.calls:
        return None
    span = max(c["end"] for c in run.calls) - min(c["start"] for c in run.calls)
    return 1e3 * span / len(run.calls)
