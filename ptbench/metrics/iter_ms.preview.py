"""iter_ms.preview: the window's sum of RenderStats.wall_s over its sum of wavefront
iterations, in ms, over the preview calls."""


def read(run):
    if run.workload["traffic"] != "preview":
        return None
    done = [c for c in run.calls if c["ok"]]
    iters = sum(c["iterations"] for c in done)
    return 1e3 * sum(c["wall_s"] for c in done) / iters if iters else None
