"""paths_per_s: the paths of every frame rendered in the window over the time from the
first frame's call to the last frame's return (host clock). A frame is a whole
render_image call that returns its image to the host."""


def read(run):
    done = [c for c in run.calls if c["ok"]]
    if not done:
        return None
    span = max(c["end"] for c in run.calls) - min(c["start"] for c in run.calls)
    return sum(c["paths"] for c in done) / span
