"""frame_ms_p95: the 95th percentile (nearest rank) of the wall time of every call in the
window, from the call to the image on the host. A failed call ranks above every completed
call; if the rank lands on one, the window's length stands for it."""

import math


def read(run):
    if not run.calls:
        return None
    ms = sorted(1e3 * (c["end"] - c["start"]) if c["ok"] else math.inf for c in run.calls)
    value = ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
    return value if math.isfinite(value) else 1e3 * run.window_s
