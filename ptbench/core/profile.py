"""The traced window: a call of the cell's traffic under torch.profiler (CUPTI), and from
its trace the seconds the device was busy, the window's length and a breakdown.

busy_s is the length of the union of the device's activity intervals (kernels, copies,
sets), so that overlapping work counts once; window_s is the traced span on the host's
clock. The breakdown gives the device operations that took most time, summed by name,
and the longest gaps between device activity, each named by the host operation that
was running at its middle.
"""

from __future__ import annotations

import time


def _events(prof):
    """(device intervals [(start_us, end_us, name)], host intervals) from the trace."""
    dev, host = [], []
    for e in prof.events():
        kind = str(getattr(e, "device_type", "")).upper()
        rng = e.time_range
        item = (float(rng.start), float(rng.end), e.name)
        if "CUDA" in kind:
            dev.append(item)
        else:
            host.append(item)
    return dev, host


def traced(fn):
    """Run fn() under the profiler -> dict(busy_s, window_s, breakdown) or raise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = _events(prof)
    if not dev:
        raise RuntimeError("the profiler's trace holds no device activity")
    dev.sort()
    busy_us, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:10]:
        mid = 0.5 * (s + e)
        over = [h for h in host if h[0] <= mid <= h[1]]
        name = min(over, key=lambda h: h[1] - h[0])[2] if over else "host idle"
        named.append([name, 1e-6 * (e - s)])
    return {"busy_s": 1e-6 * busy_us, "window_s": window_s,
            "breakdown": {"device_ops": [[n, 1e-6 * us] for n, us in ops], "idle_gaps": named}}
