"""fwd_ms_per_trip: the window's sum of GradStats.forward_s over its sum of trips, in ms
(render/diff.py FilmScanStages' forward chain, replayed by render/graph.py GradGraphs)."""


def read(run):
    done = [c for c in run.calls if c["ok"] and "trips" in c]
    trips = sum(c["trips"] for c in done)
    return 1e3 * sum(c["forward_s"] for c in done) / trips if trips else None
