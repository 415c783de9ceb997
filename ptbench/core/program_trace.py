"""The program's own spans over one traced window of a cell, and the arithmetic of the
metrics that read them.

``recording(run)`` runs the cell's own ``traffic.traced(run)`` once more (one frame, 20
previews or one step) under ``tpupt_torch.trace.recording()`` and keeps the Recording on the
run, so that every metric of the run reads the same window. A program that has no span
system (``tpupt_torch.trace``), or a run without the program's state, gives None, and the
metrics then read nothing.

The spans it reads (tpupt_torch/trace.py): ``render`` (a render_image call, its attrs the
call's RenderStats) and its child ``render.wait`` (from a chain's launch to the launch's host
read); ``grads`` (a render_film_grads call); the card's intervals ``card.chain`` (a launch's
chain of graphs), ``card.forward`` and ``card.backward`` (a chunk's chain of the gradient
pass), placed on the host's clock.
"""

from __future__ import annotations


def recording(run):
    """The Recording of one traced window of the cell, made at the first call, or None."""
    if run.program is None:
        return None
    if not hasattr(run, "program_trace"):
        try:
            from tpupt_torch import trace
        except ImportError:
            run.program_trace = None
            return None
        with trace.recording() as rec:
            run.traffic.traced(run)
        run.program_trace = rec
    return run.program_trace


def _calls(run, traffic, name):
    if run.workload["traffic"] != traffic:
        return None, []
    rec = recording(run)
    if rec is None:
        return None, []
    return rec, [s for s in rec.spans if s.name == name]


def graph_busy(run, traffic, call, cards):
    """Percent of the window's host wall (the first `call` span's start to the last one's end)
    that the card's intervals named in `cards` cover, summed, or None (no such interval: the
    eager loop, or the CPU)."""
    rec, calls = _calls(run, traffic, call)
    if not calls:
        return None
    spans = [s for s in rec.spans if s.name in cards]
    wall = max(s.end for s in calls) - min(s.start for s in calls)
    return 100.0 * sum(s.end - s.start for s in spans) / wall if spans and wall > 0 else None


def driver_ms(run, traffic):
    """Mean over the window's render calls of the call's host ms outside its render.wait
    spans (the render loop's own host time: inputs, captures, readback, film, tonemap), or None."""
    rec, calls = _calls(run, traffic, "render")
    if not calls:
        return None
    waits = [s for s in rec.spans if s.name == "render.wait"]
    own = [(c.end - c.start) - sum(w.end - w.start for w in waits if c.start <= w.start <= c.end) for c in calls]
    return 1e-6 * sum(own) / len(own)


def lane_occupancy(run, traffic):
    """Percent: the window's lanes with work summed over its wavefront iterations, over each
    stage's lanes times its iterations (RenderStats.work_lanes / lane_slots), or None."""
    _, calls = _calls(run, traffic, "render")
    slots = sum(s.attrs.get("lane_slots", 0) for s in calls)
    return 100.0 * sum(s.attrs.get("work_lanes", 0) for s in calls) / slots if slots else None
