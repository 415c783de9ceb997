"""k1_enter.frame: percent of K1's (ray, tile) pairs whose widened box the ray itself enters
(every tile for a ray that may not cull), over a traced frame: RenderStats.k1_tiles_entered
over k1_tile_slots, the render spans' attrs, counted by K1's culled variant on the card,
recorded by the program's spans (core/program_trace.py). What the rays needed; the gap to
k1_sweep.frame is what the warps' divergence costs. None where the render spans carry no
such counts (a program without them) or the sphere table is one tile (no slot counted)."""

from ptbench.core import program_trace


def read(run):
    if run.workload["traffic"] != "frames":
        return None
    rec = program_trace.recording(run)
    calls = [s for s in rec.spans if s.name == "render"] if rec is not None else []
    if not calls or any("k1_tiles_entered" not in s.attrs for s in calls):
        return None
    slots = sum(s.attrs["k1_tile_slots"] for s in calls)
    return 100.0 * sum(s.attrs["k1_tiles_entered"] for s in calls) / slots if slots else None
