"""k1_sweep.frame: percent of K1's (ray, tile) pairs that its warps tested, over a traced
frame: RenderStats.k1_tiles_swept over k1_tile_slots, the render spans' attrs, counted by
K1's culled variant on the card (a warp of 32 rays sweeps a tile that one of its rays
enters, and pays for all of its rays), recorded by the program's spans
(core/program_trace.py). None where the render spans carry no such counts (a program
without them) or the sphere table is one tile, swept whole (no slot counted)."""

from ptbench.core import program_trace


def read(run):
    if run.workload["traffic"] != "frames":
        return None
    rec = program_trace.recording(run)
    calls = [s for s in rec.spans if s.name == "render"] if rec is not None else []
    if not calls or any("k1_tiles_swept" not in s.attrs for s in calls):
        return None
    slots = sum(s.attrs["k1_tile_slots"] for s in calls)
    return 100.0 * sum(s.attrs["k1_tiles_swept"] for s in calls) / slots if slots else None
