"""lane_occupancy.frame: percent of the wavefront's lane slots (each compaction stage's lanes
times its iterations) that held a lane with work, over a traced frame (RenderStats.work_lanes
over lane_slots, counted by K5 on the card), recorded by the program's spans
(core/program_trace.py)."""

from ptbench.core import program_trace


def read(run):
    return program_trace.lane_occupancy(run, "frames")
