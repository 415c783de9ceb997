"""fused_share.frame: percent of a traced frame's wavefront iterations whose step ran on the
regeneration and shading kernels (RenderStats.fused_iterations over iterations, the render
spans' attrs), recorded by the program's spans (core/program_trace.py). None where the
program's render spans carry no fused_iterations (a program without those kernels)."""

from ptbench.core import program_trace


def read(run):
    if run.workload["traffic"] != "frames":
        return None
    rec = program_trace.recording(run)
    calls = [s for s in rec.spans if s.name == "render"] if rec is not None else []
    if not calls or any("fused_iterations" not in s.attrs for s in calls):
        return None
    iterations = sum(s.attrs.get("iterations", 0) for s in calls)
    return 100.0 * sum(s.attrs["fused_iterations"] for s in calls) / iterations if iterations else None
