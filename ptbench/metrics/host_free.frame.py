"""host_free.frame: percent of a traced frame's launches that were host-free
(RenderStats.host_free_launches over launches, the render spans' attrs): launches that took
their inputs from the buffers kept on the device and added their film there, with no host
copy of it (render/renderer.py), recorded by the program's spans (core/program_trace.py).
None where the program's render spans carry no host_free_launches (a program whose film
lives on the host)."""

from ptbench.core import program_trace


def read(run):
    if run.workload["traffic"] != "frames":
        return None
    rec = program_trace.recording(run)
    calls = [s for s in rec.spans if s.name == "render"] if rec is not None else []
    if not calls or any("host_free_launches" not in s.attrs for s in calls):
        return None
    launches = sum(s.attrs.get("launches", 0) for s in calls)
    return 100.0 * sum(s.attrs["host_free_launches"] for s in calls) / launches if launches else None
