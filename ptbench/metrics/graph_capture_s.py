"""graph_capture_s: the warm call's seconds of CUDA graph capture and instantiation
(RenderStats.capture_s or GradStats.capture_s; render/graph.py), paid in set-up."""


def read(run):
    return run.layer.get("graph_capture_s")
