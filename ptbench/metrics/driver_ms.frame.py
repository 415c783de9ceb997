"""driver_ms.frame: host ms of a traced frame's render_image call outside its ``render.wait``
spans (inputs, captures, the film's readback and float64 sum, tonemap; render/renderer.py),
recorded by the program's spans (core/program_trace.py)."""

from ptbench.core import program_trace


def read(run):
    return program_trace.driver_ms(run, "frames")
