"""driver_ms.preview: mean host ms of 20 traced preview calls outside their ``render.wait``
spans (Morton order, inputs, the film's readback and float64 sum, tonemap;
render/renderer.py), recorded by the program's spans (core/program_trace.py)."""

from ptbench.core import program_trace


def read(run):
    return program_trace.driver_ms(run, "preview")
