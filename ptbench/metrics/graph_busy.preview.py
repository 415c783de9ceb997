"""graph_busy.preview: percent of the host wall of 20 traced preview calls (the first call's
start to the last one's end) that the card spends in the launches' chains of graphs
(``card.chain``), recorded by the program's spans (core/program_trace.py)."""

from ptbench.core import program_trace


def read(run):
    return program_trace.graph_busy(run, "preview", "render", ("card.chain",))
