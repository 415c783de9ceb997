"""graph_busy.frame: percent of a traced frame's host wall that the card spends in the
launches' chains of graphs (the card's own stamps, ``card.chain``; render/graph.py), over one
frame recorded by the program's spans (core/program_trace.py)."""

from ptbench.core import program_trace


def read(run):
    return program_trace.graph_busy(run, "frames", "render", ("card.chain",))
