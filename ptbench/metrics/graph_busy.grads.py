"""graph_busy.grads: percent of a traced step's render_film_grads wall that the card spends in
the gradient pass's forward and backward chains (``card.forward``, ``card.backward``;
render/graph.py GradGraphs), recorded by the program's spans (core/program_trace.py)."""

from ptbench.core import program_trace


def read(run):
    return program_trace.graph_busy(run, "grad_steps", "grads", ("card.forward", "card.backward"))
