"""The benchmark's reader of fused_share.frame (ptbench/metrics/fused_share.frame.py) on
made-up recordings and on a CPU render's spans: the share of a traced frame's wavefront
iterations that ran on the regeneration and shading kernels (RenderStats.fused_iterations
over iterations, attrs of the render spans)."""

import types

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
import pytest
import torch

from ptbench.core import spec
from tpupt_torch import trace
from tpupt_torch.render.renderer import render_image
from tpupt_torch.scenes import cornell_box_scene
from tpupt_torch.trace import Recording, Span

MS = 1_000_000  # ns


def _run(traffic, rec):
    return types.SimpleNamespace(workload={"traffic": traffic}, program={}, program_trace=rec)


def _read(run):
    return spec.module("metrics", "fused_share.frame").read(run)


def _recording(attrs):
    rec = Recording()
    for i, a in enumerate(attrs):
        rec.spans.append(Span(2 * i, None, 2 * i, "render", 100 * i * MS, (100 * i + 90) * MS, a))
        rec.spans.append(Span(2 * i + 1, 2 * i, 2 * i, "render.wait", 100 * i * MS, (100 * i + 80) * MS, {}))
    return rec


def test_the_share_of_fused_iterations_over_the_window():
    rec = _recording([{"iterations": 400, "fused_iterations": 300}, {"iterations": 100, "fused_iterations": 100}])
    assert _read(_run("frames", rec)) == pytest.approx(100.0 * 400 / 500)
    assert _read(_run("preview", rec)) is None  # the metric reads frames alone


@pytest.mark.parametrize("rec", [None, Recording(), _recording([{"iterations": 400}]),
                                 _recording([{"iterations": 0, "fused_iterations": 0}])])
def test_silent_without_spans_or_the_counter(rec):
    """No recording (a program without spans), no render span, render spans without
    fused_iterations (a program without the kernels), or no iteration: nothing to read."""
    assert _read(_run("frames", rec)) is None


def test_a_cpu_render_reads_zero():
    """The CPU's eager loop runs no fused iteration: its render span says so, and the share
    reads 0."""
    scene, cam = cornell_box_scene(8, 2)
    cam.max_depth = 4
    compiled = scene.compile(device=torch.device("cpu"))
    with trace.recording() as rec:
        _, _, stats = render_image(compiled, cam, progress=False)
    (span,) = rec.named("render")
    assert span.attrs["fused_iterations"] == 0 < span.attrs["iterations"] == stats.iterations
    assert _read(_run("frames", rec)) == 0.0
