"""The arithmetic of the readers of the program's spans on made-up recordings, and their
silence where the recording has nothing for them."""

import types

import pytest

from ptbench.core import spec
from tpupt_torch.trace import Recording, Span

MS = 1_000_000  # ns


def _recording(spans):
    rec = Recording()
    for i, (name, parent, start, end, attrs, track) in enumerate(spans):
        rec.spans.append(Span(i, parent, 0 if parent is None else parent, name, start, end, attrs, track))
    return rec


def _run(traffic, rec):
    return types.SimpleNamespace(workload={"traffic": traffic}, program={}, program_trace=rec)


def read(name, run):
    return spec.module("metrics", name).read(run)


def _renders():
    """Two render calls: 0-100 ms with a wait of 60 ms (card 50 ms in it), 200-250 ms with
    waits of 10 and 20 ms (card 8 and 16 ms)."""
    stats = [{"work_lanes": 900, "lane_slots": 1000}, {"work_lanes": 300, "lane_slots": 1000}]
    return _recording([
        ("render", None, 0, 100 * MS, stats[0], "host"),
        ("render.order", 0, 0, 10 * MS, {}, "host"),
        ("render.wait", 0, 20 * MS, 80 * MS, {}, "host"),
        ("card.chain", 2, 25 * MS, 75 * MS, {}, "card"),
        ("card.stage0", 2, 25 * MS, 60 * MS, {}, "card"),
        ("render", None, 200 * MS, 250 * MS, stats[1], "host"),
        ("render.wait", 5, 205 * MS, 215 * MS, {}, "host"),
        ("card.chain", 6, 206 * MS, 214 * MS, {}, "card"),
        ("render.wait", 5, 220 * MS, 240 * MS, {}, "host"),
        ("card.chain", 8, 222 * MS, 238 * MS, {}, "card"),
    ])


@pytest.mark.parametrize("traffic,kind", [("frames", "frame"), ("preview", "preview")])
def test_render_readers(traffic, kind):
    run = _run(traffic, _renders())
    assert read(f"graph_busy.{kind}", run) == pytest.approx(100.0 * (50 + 8 + 16) / 250)
    assert read(f"driver_ms.{kind}", run) == pytest.approx(((100 - 60) + (50 - 30)) / 2)
    other = _run("grad_steps", _renders())
    assert read(f"graph_busy.{kind}", other) is None and read(f"driver_ms.{kind}", other) is None
    if kind == "frame":
        assert read("lane_occupancy.frame", run) == pytest.approx(100.0 * 1200 / 2000)


def test_grads_reader():
    rec = _recording([
        ("grads", None, 0, 400 * MS, {}, "host"),
        ("grads.forward.chunk", 0, 10 * MS, 110 * MS, {}, "host"),
        ("card.forward", 1, 12 * MS, 108 * MS, {}, "card"),
        ("grads.backward.chunk", 0, 120 * MS, 130 * MS, {}, "host"),
        ("card.backward", 3, 125 * MS, 380 * MS, {}, "card"),
    ])
    assert read("graph_busy.grads", _run("grad_steps", rec)) == pytest.approx(100.0 * (96 + 255) / 400)
    assert read("graph_busy.grads", _run("frames", rec)) is None


def test_readers_are_silent_without_spans_or_program():
    """No card interval (the eager loop, the CPU), no recording (a program without spans), or
    no program: nothing to read."""
    host_only = _recording([("render", None, 0, 10 * MS, {}, "host"), ("grads", None, 0, 10 * MS, {}, "host")])
    for name, traffic in (("graph_busy.frame", "frames"), ("graph_busy.grads", "grad_steps")):
        assert read(name, _run(traffic, host_only)) is None
    assert read("lane_occupancy.frame", _run("frames", host_only)) is None
    for name, traffic in (("graph_busy.preview", "preview"), ("driver_ms.frame", "frames"),
                          ("lane_occupancy.frame", "frames"), ("graph_busy.grads", "grad_steps")):
        assert read(name, _run(traffic, None)) is None
        assert read(name, types.SimpleNamespace(workload={"traffic": traffic}, program=None)) is None


def test_a_recorded_window_of_a_tiny_cell(tmp_path):
    """The cell's own traced window, recorded once and kept on the run: 20 preview calls on
    the CPU, whose driver time reads and whose card share reads nothing (no card)."""
    from ptbench import run as R
    from ptbench.core import program_trace
    from ptbench.tests.tiny import tiny_copy, tiny_run

    run = tiny_run(*tiny_copy(str(tmp_path)), "cornell.preview")
    R.set_up(run, 0.0)
    rec = program_trace.recording(run)
    assert program_trace.recording(run) is rec and len(rec.named("render")) == 20
    assert all(s.attrs["lane_slots"] > 0 for s in rec.named("render"))
    assert read("driver_ms.preview", run) > 0 and read("graph_busy.preview", run) is None
