"""The program's spans and counters (tpupt_torch/trace.py) on the CPU.

- With recording off nothing is kept, and a render is the same bit for bit with it on.
- Spans nest: a child lies within its parent, every span of one API call shares the call's
  id, and the self times of a call's spans add up to the call's duration.
- The lanes with work that the stage runner sums on the device (``StreamStages.work``) and
  that the eager loop sums on the host equal, stage by stage, the sums of the counts that
  ``StreamStages.run(log=...)`` logs.
- ``render_image(profile_dir=...)`` merges the spans into torch.profiler's trace, on its clock.

The card's stamps and intervals are tested in tests/test_torch_cuda.py.
"""

import dataclasses
import json

import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)

import numpy as np
import pytest
import torch

from tpupt_torch import trace
from tpupt_torch.render import renderer as R
from tpupt_torch.render.diff import render_film_grads
from tpupt_torch.render.integrator import StreamStages, trace_film_streamed
from tpupt_torch.scenes import cornell_box_scene

CPU = torch.device("cpu")


def _small(width=8, spp=2, depth=4):
    scene, cam = cornell_box_scene(width, spp)
    cam.max_depth = depth
    return scene, cam


def test_recording_off_keeps_nothing_and_changes_nothing():
    assert trace.active() is None and trace.current() is None
    assert trace.span("render") is trace.span("render.wait", a=1)  # the shared null context
    with trace.span("render") as sp:
        assert sp is None
    scene, cam = _small()
    compiled = scene.compile(device=CPU)
    R.render_image(compiled, cam, progress=False)  # the schedule's inputs made and kept: both calls below reuse them
    img_off, mean_off, st_off = R.render_image(compiled, cam, progress=False)
    with trace.recording() as rec:
        img_on, mean_on, st_on = R.render_image(compiled, cam, progress=False)
        with pytest.raises(RuntimeError, match="already on"):
            with trace.recording():
                pass
    assert trace.active() is None and rec.named("render")
    np.testing.assert_array_equal(img_on, img_off)
    assert mean_on.tobytes() == mean_off.tobytes()
    off, on = dataclasses.asdict(st_off), dataclasses.asdict(st_on)
    off.pop("wall_s"), on.pop("wall_s")
    assert on == off and off["work_lanes"] > 0 and off["device_s"] == 0.0


def _check_call(rec, root):
    spans = [s for s in rec.spans if s.call == root.id]
    assert all(s.track == "host" and s.end >= s.start for s in spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s is not root:
            up = by_id[s.parent]
            assert up.start <= s.start and s.end <= up.end
    for s in spans:  # children do not overlap: no self time is negative
        kids = sorted(rec.children(s), key=lambda c: c.start)
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert rec.self_ns(s) >= 0
    assert sum(rec.self_ns(s) for s in spans) == root.ns
    return {s.name for s in spans}


def test_spans_nest_and_share_their_call():
    scene, cam = _small()
    with trace.recording() as rec:
        compiled = scene.compile(device=CPU)
        _, _, stats = R.render_image(compiled, cam, progress=False)
        _, _, gstats = render_film_grads(compiled, cam, spp=2, return_stats=True)
    (comp,) = rec.named("scene.compile")
    assert {"scene.compile", "scene.upload"} <= _check_call(rec, comp)
    (render,) = rec.named("render")
    names = _check_call(rec, render)
    assert names == {"render", "render.order", "render.inputs", "render.eager", "render.readback",
                     "render.accumulate", "render.tonemap"}
    assert render.attrs == dataclasses.asdict(stats)
    (grads,) = rec.named("grads")
    assert _check_call(rec, grads) == {"grads", "grads.inputs", "grads.forward.chunk", "grads.backward.chunk"}
    assert grads.attrs["trips"] == gstats.trips > 0 and gstats.device_forward_s == 0.0
    assert len({comp.call, render.call, grads.call}) == 3


def test_work_sums_equal_the_logged_lanes_with_work():
    """Cornell at 64 px, 2 lanes a pixel, max_depth 12: 8192 lanes, a compaction at 4096."""
    scene, cam = cornell_box_scene(64, 2)
    compiled = scene.compile(device=CPU)
    sd, c = compiled.data, cam.init(CPU)
    npix = 64 * 64
    pix = torch.arange(npix, dtype=torch.int32).repeat(2)
    rows, cols = pix // 64, pix % 64
    sample0 = torch.from_numpy(R.lane_first_samples(npix, npix, 2, 1, 0, 2))
    stages = []
    _, rays, iters = trace_film_streamed(sd, c, pix, rows, cols, sample0, 2, 0, 1, 12, compiled.has_lights,
                                         stages=stages)
    st = StreamStages(sd, c, pix.shape[0], 2, 1, 12, compiled.has_lights, CPU)
    st.set_inputs(pix, rows, cols, sample0, 0)
    log = []
    st.run(log=log)
    logged = [sum(n for i, n, go, _ in log if i == stage and go) for stage in range(len(st.thresholds))]
    assert len(logged) == 2 and all(n > 0 for n in logged)
    assert st.work.tolist() == logged == [work for _, _, work in stages]
    assert [lanes for lanes, _, _ in stages] == st.sizes
    assert [ran for _, ran, _ in stages] == st.iters.tolist() and iters == sum(st.iters.tolist())
    assert sum(logged) == rays  # a lane with work traces a ray in its iteration


def test_profile_dir_merges_the_spans_on_the_profilers_clock(tmp_path):
    scene, cam = _small()
    compiled = scene.compile(device=CPU)
    R.render_image(compiled, cam, progress=False, profile_dir=str(tmp_path))
    events = json.loads((tmp_path / "render_rank0.json").read_text())["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "tpupt_torch"}
    assert {"render", "render.order", "render.eager", "render.tonemap"} <= set(ours)
    assert all(e["tid"] == "spans" for e in ours.values())
    eager = ours["render.eager"]
    adds = [e for e in events if e.get("name") == "aten::index_add_"]
    assert adds and all(eager["ts"] - 50 <= e["ts"] and e["ts"] + e["dur"] <= eager["ts"] + eager["dur"] + 50
                        for e in adds)
