"""The arithmetic of each metric on made-up records, and the frozen byte counts."""

import math
import types

import pytest

from ptbench.core import compare, spec
from ptbench.counts import k1, k2


def _run(calls, traffic="frames", **kw):
    run = types.SimpleNamespace(calls=calls, workload={"traffic": traffic}, layer={}, program=None,
                                setup_s=None, window_s=None)
    run.__dict__.update(kw)
    return run


def _call(start, end, ok=True, paths=100, iterations=10, wall_s=None):
    return dict(start=start, end=end, ok=ok, paths=paths, iterations=iterations,
                wall_s=end - start if wall_s is None else wall_s)


def read(name, run):
    return spec.module("metrics", name).read(run)


def test_paths_per_s_is_all_paths_over_the_whole_span():
    calls = [_call(1.0, 3.0, paths=10), _call(3.5, 5.0, paths=20), _call(5.0, 6.0, ok=False)]
    assert read("paths_per_s", _run(calls)) == pytest.approx(30 / 5.0)
    assert read("paths_per_s", _run([])) is None


def test_frame_ms_p95_ranks_failed_calls_last():
    calls = [_call(0.0, 0.001 * (i + 1)) for i in range(100)]
    assert read("frame_ms_p95", _run(calls)) == pytest.approx(95.0)
    calls[0] = _call(0.0, 0.5, ok=False)  # two of the fastest fail: they rank above the rest
    calls[1] = _call(0.0, 0.5, ok=False)
    assert read("frame_ms_p95", _run(calls)) == pytest.approx(97.0)
    bad = [_call(0.0, 0.001, ok=(i < 90)) for i in range(100)]
    assert read("frame_ms_p95", _run(bad, window_s=12.5)) == pytest.approx(12500.0)


def test_iteration_times_and_set_up_spans():
    calls = [_call(0.0, 2.0, iterations=100, wall_s=1.5), _call(2.0, 3.0, iterations=50, wall_s=0.9)]
    assert read("iter_ms.frame", _run(calls)) == pytest.approx(1e3 * 2.4 / 150)
    assert read("iter_ms.frame", _run(calls, traffic="preview")) is None
    assert read("iter_ms.preview", _run(calls, traffic="preview")) == pytest.approx(1e3 * 2.4 / 150)
    assert read("iter_ms.preview", _run(calls)) is None
    run = _run(calls, setup_s=12.5)
    run.layer.update(scene_compile_s=0.25, graph_capture_s=0.5)
    assert read("setup_s", run) == 12.5
    assert read("scene_compile_s", run) == 0.25 and read("graph_capture_s", run) == 0.5


def test_kernel_rooflines_read_nothing_without_the_program():
    assert read("k1_roofline", _run([])) is None
    assert read("k2_roofline", _run([])) is None


def test_byte_counts():
    # K1: o, d, time in (28 B), t, kind, idx out (12 B); tables 7 S + 16 Q floats
    assert k1.bytes_moved(360000, 8, 24) == 360000 * 40 + 4 * (7 * 8 + 16 * 24)
    assert k1.least_ms(360000, 8, 24) == pytest.approx(1e3 * (14_400_000 + 1760) / 3.35e12)
    # K2: o, d, t_in in (28 B), t, idx, ns_raw, u, v, mat out (32 B); boxes and slot blocks
    assert k2.bytes_moved(202200, 8, 384) == 202200 * 60 + 4 * (8 * 8 + (8 + 640 + 1024) * 384)
    assert k2.least_ms(1, 0, 0) == pytest.approx(1e3 * 60 / 3.35e12)


def test_film_numbers():
    want = [[1.0, 2.0, 3.0], [0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [2.0, 0.0, 0.0]]
    same = compare.film_numbers(want, want)
    assert same["rel_l1"] == 0.0 and same["pixels_off"] == 0.0 and same["compared"] == 4
    got = [[1.0, 2.0, 3.0], [0.5, 0.5, 0.6], [0.0, 0.0, 0.0], [2.0, 0.0, 0.0]]
    n = compare.film_numbers(got, want)
    assert n["rel_l1"] == pytest.approx(0.1 / 9.5) and n["pixels_off"] == 0.25
    n = compare.film_numbers([[math.nan, 0, 0]] + want[1:], want)
    assert n["pixels_off"] == 0.25 and n["rel_l1"] == pytest.approx(5.0 / 8.5)  # NaN channel left out
    nan = [[math.nan, 1.0, 1.0]]
    assert compare.film_numbers(nan, nan) == dict(compare.film_numbers([[1.0] * 3], [[1.0] * 3]), nonfinite=1)
    ok, checks = compare.judge({"rel_l1": 0.1, "pixels_off": 0.0}, {"rel_l1": 0.05})
    assert not ok and checks == {"rel_l1": {"value": 0.1, "limit": 0.05}}
