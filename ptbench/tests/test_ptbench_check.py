"""The output check: the reference against the program on the CPU at a tiny size, the
control (the reference at bfloat16 state in the program's place) coming out as not
correct, and runs driven past the look for a card with the program broken underneath
(core/faults.py) coming out as not correct, each cell at its own limits. (The cells run
on one card: there is no exchange between cards to leave out.)"""

import os

import numpy as np
import pytest
import torch

from ptbench import run as R
from ptbench.core import faults, renders, spec
from ptbench.tests.tiny import EXTRA_CELLS, MAX_PATHS, MIN_SPP, frame_paths, tiny_copy, tiny_run

CELLS = [w["name"] for w in spec.benchmark()["workloads"]] + EXTRA_CELLS


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("ptbench")))


def _execute(tiny, cell, seconds=0.5):
    run = tiny_run(*tiny, cell, seconds=seconds)
    result, _ = R.execute(run, 0.0)
    return run, result


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(tiny, cell):
    run, result = _execute(tiny, cell)
    assert result["correct"], run.numbers
    for name in run.workload["limits"]:
        assert run.numbers[name] < 1e-5, run.numbers


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    run, _ = _execute(tiny, cell)
    control = run.traffic.check(run, state_dtype=torch.bfloat16)
    ok, _ = R.compare.judge(control, run.workload["limits"])
    assert not ok, control


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(tiny, cell, fault):
    wl = spec.workload(cell, tiny[1])
    if fault == "half_batch" and wl["traffic"] == "preview" and wl["params"]["spp"] < 2:
        pytest.skip("a preview call has one sample a pixel: there is no half to leave out")
    undo = faults.plant(fault)
    try:
        run, result = _execute(tiny, cell, seconds=1.0)
    finally:
        undo()
    if fault == "state_unchanged" and run.workload["traffic"] != "grad_steps":
        assert len(run.calls) >= 2
    assert not result["correct"], run.numbers


def test_every_configuration_is_cut_to_a_test_size(tiny):
    root, here = tiny
    names = sorted(fn[: -len(".json")] for fn in os.listdir(os.path.join(here, "configs")))
    assert names == sorted(c["name"] for c in spec.benchmark(root)["configs"])
    assert {c["name"] for c in spec.benchmark()["configs"]} | {"everything"} <= set(names)
    for name in names:
        cam = spec.config(name, here)["camera"]
        assert cam["samples_per_pixel"] >= MIN_SPP and frame_paths(cam) <= MAX_PATHS, (name, cam)


def test_pixel_samples_and_seeds_follow_the_seed(tiny):
    a, b = tiny_run(*tiny, "cornell.fast", seed=7), tiny_run(*tiny, "cornell.fast", seed=7)
    c = tiny_run(*tiny, "cornell.fast", seed=8)
    big = tiny_run(*tiny, "cornell.fast", seed=2**31 + 5)
    assert np.array_equal(renders.pixel_sample(a, 3, 20), renders.pixel_sample(b, 3, 20))
    assert not np.array_equal(renders.pixel_sample(a, 3, 20), renders.pixel_sample(c, 3, 20))
    assert a.call_seed(0) == b.call_seed(0) != c.call_seed(0)
    assert 0 <= big.call_seed(5) < 2**31 and big.call_seed(-1) != big.call_seed(0)


def _leaves():
    return {"mat_params": torch.ones(4, 3), "tex_rgb": torch.full((2, 3), 0.5),
            "env_color": torch.full((1, 3), 0.2), "atlas": torch.zeros(1, 3)}


def _train():
    return {"loss": [1.0, 0.5], "grad1": _leaves(), "change": _leaves(),
            "last": {"film": np.ones((6, 3)), "grads": _leaves()}}


def _nan_at(tr, where):
    if where == "loss":
        tr["loss"][1] = float("nan")
    elif where == "last_film":
        tr["last"]["film"][2, 1] = np.nan
    else:
        leaves = tr["last"]["grads"] if where == "last_grad" else tr[where]
        leaves["tex_rgb"][1, 0] = float("nan")  # not the first leaf counted
    return tr


@pytest.mark.parametrize("where", ["loss", "grad1", "change", "last_film", "last_grad"])
def test_a_nan_on_one_side_is_not_correct(where):
    limits = spec.workload("cornell.grads")["limits"]
    numbers = R.compare.train_numbers(_nan_at(_train(), where), _train())
    ok, _ = R.compare.judge(numbers, limits)
    assert not ok and numbers[where] == float("inf"), numbers
    same = R.compare.train_numbers(_nan_at(_train(), where), _nan_at(_train(), where))
    assert same[where] == 0.0 and R.compare.judge(same, limits)[0], same


def test_a_nan_gradient_in_a_later_step_is_not_correct(tiny, monkeypatch):
    from tpupt_torch.render import diff

    real, calls = diff.render_film_grads, []

    def render_film_grads(*a, **kw):
        out = real(*a, **kw)
        calls.append(1)
        if len(calls) == 4:  # the window's second step (after the target and step 0)
            out = (out[0], dict(out[1], tex_rgb=out[1]["tex_rgb"] * float("nan")), *out[2:])
        return out

    monkeypatch.setattr(diff, "render_film_grads", render_film_grads)
    run = tiny_run(*tiny, "cornell.grads")
    R.set_up(run, 0.0)
    run.calls = [run.traffic.call(run, i) for i in range(3)]  # the window's steps, not timed
    R.free_program(run)
    numbers = run.traffic.check(run)
    ok, _ = R.compare.judge(numbers, run.workload["limits"])
    assert all(c["ok"] for c in run.calls) and not ok, numbers
