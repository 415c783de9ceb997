"""The harness finds its parts by name, BENCHMARK.json keeps to its contract, and a cell
added as files runs without an edit to any file that is there."""

import hashlib
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from ptbench import run as R
from ptbench.core import faults, spec
from ptbench.tests.tiny import MAX_PATHS, MIN_SPP, SIZES, frame_paths, tiny_copy, tiny_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_every_cell_finds_its_parts_by_name():
    for w in BENCH["workloads"]:
        wl = spec.workload(w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert spec.config(w["config"])["name"] == w["config"]
        traffic = spec.module("traffic", w["traffic"])
        for fn in ("setup", "warm", "call", "traced", "check"):
            assert callable(getattr(traffic, fn))
        assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.exists(os.path.join(spec.ROOT, c["file"])) and c["file"].startswith("ptbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):  # each cell it lists reports what it moves
            assert m["moves"] in [x["name"] for x in spec.metrics_of(BENCH, cell, False)]
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in spec.metrics_of(BENCH, w["name"], False)]
        assert "setup_s" in mine and len(mine) >= 2
        assert spec.metrics_of(BENCH, w["name"], True)
    assert len(json.dumps(BENCH)) < 64 * 1024


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(base, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def spheres_config(seed):
    """A sphere-heavy configuration at its own full size, written from `seed`: a checker
    ground sphere, three large spheres and a grid of about 480 small ones (about 80% diffuse
    with a second centre, 15% metal, 5% glass), a lens (defocus 0.6) and a constant sky."""
    rng = np.random.default_rng(seed)
    mats = {"ground": {"type": "diffuse", "base_color": {"checker": {"scale": 0.32, "even": [0.2, 0.3, 0.1],
                                                                     "odd": [0.9, 0.9, 0.9]}}},
            "glass": {"type": "glass", "base_color": [1.0, 1.0, 1.0], "roughness": 0.001, "ior": 1.5},
            "brown": {"type": "diffuse", "base_color": [0.4, 0.2, 0.1]},
            "bronze": {"type": "metal", "base_color": [0.7, 0.6, 0.5], "roughness": 0.0}}
    objects = [{"type": "sphere", "radius": r, "center": c, "material": m}
               for r, c, m in ((1000.0, [0.0, -1000.0, 0.0], "ground"), (1.0, [0.0, 1.0, 0.0], "glass"),
                               (1.0, [-4.0, 1.0, 0.0], "brown"), (1.0, [4.0, 1.0, 0.0], "bronze"))]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            center = [a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()]
            if np.hypot(center[0] - 4.0, center[2]) <= 0.9:  # clear of the metal sphere
                continue
            ob = {"type": "sphere", "radius": 0.2, "center": center, "material": "glass"}
            if choose < 0.8:
                ob["material"] = f"diffuse{len(mats)}"
                mats[ob["material"]] = {"type": "diffuse", "base_color": (rng.random(3) * rng.random(3)).tolist()}
                ob["center2"] = [center[0], center[1] + 0.5 * rng.random(), center[2]]
            elif choose < 0.95:
                ob["material"] = f"metal{len(mats)}"
                mats[ob["material"]] = {"type": "metal", "base_color": (0.5 + 0.5 * rng.random(3)).tolist(),
                                        "roughness": 0.0}
            objects.append(ob)
    camera = {"aspect_ratio": 16.0 / 9.0, "image_width": 600, "samples_per_pixel": 100, "max_depth": 50,
              "vfov": 20.0, "look_from": [13.0, 2.0, 3.0], "look_at": [0.0, 0.0, 0.0], "vup": [0.0, 1.0, 0.0],
              "blur_strength": 0.5, "focal_length": 10.0, "defocus_angle": 0.6}
    return {"name": "spheres", "source": f"written from seed {seed}", "reduced": [], "camera": camera,
            "environment": [0.7, 0.8, 1.0], "materials": mats, "objects": objects, "stand_ins": {}}


def _add_cell(src, cfg):
    """A configuration, its frames cell and a per-layer metric (calls_done) added to the
    ptbench/ tree `src` as a later change adds them: new files, and entries in BENCHMARK.json."""
    name = cfg["name"]
    with open(os.path.join(src, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(src, "workloads", f"{name}.fast.json"), "w") as f:
        json.dump({"config": name, "traffic": "frames", "params": {"check_pixels": 512},
                   "limits": {"rel_l1": 0.01, "pixels_off": 0.03}}, f)
    with open(os.path.join(src, "metrics", "calls_done.py"), "w") as f:
        f.write("def read(run):\n    return float(sum(c['ok'] for c in run.calls))\n")
    path = os.path.join(os.path.dirname(src), "BENCHMARK.json")
    bench = spec.load_json(path)
    bench["configs"].append({"name": name, "source": cfg["source"], "file": f"ptbench/configs/{name}.json",
                             "reduced": [], "why": "spheres, motion blur, a lens, glass and metal chains"})
    bench["workloads"].append({"name": f"{name}.fast", "config": name, "traffic": "frames", "chips": 1,
                               "why": "frames of about 500 spheres"})
    for m in bench["end_to_end"]:
        if m["name"] == "paths_per_s":
            m["workloads"].append(f"{name}.fast")
    bench["per_layer"].append({"name": "calls_done", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "driver", "moves": "paths_per_s", "workloads": [f"{name}.fast"]})
    with open(path, "w") as f:
        json.dump(bench, f)


def test_a_cell_added_as_files_runs_without_editing_any_file(tmp_path):
    """A configuration of a name the CPU copy does not know, at its own full size, with its
    cell and a per-layer metric, added to a copy of the checkout's ptbench/ as files and
    entries alone: the CPU copy cuts it, its run agrees with the reference, the control and
    every fault of core/faults.py come out as not correct, and no file that was there moves."""
    src = os.path.join(tmp_path, "src", "ptbench")
    shutil.copytree(spec.HERE, src, ignore=shutil.ignore_patterns("_work", "__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), os.path.dirname(src))
    before = _digests(src)
    full = spheres_config(22)
    assert full["name"] not in SIZES and len(full["objects"]) >= 450
    _add_cell(src, full)
    after_adding = _digests(src)
    assert all(after_adding[k] == v for k, v in before.items())

    root, here = tiny_copy(os.path.join(tmp_path, "tiny"), src=src)
    cut = spec.config(full["name"], here)
    assert frame_paths(cut["camera"]) <= MAX_PATHS < frame_paths(full["camera"])
    assert cut["camera"]["samples_per_pixel"] >= MIN_SPP
    assert cut["camera"]["aspect_ratio"] == full["camera"]["aspect_ratio"]
    assert {k: v for k, v in cut.items() if k != "camera"} == {k: v for k, v in full.items() if k != "camera"}
    cell = f"{full['name']}.fast"
    copied = _digests(here)

    run = tiny_run(root, here, cell)
    result, _ = R.execute(run, 0.0)
    assert result["correct"] and result["attempted"] >= 1, run.numbers
    assert all(run.numbers[name] < 1e-5 for name in run.workload["limits"]), run.numbers
    assert set(result["metrics"]) == {"paths_per_s", "setup_s"}
    control = run.traffic.check(run, state_dtype=torch.bfloat16)
    assert not R.compare.judge(control, run.workload["limits"])[0], control
    run.trace = True
    names = [m["name"] for m in spec.metrics_of(run.bench, run.name, True)]
    assert "calls_done" in names and "k1_roofline" not in names
    assert spec.module("metrics", "calls_done", here).read(run) == result["attempted"]

    for fault in faults.NAMES:
        undo = faults.plant(fault)
        try:
            broken = tiny_run(root, here, cell, seconds=1.0)
            result, _ = R.execute(broken, 0.0)
        finally:
            undo()
        assert len(broken.calls) >= 2 and not result["correct"], (fault, broken.numbers)

    after = _digests(here)
    assert all(after[k] == v for k, v in copied.items())
    assert _digests(src) == after_adding


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_metrics_of_a_cell(cell):
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, False)]
    per = [m for m in spec.metrics_of(BENCH, cell, True)]
    assert per and all(m["moves"] in e2e for m in per)
