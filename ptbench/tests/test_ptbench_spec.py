"""The harness finds its parts by name, BENCHMARK.json keeps to its contract, and a cell
added as files runs without an edit to any file that is there."""

import hashlib
import json
import os
import re

import pytest

from ptbench import run as R
from ptbench.core import spec
from ptbench.tests.tiny import tiny_copy, tiny_run

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


def test_a_cell_added_as_files_runs_without_editing_any_file(tmp_path):
    root, here = tiny_copy(str(tmp_path))
    before = _digests(here)
    # a new configuration, cell and per-layer metric: new files, and entries in BENCHMARK.json
    cfg = spec.load_json(os.path.join(here, "configs", "cornell.json"))
    cfg["name"] = "cornell_lit"
    cfg["materials"]["light"]["emission"] = [40.0, 40.0, 40.0]
    with open(os.path.join(here, "configs", "cornell_lit.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "workloads", "cornell_lit.fast.json"), "w") as f:
        json.dump({"config": "cornell_lit", "traffic": "frames", "params": {"check_pixels": 32},
                   "limits": {"rel_l1": 1e-6}}, f)
    with open(os.path.join(here, "metrics", "calls_done.py"), "w") as f:
        f.write("def read(run):\n    return float(sum(c['ok'] for c in run.calls))\n")
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append(dict(bench["configs"][0], name="cornell_lit", file="ptbench/configs/cornell_lit.json"))
    bench["workloads"].append({"name": "cornell_lit.fast", "config": "cornell_lit", "traffic": "frames",
                               "chips": 1, "why": "a brighter light"})
    for m in bench["end_to_end"]:
        if m["name"] == "paths_per_s":
            m["workloads"].append("cornell_lit.fast")
    bench["per_layer"].append({"name": "calls_done", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "driver", "moves": "paths_per_s", "workloads": ["cornell_lit.fast"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    run = tiny_run(root, here, "cornell_lit.fast")
    result, checks = R.execute(run, 0.0)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"paths_per_s", "setup_s"}
    run.trace = True
    names = [m["name"] for m in spec.metrics_of(run.bench, run.name, True)]
    assert "calls_done" in names and "k1_roofline" not in names
    assert spec.module("metrics", "calls_done", here).read(run) == result["attempted"]
    after = _digests(here)
    assert all(after[k] == v for k, v in before.items() if not k.startswith("_work"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_metrics_of_a_cell(cell):
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, False)]
    per = [m for m in spec.metrics_of(BENCH, cell, True)]
    assert per and all(m["moves"] in e2e for m in per)
