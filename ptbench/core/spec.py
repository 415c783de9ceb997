"""Finding the benchmark's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and metrics. Each part
lives in a file named after it, which the harness finds without a list of its own:

- a cell: ``workloads/<cell>.json`` (its configuration, its traffic module, the
  traffic's parameters and the limits of its output check);
- a configuration: ``configs/<config>.json``;
- a kind of traffic: ``traffic/<traffic>.py``;
- a metric, end-to-end or per-layer: ``metrics/<metric>.py``, whose ``read(run)``
  returns the value or None when the run has nothing to read for it.

So a later change adds a configuration, a cell or a metric by adding files and
entries in ``BENCHMARK.json``, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def workload(name: str, here=HERE) -> dict:
    return load_json(os.path.join(here, "workloads", f"{name}.json"))


def config(name: str, here=HERE) -> dict:
    return load_json(os.path.join(here, "configs", f"{name}.json"))


def module(kind: str, name: str, here=HERE):
    """ptbench/<kind>/<name>.py as a module (names may hold dots, so it is loaded by path)."""
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"ptbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end ones with trace off, its
    per-layer ones with trace on. A metric without a "workloads" key belongs to every
    cell that reports the end-to-end metric it moves (or, end-to-end, to every cell)."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in mine else [])]
