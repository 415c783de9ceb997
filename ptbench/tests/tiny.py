"""A copy of the benchmark's files at a size a CPU test can hold.

``tiny_copy`` copies ptbench/ (without its work directory) into a temporary directory and
cuts each configuration's image width, samples and the cells' check pixels, so that a run
of a cell, driven without the look for a card (``run.execute``), ends in seconds on the
CPU. The copy also holds a cell that the benchmark leaves out until the real meshes and
sky of the Rust reference's scene 6 are in the repository: ``everything.fast``, scene 6
on the stand-ins that ``core/assets.py`` writes (this directory's ``everything*.json``).
It drives the reference's triangles, textures and sky against the program's K2 route. The CPU's first vector-math call on several threads can round one chunk otherwise
(the port's tests warm it the same way), so this module makes it once.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from ptbench import run as R
from ptbench.core import spec

torch.sqrt(torch.ones(64))

SIZES = {"cornell": (24, 8), "everything": (32, 4)}
EXTRA_CELLS = ["everything.fast"]


def tiny_copy(dst, sizes=SIZES, check_pixels=48):
    """ptbench/ copied to dst/ptbench and BENCHMARK.json to dst, at small sizes -> (root, here)."""
    here = os.path.join(dst, "ptbench")
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("_work", "__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), dst)
    _add_scene6(dst, here)
    for name, (width, spp) in sizes.items():
        path = os.path.join(here, "configs", f"{name}.json")
        cfg = spec.load_json(path)
        cfg["camera"].update(image_width=width, samples_per_pixel=spp)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for fn in os.listdir(os.path.join(here, "workloads")):
        path = os.path.join(here, "workloads", fn)
        wl = spec.load_json(path)
        wl["params"]["check_pixels"] = check_pixels
        with open(path, "w") as f:
            json.dump(wl, f)
    return dst, here


def tiny_run(root, here, cell, seed=2**31 + 11, seconds=0.5):
    """A Run of `cell` on the CPU over the copy."""
    return R.Run(cell, seed, seconds, False, on_card=False, root=root, here=here)


def _add_scene6(root, here):
    tests = os.path.dirname(os.path.abspath(__file__))
    shutil.copy(os.path.join(tests, "everything.json"), os.path.join(here, "configs"))
    shutil.copy(os.path.join(tests, "everything.fast.json"), os.path.join(here, "workloads"))
    path = os.path.join(root, "BENCHMARK.json")
    bench = spec.load_json(path)
    bench["configs"].append({"name": "everything", "source": "scene 6 of the Rust reference on stand-ins",
                             "file": "ptbench/configs/everything.json", "reduced": [], "why": "K2"})
    bench["workloads"].append({"name": "everything.fast", "config": "everything", "traffic": "frames",
                               "chips": 1, "why": "K2, textures, the sky"})
    for m in bench["end_to_end"]:
        if m["name"] == "paths_per_s":
            m["workloads"].append("everything.fast")
    with open(path, "w") as f:
        json.dump(bench, f)
