"""A copy of the benchmark's files at a size a CPU test can hold.

``tiny_copy`` copies a ptbench/ tree (the checkout's, or one a test made) without its work
directory into a temporary directory, cuts every configuration in the copy's ``configs/``
to a CPU test size, whatever its name, and sets each cell's check pixels, so that a run of
a cell, driven without the look for a card (``run.execute``), ends in seconds on the CPU.
So a configuration added as files and entries alone reaches these tests cut, never at its
own size. A configuration that ``SIZES`` names gets that ``(image_width,
samples_per_pixel)``; every other one gets ``CUT``'s width, samples and ``max_depth``, or
its own where that is smaller, and never fewer than ``MIN_SPP`` samples a pixel. The height
follows the width, so the aspect ratio stays. Two tests set the cut:
``test_a_broken_program_is_not_correct`` wants 2 or more calls in its 1.0 s fault window,
and the slowest configuration known on the CPU, about 500 spheres under a lens with
moving centres and glass and metal chains, costs a call about 0.04 s an iteration
whatever the width (a sweep of every sphere tile, each a handful of small operations):
at 16 px, 2 samples and ``max_depth`` 3 a warm call took 0.2-0.3 s, at ``max_depth`` 50
0.6-0.8 s; and the ``half_batch`` fault leaves out half of the samples, so a frame keeps
2. ``MAX_PATHS`` is the most paths a copied configuration's frame may take (Cornell's
24x24 at 8 samples); a test holds every configuration to it.

Torch runs on at most ``THREADS`` threads here. A call is thousands of small operations,
and on a host whose cores other work shares, threads for every core make each operation
wait for the slowest: the warm call above took 0.9-8.5 s on 8 threads of a busy 8-core
host, 0.2-0.3 s on 1 or 2. The output check of a fault that returns a call's state
unchanged traces the paths of thousands of instant calls again, and 2 threads take it
in about half the time of one. This module also makes the CPU's first vector-math call
once, as the port's tests do: on several threads that call can round one chunk otherwise.

The copy also holds two cells that the benchmark leaves out. ``everything.fast``, until the
real meshes and sky of the Rust reference's scene 6 are in the repository: scene 6 on the
stand-ins that ``core/assets.py`` writes (this directory's ``everything*.json``). It drives
the reference's triangles, textures and sky against the program's K2 route.
``cornell.preview`` (``workloads/cornell.preview.json``, ``traffic/preview.py``), until the
program's per-call host path is steady enough on the card's host for a bound to hold its
``frame_ms_p95``: 1-spp previews with the camera moved each call.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from ptbench import run as R
from ptbench.core import spec

SIZES = {"cornell": (24, 8), "everything": (32, 4)}
CUT = (16, 2, 3)
MIN_SPP = 2
MAX_PATHS = 24 * 24 * 8
EXTRA_CELLS = ["everything.fast", "cornell.preview"]
THREADS = 2

torch.set_num_threads(min(torch.get_num_threads(), THREADS))
torch.sqrt(torch.ones(64))


def tiny_copy(dst, sizes=SIZES, check_pixels=48, src=spec.HERE):
    """The ptbench/ tree `src` copied to dst/ptbench and its BENCHMARK.json to dst, every
    configuration cut to a test size -> (root, here)."""
    here = os.path.join(dst, "ptbench")
    shutil.copytree(src, here, ignore=shutil.ignore_patterns("_work", "__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(src), "BENCHMARK.json"), dst)
    _add_left_out_cells(dst, here)
    configs = os.path.join(here, "configs")
    for fn in os.listdir(configs):
        path = os.path.join(configs, fn)
        cfg = spec.load_json(path)
        cfg["camera"].update(_cut(fn[: -len(".json")], cfg["camera"], sizes))
        _write(path, cfg)
    for fn in os.listdir(os.path.join(here, "workloads")):
        path = os.path.join(here, "workloads", fn)
        wl = spec.load_json(path)
        wl["params"]["check_pixels"] = check_pixels
        _write(path, wl)
    return dst, here


def tiny_run(root, here, cell, seed=2**31 + 11, seconds=0.5):
    """A Run of `cell` on the CPU over the copy."""
    return R.Run(cell, seed, seconds, False, on_card=False, root=root, here=here)


def frame_paths(camera: dict) -> int:
    """The paths of one frame of a configuration's camera: width x height x samples."""
    w = int(camera["image_width"])
    return w * int(w / camera["aspect_ratio"]) * int(camera["samples_per_pixel"])


def _cut(name, camera, sizes):
    if name in sizes:
        width, spp = sizes[name]
        return {"image_width": width, "samples_per_pixel": spp}
    width, spp, depth = CUT
    return {"image_width": min(int(camera["image_width"]), width),
            "samples_per_pixel": max(MIN_SPP, min(int(camera["samples_per_pixel"]), spp)),
            "max_depth": min(int(camera["max_depth"]), depth)}


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _add_left_out_cells(root, here):
    tests = os.path.dirname(os.path.abspath(__file__))
    shutil.copy(os.path.join(tests, "everything.json"), os.path.join(here, "configs"))
    shutil.copy(os.path.join(tests, "everything.fast.json"), os.path.join(here, "workloads"))
    path = os.path.join(root, "BENCHMARK.json")
    bench = spec.load_json(path)
    bench["configs"].append({"name": "everything", "source": "scene 6 of the Rust reference on stand-ins",
                             "file": "ptbench/configs/everything.json", "reduced": [], "why": "K2"})
    bench["workloads"].append({"name": "everything.fast", "config": "everything", "traffic": "frames",
                               "chips": 1, "why": "K2, textures, the sky"})
    bench["workloads"].append({"name": "cornell.preview", "config": "cornell", "traffic": "preview",
                               "chips": 1, "why": "the per-call host path"})
    for m in bench["end_to_end"]:
        if m["name"] == "paths_per_s":
            m["workloads"].append("everything.fast")
    bench["end_to_end"].append({"name": "frame_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": ["cornell.preview"]})
    _write(path, bench)
