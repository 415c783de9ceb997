"""Run one cell of the benchmark once and print its result as the last line.

    python3 ptbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run is one process: it loads the program, builds the
cell's configuration, warms the cell's own shape with one call (all of that is set-up),
then calls the program back to back for --seconds (the window; the call running at its
end completes and counts). With --trace 0 it reports the cell's end-to-end metrics;
with --trace 1 its per-layer metrics, and the device's busy seconds over a traced call
after the window. Then it reads the device's memory peak, frees the program's state,
and checks what the window's calls produced against the plain reference
(``ptbench/reference``): `correct`. Every number compared is printed beside its limit,
as the last lines on standard error and under "checks", the last key of the result.

The run needs a CUDA card (it never falls back to the CPU), writes only inside the
checkout (the stand-in assets under ``ptbench/_work/``, the program's kernel builds in
``tpupt_torch/_build/``), and refuses to print a result if JAX or the JAX package is
loaded in the process. Exit codes: 0 with a result; 2 no card; 3 JAX loaded; 1 errors.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import zlib  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root holds both packages
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from ptbench.core import compare, device, spec  # noqa: E402

class Run:
    """One run of a cell: its parts found by name, its records, and the program's state."""

    def __init__(self, name, seed, seconds, trace, on_card=True, root=spec.ROOT, here=spec.HERE):
        self.bench = spec.benchmark(root)
        self.cell = spec.cell(self.bench, name)
        self.workload = spec.workload(name, here)
        self.cfg = spec.config(self.cell["config"], here)
        self.traffic = spec.module("traffic", self.workload["traffic"], here)
        self.name, self.seed, self.seconds, self.trace = name, seed, seconds, trace
        self.seed_u64 = seed & 0xFFFFFFFFFFFFFFFF
        self.on_card = on_card
        self.device = "cuda" if on_card else "cpu"
        self.here = here
        self.asset_dir = os.path.join(here, "_work", "assets", self.cell["config"])
        self.calls, self.layer, self.program = [], {}, None
        self.setup_s = self.window_s = None
        cam = self.cfg["camera"]
        w = int(cam["image_width"])
        self.image_size = (w, int(w / cam["aspect_ratio"]))

    def call_seed(self, index: int) -> int:
        """The RNG seed of call `index`, drawn from the run's seed (same seed, same inputs)."""
        return int(np.random.default_rng([self.seed_u64, 1, index & 0xFFFFFFFF]).integers(0, 2**31))

    def seed_for(self, what: str) -> int:
        """A seed for one use outside the calls (a kernel's rays, say), drawn from the run's seed."""
        return int(np.random.default_rng([self.seed_u64, 4, zlib.crc32(what.encode())]).integers(0, 2**31))


def set_up(run, t_start):
    from ptbench.core.assets import write_stand_ins

    write_stand_ins(run.cfg, run.asset_dir)
    run.traffic.setup(run)
    run.traffic.warm(run)
    run.setup_s = time.perf_counter() - t_start


def window(run):
    t0 = time.perf_counter()
    i = 0
    while True:
        rec = run.traffic.call(run, i)
        run.calls.append(rec)
        i += 1
        if rec["end"] - t0 >= run.seconds:
            break
    run.window_s = run.calls[-1]["end"] - t0


def read_metrics(run, names_units):
    out = {}
    for name, unit in names_units:
        value = spec.module("metrics", name, run.here).read(run)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def free_program(run):
    import gc

    import torch

    run.program = None
    gc.collect()
    if run.on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def execute(run, t_start=T_START):
    """Set-up, window, metrics, the traced call, then the check -> (result, checks)."""
    import torch

    set_up(run, t_start)
    window(run)
    peak = torch.cuda.max_memory_allocated() if run.on_card else 0
    metrics = spec.metrics_of(run.bench, run.name, run.trace)
    result = {"correct": None, "attempted": len(run.calls),
              "failed": sum(not c["ok"] for c in run.calls),
              "metrics": read_metrics(run, [(m["name"], m["unit"]) for m in metrics])}
    dev = device.describe(run.cell["chips"], peak) if run.on_card else {"platform": "cpu", "count": 0}
    if run.trace:
        from ptbench.core.profile import traced

        prof = traced(lambda: run.traffic.traced(run))
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = prof["breakdown"]
    result["device"] = dev
    free_program(run)
    t0 = time.perf_counter()
    run.numbers = run.traffic.check(run)
    run.check_s = time.perf_counter() - t0
    ok, checks = compare.judge(run.numbers, run.workload["limits"])
    result["correct"] = bool(ok and result["failed"] == 0)
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    run = Run(args.workload, args.seed, args.seconds, bool(args.trace))
    try:
        device.require_cards(run.cell["chips"])
    except device.NoCard as e:
        print(f"ptbench: {e}", file=sys.stderr)
        return 2
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checks = execute(run)
    for c in run.calls:
        if not c["ok"]:
            print(f"ptbench: call failed: {c['error']}", file=sys.stderr)
    ms = sorted(1e3 * (c["end"] - c["start"]) for c in run.calls)
    print(f"ptbench: call ms: min {ms[0]!r}, median {ms[len(ms) // 2]!r}, max {ms[-1]!r}", file=sys.stderr)
    print(f"ptbench: {run.name} seed {run.seed}: {len(run.calls)} calls in {run.window_s:.3f} s, "
          f"set-up {run.setup_s:.3f} s, card {device.power_limit()}, reference {run.check_s:.3f} s, "
          f"check numbers {json.dumps(run.numbers)}",
          file=sys.stderr)
    bad = device.forbidden_modules()
    if bad:
        print(f"ptbench: refusing to report: {bad} loaded in this process", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = {name: {k: _text_if_not_finite(v) for k, v in c.items()} for name, c in checks.items()}
    print(json.dumps(result, allow_nan=False, default=_plain))
    return 0


def _text_if_not_finite(x):
    """A number JSON cannot hold (a check that read NaN or infinite) as its text."""
    return repr(float(x)) if isinstance(x, (float, np.floating)) and not np.isfinite(x) else x


def _plain(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    raise TypeError(f"{type(x).__name__} is not JSON")


if __name__ == "__main__":
    sys.exit(main())
