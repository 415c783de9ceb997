"""Readings that set a cell's limits: the program's check numbers over many seeds, and the
control's, in one process on the card.

    python3 ptbench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 [--control-seeds 3] [--fault F]

The process, its imports and the kernel builds are paid once; then for each seed a run
as run.py makes it: the cell's set-up and warm call for that seed, a window of --seconds
at the cell's own load (the same calls a run makes for that seed), and the same check
against the reference, which gives the program's readings (the lower ones). For the first --control-seeds seeds the
control is read as well: the reference put in the program's place and run with its ray
and path state rounded to bfloat16 each bounce, the precision below the float32 that
the configurations state, and compared with the reference at float32 (the upper
readings). --fault plants one of core/faults.py's faults in the program first: the
readings of a training cell's faults. One JSON line a seed; the benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ptbench import run as R  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault", default=None, help="plant a fault (core/faults.py) before set-up")
    args = ap.parse_args(argv)
    import torch

    seeds = [int(s) for s in args.seeds.split(",")]
    run = R.Run(args.workload, seeds[0], args.seconds, False)
    R.device.require_cards(run.cell["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.fault:
        from ptbench.core import faults

        faults.plant(args.fault)
    for n, seed in enumerate(seeds):
        run.seed, run.seed_u64, run.calls, run.program = seed, seed & 0xFFFFFFFFFFFFFFFF, [], None
        R.set_up(run, R.T_START)
        R.window(run)
        R.free_program(run)
        t0 = time.perf_counter()
        prog = run.traffic.check(run)
        line = {"workload": run.name, "fault": args.fault, "seed": seed, "calls": len(run.calls), "window_s": run.window_s,
                "failed": sum(not c["ok"] for c in run.calls), "program": prog,
                "reference_s": time.perf_counter() - t0}
        if n < args.control_seeds:
            line["control"] = run.traffic.check(run, state_dtype=torch.bfloat16)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
