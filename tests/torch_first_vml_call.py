"""Does the first call into MKL's vector math of a process give other bits than the
second? (ROADMAP Queue 3; tests/torch_cpu_warmup.py is the tests' answer.)

    python tests/torch_first_vml_call.py --mode plain --runs 480 --workers 8
    python tests/torch_first_vml_call.py --mode warm     # torch_cpu_warmup imported first
    python tests/torch_first_vml_call.py --mode k1       # K1's plain version, balls scene

Each run is a fresh process. plain / warm: torch.sqrt of 16296 float32 values (eight
intra-op chunks of 2037) twice, compared bit for bit. k1: K1's plain version twice on the
balls scene's 2037 rays (its sqrt covers [2037, 8] elements). The parent prints each run
that differed (elements, their index range, the largest relative difference) and the
tally. The rate follows the machine's load: run the modes in turns.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one_run(mode: str) -> str:
    """The child: -> 'differ N ...' for the first call against the second."""
    if mode == "warm":
        import torch_cpu_warmup  # noqa: F401
    import numpy as np
    import torch

    if mode == "k1":
        from tpupt_torch.ops import hit_kernel
        from tpupt_torch.scenes import balls_scene

        rng = np.random.default_rng(3)
        o = rng.uniform(-12.0, 12.0, size=(2037, 3)).astype(np.float32)
        d = rng.normal(size=(2037, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tm = rng.uniform(size=2037).astype(np.float32)
        sph, quad = hit_kernel.tables(balls_scene(16, 4)[0].compile(device="cpu").data)
        args = [torch.from_numpy(a) for a in (o, d, tm)] + [sph, quad]
        first, second = (hit_kernel.closest_sphere_quad_plain(*args)[0] for _ in range(2))
    else:
        x = torch.rand(16296, generator=torch.Generator().manual_seed(0)) * 100 + 1e-3
        first, second = torch.sqrt(x), torch.sqrt(x)
    bad = first != second
    if not bool(bad.any()):
        return "differ 0"
    i = bad.nonzero()[:, 0]
    rel = float(((first - second).abs() / second.abs())[bad].max())
    return f"differ {int(bad.sum())} at {int(i[0])}..{int(i[-1])}, relative difference up to {rel:.3g}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("plain", "warm", "k1"), default="plain")
    ap.add_argument("--runs", type=int, default=480)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(one_run(args.mode), flush=True)
        return 0

    def spawn(_):
        r = subprocess.run([sys.executable, __file__, "--child", "--mode", args.mode], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        return lines[-1] if r.returncode == 0 and lines else f"failed: {r.stderr.strip()[-300:]}"

    with ThreadPoolExecutor(args.workers) as pool:
        results = list(pool.map(spawn, range(args.runs)))
    bad = [r for r in results if r != "differ 0"]
    for r in bad:
        print(r)
    print(f"mode {args.mode}: {len(bad)} of {args.runs} runs differed")
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    raise SystemExit(main())
