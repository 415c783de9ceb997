"""What the compiler made of the sphere+quad closest-hit kernel (csrc/hit_kernel.cu) of
the checkout in the working directory: ptxas's registers, spills and shared memory,
the loops of its machine code with their instruction counts, and its residency.

    cd <checkout> && python <this checkout>/tools/torch_k1_sass.py [LABEL] [--sass FILE]

Needs a CUDA card's machine (nvcc and cuobjdump from the CUDA toolkit). A loop is a
backward branch in `cuobjdump -sass` of the built library; per loop one JSON line
with the instructions of its body by opcode. The sphere loop is the one with a
MUFU.RSQ (the square root), the quad loop the one with a MUFU.RCP (the divide); an
unrolled loop holds several slots, told by its count of those. --sass FILE also
writes the whole listing. Where the library exports `tpupt_hit_kernel_info`, its
answer (registers, static shared memory, resident blocks an SM, SMs) is printed too,
for the kernel without and with the tile cull.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys


def loops(sass: str):
    """[(kernel, first address, last address, Counter of opcodes)] of each backward branch."""
    out, kernel, code = [], None, []

    def close():
        for k, (addr, op, target) in enumerate(code):
            if op.startswith("BRA") and target is not None and target <= addr:
                body = [o for a, o, _ in code if target <= a <= addr]
                out.append((kernel, target, addr, collections.Counter(body)))

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            kernel, code = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)(.*?);", line)
        if m:
            t = re.search(r"0x([0-9a-f]+)\s*$", m.group(3).strip())
            code.append((int(m.group(1), 16), m.group(2), int(t.group(1), 16) if t else None))
    close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", nargs="?", default="tree")
    ap.add_argument("--sass", type=str, default=None, metavar="FILE")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())  # tpupt_torch of the checkout to read
    from tpupt_torch import build

    report = build.build_all(["hit_kernel"])["hit_kernel"]
    for line in report.splitlines():
        if any(w in line for w in ("registers", "smem", "spill")):
            print(json.dumps(dict(tree=args.label, ptxas=line.strip())), flush=True)
    lib = build.load("hit_kernel")
    if hasattr(lib, "tpupt_hit_kernel_info"):
        lib.tpupt_hit_kernel_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.tpupt_hit_kernel_info.restype = ctypes.c_int
        for cull in (0, 1):  # the kernel without and with the tile cull
            info = (ctypes.c_int * 4)()
            err = lib.tpupt_hit_kernel_info(cull, info)
            print(json.dumps(dict(tree=args.label, tile_cull=bool(cull), info_error=err, registers=info[0],
                                  static_smem=info[1], blocks_per_sm=info[2], sms=info[3])), flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True, check=True).stdout
    if args.sass:
        os.makedirs(os.path.dirname(os.path.abspath(args.sass)), exist_ok=True)
        with open(args.sass, "w") as f:
            f.write(sass)
    n_code = len(re.findall(r"^\s*/\*[0-9a-f]{4,}\*/", sass, flags=re.M))
    print(json.dumps(dict(tree=args.label, instructions_in_library=n_code)), flush=True)
    for kernel, first, last, ops in loops(sass):
        print(json.dumps(dict(
            tree=args.label, kernel=kernel, loop=f"{first:#06x}-{last:#06x}", instructions=sum(ops.values()),
            sqrt_slots=ops.get("MUFU.RSQ", 0), divide_slots=ops.get("MUFU.RCP", 0),
            shared_loads=sum(v for k, v in ops.items() if k.startswith("LDS")),
            constant_loads=sum(v for k, v in ops.items() if k.startswith(("LDC", "ULDC"))),
            branches=sum(v for k, v in ops.items() if k.startswith("BRA")),
            ops=dict(sorted(ops.items())))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
