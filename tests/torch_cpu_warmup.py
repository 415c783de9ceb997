"""Imported by every test module of the port: makes the process's first call into MKL's
vector math library on one thread, before any test runs.

PyTorch computes sqrt, exp, log and the trigonometric functions of float tensors on the
CPU through MKL's vector math (`vms*` / `vmd*`, high-accuracy mode) inside its intra-op
parallel loop. When the first such call of a process runs on several intra-op threads at
once, one thread's chunk can come out of a less accurate routine (a float32 sqrt off by
up to 3.1e-4 relative). That made K1's plain version give other t bits on one
intra-op chunk of lanes in up to a few percent of fresh processes (ROADMAP Queue 3; the
experiment: tests/torch_first_vml_call.py). Later calls are right, so one call on one
thread first (tensors below PyTorch's grain of 2048 elements run on the calling thread)
takes the first call's place.
"""

import torch

for _dtype in (torch.float32, torch.float64):
    _x = torch.full((8,), 0.5, dtype=_dtype)
    for _op in (torch.sqrt, torch.exp, torch.log, torch.sin, torch.cos, torch.tan, torch.atan, torch.acos,
                torch.asin, torch.tanh, torch.erf, torch.log2, torch.log10):
        _op(_x)
