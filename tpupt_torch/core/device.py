"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from .dtypes import ORACLE_X64


def resolve_device(device=None) -> torch.device:
    """None -> cuda; a CUDA device without a GPU raises (no silent CPU fallback), and so
    does any device but the CPU under the f64 oracle (core/dtypes.py)."""
    dev = torch.device("cuda" if device is None else device)
    if ORACLE_X64 and dev.type != "cpu":
        raise RuntimeError(
            f"tpupt_torch: the f64 oracle (TPUPT_ORACLE_X64) runs on the CPU only, not on {dev}"
        )
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpupt_torch: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
