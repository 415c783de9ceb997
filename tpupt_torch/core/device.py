"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda; a CUDA device without a GPU raises (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpupt_torch: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
