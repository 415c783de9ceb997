"""The card a run uses: refusing to run without one, and naming it in every result."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tpupt")


class NoCard(RuntimeError):
    pass


def require_cards(n: int):
    """Raise NoCard unless CUDA is there with at least n devices (no fall-back to the CPU)."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a CUDA card only")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards and {torch.cuda.device_count()} are visible")


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def describe(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are JAX's or the JAX package's, compared whole
    (the port's own name, tpupt_torch, starts with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
