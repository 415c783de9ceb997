"""Compute dtype of the port: float32 kernels, or the f64 CPU oracle.

Counterpart of ``tpupt/core/dtypes.py``. The reference renderer computes in f64
(vec3.rs:3-6); the card's path is float32, and the same integrator re-runs in
float64 on the CPU as the oracle that measures the float32 round-off. The oracle is
chosen by the environment variable ``TPUPT_ORACLE_X64=1`` when this module is first
imported: every table, ray and constant of the compute path takes ``REAL``. The
counter-based sampler (core/rng.py) draws the same 24-bit uniforms in both modes,
so the oracle follows the same paths and a per-pixel difference is round-off.

The oracle runs on the CPU only: resolving a CUDA device under it raises
(core/device.py), since the hand-written kernels are float32. The cluster routes'
plain versions order hits by float32 bits and raise under it too, so meshes take
the stackless BVH there, as in the reference's CPU route.
"""

from __future__ import annotations

import os

import numpy as np
import torch

ORACLE_X64 = os.environ.get("TPUPT_ORACLE_X64", "0").lower() not in ("", "0", "false")

REAL = torch.float64 if ORACLE_X64 else torch.float32
NP_REAL = np.float64 if ORACLE_X64 else np.float32
