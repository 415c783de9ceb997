"""Compute dtype of the port: float32 everywhere, like the reference's device path.

The reference package also has an f64 CPU oracle mode; the port does not carry
it yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

REAL = torch.float32
NP_REAL = np.float32
