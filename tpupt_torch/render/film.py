"""Film: gamma and quantization (camera.rs:95-97,111-113,128-130)."""

from __future__ import annotations

import numpy as np


def tonemap_quantize(mean_radiance: np.ndarray) -> np.ndarray:
    """[H,W,3] float mean radiance -> [H,W,3] uint8.

    gamma = sqrt(max(x,0)) (camera.rs:128-130), then (clamp(g, 0, 0.999) * 256) as
    u8 (camera.rs:95-97). Rust's `as u8` maps NaN to 0, so NaN pixels (zero-pdf
    paths) quantize to black.
    """
    x = np.asarray(mean_radiance, dtype=np.float64)
    g = np.sqrt(np.maximum(x, 0.0))
    g = np.nan_to_num(g, nan=0.0, posinf=0.999, neginf=0.0)
    return (np.clip(g, 0.0, 0.999) * 256.0).astype(np.uint8)
