"""Row gathers over the small interned tables (materials, textures, geometry rows).

The reference package routes small tables through a one-hot matmul because the TPU
has no fast vector gather; the values are identical to a plain row gather, which is
what a GPU does well.
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, C], idx [B] int -> [B, C]."""
    return table.index_select(0, idx.reshape(-1).to(torch.int64)).reshape(*idx.shape, *table.shape[1:])
