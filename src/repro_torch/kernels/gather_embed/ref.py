"""Plain PyTorch versions of the hot/cold split embedding gather (K2).

The CPU path of :func:`gather_embed.hot_gather`, and on the card the
yardstick the CUDA kernel is held against, bitwise (a gather is a copy).
Ids follow the kernel's contract: below 0 → row 0; in ``split_gather_ref``
an id at or above ``H + C`` reads the last cold row, as the reference's XLA
gather clamps it.
"""
from __future__ import annotations

import torch

__all__ = ["gather_ref", "hot_gather_ref", "split_gather_ref"]


def gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the unsplit gather both split versions must equal."""
    return table[ids.long()]


def hot_gather_ref(ids: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """(T, D): ``hot[ids[t]]`` where ``ids[t] < H``, a zero row elsewhere —
    the TPU kernel ``hot_gather_pallas``'s function."""
    ids = ids.long().clamp(min=0)
    is_hot = ids < hot.shape[0]
    rows = hot[torch.where(is_hot, ids, 0)]
    return torch.where(is_hot[:, None], rows, torch.zeros_like(rows))


def split_gather_ref(hot: torch.Tensor, cold: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """Gather from ``concat([hot, cold])`` without building it: hot ids from
    ``hot``, the rest from ``cold`` (index clamped to its last row)."""
    h, c = hot.shape[0], cold.shape[0]
    ids = ids.long().clamp(min=0)
    is_hot = ids < h
    hot_part = hot[torch.where(is_hot, ids, 0)]
    cold_part = cold[torch.where(is_hot, 0, (ids - h).clamp(max=c - 1))]
    return torch.where(is_hot[:, None], hot_part, cold_part)
