"""Plain PyTorch version of the packed hot-segment SpMV (K4).

The CPU path of :func:`pack_spmv.hot_spmv`, and on the card the yardstick
the CUDA kernel is held against.  Torch indexes with int64 — and would read
a uint8 tensor as a boolean MASK, not as ids — so the stored plane is
widened to int64 here (uint32 through an int32 view: every id is < V <
2^31), while the plane itself stays at its minimal width.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["hot_spmv_ref", "ids_as_int64"]


def ids_as_int64(idx: torch.Tensor) -> torch.Tensor:
    """A stored id plane as torch's index type."""
    if idx.dtype == torch.uint32:
        idx = idx.view(torch.int32)
    return idx.to(torch.int64)


def hot_spmv_ref(
    x: torch.Tensor,
    idx: torch.Tensor,
    deg: torch.Tensor,
    w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y[r] = sum_{j < deg[r]} x[idx[r, j]] (* w[r, j]) — degree-masked ELL."""
    width = idx.shape[1]
    vals = x[ids_as_int64(idx)]
    if w is not None:
        vals = vals * w
    cols = torch.arange(width, device=idx.device)
    return torch.where(cols[None, :] < deg.to(torch.int64)[:, None], vals,
                       0.0).sum(dim=1)
