"""Plain PyTorch version of the fused edge-map kernel (same masking semantics).

The CPU path of :func:`edge_map.ell_edge_map`, and on the card the yardstick
the CUDA kernel is held against.  Torch indexes with int64, so ``uint16`` ids
are widened here (the stored plane stays at its minimal width).
"""
from __future__ import annotations

from typing import Optional

import torch

from .edge_map import REDUCE_IDENTITY

__all__ = ["ell_edge_map_ref"]


def ell_edge_map_ref(
    x: torch.Tensor,
    idx: torch.Tensor,
    deg: torch.Tensor,
    *,
    reduce: str = "sum",
    w: Optional[torch.Tensor] = None,
    unit_weights: bool = False,
    frontier: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    init_rows: Optional[torch.Tensor] = None,
    neutral: float = 0.0,
    identity: Optional[float] = None,
) -> torch.Tensor:
    if identity is None:
        identity = REDUCE_IDENTITY[reduce]
    r, width = idx.shape
    ids = idx.to(torch.int64)
    vals = x[ids]  # (R, W) or, for a (V, K) property plane, (R, W, K)
    planar = vals.dim() == 3
    if w is not None:
        vals = vals + (w[..., None] if planar else w)
    elif unit_weights:
        vals = vals + 1.0
    if frontier is not None:
        active = frontier[ids] > 0
        if planar and active.dim() == 2:
            active = active[..., None]
        vals = torch.where(active, vals, torch.tensor(neutral, dtype=vals.dtype,
                                                      device=vals.device))
    valid = (torch.arange(width, device=idx.device)[None, :]
             < deg.to(torch.int64)[:, None])
    if alive is not None:
        valid = valid & (alive > 0)
    if planar:
        valid = valid[..., None]
    vals = torch.where(valid, vals, torch.tensor(identity, dtype=vals.dtype,
                                                 device=vals.device))
    shape = (r, x.shape[1]) if planar else (r,)
    acc = (torch.full(shape, identity, dtype=x.dtype, device=x.device)
           if init_rows is None else init_rows)
    if reduce == "sum":
        return acc + vals.sum(dim=1)
    if reduce == "min":
        return torch.minimum(acc, vals.amin(dim=1))
    return torch.maximum(acc, vals.amax(dim=1))
