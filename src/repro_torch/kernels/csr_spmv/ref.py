"""Plain PyTorch versions of the degree-binned SpMV (K1) and its CSR oracle.

``ell_spmv_ref`` is the CPU path of :func:`csr_spmv.ell_spmv` and, on the
card, the yardstick the CUDA kernel is held against.  ``csr_spmv_ref`` is
the edge-parallel oracle of the pull-mode edge map, a sorted-segment sum
over the in-CSR offsets: deterministic on every device (no float atomics).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ell_spmv_ref", "csr_spmv_ref"]


def ell_spmv_ref(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
                 deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row sums of gathered x over an ELL pack: y[r] = sum_j x[idx[r,j]] * w[r,j].

    Padding slots carry w == 0 (and any in-range idx), so they contribute 0
    (NaN where that x is not finite).  With ``deg`` (R,), lanes j >= deg[r]
    must be (0, 0.0); they are masked out and the single term x[0] · 0
    stands for them in each row with deg[r] < W, as in the kernel.
    """
    vals = x[idx.to(torch.int64)] * w
    if deg is None:
        return vals.sum(dim=1)
    width = idx.shape[1]
    d = deg.to(torch.int64).clamp(0, width)
    lane = torch.arange(width, device=idx.device)
    y = torch.where(lane[None, :] < d[:, None], vals, 0.0).sum(dim=1)
    return torch.where(d < width, y + x[0] * 0.0, y)


def csr_spmv_ref(x: torch.Tensor, indices: torch.Tensor, indptr: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Edge-parallel CSR oracle: y[dst] = Σ over dst's in-edges of
    x[src] * w (pull-mode edge map); ``indptr`` (V+1,) are the in-CSR
    offsets, ``indices`` (E,) the sources."""
    vals = x[indices.to(torch.int64)] * w
    return torch.segment_reduce(vals, "sum", offsets=indptr.to(torch.int64),
                                axis=0, unsafe=True)
