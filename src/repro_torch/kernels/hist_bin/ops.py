"""DBG (Listing 1) on the device: binning kernel + stable rank assembly.

Port of ``repro.kernels.hist_bin.ops``.  ``dbg_bin`` produces everything
Listing 1 needs: group ids and histogram (the hist_bin kernel) and the final
stable mapping (step 3) — the rank within a group is a cumulative count, one
exclusive scan over the one-hot group matrix in plain PyTorch, since the
scan across the whole vertex range belongs to the outer program, not the
binning kernel.  The mapping equals the host ``core.reorder.group_reorder``
mapping.
"""
from __future__ import annotations

import torch

from .hist_bin import hist_bin

__all__ = ["dbg_bin", "stable_mapping_from_groups"]


def stable_mapping_from_groups(groups: torch.Tensor,
                               num_groups: int) -> torch.Tensor:
    """Listing 1 step 3: new id = (start of my group) + (my stable rank within
    group), int64.  Stable rank via exclusive cumsum of the one-hot group
    matrix.

    The matrix is laid out (K, V) so the scan runs along the contiguous
    dimension: the same scan over a (V, K) matrix along its strided first
    dimension took 748 ms at V = 2^21, K = 8 on an H100 (``chip_smoke.py``)."""
    g = groups.to(torch.int64)
    onehot = (torch.arange(num_groups, device=g.device)[:, None] == g[None, :])
    onehot = onehot.to(torch.int64)
    within = torch.cumsum(onehot, dim=1) - onehot  # earlier same-group count
    sizes = onehot.sum(dim=1)
    starts = torch.cumsum(sizes, dim=0) - sizes
    return starts[g] + within[g, torch.arange(g.shape[0], device=g.device)]


def dbg_bin(degrees: torch.Tensor, boundaries: torch.Tensor):
    """Full DBG (Listing 1) on the tensors' device.  Returns
    (mapping (V,) int64, groups (V,) int32, histogram (K,) int32)."""
    groups, hist = hist_bin(degrees.to(torch.int32).contiguous(),
                            boundaries.to(torch.int32).contiguous())
    mapping = stable_mapping_from_groups(groups, boundaries.shape[0])
    return mapping, groups, hist
