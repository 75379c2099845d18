"""DBG (Listing 1) on the device: the binning kernel, then the stable rank.

Port of ``repro.kernels.hist_bin.ops``.  ``dbg_bin`` produces everything
Listing 1 needs: group ids and histogram and the final stable mapping (step
3), whose ranks within a group are running counts in vertex order.  On the
card that is two launches: the binning kernel, which also writes each
tile's offsets, and the rank kernel (``hist_bin.stable_rank``).  For CPU
tensors both steps take their plain versions (``ref``).  The mapping equals
the host ``core.reorder.group_reorder`` mapping.
"""
from __future__ import annotations

import torch

from .hist_bin import (MAX_BINS, bin_tiles, group_tiles, hist_bin,
                       stable_rank)
from .ref import stable_mapping_ref

__all__ = ["dbg_bin", "stable_mapping_from_groups"]


def stable_mapping_from_groups(groups: torch.Tensor,
                               num_groups: int) -> torch.Tensor:
    """Listing 1 step 3: new id = (start of my group) + (my stable rank within
    group), int64, from int32 ``groups`` (V,) in ``[0, num_groups)``,
    ``num_groups`` <= 32.

    CUDA tensors run the binning kernel over the groups (for the tile
    offsets) and the rank kernel; CPU tensors take the plain version."""
    if groups.dim() != 1:
        raise ValueError(f"groups must be (V,), got {tuple(groups.shape)}")
    if groups.dtype != torch.int32:
        raise TypeError(f"groups must be int32, got {groups.dtype}")
    if not 1 <= num_groups <= MAX_BINS:
        raise ValueError(f"1 <= K <= {MAX_BINS} groups, got {num_groups}")
    if groups.device.type == "cpu":
        return stable_mapping_ref(groups, num_groups)
    return stable_rank(groups, *group_tiles(groups, num_groups))


def dbg_bin(degrees: torch.Tensor, boundaries: torch.Tensor):
    """Full DBG (Listing 1) on the tensors' device.  Returns
    (mapping (V,) int64, groups (V,) int32, histogram (K,) int32)."""
    degrees = degrees.to(torch.int32).contiguous()
    boundaries = boundaries.to(torch.int32).contiguous()
    if degrees.device.type == "cpu":
        groups, hist = hist_bin(degrees, boundaries)
        return (stable_mapping_ref(groups, boundaries.shape[0]), groups,
                hist)
    groups, hist, tiles = bin_tiles(degrees, boundaries)
    return stable_rank(groups, hist, tiles), groups, hist
