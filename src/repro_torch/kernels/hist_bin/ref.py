"""Plain PyTorch version of the DBG binning kernel (Listing 1 steps 1-2).

The CPU path of :func:`hist_bin.hist_bin`, and on the card the yardstick the
CUDA kernel is held against.
"""
from __future__ import annotations

import torch

__all__ = ["assign_bins_ref", "hist_bin_ref", "histogram_ref"]


def assign_bins_ref(degrees: torch.Tensor,
                    boundaries: torch.Tensor) -> torch.Tensor:
    """Group index (0 = hottest) for every vertex, int32.

    ``boundaries`` is descending with last element 0 in DBG; group k holds
    degrees in ``[boundaries[k], boundaries[k-1])``.  The group is the first
    k with degree >= boundaries[k] — the argmax of the >= mask, so a vertex
    no bound admits lands in group 0, as on the TPU.
    """
    ge = degrees.to(torch.int64)[:, None] >= boundaries.to(torch.int64)[None, :]
    # torch.argmax returns the first of equal maxima
    return torch.argmax(ge.to(torch.uint8), dim=1).to(torch.int32)


def histogram_ref(degrees: torch.Tensor,
                  boundaries: torch.Tensor) -> torch.Tensor:
    """Vertices per group, int32 (K,)."""
    return hist_bin_ref(degrees, boundaries)[1]


def hist_bin_ref(degrees: torch.Tensor, boundaries: torch.Tensor):
    """(groups, histogram): the plain version of the whole kernel."""
    groups = assign_bins_ref(degrees, boundaries)
    hist = torch.bincount(groups.to(torch.int64),
                          minlength=boundaries.shape[0]).to(torch.int32)
    return groups, hist
