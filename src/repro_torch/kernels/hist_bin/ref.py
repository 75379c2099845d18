"""Plain PyTorch versions of the DBG binning kernel (Listing 1 steps 1-2)
and of the stable rank (step 3).

The CPU path of :func:`hist_bin.hist_bin`, ``ops.stable_mapping_from_groups``
and ``ops.dbg_bin``, and on the card the yardstick the CUDA kernels are held
against.
"""
from __future__ import annotations

import torch

__all__ = ["assign_bins_ref", "hist_bin_ref", "histogram_ref",
           "stable_mapping_ref"]


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


def stable_mapping_ref(groups: torch.Tensor, num_groups: int) -> torch.Tensor:
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
