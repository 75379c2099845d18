"""The hot/cold split gather as the LM calls it: one K2 launch.

Port of ``repro.kernels.gather_embed.ops``.  The reference serves hot ids
from the TPU kernel, cold ids from an XLA gather, and merges the two with
``where``; on the card the CUDA kernel does all three in one pass
(``hot_gather`` with ``cold``), reading int32 or int64 ids where they lie.
CPU tensors take the plain version.
"""
from __future__ import annotations

import torch

from .gather_embed import ID_DTYPES, hot_gather

__all__ = ["split_gather"]


def split_gather(hot: torch.Tensor, cold: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Rows of the logical table ``concat([hot, cold])`` for ``ids`` (T,),
    any integer dtype and stride; (T, D) in the tables' dtype.  int32 and
    int64 ids go to the kernel as they are; others are converted first."""
    if ids.dtype not in ID_DTYPES:
        ids = ids.to(torch.int32)
    return hot_gather(ids, hot, cold)
