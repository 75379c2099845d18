"""The hot/cold split gather as the LM calls it: one K2 launch, and its
gradient.

Port of ``repro.kernels.gather_embed.ops``.  The reference serves hot ids
from the TPU kernel, cold ids from an XLA gather, and merges the two with
``where``; on the card the CUDA kernel does all three in one pass
(``hot_gather`` with ``cold``), reading int32 or int64 ids where they lie.
CPU tensors take the plain version.

:func:`gather_rows` is the differentiable entry the LM uses.  Its forward
is exactly one ``hot_gather`` call (one K2 launch on the card, the plain
version on the CPU); its backward (:func:`gather_backward`) is plain
PyTorch, the same code on both devices, as the reference's gradient is
XLA's scatter-add of its indexing.  It is deterministic: the ids are sorted
stably and each table row's run of gradients is summed in float32 by
``torch.segment_reduce``, one segment per row (empty rows give zeros), then
cast once; no float atomics, no host synchronisation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .gather_embed import ID_DTYPES, hot_gather

__all__ = ["gather_backward", "gather_rows", "split_gather"]


def gather_backward(ids: torch.Tensor, grad: torch.Tensor, hot_rows: int,
                    cold_rows: int, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradients of ``hot`` (H, D) and, when ``cold_rows`` > 0, of
    ``cold`` (C, D), in ``dtype``, for ``grad`` (T, D), the gradient of
    ``hot_gather(ids, hot[, cold])``.  Each id's row goes to the row the
    forward read: ids below 0 to row 0; with a cold table ids at or past
    H + C to its last row; without one, ids at or past H read a zero row
    and send nothing."""
    h, c = hot_rows, cold_rows
    n = h + c  # rows that take gradient; segment n collects the rest
    r = ids.reshape(-1).long().clamp(min=0)
    r = r.clamp(max=n - 1) if c else torch.where(r < h, r, n)
    rs, order = torch.sort(r, stable=True)
    bounds = torch.searchsorted(
        rs, torch.arange(n + 2, dtype=rs.dtype, device=rs.device))
    sums = torch.segment_reduce(grad[order].float(), "sum",
                                lengths=bounds.diff(), axis=0, unsafe=True)
    full = sums[:n].to(dtype)
    return full[:h], (full[h:] if c else None)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, hot, cold):
        ctx.save_for_backward(ids)
        ctx.rows = (hot.shape[0], 0 if cold is None else cold.shape[0])
        return hot_gather(ids, hot, cold)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        g_hot, g_cold = gather_backward(ids, grad, *ctx.rows, grad.dtype)
        return None, g_hot, g_cold


def gather_rows(ids: torch.Tensor, hot: torch.Tensor,
                cold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``hot_gather(ids, hot, cold)`` with a gradient for ``hot`` and
    ``cold``: one K2 launch forward on the card, :func:`gather_backward`
    backward."""
    return _GatherRows.apply(ids, hot, cold)


def split_gather(hot: torch.Tensor, cold: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Rows of the logical table ``concat([hot, cold])`` for ``ids`` (T,),
    any integer dtype and stride; (T, D) in the tables' dtype,
    differentiable in both tables.  int32 and int64 ids go to the kernel as
    they are; others are converted first."""
    if ids.dtype not in ID_DTYPES:
        ids = ids.to(torch.int32)
    return gather_rows(ids, hot, cold)
