"""What every kernel wrapper of the port checks before a launch."""
from __future__ import annotations

import torch

__all__ = ["lanes_per_row", "require"]


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is contiguous:
    a kernel reads raw pointers and takes nothing else."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lanes_per_row(width: int) -> int:
    """Lanes that share one row in the K4 / K1 SpMV kernels: the smallest of
    8 / 16 / 32 that covers a narrow row, a whole 256-thread block for rows
    wider than 1,024 lanes."""
    if width <= 8:
        return 8
    if width <= 16:
        return 16
    return 32 if width <= 1024 else 256
