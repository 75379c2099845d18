"""What the port's kernel wrappers share: the checks before a launch, the
lane-group rule, the row split of the wide groups, and the launch on the
current stream."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["SEGMENT_LANES", "class_segments", "lanes_per_row", "launch_on",
           "require", "row_segments", "split_scratch_rows", "walk_group"]

#: Lanes of a row that one block of a wide group (K5, K1, K4) walks at most:
#: longer rows are split across blocks (``row_segments``).
SEGMENT_LANES = 4096


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
    """Lanes that share one row in the K5, K4 and K1 kernels: the smallest
    of 8 / 16 / 32 that covers a narrow row, a whole 256-thread block for
    rows wider than 1,024 lanes."""
    if width <= 8:
        return 8
    if width <= 16:
        return 16
    return 32 if width <= 1024 else 256


def walk_group(width: int, max_deg: Optional[int],
               segments: Optional[torch.Tensor], device) -> Tuple[int, int]:
    """``(walk, group)`` of a degree-masked row walk (K4, K1): the longest
    row walked, ``max_deg`` clipped to ``[1, width]`` (the width without
    it), and its lane group.  ``segments``, when given, must be an (S, 3)
    int32 list on ``device`` and the group must be 256 lanes: only rows
    wider than 1,024 lanes are split."""
    walk = width if max_deg is None else max(1, min(int(max_deg), width))
    group = lanes_per_row(walk)
    if segments is not None:
        if group < 256:
            raise ValueError(f"{walk} lanes per row is narrow: segments "
                             "split only rows wider than 1,024 lanes")
        require(segments, "segments", torch.int32,
                (segments.shape[0] if segments.dim() else 0, 3), device)
    return walk, group


def launch_on(device, fn, *args) -> int:
    """``fn(*args, stream)``: a kernel's C entry launched on the current
    raw stream of ``device``, a CUDA device.  ``device`` is made the
    current device only when it is not already, so the common call costs
    two queries and no context switch."""
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def row_segments(deg, chunk: int = SEGMENT_LANES) -> np.ndarray:
    """(S, 3) int32 ``(row, lane_begin, lane_end)``: each row's lanes
    ``[0, deg[r])`` cut in order at every ``chunk`` lanes, rows in order; a
    row of degree 0 keeps one empty segment, so every row has a first
    segment (``lane_begin == 0``).  ``deg`` is a host array."""
    deg = np.maximum(np.asarray(deg, dtype=np.int64), 0)
    n = np.maximum(1, -(-deg // chunk))
    row = np.repeat(np.arange(deg.shape[0], dtype=np.int64), n)
    first = np.repeat(np.cumsum(n) - n, n)
    lo = (np.arange(row.shape[0], dtype=np.int64) - first) * chunk
    hi = np.minimum(lo + chunk, deg[row])
    return np.stack([row, lo, hi], axis=1).astype(np.int32)


def split_scratch_rows(segments, rows: int, width: int) -> int:
    """Partials K1's split of a wide group writes: one per segment of the
    list, or, with none, one per ``SEGMENT_LANES`` piece of every row's
    width."""
    if segments is not None:
        return int(segments.shape[0])
    return rows * -(-width // SEGMENT_LANES)


def class_segments(deg: np.ndarray, width: int,
                   device) -> Optional[torch.Tensor]:
    """The segment list of a group whose rows (padding rows included) have
    host degrees ``deg`` and walk ``width`` lanes at most: ``row_segments``
    on ``device`` when the group takes 256 lanes per row, else ``None``.
    Built once with the planes: set-up, not per-call work."""
    if lanes_per_row(width) < 256:
        return None
    return torch.from_numpy(row_segments(deg)).to(device)
