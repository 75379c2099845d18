"""SpMV over the packed hot segment (kernel family K4): a hand-written CUDA
kernel.

Port of ``repro.kernels.pack_spmv.pack_spmv`` (the TPU kernel
``hot_spmv_pallas``).  One call per hot slot table computes
``y[r] = Σ_{c < deg[r]} x[idx[r, c]] (· w[r, c])``: the slot padding is
masked by the true degree, so the unweighted path reads the id plane alone,
at the width the packed storage keeps it (uint8, uint16 or uint32).  The
lane group is sized to the table's longest row (``max_deg``), and a table
whose rows pass 1,024 slots (the hub) is split into pieces of at most
``SEGMENT_LANES`` slots, a block each, folded per row in a second launch.

The kernel is ``csrc/pack_spmv.cu``, built with ``nvcc`` at first use
(``repro_torch.kernels._build``).  :func:`hot_spmv` launches it for CUDA
tensors and runs the plain PyTorch version (``ref.hot_spmv_ref``) for
tensors the caller put on the CPU; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .._wrap import SEGMENT_LANES, class_segments, launch_on, require, walk_group

__all__ = ["ID_DTYPES", "hot_spmv", "load_kernels"]

#: Id widths the kernel reads as stored.
ID_DTYPES = (torch.uint8, torch.uint16, torch.uint32)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "pack_spmv.cu"
_VARIANTS = {"all": []}
_KERNELS: Dict[str, ctypes._CFuncPtr] = {}


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = libs["all"].k4_hot_spmv
    fn.argtypes = [p, p, i32, p, p, p, i64, i64, p, p, i64, i64, i64, i32,
                   i64, p]
    fn.restype = ctypes.c_int
    _KERNELS["hot_spmv"] = fn


def load_kernels() -> Dict[str, ctypes._CFuncPtr]:
    """Build (first use) and bind the K4 library."""
    if not _KERNELS:
        from .._build import load_libraries

        _bind(load_libraries(_SOURCE, _VARIANTS))
    return _KERNELS


def hot_spmv(
    x: torch.Tensor,
    idx: torch.Tensor,
    deg: torch.Tensor,
    w: Optional[torch.Tensor] = None,
    *,
    max_deg: Optional[int] = None,
    segments: Optional[torch.Tensor] = None,
    row_tile: int = 64,
    width_tile: int = 128,
) -> torch.Tensor:
    """y (R,) = rowsum over valid slots of x[idx] (* w).

    The arguments of ``hot_spmv_pallas`` without ``interpret``: ``idx``
    (R, W) uint8, uint16 or uint32 with R % row_tile == 0 and
    W % width_tile == 0 (``ops.pack_spmv`` pads); padding slots are masked by
    ``deg`` (int32 (R,)), so their contents are never read.  ``x`` float32
    (V,); ``w`` float32 (R, W) or None.  Every valid id must be < V.

    ``max_deg`` (host int, the largest of ``deg``) sizes the lane group to
    the longest row walked; without it the width does.  A group of 256
    lanes (rows wider than 1,024 slots) splits its rows into pieces, a block
    each, and folds them in a second launch: ``segments`` (S, 3) int32, the
    table's ``row_segments(deg)``, cuts each row at every ``SEGMENT_LANES``
    of its degree.  A caller that passes none gets that list built here
    from ``deg`` (a copy to the host: set-up, not per-call work, so
    ``ops.pack_spmv`` passes its own).  These change how the kernel walks,
    not the function.

    CUDA tensors launch the K4 kernel (and count its launches in
    ``hot_spmv.launches``: one, or two for a 256-lane group); CPU tensors
    take the plain PyTorch version, which checks the same arguments.
    """
    r, width = idx.shape
    if r % row_tile or width % width_tile:
        raise ValueError(f"idx shape {tuple(idx.shape)} is not a multiple of "
                         f"the ({row_tile}, {width_tile}) tile")
    if x.device.type == "cpu":
        from .ref import hot_spmv_ref

        return hot_spmv_ref(x, idx, deg, w, max_deg=max_deg,
                            segments=segments)
    if x.device.type != "cuda":
        raise ValueError(f"hot_spmv runs on cuda or cpu, not {x.device}")
    dev = x.device
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise TypeError("x must be a contiguous float32 (V,) tensor")
    if idx.dtype not in ID_DTYPES:
        raise TypeError(f"idx must be uint8, uint16 or uint32, got {idx.dtype}")
    require(idx, "idx", idx.dtype, (r, width), dev)
    require(deg, "deg", torch.int32, (r,), dev)
    if w is not None:
        require(w, "w", torch.float32, (r, width), dev)
    if x.shape[0] == 0:
        raise ValueError("x is empty")
    walk, group = walk_group(width, max_deg, segments, dev)
    partial = None
    if group == 256:
        if segments is None:
            segments = class_segments(deg.cpu().numpy(), walk, dev)
        partial = torch.empty((segments.shape[0],), dtype=torch.float32,
                              device=dev)

    y = torch.empty((r,), dtype=torch.float32, device=dev)
    err = launch_on(dev, load_kernels()["hot_spmv"], x.data_ptr(),
                    idx.data_ptr(), idx.element_size(), deg.data_ptr(),
                    None if w is None else w.data_ptr(),
                    None if segments is None else segments.data_ptr(),
                    0 if segments is None else segments.shape[0],
                    SEGMENT_LANES,
                    None if partial is None else partial.data_ptr(),
                    y.data_ptr(), r, width, x.shape[0], group, walk)
    if err != 0:
        raise RuntimeError(f"K4 hot-SpMV launch failed: cudaError {err}")
    # a 256-lane group is two launches: the pieces' blocks, then the fold
    hot_spmv.launches += 2 if group == 256 else 1
    return y


hot_spmv.launches = 0
