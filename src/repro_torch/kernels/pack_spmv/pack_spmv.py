"""SpMV over the packed hot segment (kernel family K4): a hand-written CUDA
kernel.

Port of ``repro.kernels.pack_spmv.pack_spmv`` (the TPU kernel
``hot_spmv_pallas``).  One launch per hot slot table computes
``y[r] = Σ_{c < deg[r]} x[idx[r, c]] (· w[r, c])``: the slot padding is
masked by the true degree, so the unweighted path reads the id plane alone,
at the width the packed storage keeps it (uint8, uint16 or uint32).

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

from .._wrap import lanes_per_row, require

__all__ = ["ID_DTYPES", "hot_spmv", "load_kernels"]

#: Id widths the kernel reads as stored.
ID_DTYPES = (torch.uint8, torch.uint16, torch.uint32)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "pack_spmv.cu"
_VARIANTS = {"all": []}
_KERNELS: Dict[str, ctypes._CFuncPtr] = {}


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = libs["all"].k4_hot_spmv
    fn.argtypes = [p, p, i32, p, p, p, i64, i64, i64, i32, p]
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
    row_tile: int = 64,
    width_tile: int = 128,
) -> torch.Tensor:
    """y (R,) = rowsum over valid slots of x[idx] (* w).

    The arguments of ``hot_spmv_pallas`` without ``interpret``: ``idx``
    (R, W) uint8, uint16 or uint32 with R % row_tile == 0 and
    W % width_tile == 0 (``ops.pack_spmv`` pads); padding slots are masked by
    ``deg`` (int32 (R,)), so their contents are never read.  ``x`` float32
    (V,); ``w`` float32 (R, W) or None.  Every valid id must be < V.

    CUDA tensors launch the K4 kernel (and count one launch in
    ``hot_spmv.launches``); CPU tensors take the plain PyTorch version.
    """
    r, width = idx.shape
    if r % row_tile or width % width_tile:
        raise ValueError(f"idx shape {tuple(idx.shape)} is not a multiple of "
                         f"the ({row_tile}, {width_tile}) tile")
    if x.device.type == "cpu":
        from .ref import hot_spmv_ref

        return hot_spmv_ref(x, idx, deg, w)
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

    y = torch.empty((r,), dtype=torch.float32, device=dev)
    fn = load_kernels()["hot_spmv"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), idx.data_ptr(), idx.element_size(),
                 deg.data_ptr(), None if w is None else w.data_ptr(),
                 y.data_ptr(), r, width, x.shape[0], lanes_per_row(width),
                 stream)
    if err != 0:
        raise RuntimeError(f"K4 hot-SpMV launch failed: cudaError {err}")
    hot_spmv.launches += 1
    return y


hot_spmv.launches = 0
