"""Degree-binned ELL SpMV (kernel family K1): a hand-written CUDA kernel.

Port of ``repro.kernels.csr_spmv.csr_spmv`` (the TPU kernel
``ell_spmv_pallas``).  One launch per DBG group computes the TPU kernel's
``y[r] = Σ_c x[idx[r, c]] · w[r, c]`` over ALL lanes of the group's padded
ELL planes, where padding is id 0 with weight 0 (so a non-finite ``x[0]``
reaches every padded row, as on the TPU).

What bounds it is bytes, and the padded planes are ~20x the edges of a
DBG-binned RMAT graph.  So :func:`ell_spmv` takes the packer's degree vector
(``deg``): the kernel then reads only lanes ``c < deg[r]`` and adds the one
term ``x[0] · 0`` to each row with padding, which has the value of all its
padding terms (NaN included).  Without ``deg`` it reads every lane.  The
hub group's longest rows would set its time, so rows wider than 1,024
lanes are split across blocks (``segments``) and folded in a second launch.

The kernel is ``csrc/csr_spmv.cu``, built with ``nvcc`` at first use
(``repro_torch.kernels._build``).  :func:`ell_spmv` launches it for CUDA
tensors and runs the plain PyTorch version (``ref.ell_spmv_ref``) for
tensors the caller put on the CPU; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .._wrap import SEGMENT_LANES, require, split_scratch_rows, walk_group

__all__ = ["ell_spmv", "load_kernels"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "csr_spmv.cu"
_VARIANTS = {"all": []}
_KERNELS: Dict[str, ctypes._CFuncPtr] = {}


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = libs["all"].k1_ell_spmv
    fn.argtypes = [p, p, p, p, p, i64, i64, p, p, i64, i64, i64, i32, i64, p]
    fn.restype = ctypes.c_int
    _KERNELS["ell_spmv"] = fn


def load_kernels() -> Dict[str, ctypes._CFuncPtr]:
    """Build (first use) and bind the K1 library."""
    if not _KERNELS:
        from .._build import load_libraries

        _bind(load_libraries(_SOURCE, _VARIANTS))
    return _KERNELS


def ell_spmv(
    x: torch.Tensor,
    idx: torch.Tensor,
    w: torch.Tensor,
    *,
    deg: Optional[torch.Tensor] = None,
    max_deg: Optional[int] = None,
    segments: Optional[torch.Tensor] = None,
    row_tile: int = 256,
    width_tile: int = 512,
) -> torch.Tensor:
    """y (R,) = rowsum(x[idx] * w) over every lane.

    The arguments of ``ell_spmv_pallas`` without ``interpret``: ``idx`` int32
    and ``w`` float32, both (R, W) with R % row_tile == 0 and
    W % width_tile == 0 (``ops.ell_pack_groups`` pads); ``x`` float32 (V,).
    Every id, padding included, must be < V.  ``deg``, int32 (R,), is each
    row's true degree: lanes >= deg must be (0, 0.0), which
    ``ell_pack_groups`` guarantees; they are then not read.  ``max_deg``
    (host int, the largest of ``deg``) sizes the lane group to the longest
    row walked; without it the width does.  A group of 256 lanes (rows
    wider than 1,024) splits its rows into pieces, a block each, and folds
    them in a second launch: ``segments`` (S, 3) int32, the group's
    ``row_segments(deg)``, cuts each row at every ``SEGMENT_LANES`` of its
    degree; without it each row's width is cut at the same points.  These
    change how the kernel walks, not the function.

    CUDA tensors launch the K1 kernel (and count its launches in
    ``ell_spmv.launches``: one, or two for a 256-lane group); CPU tensors
    take the plain PyTorch version.
    """
    r, width = idx.shape
    if r % row_tile or width % width_tile:
        raise ValueError(f"idx shape {tuple(idx.shape)} is not a multiple of "
                         f"the ({row_tile}, {width_tile}) tile")
    if x.device.type == "cpu":
        from .ref import ell_spmv_ref

        return ell_spmv_ref(x, idx, w, deg=deg)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu, not {x.device}")
    dev = x.device
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise TypeError("x must be a contiguous float32 (V,) tensor")
    require(idx, "idx", torch.int32, (r, width), dev)
    require(w, "w", torch.float32, (r, width), dev)
    if deg is not None:
        require(deg, "deg", torch.int32, (r,), dev)
    elif segments is not None:
        raise ValueError("segments cut the rows' degrees: pass deg")
    walk, group = walk_group(width, None if deg is None else max_deg,
                             segments, dev)
    partial = None
    if group == 256:
        partial = torch.empty((split_scratch_rows(segments, r, width),),
                              dtype=torch.float32, device=dev)
    if x.shape[0] == 0:
        raise ValueError("x is empty")

    y = torch.empty((r,), dtype=torch.float32, device=dev)
    fn = load_kernels()["ell_spmv"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), idx.data_ptr(), w.data_ptr(),
                 None if deg is None else deg.data_ptr(),
                 None if segments is None else segments.data_ptr(),
                 0 if segments is None else segments.shape[0], SEGMENT_LANES,
                 None if partial is None else partial.data_ptr(),
                 y.data_ptr(), r, width, x.shape[0], group, walk, stream)
    if err != 0:
        raise RuntimeError(f"K1 ELL-SpMV launch failed: cudaError {err}")
    # a 256-lane group is two launches: the pieces' blocks, then the fold
    ell_spmv.launches += 2 if group == 256 else 1
    return y


ell_spmv.launches = 0
