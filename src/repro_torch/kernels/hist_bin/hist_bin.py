"""DBG degree binning + histogram (Listing 1, steps 1-2): a hand-written CUDA
kernel.

Port of ``repro.kernels.hist_bin.hist_bin`` (the TPU kernel
``hist_bin_pallas``).  One launch bins every vertex: ``groups[v]`` is the
first k with ``deg[v] >= bounds[k]`` (0 when none matches, the TPU kernel's
argmax of the >= mask), and ``hist[k]`` counts group k.  The CUDA kernel
takes any V, so the reference's padding to a tile (and the correction of the
last bin that undoes it) has no counterpart here.

The kernel is ``csrc/hist_bin.cu``, built with ``nvcc`` at first use
(``repro_torch.kernels._build``).  :func:`hist_bin` launches it for CUDA
tensors and runs the plain PyTorch version (``ref``) for tensors the caller
put on the CPU; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from .._wrap import require

__all__ = ["MAX_BINS", "hist_bin", "load_kernels"]

#: Most bounds the kernel keeps in shared memory (the paper's DBG uses 8).
MAX_BINS = 32

_SOURCE = Path(__file__).resolve().parent / "csrc" / "hist_bin.cu"
_VARIANTS = {"all": []}
_KERNELS: Dict[str, ctypes._CFuncPtr] = {}


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = libs["all"].hist_bin
    fn.argtypes = [p, p, i32, p, p, i64, p]
    fn.restype = ctypes.c_int
    _KERNELS["hist_bin"] = fn


def load_kernels() -> Dict[str, ctypes._CFuncPtr]:
    """Build (first use) and bind the hist_bin library."""
    if not _KERNELS:
        from .._build import load_libraries

        _bind(load_libraries(_SOURCE, _VARIANTS))
    return _KERNELS


def hist_bin(degrees: torch.Tensor,
             boundaries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(groups (V,) int32, histogram (K,) int32) of int32 ``degrees`` (V,)
    over int32 ``boundaries`` (K,), 1 <= K <= 32 (descending in DBG).

    CUDA tensors launch the kernel (and count one launch in
    ``hist_bin.launches``); CPU tensors take the plain PyTorch version.
    """
    if boundaries.dim() != 1 or not 1 <= boundaries.shape[0] <= MAX_BINS:
        raise ValueError(f"boundaries must be (K,) with 1 <= K <= {MAX_BINS}, "
                         f"got {tuple(boundaries.shape)}")
    if degrees.dim() != 1:
        raise ValueError(f"degrees must be (V,), got {tuple(degrees.shape)}")
    if degrees.device.type == "cpu":
        from .ref import hist_bin_ref

        return hist_bin_ref(degrees, boundaries)
    if degrees.device.type != "cuda":
        raise ValueError(f"hist_bin runs on cuda or cpu, not {degrees.device}")
    dev = degrees.device
    v, k = degrees.shape[0], boundaries.shape[0]
    if degrees.dtype != torch.int32 or not degrees.is_contiguous():
        raise TypeError("degrees must be a contiguous int32 (V,) tensor")
    require(boundaries, "boundaries", torch.int32, (k,), dev)

    groups = torch.empty((v,), dtype=torch.int32, device=dev)
    hist = torch.zeros((k,), dtype=torch.int32, device=dev)
    fn = load_kernels()["hist_bin"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(degrees.data_ptr(), boundaries.data_ptr(), k,
                 groups.data_ptr(), hist.data_ptr(), v, stream)
    if err != 0:
        raise RuntimeError(f"hist_bin launch failed: cudaError {err}")
    hist_bin.launches += 1
    return groups, hist


hist_bin.launches = 0
