"""K2, the hot/cold split embedding gather: a hand-written CUDA kernel.

Port of ``repro.kernels.gather_embed.gather_embed`` (the TPU kernel
``hot_gather_pallas``) together with the merge in its ``ops.split_gather``.
One wrapper, :func:`hot_gather`, drives both entry points of
``csrc/gather_embed.cu``:

* ``hot_gather(ids, hot)`` — the TPU kernel's function: ``out[t] =
  hot[ids[t]]`` for ``ids[t] < H``, a zero row for any larger id;
* ``hot_gather(ids, hot, cold)`` — the whole split gather in one pass:
  ``hot[id]`` for ``id < H``, else ``cold[id - H]``, where an id at or
  above ``H + C`` reads the last cold row (the reference's XLA gather clamps
  the same way).

Ids below 0 are outside the contract; kernel and plain version clamp them to
0, so no id makes the kernel read outside a table.  Ids are int32 or int64,
in any 1-D layout: the kernel reads them through their stride, so a lookup
is one launch even for a strided column of a prompt.  The kernel takes any
T, so the reference's token tile and its padding have no counterpart here.

The kernel is built with ``nvcc`` at first use (``repro_torch.kernels._build``),
one library per element type (float32, bfloat16).  CUDA tensors launch it
(one count in ``hot_gather.launches`` per launch); CPU tensors take the plain
PyTorch version (``ref``).  It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .._wrap import launch_on, require

__all__ = ["ID_DTYPES", "hot_gather", "load_kernels"]

#: Id types the kernel reads as they are.
ID_DTYPES = (torch.int32, torch.int64)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "gather_embed.cu"
_VARIANTS = {"f32": ["-DK2_ELEM_BYTES=4"], "bf16": ["-DK2_ELEM_BYTES=2"]}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_KERNELS: Dict[tuple, ctypes._CFuncPtr] = {}


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, lib in libs.items():
        hot, split = lib.hot_gather, lib.split_gather
        hot.argtypes = [p, i32, i64, p, i64, i64, p, i64, p]
        split.argtypes = [p, i32, i64, p, i64, p, i64, i64, p, i64, p]
        hot.restype = split.restype = ctypes.c_int
        _KERNELS[False, name], _KERNELS[True, name] = hot, split


def load_kernels() -> Dict[tuple, ctypes._CFuncPtr]:
    """Build (first use) and bind both K2 libraries: ``(split, "f32" or
    "bf16")`` → C entry."""
    if not _KERNELS:
        from .._build import load_libraries

        _bind(load_libraries(_SOURCE, _VARIANTS))
    return _KERNELS


def hot_gather(ids: torch.Tensor, hot: torch.Tensor,
               cold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, D) rows for int32 or int64 ``ids`` (T,), any stride, from ``hot``
    (H, D), and from ``cold`` (C >= 1, D) when given; float32 or bfloat16
    tables, contiguous.

    Without ``cold`` an id >= H gives a zero row; with it, an id >= H reads
    ``cold[min(id - H, C - 1)]``.  Ids below 0 read row 0.
    """
    if hot.dim() != 2 or hot.dtype not in _DTYPES:
        raise TypeError(f"hot must be a (H, D) float32 or bfloat16 tensor, "
                        f"got {tuple(hot.shape)} {hot.dtype}")
    if ids.dtype not in ID_DTYPES:
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if ids.dim() != 1:
        raise ValueError(f"ids must have shape (T,), got {tuple(ids.shape)}")
    dev = hot.device
    if ids.device != dev:
        raise ValueError(f"ids is on {ids.device}, hot on {dev}")
    h, d = hot.shape
    if not hot.is_contiguous():
        raise ValueError("hot must be contiguous")
    if cold is not None:
        if cold.dim() != 2 or cold.shape[0] < 1:
            raise ValueError(f"cold must be (C, D) with C >= 1, got "
                             f"{tuple(cold.shape)}")
        require(cold, "cold", hot.dtype, (cold.shape[0], d), dev)
    if dev.type == "cpu":
        from .ref import hot_gather_ref, split_gather_ref

        return (hot_gather_ref(ids, hot) if cold is None
                else split_gather_ref(hot, cold, ids))
    if dev.type != "cuda":
        raise ValueError(f"hot_gather runs on cuda or cpu, not {dev}")

    t = ids.shape[0]
    out = torch.empty((t, d), dtype=hot.dtype, device=dev)
    fn = (_KERNELS or load_kernels())[cold is not None, _DTYPES[hot.dtype]]
    if cold is None:
        err = launch_on(dev, fn, ids.data_ptr(), ids.element_size(),
                        ids.stride(0), hot.data_ptr(), h, d, out.data_ptr(),
                        t)
    else:
        err = launch_on(dev, fn, ids.data_ptr(), ids.element_size(),
                        ids.stride(0), hot.data_ptr(), h, cold.data_ptr(),
                        cold.shape[0], d, out.data_ptr(), t)
    if err != 0:
        raise RuntimeError(f"hot_gather launch failed: cudaError {err}")
    hot_gather.launches += 1
    return out


hot_gather.launches = 0
