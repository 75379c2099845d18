"""The absorbed MLA decode attention over a latent cache: a hand-written CUDA
kernel (``csrc/mla_decode.cu``), and its plain version on the CPU.

One call attends every sequence's new token over that sequence's own rows
of the latent cache, for every head at once: the kernel reads each row
once, splits long caches over the SMs and combines the slices (two
launches from one C entry).  It replaces no TPU kernel (the JAX package
re-expands the cache outside any kernel; see the source's notes).

The kernel takes up to 16 heads, in bf16 (the tensor cores) at DeepSeek-V2's
latent widths, a latent row of 512 and a rope key of 64, or in float32 (a
variant on the CUDA cores, for the port's float32 models) at a latent row
of up to 512 (a multiple of 4) and a rope key of up to 64; anything else
raises.  CUDA tensors launch it (one count in ``latent_attention.launches``
per call); CPU tensors take the plain version (``ref``).  It never falls
back from one to the other.  Built with ``nvcc`` at first use
(``repro_torch.kernels._build``).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch

from .._wrap import launch_on, require

__all__ = ["HEADS", "LATENT", "ROPE", "TILE", "latent_attention",
           "load_kernels", "slice_rows"]

HEADS, LATENT, ROPE = 16, 512, 64  # the kernel's widths (the most heads)
TILE = 64  # cache rows per tile: a slice is a whole number of tiles

_SOURCE = Path(__file__).resolve().parent / "csrc" / "mla_decode.cu"
_VARIANTS = {"all": []}  # one library: both entries
_KERNELS: Dict[torch.dtype, ctypes._CFuncPtr] = {}
_SMS: Dict[int, int] = {}


#: the C entry of each cache dtype the kernel takes
_ENTRIES = {torch.bfloat16: "mla_decode_attend",
            torch.float32: "mla_decode_attend_f32"}


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for dtype, name in _ENTRIES.items():
        fn = getattr(libs["all"], name)
        fn.argtypes = [p, i64, i64, p, i64, i64, p, p, i64, p, i32, i32,
                       i32, i32, ctypes.c_float, i32, i32, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _KERNELS[dtype] = fn


def load_kernels() -> Dict[torch.dtype, ctypes._CFuncPtr]:
    """Build (first use) and bind the kernel's library."""
    if not _KERNELS:
        from .._build import load_libraries

        _bind(load_libraries(_SOURCE, _VARIANTS))
    return _KERNELS


def slice_rows(total_rows: int, sms: int) -> int:
    """Rows per slice: the batch's rows over four slices per SM, in whole
    tiles, at least four tiles (a slice reads its rows in one block)."""
    per = -(-max(1, total_rows) // (4 * sms))
    return max(4 * TILE, -(-per // TILE) * TILE)


def _sms(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def latent_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     cache_latent: torch.Tensor, cache_krope: torch.Tensor,
                     rows: torch.Tensor, scale: float, max_rows: int,
                     total_rows: int) -> torch.Tensor:
    """``o[b, h] = sum_t softmax_t(s[b, h, t]) cache_latent[b, t]`` over
    each sequence's first ``rows[b]`` rows, ``s = (q_lat[b, h] .
    latent[b, t] + q_rope[b, h] . krope[b, t]) * scale``.

    ``q_lat`` (B, H, C) and ``q_rope`` (B, H, R), any strides with the
    last dim contiguous; ``cache_latent`` (B, S, C) and ``cache_krope``
    (B, S, R), contiguous; ``rows`` (B,) int64 on their device, each in
    ``[1, S]``, ``max_rows`` their largest and ``total_rows`` their sum
    (host ints: the grid is sized from them, and nothing is read back).
    On the card: all bf16 (C 512, R 64) or all float32 (C up to 512, a
    multiple of 4; R up to 64) in, (B, H, C) of that dtype out.  On the
    CPU: any float dtype, float32 out (``ref.latent_attention_ref``)."""
    b, h, c = q_lat.shape
    dev = cache_latent.device
    s_max = cache_latent.shape[1]
    r = cache_krope.shape[-1]
    if tuple(q_rope.shape) != (b, h, r):
        raise ValueError(f"q_rope must have shape {(b, h, r)}, got "
                         f"{tuple(q_rope.shape)}")
    if tuple(cache_latent.shape) != (b, s_max, c) or tuple(
            cache_krope.shape) != (b, s_max, r):
        raise ValueError(f"caches must be {(b, s_max, c)} and "
                         f"{(b, s_max, r)}, got {tuple(cache_latent.shape)} "
                         f"and {tuple(cache_krope.shape)}")
    if not 1 <= max_rows <= s_max:
        raise ValueError(f"max_rows {max_rows} outside [1, {s_max}]")
    if dev.type == "cpu":
        from .ref import latent_attention_ref

        return latent_attention_ref(q_lat, q_rope, cache_latent, cache_krope,
                                    rows, scale, max_rows)
    if dev.type != "cuda":
        raise ValueError(f"latent_attention runs on cuda or cpu, not {dev}")
    dt = cache_latent.dtype
    if dt not in _ENTRIES:
        raise TypeError(f"the kernel takes a bfloat16 or float32 cache, got "
                        f"{dt}")
    if not 1 <= h <= HEADS:
        raise ValueError(f"the kernel takes 1 to {HEADS} heads; got {h}")
    if dt == torch.bfloat16 and (c != LATENT or r != ROPE):
        raise ValueError(f"over bf16 the kernel takes a latent of {LATENT} "
                         f"and a rope key of {ROPE}; got {c} and {r}")
    if not (4 <= c <= LATENT and c % 4 == 0 and 0 <= r <= ROPE):
        raise ValueError(f"the kernel takes a latent of up to {LATENT} (a "
                         f"multiple of 4) and a rope key of up to {ROPE}; "
                         f"got {c} and {r}")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name} must be {dt} on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    require(cache_latent, "cache_latent", dt, (b, s_max, c), dev)
    require(cache_krope, "cache_krope", dt, (b, s_max, r), dev)
    require(rows, "rows", torch.int64, (b,), dev)
    chunk = slice_rows(total_rows, _sms(dev))
    splits = -(-max_rows // chunk)
    o_part = torch.empty((b, splits, HEADS, LATENT), dtype=torch.float32,
                         device=dev)
    ml = torch.empty((2, b, splits, HEADS), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, c), dtype=dt, device=dev)
    fn = (_KERNELS or load_kernels())[dt]
    err = launch_on(dev, fn, q_lat.data_ptr(), q_lat.stride(0),
                    q_lat.stride(1), q_rope.data_ptr(), q_rope.stride(0),
                    q_rope.stride(1), cache_latent.data_ptr(),
                    cache_krope.data_ptr(), s_max, rows.data_ptr(), b, h, c,
                    r, float(scale) * math.log2(math.e), chunk, splits,
                    o_part.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr(),
                    out.data_ptr())
    if err != 0:
        raise RuntimeError(f"mla_decode launch failed: cudaError {err}")
    latent_attention.launches += 1
    return out


latent_attention.launches = 0
