"""int8 error-feedback gradient compression.

Port of ``repro.train.compress``: per-tensor int8 quantization, the
error-feedback residual (Seide et al.; Karimireddy et al.: the quantization
error is added back into the next step's gradient before quantizing) and
the compressed mean over ranks.  The reference's ``compressed_psum`` runs
inside ``shard_map``; :func:`compressed_all_reduce` is its counterpart on a
``torch.distributed`` group (gloo or NCCL): an all-reduce MAX of the scale,
an int32 SUM of the int8 payload, divided by the group's size.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

__all__ = ["compressed_all_reduce", "dequantize_int8", "ef_compress_grads",
           "quantize_int8"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, float32 scale) with ``scale = max|x| / 127 + 1e-12``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` with an int8 payload:
    every rank quantizes against the largest scale of the group, the
    payloads sum in int32 (no overflow below 2^24 ranks), and the sum is
    rescaled once.  Every rank returns the same tensor."""
    n = dist.get_world_size(group)
    smax = x.abs().max() / 127.0 + 1e-12
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x / smax), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * smax / n


def ef_compress_grads(grads: Dict[str, torch.Tensor],
                      residual: Dict[str, torch.Tensor]
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """Error feedback by name: ``g' = Q(g + r)`` in ``g``'s dtype and
    ``r' = (g + r) - Q(g + r)`` in float32, for every name of ``grads``."""
    out, res = {}, {}
    for name, g in grads.items():
        corrected = g.float() + residual[name]
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        out[name] = deq.to(g.dtype)
        res[name] = corrected - deq
    return out, res
