"""Transformer building blocks of the dense decode path: norms, RoPE, GQA
decode attention against a KV cache, gated MLPs.

Port of the dense part of ``repro.lm.layers``, with the reference's layout
at every function (weights (d_in, d_out) applied as ``x @ w``, heads on the
second-to-last axis) so the parity tests compare like with like.  Params are
``nn.ParameterDict`` / ``nn.ModuleDict`` trees with the reference's key
names.  ``repro`` computes attention outside any Pallas kernel; so does the
port (plain tensor ops).  The full-sequence paths (``mha``, blockwise
attention, MLA, cross attention) wait for ROADMAP A12.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .embed import _normal

__all__ = ["AttnDims", "apply_norm", "attn_init", "dense_init", "mha_decode",
           "mlp", "mlp_init", "nonparametric_ln", "norm_init", "rmsnorm",
           "rope"]


def dense_init(d_in: int, d_out: int, **kw) -> nn.ParameterDict:
    """``{"w": (d_in, d_out)}`` at N(0, 1/d_in); ``kw`` = generator, device,
    dtype (``embed._normal``)."""
    return nn.ParameterDict({"w": _normal((d_in, d_out), 1.0 / math.sqrt(d_in),
                                          **kw)})


# ---------------------------------------------------------------- norms
def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def nonparametric_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: standardize, no scale/bias
    (population variance, as ``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_init(kind: str, d: int, *, generator=None, device=None,
              dtype=torch.float32) -> nn.ParameterDict:
    """RMSNorm's ``scale`` of ones (nothing is drawn from ``generator``), or
    no params (non-parametric)."""
    if kind == "rmsnorm":
        return nn.ParameterDict({"scale": nn.Parameter(
            torch.ones((d,), dtype=dtype, device=device))})
    if kind == "nonparametric":
        return nn.ParameterDict()
    raise ValueError(kind)


def apply_norm(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(params, x)
    if kind == "nonparametric":
        return nonparametric_ln(x)
    raise ValueError(kind)


# ---------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) rotated in halves (``x[..., :D/2]`` against
    ``x[..., D/2:]``, not interleaved); positions: (..., S).  Frequencies
    ``theta ** (-i / half)`` and the angles in float32, as the reference."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv: int
    d_head: int


def attn_init(d_model: int, dims: AttnDims, **kw) -> nn.ModuleDict:
    return nn.ModuleDict({
        "q": dense_init(d_model, dims.n_heads * dims.d_head, **kw),
        "k": dense_init(d_model, dims.n_kv * dims.d_head, **kw),
        "v": dense_init(d_model, dims.n_kv * dims.d_head, **kw),
        "o": dense_init(dims.n_heads * dims.d_head, d_model, **kw),
    })


def mha_decode(params, x: torch.Tensor, dims: AttnDims,
               cache_k: torch.Tensor, cache_v: torch.Tensor, cur_len: int,
               *, rope_theta: float = 10000.0) -> torch.Tensor:
    """One-token GQA decode against a KV cache (B, S_max, Hkv, D).

    Writes this token's k and v at position ``cur_len`` IN PLACE (the
    reference returns new caches; updating them saves a copy of the cache
    per layer and step) and returns the attention output (B, 1, d_model).
    Query head ``h·g + j`` reads KV head ``h``; scores and probabilities are
    float32 over the whole ``S_max`` with ``-inf`` past ``cur_len``.
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    if not 0 <= cur_len < s_max:
        raise ValueError(f"cache holds {s_max} positions; cannot write "
                         f"position {cur_len}")
    q = (x @ params["q"]["w"]).reshape(b, 1, dims.n_heads, dims.d_head)
    k = (x @ params["k"]["w"]).reshape(b, 1, dims.n_kv, dims.d_head)
    v = (x @ params["v"]["w"]).reshape(b, 1, dims.n_kv, dims.d_head)
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q = rope(q, pos, rope_theta)
    k = rope(k, pos, rope_theta)
    cache_k[:, cur_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cur_len] = v[:, 0].to(cache_v.dtype)
    g = dims.n_heads // dims.n_kv
    qr = q.reshape(b, dims.n_kv, g, dims.d_head)
    sc = torch.einsum("bhgd,bshd->bhgs", qr.float(), cache_k.float())
    sc = sc / math.sqrt(dims.d_head)
    valid = torch.arange(s_max, device=x.device) <= cur_len
    sc = sc.masked_fill(~valid, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float())
    out = out.reshape(b, 1, dims.n_heads * dims.d_head).to(x.dtype)
    return out @ params["o"]["w"]


# ---------------------------------------------------------------- MLP
def mlp_init(d_model: int, d_ff: int, gated: bool = True, **kw) -> nn.ModuleDict:
    p = nn.ModuleDict({"up": dense_init(d_model, d_ff, **kw)})
    if gated:
        p["gate"] = dense_init(d_model, d_ff, **kw)
    p["down"] = dense_init(d_ff, d_model, **kw)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ params["up"]["w"]
    if "gate" in params:
        g = x @ params["gate"]["w"]
        g = F.silu(g) if act == "silu" else _gelu(g)
        h = g * up
    else:
        h = _gelu(up)
    return h @ params["down"]["w"]
