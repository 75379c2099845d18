"""Transformer building blocks: norms, RoPE, full-sequence causal GQA
attention (flash-style blockwise, optionally sliding-window), the encoder's
unmasked blockwise attention, cross attention, GQA decode attention against
a KV cache, DeepSeek-V2's MLA (full sequence and latent-cache decode),
gated MLPs.

Port of ``repro.lm.layers``, with the reference's layout at every function
(weights (d_in, d_out) applied as ``x @ w``, heads on the second-to-last
axis) so the parity tests compare like with like.  Params are
``nn.ParameterDict`` / ``nn.ModuleDict`` trees with the reference's key
names.  ``repro`` computes attention outside any Pallas kernel; so does the
port (plain tensor ops, no library attention: the parity bands are set
against the reference's own step-by-step arithmetic).  Decode writes its
caches in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.constrain import (axis_size, constrain, full, is_sharded,
                              replicate, reshape)
from .embed import _normal

__all__ = ["AttnDims", "MlaDims", "apply_norm", "attn_init", "cross_attn",
           "dense_init", "mha", "mha_bidir", "mha_decode", "mla", "mla_decode",
           "mla_init", "mlp", "mlp_init", "nonparametric_ln", "norm_init",
           "rmsnorm", "rope"]


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
def _constrain_qkv(q, k, v, n_heads: int):
    """Head-sharded when the model axis divides ``n_heads``; otherwise
    sequence-sharded q with k and v replicated (the reference's choice:
    padding an indivisible head axis costs collectives per block).  No-ops
    off a mesh."""
    hs = axis_size("model")
    if hs and n_heads % hs == 0:
        q = constrain(q, "batch", None, "model", None)
        k = constrain(k, "batch", None, "model", None)  # drops if kv % hs
        v = constrain(v, "batch", None, "model", None)
    else:
        q = constrain(q, "batch", "seq", None, None)
        k = constrain(k, "batch", None, None, None)
        v = constrain(v, "batch", None, None, None)
    return q, k, v


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


def _expand_kv(q, k, v):
    """On a mesh, where q's head dim is split over ranks and GQA groups G
    query heads on a KV head, k and v repeated to one head per query head
    and split as q is: DTensor cannot unflatten a head dim split 16 ways
    into (Hkv, G) when 16 does not divide Hkv.  Each query head reads the
    same KV head's values either way.  (q, k, v) unchanged otherwise."""
    from torch.distributed.tensor import Shard

    h, hkv = q.shape[2], k.shape[2]
    if h == hkv or not is_sharded(q) or not any(
            isinstance(p, Shard) and p.dim == 2 and n > 1
            for p, n in zip(q.placements, q.device_mesh.shape)):
        return q, k, v
    g = h // hkv

    def rep(t):
        b, s, _, d = t.shape
        t = replicate(t, (2,))[:, :, :, None].expand(b, s, hkv, g, d)
        t = t.reshape(b, s, h, d)
        return t.redistribute(q.device_mesh, q.placements)

    return q, rep(k), rep(v)


def _blockwise_causal_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, block_q: int, block_k: int,
                           window: Optional[int] = None) -> torch.Tensor:
    """Flash-style blockwise causal attention, O(S · block) memory.

    q: (B, S, H, D); k, v: (B, S, Hkv, D), H = G · Hkv (query head
    ``h·G + j`` reads KV head ``h``).  S must be a multiple of both blocks.
    The reference's arithmetic step by step: scores in the inputs' dtype,
    the running max, sum and accumulator in float32, the ``isfinite``
    guards; ``window`` masks keys at or past that distance.  A key block
    that every query of the block masks is skipped: its update is the
    identity (``p`` is 0, ``alpha`` 1, or 0 on rows that have seen no key
    yet), so the result is the one the reference's full scan gives.
    """
    q, k, v = _expand_kv(q, k, v)
    b, s, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = h // hkv
    if s % block_q or s % block_k:
        raise ValueError(f"sequence {s} is not a multiple of the blocks "
                         f"({block_q}, {block_k})")
    scale = 1.0 / math.sqrt(d)
    outs = []
    for qi in range(s // block_q):
        q0 = qi * block_q
        qr = reshape(q[:, q0:q0 + block_q], b, block_q, hkv, g, d)
        qpos = torch.arange(q0, q0 + block_q, device=q.device)
        m = full(q, (b, block_q, h), float("-inf"), torch.float32)
        l = full(q, (b, block_q, h), 0.0, torch.float32)
        acc = full(q, (b, block_q, h, dv), 0.0, torch.float32)
        for ki in range(s // block_k):
            k0 = ki * block_k
            if k0 > q0 + block_q - 1:  # every key after every query
                break
            if window is not None and q0 - (k0 + block_k - 1) >= window:
                continue  # every key out of every query's window
            kr = k[:, k0:k0 + block_k]
            vr = v[:, k0:k0 + block_k]
            sc = torch.einsum("bqhgd,bkhd->bqhgk", qr, kr) * scale
            sc = sc.reshape(b, block_q, h, block_k)
            kpos = torch.arange(k0, k0 + block_k, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            sc = torch.where(mask[None, :, None, :], sc, float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            p = torch.where(torch.isfinite(m_new)[..., None], p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
            l = l * alpha + p.sum(dim=-1)
            pr = p.reshape(b, block_q, hkv, g, block_k)
            delta = torch.einsum("bqhgk,bkhd->bqhgd", pr, vr.float())
            acc = acc * alpha[..., None] + delta.reshape(b, block_q, h, dv)
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def mha(params, x: torch.Tensor, dims: AttnDims, *, positions: torch.Tensor,
        rope_theta: float = 10000.0, window: Optional[int] = None,
        block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Full-sequence causal (optionally sliding-window) GQA attention:
    (B, S, d_model) → (B, S, d_model), blocks of ``min(512, S)``."""
    b, s, _ = x.shape
    q = reshape(x @ params["q"]["w"], b, s, dims.n_heads, dims.d_head)
    k = reshape(x @ params["k"]["w"], b, s, dims.n_kv, dims.d_head)
    v = reshape(x @ params["v"]["w"], b, s, dims.n_kv, dims.d_head)
    q, k, v = _constrain_qkv(q, k, v, dims.n_heads)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    out = _blockwise_causal_attn(q, k, v, block_q=min(block_q, s),
                                 block_k=min(block_k, s), window=window)
    return reshape(out, b, s, -1) @ params["o"]["w"]


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
    _check_position(s_max, cur_len)
    q = reshape(x @ params["q"]["w"], b, 1, dims.n_heads, dims.d_head)
    k = reshape(x @ params["k"]["w"], b, 1, dims.n_kv, dims.d_head)
    v = reshape(x @ params["v"]["w"], b, 1, dims.n_kv, dims.d_head)
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q = rope(q, pos, rope_theta)
    k = rope(k, pos, rope_theta)
    cache_k[:, cur_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cur_len] = v[:, 0].to(cache_v.dtype)
    g = dims.n_heads // dims.n_kv
    qr = reshape(q, b, dims.n_kv, g, dims.d_head)
    sc = torch.einsum("bhgd,bshd->bhgs", qr.float(), cache_k.float())
    sc = sc / math.sqrt(dims.d_head)
    valid = torch.arange(s_max, device=x.device) <= cur_len
    sc = sc.masked_fill(~valid, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, cache_v.float())
    out = reshape(out, b, 1, dims.n_heads * dims.d_head).to(x.dtype)
    return out @ params["o"]["w"]


def _check_position(s_max: int, cur_len: int) -> None:
    """A linear cache of ``s_max`` positions takes position ``cur_len``, or
    raises (the reference's cache write clamps an out-of-range position)."""
    if not 0 <= cur_len < s_max:
        raise ValueError(f"cache holds {s_max} positions; cannot write "
                         f"position {cur_len}")


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two, as JAX promotes a
    bfloat16 cache against float32 weights (torch's matmul does not)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _blockwise_attn_nomask(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, block_q: int, block_k: int) -> torch.Tensor:
    """Unmasked blockwise softmax attention (the encoder's): the reference's
    online softmax without masks or ``isfinite`` guards.  q: (B, S, H, D);
    k, v: (B, S, Hkv, D); S a multiple of both blocks."""
    q, k, v = _expand_kv(q, k, v)
    b, s, h, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = h // hkv
    if s % block_q or s % block_k:
        raise ValueError(f"sequence {s} is not a multiple of the blocks "
                         f"({block_q}, {block_k})")
    scale = 1.0 / math.sqrt(d)
    outs = []
    for q0 in range(0, s, block_q):
        qr = reshape(q[:, q0:q0 + block_q], b, block_q, hkv, g, d)
        m = full(q, (b, block_q, h), float("-inf"), torch.float32)
        l = full(q, (b, block_q, h), 0.0, torch.float32)
        acc = full(q, (b, block_q, h, dv), 0.0, torch.float32)
        for k0 in range(0, s, block_k):
            sc = torch.einsum("bqhgd,bkhd->bqhgk", qr,
                              k[:, k0:k0 + block_k]) * scale
            sc = sc.reshape(b, block_q, h, block_k)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pr = p.reshape(b, block_q, hkv, g, block_k)
            delta = torch.einsum("bqhgk,bkhd->bqhgd", pr,
                                 v[:, k0:k0 + block_k].float())
            acc = acc * alpha[..., None] + delta.reshape(b, block_q, h, dv)
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def mha_bidir(params, x: torch.Tensor, dims: AttnDims, *,
              positions: torch.Tensor, rope_theta: float = 10000.0,
              block: int = 512) -> torch.Tensor:
    """Bidirectional (encoder) attention, blockwise over keys in blocks of
    ``min(block, S)``: (B, S, d_model) → (B, S, d_model)."""
    b, s, _ = x.shape
    q = reshape(x @ params["q"]["w"], b, s, dims.n_heads, dims.d_head)
    k = reshape(x @ params["k"]["w"], b, s, dims.n_kv, dims.d_head)
    v = reshape(x @ params["v"]["w"], b, s, dims.n_kv, dims.d_head)
    q, k, v = _constrain_qkv(q, k, v, dims.n_heads)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    bq = min(block, s)
    out = _blockwise_attn_nomask(q, k, v, block_q=bq, block_k=bq)
    return reshape(out, b, s, -1) @ params["o"]["w"]


def cross_attn(params, x: torch.Tensor, memory: torch.Tensor,
               dims: AttnDims) -> torch.Tensor:
    """Encoder-decoder cross attention: queries from ``x`` (B, S, d_model),
    keys and values from ``memory`` (B, S_mem, d_model), a full softmax
    over the memory, no positions."""
    b, s, _ = x.shape
    sm = memory.shape[1]
    q = reshape(x @ params["q"]["w"], b, s, dims.n_heads, dims.d_head)
    k = reshape(memory @ params["k"]["w"], b, sm, dims.n_kv, dims.d_head)
    v = reshape(memory @ params["v"]["w"], b, sm, dims.n_kv, dims.d_head)
    g = dims.n_heads // dims.n_kv
    qr = reshape(q, b, s, dims.n_kv, g, dims.d_head)
    sc = torch.einsum("bqhgd,bkhd->bqhgk", qr, k) / math.sqrt(dims.d_head)
    p = torch.softmax(sc, dim=-1)
    out = reshape(torch.einsum("bqhgk,bkhd->bqhgd", p, v), b, s, -1)
    return out.to(x.dtype) @ params["o"]["w"]


# ---------------------------------------------------------------- MLA
@dataclasses.dataclass(frozen=True)
class MlaDims:
    """DeepSeek-V2's multi-head latent attention."""
    n_heads: int
    kv_lora: int  # latent width (512 for V2-Lite)
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


def mla_init(d_model: int, dims: MlaDims, **kw) -> nn.ModuleDict:
    h = dims.n_heads
    return nn.ModuleDict({
        "q": dense_init(d_model, h * (dims.d_nope + dims.d_rope), **kw),
        "kv_down": dense_init(d_model, dims.kv_lora, **kw),
        "k_rope": dense_init(d_model, dims.d_rope, **kw),
        "k_up": dense_init(dims.kv_lora, h * dims.d_nope, **kw),
        "v_up": dense_init(dims.kv_lora, h * dims.d_v, **kw),
        "o": dense_init(h * dims.d_v, d_model, **kw),
    })


def mla(params, x: torch.Tensor, dims: MlaDims, *, positions: torch.Tensor,
        rope_theta: float = 10000.0, block_q: int = 512,
        block_k: int = 512) -> torch.Tensor:
    """Full-sequence causal MLA through the blockwise causal attention: keys
    ``[k_nope | k_rope]`` (one rotated ``k_rope`` head broadcast to every
    head) of head dim ``d_nope + d_rope``, values of ``d_v`` decompressed
    from the latent."""
    b, s, _ = x.shape
    h = dims.n_heads
    q = reshape(x @ params["q"]["w"], b, s, h, dims.d_nope + dims.d_rope)
    q_nope, q_rope = q[..., :dims.d_nope], q[..., dims.d_nope:]
    q_full = torch.cat([q_nope, rope(q_rope, positions, rope_theta)], dim=-1)
    latent = x @ params["kv_down"]["w"]  # (B, S, kv_lora)
    k_rope = rope((x @ params["k_rope"]["w"])[:, :, None, :], positions,
                  rope_theta)
    k_nope = reshape(latent @ params["k_up"]["w"], b, s, h, dims.d_nope)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dims.d_rope)], dim=-1)
    v = reshape(latent @ params["v_up"]["w"], b, s, h, dims.d_v)
    out = _blockwise_causal_attn(q_full, k_full, v, block_q=min(block_q, s),
                                 block_k=min(block_k, s))
    return reshape(out, b, s, -1) @ params["o"]["w"]


def mla_decode(params, x: torch.Tensor, dims: MlaDims,
               cache_latent: torch.Tensor, cache_krope: torch.Tensor,
               cur_len: int, *, rope_theta: float = 10000.0) -> torch.Tensor:
    """One-token MLA decode against the latent cache (B, S_max, kv_lora) +
    (B, S_max, d_rope), written at ``cur_len`` IN PLACE.  Every step
    decompresses the whole latent cache into keys and values, as the
    reference does; scores in float32 over ``S_max``, ``-inf`` past
    ``cur_len``, scaled by ``sqrt(d_nope + d_rope)``."""
    b = x.shape[0]
    h = dims.n_heads
    s_max = cache_latent.shape[1]
    _check_position(s_max, cur_len)
    q = reshape(x @ params["q"]["w"], b, 1, h, dims.d_nope + dims.d_rope)
    q_nope, q_rope = q[..., :dims.d_nope], q[..., dims.d_nope:]
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=x.device)
    q_rope = rope(q_rope, pos, rope_theta)
    latent_t = x @ params["kv_down"]["w"]  # (B, 1, kv_lora)
    krope_t = rope((x @ params["k_rope"]["w"])[:, :, None, :], pos,
                   rope_theta)[:, :, 0]
    cache_latent[:, cur_len] = latent_t[:, 0].to(cache_latent.dtype)
    cache_krope[:, cur_len] = krope_t[:, 0].to(cache_krope.dtype)
    k_nope = reshape(_mm(cache_latent, params["k_up"]["w"]), b, s_max, h,
                     dims.d_nope)
    v = reshape(_mm(cache_latent, params["v_up"]["w"]), b, s_max, h,
                dims.d_v)
    sc = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
    sc = sc + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                           cache_krope.float())
    sc = sc / math.sqrt(dims.d_nope + dims.d_rope)
    valid = torch.arange(s_max, device=x.device) <= cur_len
    sc = sc.masked_fill(~valid, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return reshape(out, b, 1, -1).to(x.dtype) @ params["o"]["w"]


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
