"""Transformer building blocks: norms, RoPE (plain and YaRN), full-sequence
causal GQA attention (flash-style blockwise, optionally sliding-window), the
encoder's unmasked blockwise attention, cross attention, GQA decode attention
against a KV cache, DeepSeek-V2's MLA (full sequence, and the absorbed decode
over the latent cache), gated MLPs.

Port of ``repro.lm.layers``, with the reference's layout at every function
(weights (d_in, d_out) applied as ``x @ w``, heads on the second-to-last
axis) so the parity tests compare like with like.  Params are
``nn.ParameterDict`` / ``nn.ModuleDict`` trees with the reference's key
names.  ``repro`` computes attention outside any Pallas kernel; so does the
port (plain tensor ops, no library attention: the parity bands are set
against the reference's own step-by-step arithmetic), except MLA's decode,
whose attention over the latent cache on the card (bf16 or float32) is a
kernel of its own (``kernels.mla_decode``).  Decode writes its caches in place, at one
position for the whole batch or at each sequence's own (:class:`DecodeAt`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dist.constrain import (axis_size, constrain, full, is_sharded,
                              replicate, reshape)
from ..kernels.mla_decode import latent_attention, latent_attention_ref
from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from .embed import _normal

__all__ = ["AttnDims", "DecodeAt", "MlaDims", "Yarn", "apply_norm",
           "apply_rope", "attn_init", "cross_attn", "dense_init", "mha",
           "mha_bidir", "mha_decode", "mla", "mla_decode", "mla_init", "mlp",
           "mlp_init", "nonparametric_ln", "norm_init", "rmsnorm", "rope",
           "rope_angles", "rope_inv_freq", "yarn_mscale"]


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
@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN rope scaling as DeepSeek-V2's modelling code applies it: the
    frequencies blended between ``1/θ^(2i/d)`` and that over ``factor`` by
    a linear ramp over the correction range that ``beta_fast`` and
    ``beta_slow`` give at ``original_max_pos``; cos and sin scaled by
    ``yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)``;
    the softmax scale by ``yarn_mscale(factor, mscale_all_dim)²``."""
    factor: float
    mscale: float
    mscale_all_dim: float
    original_max_pos: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0

    @property
    def cos_sin_scale(self) -> float:
        return (yarn_mscale(self.factor, self.mscale)
                / yarn_mscale(self.factor, self.mscale_all_dim))

    @property
    def softmax_mscale(self) -> float:
        """The factor on the softmax scale (1 without ``mscale_all_dim``)."""
        if not self.mscale_all_dim:
            return 1.0
        return yarn_mscale(self.factor, self.mscale_all_dim) ** 2


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """``0.1 · mscale · ln(scale) + 1``, and 1 for a scale of at most 1."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_inv_freq(d: int, theta: float = 10000.0, yarn: Optional[Yarn] = None,
                  device=None) -> torch.Tensor:
    """(d/2,) float32 rotation frequencies: ``theta ** (-i / half)``, and
    with ``yarn`` those blended with the same over ``yarn.factor``."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=device) / half)
    if yarn is None:
        return freqs

    def corr_dim(rotations: float) -> float:
        return (d * math.log(yarn.original_max_pos / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(corr_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(corr_dim(yarn.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1: the unscaled frequency; 0: the scaled one
    return freqs / yarn.factor * (1.0 - keep) + freqs * keep


def rope_angles(positions: torch.Tensor, d: int, theta: float = 10000.0,
                yarn: Optional[Yarn] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (..., S, 1, d/2) float32 of ``positions`` (..., S): the
    angles in float32, as the reference."""
    freqs = rope_inv_freq(d, theta, yarn, positions.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    if yarn is not None and yarn.cos_sin_scale != 1.0:
        cos, sin = cos * yarn.cos_sin_scale, sin * yarn.cos_sin_scale
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) rotated in halves (``x[..., :D/2]`` against
    ``x[..., D/2:]``, not interleaved) by ``rope_angles``' cos and sin."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0, yarn: Optional[Yarn] = None) -> torch.Tensor:
    """x: (..., S, H, D) rotated in halves (``x[..., :D/2]`` against
    ``x[..., D/2:]``, not interleaved); positions: (..., S).  Frequencies
    ``theta ** (-i / half)`` (YaRN-blended with ``yarn``) and the angles in
    float32, as the reference."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta, yarn))


class DecodeAt:
    """Where one decode step writes, per sequence: ``lens`` (B,) host ints,
    each sequence's position of this token (its length before the step),
    and ``positions``, the same on the device (int64).  A batch whose
    sequences all stand at one position is ``uniform``: its layers write at
    that position with a slice, as a scalar length does.  The rope angles
    of a step are made once and shared by its layers (``angles``).

    A ``fixed`` step is one a CUDA graph records and replays at other
    lengths (``serve.DecodeGraph``): nothing the host lengths decide may
    shape its launches, so it is never ``uniform`` (writes and masks go
    through the device positions) and the MLA kernel's grid covers the
    cache's whole room."""

    def __init__(self, lens: np.ndarray, positions: torch.Tensor,
                 fixed: bool = False):
        self.lens = np.asarray(lens, dtype=np.int64)
        self.positions = positions
        self.fixed = fixed
        self.uniform = not fixed and bool(self.lens.min() == self.lens.max())
        self._angles: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def of(cls, at: Union[int, "DecodeAt"], b: int, device) -> "DecodeAt":
        """``at`` itself, or every one of ``b`` sequences at position
        ``at``."""
        if isinstance(at, DecodeAt):
            return at
        return cls(np.full(b, int(at), dtype=np.int64),
                   torch.full((b,), int(at), dtype=torch.int64,
                              device=device))

    @property
    def position(self) -> int:
        """The batch's one position (a uniform batch only)."""
        if not self.uniform:
            raise ValueError("the batch's sequences stand at different "
                             "positions")
        return int(self.lens[0])

    def check(self, s_max: int) -> None:
        """Raise unless a linear cache of ``s_max`` positions takes every
        sequence's position."""
        _check_position(s_max, int(self.lens.min()))
        _check_position(s_max, int(self.lens.max()))

    def angles(self, d: int, theta: float, yarn: Optional[Yarn] = None):
        """``rope_angles`` (B, 1, 1, d/2) at the positions, once a step."""
        key = (d, theta, yarn)
        if key not in self._angles:
            self._angles[key] = rope_angles(self.positions[:, None], d,
                                            theta, yarn)
        return self._angles[key]

    def write(self, cache: torch.Tensor, rows: torch.Tensor) -> None:
        """``cache[b, position_b] = rows[b]`` IN PLACE (rows: (B, ...))."""
        if self.uniform:
            cache[:, self.position] = rows.to(cache.dtype)
        else:
            cache[self._batch, self.positions] = rows.to(cache.dtype)

    @functools.cached_property
    def _batch(self) -> torch.Tensor:
        return torch.arange(self.lens.shape[0], device=self.positions.device)

    @functools.cached_property
    def rows(self) -> torch.Tensor:
        """(B,) int64 on the device: the rows each sequence reads (its
        position + 1), made once a step."""
        return self.positions + 1

    def valid(self, s_max: int, device) -> torch.Tensor:
        """(B, S_max) bool: the rows each sequence reads, its position
        included."""
        t = torch.arange(s_max, device=device)
        if self.uniform:
            return (t <= self.position)[None, :]
        return t[None, :] <= self.positions[:, None]


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
                           window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Flash-style blockwise causal attention, O(S · block) memory.

    q: (B, S, H, D); k, v: (B, S, Hkv, D), H = G · Hkv (query head
    ``h·G + j`` reads KV head ``h``).  S must be a multiple of both blocks.
    The reference's arithmetic step by step: scores in the inputs' dtype,
    the running max, sum and accumulator in float32, the ``isfinite``
    guards; ``window`` masks keys at or past that distance; ``scale`` on
    the scores, ``1/sqrt(D)`` by default.  A key block
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
    scale = 1.0 / math.sqrt(d) if scale is None else scale
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
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               cur_len: Union[int, DecodeAt], *,
               rope_theta: float = 10000.0) -> torch.Tensor:
    """One-token GQA decode against a KV cache (B, S_max, Hkv, D).

    Writes this token's k and v at position ``cur_len`` (an int for the
    whole batch, or a :class:`DecodeAt`, each sequence at its own) IN PLACE
    (the reference returns new caches; updating them saves a copy of the
    cache per layer and step) and returns the attention output (B, 1,
    d_model).  Query head ``h·g + j`` reads KV head ``h``; scores and
    probabilities are float32 over the whole ``S_max`` with ``-inf`` past
    each sequence's position.
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    at = DecodeAt.of(cur_len, b, x.device)
    at.check(s_max)
    q = reshape(x @ params["q"]["w"], b, 1, dims.n_heads, dims.d_head)
    k = reshape(x @ params["k"]["w"], b, 1, dims.n_kv, dims.d_head)
    v = reshape(x @ params["v"]["w"], b, 1, dims.n_kv, dims.d_head)
    cos, sin = at.angles(dims.d_head, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    at.write(cache_k, k[:, 0])
    at.write(cache_v, v[:, 0])
    g = dims.n_heads // dims.n_kv
    qr = reshape(q, b, dims.n_kv, g, dims.d_head)
    sc = torch.einsum("bhgd,bshd->bhgs", qr.float(), cache_k.float())
    sc = sc / math.sqrt(dims.d_head)
    valid = at.valid(s_max, x.device)[:, None, None, :]
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
    """DeepSeek-V2's multi-head latent attention: ``latent_norm`` RMS-norms
    the latent before ``k_up`` / ``v_up`` (the published model's
    ``kv_a_layernorm``), ``yarn`` scales the rope (and the softmax)."""
    n_heads: int
    kv_lora: int  # latent width (512 for V2-Lite)
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    latent_norm: bool = False
    yarn: Optional[Yarn] = None

    @property
    def scale(self) -> float:
        """The softmax scale: ``1 / sqrt(d_nope + d_rope)``, times YaRN's
        ``mscale``² where it sets one."""
        mscale = 1.0 if self.yarn is None else self.yarn.softmax_mscale
        return mscale / math.sqrt(self.d_nope + self.d_rope)


def mla_init(d_model: int, dims: MlaDims, **kw) -> nn.ModuleDict:
    h = dims.n_heads
    p = nn.ModuleDict({
        "q": dense_init(d_model, h * (dims.d_nope + dims.d_rope), **kw),
        "kv_down": dense_init(d_model, dims.kv_lora, **kw),
        "k_rope": dense_init(d_model, dims.d_rope, **kw),
        "k_up": dense_init(dims.kv_lora, h * dims.d_nope, **kw),
        "v_up": dense_init(dims.kv_lora, h * dims.d_v, **kw),
        "o": dense_init(h * dims.d_v, d_model, **kw),
    })
    if dims.latent_norm:
        p["kv_norm"] = norm_init("rmsnorm", dims.kv_lora,
                                 device=kw.get("device"),
                                 dtype=kw.get("dtype", torch.float32))
    return p


def _latent(params, x: torch.Tensor, dims: MlaDims) -> torch.Tensor:
    """The latent of ``x`` as ``k_up`` / ``v_up`` (and the cache) take it."""
    latent = x @ params["kv_down"]["w"]
    return rmsnorm(params["kv_norm"], latent) if dims.latent_norm else latent


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
    cos, sin = rope_angles(positions, dims.d_rope, rope_theta, dims.yarn)
    q_full = torch.cat([q_nope, apply_rope(q_rope, cos, sin)], dim=-1)
    latent = _latent(params, x, dims)  # (B, S, kv_lora)
    k_rope = apply_rope((x @ params["k_rope"]["w"])[:, :, None, :], cos, sin)
    k_nope = reshape(latent @ params["k_up"]["w"], b, s, h, dims.d_nope)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dims.d_rope)], dim=-1)
    v = reshape(latent @ params["v_up"]["w"], b, s, h, dims.d_v)
    out = _blockwise_causal_attn(q_full, k_full, v, block_q=min(block_q, s),
                                 block_k=min(block_k, s), scale=dims.scale)
    return reshape(out, b, s, -1) @ params["o"]["w"]


def mla_decode(params, x: torch.Tensor, dims: MlaDims,
               cache_latent: torch.Tensor, cache_krope: torch.Tensor,
               cur_len: Union[int, DecodeAt], *,
               rope_theta: float = 10000.0) -> torch.Tensor:
    """One-token MLA decode against the latent cache (B, S_max, kv_lora) +
    (B, S_max, d_rope), written IN PLACE at ``cur_len`` (an int for the
    whole batch, or a :class:`DecodeAt`, each sequence at its own).

    Absorbed: ``k_up`` is folded into the query (per head, ``d_nope`` →
    ``kv_lora``), the attention runs over the latent and rotated-key rows
    ``[0, position_b]`` of each sequence, and ``v_up`` is folded into its
    (B, H, kv_lora) output.  On the card that attention is one call of
    the ``kernels.mla_decode`` kernel, which takes a bf16 or a float32
    cache (any other raises); on the CPU the same equations in plain ops
    (``latent_attention_ref``, float32 scores over chunks of rows, no
    float32 copy of the cache).  Scores scaled by
    ``dims.scale``.  Counts the rows read
    (``lm.mla_decode.cache_rows``) and the kernel's calls
    (``lm.mla_decode.launches``) in the registry, in an
    ``lm.mla_decode`` span; counts nothing while a CUDA graph captures it.
    A ``fixed`` step sizes the kernel's grid by the cache's room."""
    b = x.shape[0]
    h = dims.n_heads
    s_max = cache_latent.shape[1]
    at = DecodeAt.of(cur_len, b, x.device)
    at.check(s_max)
    with obs_trace.span("lm.mla_decode"):
        q = reshape(x @ params["q"]["w"], b, 1, h, dims.d_nope + dims.d_rope)
        q_nope, q_rope = q[:, 0, :, :dims.d_nope], q[..., dims.d_nope:]
        cos, sin = at.angles(dims.d_rope, rope_theta, dims.yarn)
        q_rope = apply_rope(q_rope, cos, sin)[:, 0]  # (B, H, d_rope)
        latent_t = _latent(params, x, dims)  # (B, 1, kv_lora)
        krope_t = apply_rope((x @ params["k_rope"]["w"])[:, :, None, :], cos,
                             sin)[:, :, 0]
        at.write(cache_latent, latent_t[:, 0])
        at.write(cache_krope, krope_t[:, 0])
        w_uk = reshape(params["k_up"]["w"], dims.kv_lora, h, dims.d_nope)
        w_uv = reshape(params["v_up"]["w"], dims.kv_lora, h, dims.d_v)
        dt = torch.promote_types(q_nope.dtype, w_uk.dtype)
        q_lat = torch.einsum("bhd,chd->bhc", q_nope.to(dt), w_uk.to(dt))
        rows = at.lens + 1
        max_rows, total_rows = int(rows.max()), int(rows.sum())
        kernel = cache_latent.is_cuda
        if kernel:
            dt = cache_latent.dtype
            o_lat = latent_attention(q_lat.to(dt), q_rope.to(dt),
                                     cache_latent, cache_krope, at.rows,
                                     dims.scale,
                                     s_max if at.fixed else max_rows,
                                     total_rows)
        else:
            o_lat = latent_attention_ref(q_lat, q_rope, cache_latent,
                                         cache_krope, at.rows, dims.scale,
                                         max_rows)
        dt = torch.promote_types(o_lat.dtype, w_uv.dtype)
        out = torch.einsum("bhc,chd->bhd", o_lat.to(dt), w_uv.to(dt))
        out = reshape(out, b, 1, h * dims.d_v).to(x.dtype) @ params["o"]["w"]
    if kernel and torch.cuda.is_current_stream_capturing():
        return out  # a capture runs nothing: DecodeGraph counts each replay
    reg = get_registry()  # looked up per call: reset_registry swaps it
    reg.counter("lm.mla_decode.cache_rows").inc(total_rows)
    if kernel:
        reg.counter("lm.mla_decode.launches").inc()
    return out


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
