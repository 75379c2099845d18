"""DeepSeek-V2 as its published modelling code computes it, in plain float32
PyTorch: the reference of the ``deepseek-v2-lite`` configuration.

Follows ``modeling_deepseek.py`` of the published model (DeepSeek-V2,
arXiv:2405.04434): ``DeepseekV2RMSNorm``, ``DeepseekV2YarnRotaryEmbedding``
and ``yarn_get_mscale``, ``DeepseekV2Attention`` without q compression and
UNABSORBED (every head's keys and values expanded from the latent rows by
``kv_b_proj``), ``MoEGate`` (greedy top-k of a float32 softmax,
renormalised only with ``norm_topk_prob``, else times
``routed_scaling_factor``), ``DeepseekV2MoE`` with its shared experts and
``DeepseekV2MLP`` for the first ``first_k_dense_replace`` layers.  Every
value and sum is float32; the weights are upcast where they are used.  It
imports nothing of the program and runs no kernel of it; the caller turns
TF32 off (``full_float32``).

Layout, not arithmetic, departs from the published code:

* the weights are the tensors the benchmark loads into the program, under
  the program's names (``Weights``): ``kv_a_proj_with_mqa`` is the two
  matrices ``mix.kv_down`` and ``mix.k_rope``, ``kv_b_proj`` the two
  ``mix.k_up`` and ``mix.v_up``, ``kv_a_layernorm`` is ``mix.kv_norm``;
  matrices are (in, out), applied as ``x @ w``; the embedding table is the
  rows of ``embed.hot`` then ``embed.cold``;
* the rope dims are rotated in halves (``x[:32]`` against ``x[32:]``).
  The published code de-interleaves its rope dims before the same
  rotation: a fixed permutation of the columns of ``q``'s rope part and of
  ``k_rope``, which random weights do not see.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Published", "Weights", "full_float32", "yarn_get_mscale",
           "yarn_inv_freq", "softmax_scale", "new_rows", "attention",
           "forward", "decode"]


@dataclasses.dataclass(frozen=True)
class Published:
    """The keys of the published ``config.json`` the equations read."""

    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    first_k_dense_replace: int
    n_routed_experts: int
    num_experts_per_tok: int
    norm_topk_prob: bool
    routed_scaling_factor: float
    rms_norm_eps: float
    rope_theta: float
    rope_scaling: dict
    vocab_size: int

    @classmethod
    def of(cls, config: dict) -> "Published":
        return cls(**{f.name: config[f.name]
                      for f in dataclasses.fields(cls)})


class Weights:
    """The model's tensors by the program's names, read as float32."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.tensors = tensors

    def __call__(self, name: str) -> torch.Tensor:
        return self.tensors[name].float()

    def expert(self, layer: int, which: str, e: int) -> torch.Tensor:
        return self.tensors[f"layers.{layer}.chan.{which}"][e].float()

    def embed_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        hot = self.tensors["embed.hot"]
        cold = self.tensors.get("embed.cold")
        table = hot if cold is None else torch.cat([hot, cold])
        return table[tokens.long()].float()


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products in float32, not TF32, inside."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


# ---------------------------------------------------------------- rope
def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: Published, device=None) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s frequencies (d/2,)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    rs = cfg.rope_scaling
    exponents = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=device) / dim
    freq_extra = 1.0 / (base ** exponents)
    freq_inter = 1.0 / (rs["factor"] * base ** exponents)

    def correction_dim(rotations):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def _cos_sin(cfg: Published, positions: torch.Tensor):
    rs = cfg.rope_scaling
    mscale = (yarn_get_mscale(rs["factor"], rs["mscale"])
              / yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]))
    freqs = positions.float()[:, None] * yarn_inv_freq(cfg, positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., T, d) at cos/sin (T, d): ``x cos + rotate_half(x) sin``."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def softmax_scale(cfg: Published) -> float:
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    rs = cfg.rope_scaling
    if rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


# ---------------------------------------------------------------- layers
def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def new_rows(w: Weights, i: int, cfg: Published, h: torch.Tensor,
             positions: torch.Tensor):
    """The latent (T, kv_lora) after ``kv_a_layernorm`` and the rotated
    rope key (T, d_rope) of tokens ``h`` (T, d) at ``positions``: the rows
    the cache keeps."""
    p = f"layers.{i}.mix."
    latent = _rms_norm(h @ w(p + "kv_down.w"), w(p + "kv_norm.scale"),
                       cfg.rms_norm_eps)
    cos, sin = _cos_sin(cfg, positions)
    return latent, _rotate(h @ w(p + "k_rope.w"), cos, sin)


def attention(w: Weights, i: int, cfg: Published, h: torch.Tensor,
              positions: torch.Tensor, latent: torch.Tensor,
              krope: torch.Tensor) -> torch.Tensor:
    """Tokens ``h`` (T, d) at ``positions`` attend key rows ``latent``
    (S, kv_lora) and ``krope`` (S, d_rope); query t reads rows
    ``[0, positions[t]]``.  Unabsorbed: K and V of every head expanded."""
    p = f"layers.{i}.mix."
    nh, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim, cfg.v_head_dim)
    t, s = h.shape[0], latent.shape[0]
    q = (h @ w(p + "q.w")).view(t, nh, dn + dr).transpose(0, 1)
    cos, sin = _cos_sin(cfg, positions)
    q = torch.cat([q[..., :dn], _rotate(q[..., dn:], cos, sin)], dim=-1)
    k_nope = (latent @ w(p + "k_up.w")).view(s, nh, dn).transpose(0, 1)
    v = (latent @ w(p + "v_up.w")).view(s, nh, dv).transpose(0, 1)
    k = torch.cat([k_nope, krope[None].expand(nh, s, dr)], dim=-1)
    scores = (q @ k.transpose(1, 2)) * softmax_scale(cfg)  # (H, T, S)
    keys = torch.arange(s, device=h.device)
    visible = keys[None, :] <= positions[:, None]
    scores = scores.masked_fill(~visible[None], float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v  # (H, T, dv)
    return out.transpose(0, 1).reshape(t, nh * dv) @ w(p + "o.w")


def _mlp(h, gate, up, down):
    return (F.silu(h @ gate) * (h @ up)) @ down


def _moe(w: Weights, i: int, cfg: Published, h: torch.Tensor,
         routers: Optional[list] = None):
    p = f"layers.{i}.chan."
    logits = h @ w(p + "router.w")
    if routers is not None:  # one token: its top-k margin and spread
        k = cfg.num_experts_per_tok
        top = logits[0].topk(k + 1).values
        routers.append((i, float(top[k - 1] - top[k]), float(logits.std())))
    scores = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    if cfg.num_experts_per_tok > 1 and cfg.norm_topk_prob:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    else:
        top_w = top_w * cfg.routed_scaling_factor
    out = _mlp(h, w(p + "shared.gate.w"), w(p + "shared.up.w"),
               w(p + "shared.down.w"))
    routed = torch.zeros_like(out)
    for e in torch.unique(top_e).tolist():
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        y = _mlp(h[tok], w.expert(i, "gate", e), w.expert(i, "up", e),
                 w.expert(i, "down", e))
        routed.index_add_(0, tok, y * top_w[tok, slot, None])
    return out + routed


def _channel(w: Weights, i: int, cfg: Published, x: torch.Tensor,
             routers: Optional[list] = None):
    h = _rms_norm(x, w(f"layers.{i}.norm2.scale"), cfg.rms_norm_eps)
    if i < cfg.first_k_dense_replace:
        p = f"layers.{i}.chan."
        return x + _mlp(h, w(p + "gate.w"), w(p + "up.w"), w(p + "down.w"))
    return x + _moe(w, i, cfg, h, routers)


def _logits(w: Weights, cfg: Published, x: torch.Tensor) -> torch.Tensor:
    h = _rms_norm(x, w("final_norm.scale"), cfg.rms_norm_eps)
    return h @ w("embed.unembed")[:, :cfg.vocab_size]


# ---------------------------------------------------------------- model
def forward(w: Weights, cfg: Published, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, vocab) of ``tokens`` (B, S), causal, from position 0."""
    out = []
    for row in tokens:
        positions = torch.arange(row.shape[0], device=row.device)
        x = w.embed_rows(row)
        for i in range(cfg.num_hidden_layers):
            h = _rms_norm(x, w(f"layers.{i}.norm1.scale"), cfg.rms_norm_eps)
            latent, krope = new_rows(w, i, cfg, h, positions)
            x = x + attention(w, i, cfg, h, positions, latent, krope)
            x = _channel(w, i, cfg, x)
        out.append(_logits(w, cfg, x))
    return torch.stack(out)


def decode(w: Weights, cfg: Published, token: int, position: int,
           history: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
           device, routers: Optional[list] = None
           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One token at ``position`` over a cache: ``history(i)`` gives layer
    i's rows ``[0, position)``, the latent (position, kv_lora) and the
    rotated rope key (position, d_rope), in any float dtype.  Returns the
    logits (vocab,) and, per layer, the row the token adds to the cache
    (kv_lora + d_rope,).  ``routers``, where given, gets one ``(layer,
    margin, spread)`` per MoE layer: the router logit of its k-th choice
    less that of the first expert left out, and the standard deviation of
    its logits."""
    positions = torch.tensor([position], device=device)
    x = w.embed_rows(torch.tensor([token], device=device))
    rows = []
    for i in range(cfg.num_hidden_layers):
        h = _rms_norm(x, w(f"layers.{i}.norm1.scale"), cfg.rms_norm_eps)
        latent, krope = new_rows(w, i, cfg, h, positions)
        rows.append(torch.cat([latent[0], krope[0]]))
        old_latent, old_krope = history(i)
        x = x + attention(
            w, i, cfg, h, positions,
            torch.cat([old_latent.float(), latent]),
            torch.cat([old_krope.float(), krope]))
        x = _channel(w, i, cfg, x, routers)
    return _logits(w, cfg, x)[0], rows
