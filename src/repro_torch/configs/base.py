"""Architecture config schema + the input-shape cells assigned to this paper.

Every architecture is a composition of per-layer blocks: a token MIXER
('attn' | 'local' | 'mla' | 'rglru' | 'ssd' | 'none') and a channel MIXER
('mlp' | 'moe' | 'none'), repeated in a PATTERN (hybrids interleave).  The
reference's model (repro.lm.model) scans over pattern periods; the
port's (repro_torch.lm.model) keeps one block per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    norm: str = "rmsnorm"  # rmsnorm | nonparametric
    act: str = "silu"
    rope_theta: float = 10000.0

    # layer pattern: tuple of (mixer, channel) repeated; () -> uniform
    pattern: Tuple[Tuple[str, str], ...] = ()

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # MLA
    kv_lora: int = 0
    mla_d_nope: int = 128
    mla_d_rope: int = 64
    mla_d_v: int = 128

    # recurrent / ssm
    window: int = 2048  # local attention window
    ssm_state: int = 128
    ssm_d_head: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # enc-dec (audio) / vlm stubs
    n_enc_layers: int = 0
    prefix_len: int = 0  # vlm: number of (stub) patch-embedding positions

    # DBG vocabulary split (paper integration K2); 0 disables
    hot_vocab_rows: int = 8192

    # training
    remat: bool = True
    seq_parallel: bool = False  # Megatron-SP: shard the residual stream on S

    sub_quadratic: bool = False  # True → long_500k cell applies

    # Options of a published config that the JAX package's reading lacks;
    # their defaults are that reading (the parity tests hold every preset of
    # the JAX package at them).  ``d_ff`` is the dense layers' width,
    # ``moe_d_ff`` the experts'.
    first_dense_layers: int = 0  # leading layers whose channel is a dense MLP
    moe_norm_topk: bool = True  # renormalise the top-k probabilities to sum 1
    moe_drop_free: bool = False  # expert panels hold every slot: nothing drops
    mla_latent_norm: bool = False  # RMSNorm on the latent before k_up / v_up
    yarn_factor: float = 0.0  # YaRN rope scaling factor; 0: plain rope
    yarn_mscale: float = 0.0
    yarn_mscale_all_dim: float = 0.0
    yarn_original_max_pos: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def layer_pattern(self) -> Tuple[Tuple[str, str], ...]:
        if self.pattern:
            return self.pattern
        if self.family == "moe":
            return (("attn", "moe"),)
        return (("attn", "mlp"),)

    def layer_kind(self, i: int) -> Tuple[str, str]:
        """(mixer, channel) of layer ``i``: the pattern's, with a dense
        ``mlp`` channel (width ``d_ff``) in the first ``first_dense_layers``
        layers."""
        pattern = self.layer_pattern()
        mixer, channel = pattern[i % len(pattern)]
        if i < self.first_dense_layers and channel == "moe":
            channel = "mlp"
        return mixer, channel


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (the published options
    kept)."""
    period = max(1, len(cfg.layer_pattern()))
    small = dict(
        n_layers=max(period, 2 * period if cfg.n_layers >= 2 * period else period),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
        d_ff=256,
        d_head=32,
        vocab_size=512,
        hot_vocab_rows=128 if cfg.hot_vocab_rows else 0,
        window=64,
        ssm_state=16,
        ssm_d_head=32,
        ssm_chunk=32,
        kv_lora=64 if cfg.kv_lora else 0,
        mla_d_nope=32,
        mla_d_rope=16,
        mla_d_v=32,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        prefix_len=min(cfg.prefix_len, 16),
        remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
