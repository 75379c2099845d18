"""Grok-1 314B [hf:xai-org/grok-1; unverified] — MoE 8 experts top-2."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,       # dense-equivalent ff (experts use moe_d_ff)
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    hot_vocab_rows=16384,
    sub_quadratic=False,
)
