"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP + gemma VLM.

Gemma decoder backbone (18L, d=2048, 8H MQA, d_ff=16384, vocab=257216);
SigLIP vision frontend is a STUB — input_specs provides 256 precomputed patch
embeddings (B, 256, d_model) prepended to the token sequence.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    act="gelu",
    prefix_len=256,
    hot_vocab_rows=16384,
    sub_quadratic=False,
)
