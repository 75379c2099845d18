"""RecurrentGemma-9B [arXiv:2402.19427; unverified] — Griffin RG-LRU + local
attention, pattern 2 recurrent : 1 local-attention, window 2048.

Sub-quadratic → the long_500k cell RUNS for this arch.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,             # 12 full (rglru,rglru,local) periods + 2 tail
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("local", "mlp")),
    window=2048,
    hot_vocab_rows=16384,
    sub_quadratic=True,
)
