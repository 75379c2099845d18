"""OLMo-1B [arXiv:2402.00838; hf] — non-parametric LayerNorm dense."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    act="silu",
    hot_vocab_rows=8192,
    sub_quadratic=False,
)
