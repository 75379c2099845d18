"""Yi-9B [arXiv:2403.04652; hf] — llama-arch GQA dense."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    hot_vocab_rows=8192,
    sub_quadratic=False,
)
