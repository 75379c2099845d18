"""Yi-34B [arXiv:2403.04652; hf] — llama-arch GQA dense."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    hot_vocab_rows=8192,
    sub_quadratic=False,
)
