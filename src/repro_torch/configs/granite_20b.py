"""Granite-20B (code) [arXiv:2405.04324; hf] — MQA (kv=1) dense."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    hot_vocab_rows=8192,
    sub_quadratic=False,
)
