"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf] — enc-dec multimodal backbone.

24L encoder + 24L decoder, d_model=1024, 16H (GQA kv=16), d_ff=8192,
vocab=256206.  Audio frontend is a STUB: input_specs feeds precomputed frame
embeddings (B, S, d_model) to the encoder (per the assignment brief).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,           # decoder layers
    n_enc_layers=24,       # encoder layers (enc-dec)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm="rmsnorm",
    hot_vocab_rows=16384,  # 256k vocab → DBG hot panel
    sub_quadratic=False,
)
