"""Mamba2-780M [arXiv:2405.21060; unverified] — SSD, attention-free.

48L, d_model=1536, ssm_state=128, no separate MLP (d_ff=0; the SSD block's
expand=2 projection is the channel mixer).  Sub-quadratic → long_500k RUNS.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,        # ssd heads = d_inner/ssm_d_head = 3072/128
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    pattern=(("ssd", "none"),),
    ssm_state=128,
    ssm_d_head=128,
    ssm_expand=2,
    ssm_chunk=256,
    hot_vocab_rows=8192,
    sub_quadratic=True,
)
