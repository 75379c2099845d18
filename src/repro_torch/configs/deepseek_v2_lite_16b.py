"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf] — MLA + fine-grained MoE.

MLA kv_lora=512; MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408.
(The assignment line lists 64 experts; the paper's full V2 uses 160 — we
follow the assigned 64-expert lite config.)
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    pattern=(("mla", "moe"),),
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    kv_lora=512,
    mla_d_nope=128,
    mla_d_rope=64,
    mla_d_v=128,
    hot_vocab_rows=16384,
    sub_quadratic=False,
)
