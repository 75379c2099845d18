"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf] — MLA + fine-grained MoE.

MLA kv_lora=512; MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408.
(The assignment line lists 64 experts; the paper's full V2 uses 160 — we
follow the assigned 64-expert lite config.)

This is the JAX package's reading, kept field for field equal to its
config for the parity tests.  The published model is ``deepseek_v2_lite``,
which differs from it in six ways: the published model's layer 0 is a
dense MLP of width 10,944; it RMS-norms the latent before ``k_up`` /
``v_up``; its rope is YaRN (factor 40, and ``mscale``² in the softmax
scale); it uses the top-6 probabilities as they are, not renormalised; it
drops no expert slot, where this one drops by capacity (GShard); and its
decode attends over each sequence's own rows through the absorbed latent
cache, where the JAX package re-expands the whole cache every step.
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
