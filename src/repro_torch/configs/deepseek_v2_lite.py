"""DeepSeek-V2-Lite as published [arXiv:2405.04434;
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json].

The published config, value for value: 27 layers at hidden size 2,048;
MLA with 16 heads, no q compression, ``kv_lora_rank`` 512, ``qk_nope``
128, ``qk_rope`` 64, ``v_head`` 128 and an RMSNorm on the latent
(``kv_a_layernorm``); layer 0 a dense SiLU MLP of width 10,944
(``first_k_dense_replace`` 1); 26 MoE layers of 64 routed experts of width
1,408, top-6 by softmax, unrenormalised (``norm_topk_prob`` false,
``routed_scaling_factor`` 1), greedy with no group limit, plus 2 shared
experts (width 2,816); YaRN rope (factor 40, ``mscale`` =
``mscale_all_dim`` = 0.707 over ``original_max_position_embeddings``
4,096, ``beta_fast`` 32, ``beta_slow`` 1, theta 10,000); ``rms_norm_eps``
1e-6 (the port's RMSNorm's); an untied output head; vocabulary 102,400.
Inference drops no expert slot.

Assumed by the port: K2's hot panel of 16,384 vocabulary rows
(``hot_vocab_rows``, the DBG split; the published model has one table), and
the rope dims in the half-split layout (``x[:32]`` against ``x[32:]``): the
published checkpoint stores them interleaved and its modelling code
de-interleaves them before the same rotation, a fixed permutation of the
q and k_rope weights' columns.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    rope_theta=10000.0,
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
    first_dense_layers=1,
    moe_norm_topk=False,
    moe_drop_free=True,
    mla_latent_norm=True,
    yarn_factor=40.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    yarn_original_max_pos=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
)
