"""The work of an LM decode step, counted from the model's published sizes
and the cache lengths alone, whatever kernels or layout implement it.

``mla_decode_roofline`` divides the latent cache's bytes by the MLA decode
kernel's device time and the data sheet's bandwidth (``peaks.json``);
``decode_mfu`` divides a step's model FLOPs by the window's time and the
data sheet's dense bf16 peak (``peak_flops.json``).
"""
from __future__ import annotations

from typing import Dict

__all__ = ["MLA_DECODE_KERNELS", "cache_row_bytes", "attention_flops_per_row",
           "active_params", "step_flops"]

#: The MLA decode kernel's two launches
#: (``src/repro_torch/kernels/mla_decode/csrc/mla_decode.cu``) as the
#: profiler names them: the slices over the cache and their combine.
MLA_DECODE_KERNELS = ("mla_decode_split_kernel", "mla_decode_combine_kernel")


def cache_row_bytes(config: dict, elem_bytes: int = 2) -> int:
    """Bytes of one cached row of one layer: the latent and the rope key
    (1,152 B for DeepSeek-V2 in bf16)."""
    return elem_bytes * (config["kv_lora_rank"] + config["qk_rope_head_dim"])


def attention_flops_per_row(config: dict) -> int:
    """FLOPs one token spends on one cached row of one layer in the
    absorbed decode: every head's score over the latent and rope key, and
    its weighted latent (2 x H x (2 kv_lora + d_rope))."""
    return 2 * config["num_attention_heads"] * (
        2 * config["kv_lora_rank"] + config["qk_rope_head_dim"])


def active_params(config: dict) -> Dict[str, int]:
    """The weights one token multiplies, by part: attention (the absorbed
    k_up and v_up count as the expanded ones do), the dense layers' MLP,
    the MoE layers' router, routed top-k and shared experts, and the
    output head.  The embedding is a lookup, no product."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    c, dn, dr, dv = (config["kv_lora_rank"], config["qk_nope_head_dim"],
                     config["qk_rope_head_dim"], config["v_head_dim"])
    layers = config["num_hidden_layers"]
    dense = config["first_k_dense_replace"]
    attn = d * h * (dn + dr) + d * (c + dr) + c * h * (dn + dv) + h * dv * d
    moe_layers = layers - dense
    expert = 3 * d * config["moe_intermediate_size"]
    return {
        "attention": layers * attn,
        "dense_mlp": dense * 3 * d * config["intermediate_size"],
        "moe": moe_layers * (d * config["n_routed_experts"]
                             + (config["num_experts_per_tok"]
                                + config["n_shared_experts"]) * expert),
        "head": d * config["vocab_size"],
    }


def step_flops(config: dict, tokens: int, cache_rows: int) -> int:
    """Model FLOPs of decode steps that took ``tokens`` tokens and read
    ``cache_rows`` cached rows summed over layers: 2 per active weight per
    token, plus the attention over the rows."""
    return (2 * sum(active_params(config).values()) * tokens
            + attention_flops_per_row(config) * cache_rows)
