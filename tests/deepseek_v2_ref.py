"""The plain reference of DeepSeek-V2 as published, for the CPU tests.

The equations are the benchmark's reference of the ``deepseek-v2-lite``
configuration (``bench/reference/deepseek_v2.py``: plain float32 torch,
unabsorbed, the published modelling code's layers, no JAX and nothing of
the port).  This module adds what the tests hand it: ``published`` gives
the published ``config.json`` keys of a port config, ``weights`` a model's
tensors by name, with every RMSNorm scale drawn away from 1 so that a norm
left out shows.  Not a test module (pytest collects ``test_*.py`` only).
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference.deepseek_v2 import (Published, Weights,  # noqa: E402
                                         attention, decode, forward,
                                         new_rows, softmax_scale,
                                         yarn_get_mscale, yarn_inv_freq)

__all__ = ["Published", "Weights", "attention", "decode", "forward",
           "new_rows", "softmax_scale",
           "yarn_get_mscale", "yarn_inv_freq", "published", "weights",
           "scale_norms"]


def published(cfg) -> Published:
    """The published config's keys of a port's config."""
    return Published(
        hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora,
        qk_nope_head_dim=cfg.mla_d_nope, qk_rope_head_dim=cfg.mla_d_rope,
        v_head_dim=cfg.mla_d_v, first_k_dense_replace=cfg.first_dense_layers,
        n_routed_experts=cfg.n_experts, num_experts_per_tok=cfg.top_k,
        norm_topk_prob=cfg.moe_norm_topk, routed_scaling_factor=1.0,
        rms_norm_eps=1e-6, rope_theta=cfg.rope_theta,
        rope_scaling={"type": "yarn", "factor": cfg.yarn_factor,
                      "mscale": cfg.yarn_mscale,
                      "mscale_all_dim": cfg.yarn_mscale_all_dim,
                      "original_max_position_embeddings":
                          cfg.yarn_original_max_pos,
                      "beta_fast": cfg.yarn_beta_fast,
                      "beta_slow": cfg.yarn_beta_slow},
        vocab_size=cfg.vocab_size)


def scale_norms(model, seed: int = 0) -> None:
    """Every RMSNorm scale of ``model`` drawn from U(0.5, 1.5), in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.copy_(0.5 + torch.rand(p.shape, generator=g))


def weights(model) -> Weights:
    return Weights({k: v.detach() for k, v in model.state_dict().items()})
