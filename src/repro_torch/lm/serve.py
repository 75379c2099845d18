"""LM serving: greedy generation through the decode path.

Port of ``repro.lm.serve``.  Prefill runs token by token through
``decode_step`` (the reference's own choice: identical math to
``model.forward``), then greedy decode.  Every step embeds its
token with one K2 launch on the card.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from . import model as model_mod

__all__ = ["generate"]


def generate(model: model_mod.LM, prompt: torch.Tensor, max_new: int = 16,
             max_len: Optional[int] = None, cache_dtype=torch.float32,
             return_logits: bool = False):
    """Greedy generation for ``prompt`` (B, S_prompt) integer ids on the
    model's device.  Returns the (B, S_prompt + max_new) int32 tokens, and
    with ``return_logits`` also the list of every step's (B, 1, padded V)
    logits (prefill steps first).

    ``max_len`` (default S_prompt + max_new + 1, as in the reference) must
    cover every position written into a linear cache (``attn``, ``mla``);
    the reference's cache write clamps an out-of-range position, the port
    raises instead.  A model whose caches are rings (``local``: W =
    ``min(window, max_len)`` slots) or recurrent states takes any
    ``max_len``, as in the reference.
    """
    cfg = model.cfg
    b, sp = prompt.shape
    max_len = max_len or (sp + max_new + 1)
    if max_len < sp + max_new and model_mod.has_linear_cache(cfg):
        raise ValueError(f"max_len {max_len} < prompt {sp} + max_new {max_new}")
    cache = model_mod.init_cache(cfg, b, max_len, device=prompt.device,
                                 dtype=cache_dtype)
    prompt = prompt.to(torch.int32)

    def pick(lg):
        # mask the padded-vocab tail (Megatron-style padding; embed.py)
        return lg[:, -1:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)

    steps: List[torch.Tensor] = []
    logits = None
    for t in range(sp):
        logits, cache = model_mod.decode_step(model, cache, prompt[:, t:t + 1])
        if return_logits:
            steps.append(logits)
    out = [prompt]
    tok = pick(logits)
    for _ in range(max_new):
        out.append(tok)
        logits, cache = model_mod.decode_step(model, cache, tok)
        if return_logits:
            steps.append(logits)
        tok = pick(logits)
    tokens = torch.cat(out, dim=1)
    return (tokens, steps) if return_logits else tokens
