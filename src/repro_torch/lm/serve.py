"""LM serving: greedy generation through the decode path, and the decode
step of a resident batch as a CUDA graph.

Port of ``repro.lm.serve``.  Prefill runs token by token through
``decode_step`` (the reference's own choice: identical math to
``model.forward``), then greedy decode.  Every step embeds its
token with one K2 launch on the card.  ``DecodeGraph`` (the port's own)
records one step of a batch whose sequences stand at their own lengths
and replays it: the host launches one graph a step, not the step's
thousands of kernels.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from . import model as model_mod

__all__ = ["DecodeGraph", "generate"]


class DecodeGraph:
    """``decode_step`` of ``model`` over ``cache`` as a CUDA graph: recorded
    once (a ``fixed`` step: writes, masks and rope through the device
    lengths, the MLA kernel's grid over the cache's room), then replayed for
    each step, every sequence at its own length.  The graph reads its token
    from ``token``, a (B, 1) int32 buffer of its own, and writes its
    logits into one buffer that the next step overwrites.

    Set-up runs ``warm_up`` steps on a side stream before the recording
    (libraries' first calls); they write the rows at and past each length,
    as a step would, and leave the lengths as they were.  Each replay
    advances the host lengths, in an ``lm.decode_step`` span, and counts
    the rows and launches ``mla_decode`` would (the spans inside the step
    are the recording's alone).  A model with a ring or recurrent cache
    raises.  On the CPU, where there are no graphs, each call runs the
    fixed step."""

    def __init__(self, model: model_mod.LM, cache, warm_up: int = 1):
        cfg = model.cfg
        if not model_mod.takes_ragged(cfg):
            raise ValueError(f"{cfg.arch_id}: a decode graph needs caches "
                             "that hold a length per sequence")
        self.model, self.cache = model, cache
        dev = cache["len_dev"].device
        self.token = torch.zeros((cache["len"].shape[0], 1),
                                 dtype=torch.int32, device=dev)
        self.room = min(t.shape[1] for layer in cache["layers"]
                        for t in layer.values())
        self.mla_layers = sum(cfg.layer_kind(i)[0] == "mla"
                              for i in range(cfg.n_layers))
        self.graph = self.logits = None
        if dev.type == "cuda":
            self._record(warm_up)

    def _step(self) -> torch.Tensor:
        return model_mod.decode_step(self.model, self.cache, self.token,
                                     fixed=True)[0]

    def _record(self, warm_up: int) -> None:
        lens = self.cache["len"].copy()
        side = torch.cuda.Stream(self.token.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warm_up):
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        model_mod.set_lengths(self.cache, lens)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = self._step()
        model_mod.set_lengths(self.cache, lens)

    def __call__(self, token: Optional[torch.Tensor] = None):
        """One step of every sequence: ``token`` (B, 1) integer, or the
        buffer ``self.token`` as it stands.  Returns (logits (B, 1, padded
        V), cache), as ``decode_step``."""
        if token is not None and token is not self.token:
            self.token.copy_(token)
        if self.graph is None:
            return self._step(), self.cache
        lens = self.cache["len"]
        if int(lens.max()) >= self.room or int(lens.min()) < 0:
            raise ValueError(f"cache holds {self.room} positions; cannot "
                             f"write positions {lens.min()} to {lens.max()}")
        with obs_trace.span("lm.decode_step"):
            self.graph.replay()
        self.cache["len"] = lens + 1
        if self.mla_layers:
            reg = get_registry()
            reg.counter("lm.mla_decode.cache_rows").inc(
                self.mla_layers * int((lens + 1).sum()))
            reg.counter("lm.mla_decode.launches").inc(self.mla_layers)
        return self.logits, self.cache


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
