"""The dense decoder LM on one device: init, the full-sequence forward and
its loss, the KV cache and one decode step.

Port of the dense part of ``repro.lm.model``.  The reference stacks
each pattern period's params on a leading axis and scans over periods; the
port keeps one :class:`Block` per layer in an ``nn.ModuleList`` (layer
``period · len(pattern) + slot``, then the tail layers), and
``convert.lm_params_from_numpy`` is where the two layouts meet.  Param names
follow the reference's tree (``embed.hot``, ``layers.3.mix.q.w``,
``layers.3.chan.gate.w``, ``final_norm.scale``).

Only the ``attn`` mixer and the ``mlp`` channel are ported; every other
block kind (``local`` ring attention, MLA, MoE, SSD, RG-LRU, cross
attention, VLM prefixes) raises ``NotImplementedError`` naming the ROADMAP
item that carries it (A12.3 to A12.6).  ``cfg.remat`` recomputes each layer
in the backward pass (``torch.utils.checkpoint``, the counterpart of the
reference's ``jax.checkpoint`` per period): the layer's parameters enter
the checkpoint as inputs, so a recompute reads the very tensors the forward
read, cast copies included (``train.step``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import embed as embed_mod
from . import layers as L

__all__ = ["Block", "LM", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "unembed_apply"]

#: Block kinds the reference has and this slice does not, by ROADMAP item.
_LATER = {
    "local": "A12.3 (local ring attention)",
    "mla": "A12.4 (MLA and MoE)",
    "moe": "A12.4 (MLA and MoE)",
    "ssd": "A12.5 (SSD and RG-LRU)",
    "rglru": "A12.5 (SSD and RG-LRU)",
    "cross": "A12.6 (enc-dec and VLM stubs)",
    "prefix": "A12.6 (enc-dec and VLM stubs)",
}


def _not_yet(kind: str, cfg: ArchConfig):
    return NotImplementedError(
        f"{cfg.arch_id}: '{kind}' is not ported yet (ROADMAP {_LATER[kind]}); "
        "repro_torch.lm runs dense attn + mlp decoders")


def _attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _embed_dims(cfg: ArchConfig) -> embed_mod.EmbedDims:
    return embed_mod.EmbedDims(cfg.vocab_size, cfg.d_model, cfg.hot_vocab_rows)


def _check_ported(cfg: ArchConfig) -> None:
    for mixer, channel in cfg.layer_pattern():
        for kind, ok in ((mixer, ("attn",)), (channel, ("mlp",))):
            if kind not in ok:
                if kind in _LATER:
                    raise _not_yet(kind, cfg)
                raise ValueError(f"{cfg.arch_id}: block kind {kind!r} is "
                                 "not ported")
    if cfg.n_enc_layers:
        raise _not_yet("cross", cfg)
    if cfg.prefix_len:
        raise _not_yet("prefix", cfg)


class Block(nn.Module):
    """One pre-norm ``attn`` + gated ``mlp`` layer."""

    def __init__(self, cfg: ArchConfig, **kw):
        super().__init__()
        self.norm1 = L.norm_init(cfg.norm, cfg.d_model, **kw)
        self.mix = L.attn_init(cfg.d_model, _attn_dims(cfg), **kw)
        self.norm2 = L.norm_init(cfg.norm, cfg.d_model, **kw)
        self.chan = L.mlp_init(cfg.d_model, cfg.d_ff, gated=True, **kw)

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        """The full-sequence layer (the reference's ``_layer_apply`` for
        ``attn`` + ``mlp``): (B, S, d_model) → (B, S, d_model)."""
        dt = x.dtype  # the residual stream keeps its dtype
        h = L.apply_norm(cfg.norm, self.norm1, x)
        y = L.mha(self.mix, h, _attn_dims(cfg), positions=positions,
                  rope_theta=cfg.rope_theta)
        x = x + y.to(dt)
        h2 = L.apply_norm(cfg.norm, self.norm2, x)
        return x + L.mlp(self.chan, h2, act=cfg.act).to(dt)

    def decode(self, cfg: ArchConfig, x: torch.Tensor, cache: Dict[str, Any],
               cur_len: int) -> torch.Tensor:
        dt = x.dtype  # the residual stream keeps its dtype
        h = L.apply_norm(cfg.norm, self.norm1, x)
        y = L.mha_decode(self.mix, h, _attn_dims(cfg), cache["k"], cache["v"],
                         cur_len, rope_theta=cfg.rope_theta)
        x = x + y.to(dt)
        h2 = L.apply_norm(cfg.norm, self.norm2, x)
        return x + L.mlp(self.chan, h2, act=cfg.act).to(dt)


class LM(nn.Module):
    """Embedding (hot/cold split), ``cfg.n_layers`` blocks, final norm."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = embed_mod.embed_init(_embed_dims(cfg), **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.norm_init(cfg.norm, cfg.d_model, **kw)


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None,
                dtype=torch.float32) -> LM:
    """A model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless the caller asks for the CPU).
    Same distributions as the reference's ``init_params``, other numbers:
    the parity tests load the reference's weights through ``convert``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, generator=gen, device=dev, dtype=dtype)


def _block_with(block: Block, names, cfg, x, positions, *tensors):
    return torch.func.functional_call(block, dict(zip(names, tensors)),
                                      (cfg, x, positions))


def _layer(block: Block, cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    if not (cfg.remat and torch.is_grad_enabled()):
        return block(cfg, x, positions)
    # the tensors the block holds now (a cast copy inside train.step's
    # functional_call) go in as inputs and are read again by the recompute
    names, tensors = zip(*block.named_parameters())
    return checkpoint(_block_with, block, names, cfg, x, positions, *tensors,
                      use_reentrant=False)


def forward(model: LM, tokens: torch.Tensor, *,
            prefix: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, last_only: bool = False,
            return_hidden: bool = False):
    """Logits (B, S, padded V) and the auxiliary loss (a float32 scalar,
    0 for dense layers) of ``tokens`` (B, S) integer, one K2 launch on the
    card for the embedding.  ``last_only``: unembed the final position
    only (prefill serving); ``return_hidden``: the final-normed hidden
    states instead of logits (the chunked loss)."""
    cfg = model.cfg
    if prefix is not None:
        raise _not_yet("prefix", cfg)
    if frames is not None:
        raise _not_yet("cross", cfg)
    x = embed_mod.embed_lookup(model.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for block in model.layers:
        x = _layer(block, cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    if return_hidden:
        return x, aux
    if last_only:
        x = x[:, -1:]
    return unembed_apply(model, x), aux


def unembed_apply(model: LM, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) → (B, S, padded V) logits."""
    return embed_mod.unembed(model.embed, x)


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of ``labels`` under ``logits``, in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).sum()


def _chunk_ce(w: torch.Tensor, hx: torch.Tensor,
              lx: torch.Tensor) -> torch.Tensor:
    return _ce_sum(hx @ w, lx)


def loss_fn(model: LM, tokens: torch.Tensor, labels: torch.Tensor, *,
            prefix: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, aux_weight: float = 0.01,
            loss_chunk: int = 0) -> torch.Tensor:
    """Next-token cross-entropy (a float32 scalar) of ``labels`` (B, S).

    ``loss_chunk`` > 0 projects onto the vocabulary and takes the
    logsumexp per chunk of that many positions under a checkpoint, so the
    (B, S, V) logits are never held; positions past the last whole chunk
    are left out, as in the reference."""
    cfg = model.cfg
    if loss_chunk:
        hidden, aux = forward(model, tokens, prefix=prefix, frames=frames,
                              return_hidden=True)
        b, s, _ = hidden.shape
        c = min(loss_chunk, s)
        nc = s // c
        w = model.embed["unembed"]
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(nc):
            sl = slice(i * c, (i + 1) * c)
            total = total + checkpoint(_chunk_ce, w, hidden[:, sl],
                                       labels[:, sl], use_reentrant=False)
        ce = total / (b * nc * c)
    else:
        logits, aux = forward(model, tokens, prefix=prefix, frames=frames)
        ce = _ce_sum(logits, labels) / labels.numel()
    return ce + aux_weight * aux / max(1, cfg.n_layers)


def init_cache(cfg: ArchConfig, b: int, max_len: int, *, device=None,
               dtype=torch.bfloat16) -> Dict[str, Any]:
    """``{"layers": [{"k", "v"} (B, max_len, Hkv, D) zeros per layer],
    "len": 0}``; ``len`` is a host int (no device read per step)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (b, max_len, cfg.n_kv_heads, cfg.head_dim)
    layers: List[Dict[str, torch.Tensor]] = [
        {"k": torch.zeros(shape, dtype=dtype, device=dev),
         "v": torch.zeros(shape, dtype=dtype, device=dev)}
        for _ in range(cfg.n_layers)]
    return {"layers": layers, "len": 0}


@torch.no_grad()
def decode_step(model: LM, cache: Dict[str, Any], token: torch.Tensor):
    """One new token for every sequence; token: (B, 1) integer.  Returns
    (logits (B, 1, padded V), cache) — the cache's tensors are updated in
    place and its ``len`` advanced."""
    cfg = model.cfg
    cur_len = cache["len"]
    x = embed_mod.embed_lookup(model.embed, token)
    for block, layer_cache in zip(model.layers, cache["layers"]):
        x = block.decode(cfg, x, layer_cache, cur_len)
    cache["len"] = cur_len + 1
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    return embed_mod.unembed(model.embed, x), cache
