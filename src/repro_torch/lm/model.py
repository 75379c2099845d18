"""The dense decoder LM on one device: init, KV cache and one decode step.

Port of the dense decode part of ``repro.lm.model``.  The reference stacks
each pattern period's params on a leading axis and scans over periods; the
port keeps one :class:`Block` per layer in an ``nn.ModuleList`` (layer
``period · len(pattern) + slot``, then the tail layers), and
``convert.lm_params_from_numpy`` is where the two layouts meet.  Param names
follow the reference's tree (``embed.hot``, ``layers.3.mix.q.w``,
``layers.3.chan.gate.w``, ``final_norm.scale``).

Only the ``attn`` mixer and the ``mlp`` channel are ported; every other
block kind raises ``NotImplementedError`` naming the ROADMAP item that
carries it.  The full-sequence ``forward`` and training are ROADMAP A12.1
and A12.2.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import embed as embed_mod
from . import layers as L

__all__ = ["Block", "LM", "decode_step", "init_cache", "init_params"]

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
