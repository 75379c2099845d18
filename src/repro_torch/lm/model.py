"""The decoder LM on one device, every block kind of the repo's
configurations: init, the full-sequence forward and its loss, the caches
and one decode step.

Port of ``repro.lm.model``.  A layer is a token mixer (``attn``, ``local``
sliding-window attention with a ring cache, ``mla``, ``ssd``, ``rglru`` or
``none``), an optional cross attention over an encoder's memory (the
enc-dec stub) and a channel mixer (``mlp``, ``moe`` or ``none``), in the
``cfg.layer_pattern()``.  The reference stacks each pattern period's params
on a leading axis and scans over periods; the port keeps one :class:`Block`
per layer in an ``nn.ModuleList`` (layer ``period · len(pattern) + slot``,
then the tail layers; the encoder's layers likewise), and
``convert.lm_params_from_numpy`` is where the two layouts meet.  Param names
follow the reference's tree (``embed.hot``, ``layers.3.mix.q.w``,
``layers.3.chan.gate``, ``encoder.1.mix.q.w``, ``final_norm.scale``).  The
VLM stub prepends ``prefix @ prefix_proj`` to the token embeddings; the
enc-dec stub encodes ``frames`` with bidirectional layers.

``cfg.remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` per period): the layer's parameters enter the checkpoint
as inputs, so a recompute reads the very tensors the forward read, cast
copies included (``train.step``).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..dist.constrain import constrain, is_sharded, reshape
from ..dist.constrain import positions as dist_positions
from ..obs import trace as obs_trace
from . import embed as embed_mod
from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod

__all__ = ["Block", "LM", "decode_step", "forward", "has_linear_cache",
           "init_cache", "init_params", "loss_fn", "on_mesh", "set_lengths",
           "takes_ragged", "unembed_apply"]

#: The encoder-decoder stub's cross-attention memory in the decode cache:
#: zeros over a fixed S_enc, as the reference allocates it.
CROSS_MEMORY = 4096


def _attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _yarn(cfg: ArchConfig) -> Optional[L.Yarn]:
    if not cfg.yarn_factor:
        return None
    return L.Yarn(cfg.yarn_factor, cfg.yarn_mscale, cfg.yarn_mscale_all_dim,
                  cfg.yarn_original_max_pos, cfg.yarn_beta_fast,
                  cfg.yarn_beta_slow)


def _mla_dims(cfg: ArchConfig) -> L.MlaDims:
    return L.MlaDims(cfg.n_heads, cfg.kv_lora, cfg.mla_d_nope, cfg.mla_d_rope,
                     cfg.mla_d_v, latent_norm=cfg.mla_latent_norm,
                     yarn=_yarn(cfg))


def _ssd_dims(cfg: ArchConfig) -> ssm_mod.SsdDims:
    return ssm_mod.SsdDims(cfg.d_model, cfg.ssm_state, cfg.ssm_d_head,
                           cfg.ssm_expand, cfg.ssm_chunk)


def _rglru_dims(cfg: ArchConfig) -> ssm_mod.RglruDims:
    return ssm_mod.RglruDims(cfg.d_model)


def _moe_dims(cfg: ArchConfig) -> moe_mod.MoeDims:
    return moe_mod.MoeDims(cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                           cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
                           capacity_factor=cfg.capacity_factor,
                           norm_topk=cfg.moe_norm_topk,
                           drop_free=cfg.moe_drop_free)


def _embed_dims(cfg: ArchConfig) -> embed_mod.EmbedDims:
    return embed_mod.EmbedDims(cfg.vocab_size, cfg.d_model, cfg.hot_vocab_rows)


class Block(nn.Module):
    """One pre-norm layer: ``norm1`` and the token mixer ``mix``; with
    ``cross``, ``norm_x`` and the cross attention ``cross``; ``norm2`` and
    the channel mixer ``chan`` unless the channel is ``none``."""

    def __init__(self, cfg: ArchConfig, mixer: str, channel: str,
                 cross: bool = False, **kw):
        super().__init__()
        self.mixer, self.channel = mixer, channel
        self.norm1 = L.norm_init(cfg.norm, cfg.d_model, **kw)
        if mixer in ("attn", "local", "bidir"):
            self.mix = L.attn_init(cfg.d_model, _attn_dims(cfg), **kw)
        elif mixer == "mla":
            self.mix = L.mla_init(cfg.d_model, _mla_dims(cfg), **kw)
        elif mixer == "rglru":
            self.mix = ssm_mod.rglru_init(_rglru_dims(cfg), **kw)
        elif mixer == "ssd":
            self.mix = ssm_mod.ssd_init(_ssd_dims(cfg), **kw)
        elif mixer != "none":
            raise ValueError(f"{cfg.arch_id}: no token mixer {mixer!r}")
        if cross:
            self.norm_x = L.norm_init(cfg.norm, cfg.d_model, **kw)
            self.cross = L.attn_init(cfg.d_model, _attn_dims(cfg), **kw)
        if channel == "mlp":
            self.norm2 = L.norm_init(cfg.norm, cfg.d_model, **kw)
            self.chan = L.mlp_init(cfg.d_model, cfg.d_ff, gated=True, **kw)
        elif channel == "moe":
            self.norm2 = L.norm_init(cfg.norm, cfg.d_model, **kw)
            self.chan = moe_mod.moe_init(_moe_dims(cfg), **kw)
        elif channel != "none":
            raise ValueError(f"{cfg.arch_id}: no channel mixer {channel!r}")

    def _channel(self, cfg: ArchConfig, x: torch.Tensor):
        """The channel half of the layer: (x, aux)."""
        dt = x.dtype
        if self.channel == "none":
            return x, None
        h2 = L.apply_norm(cfg.norm, self.norm2, x)
        if self.channel == "mlp":
            return x + L.mlp(self.chan, h2, act=cfg.act).to(dt), None
        y, aux = moe_mod.moe_apply(self.chan, h2, _moe_dims(cfg))
        return x + y.to(dt), aux

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor,
                memory: Optional[torch.Tensor] = None):
        """The full-sequence layer (the reference's ``_layer_apply``):
        (B, S, d_model) → (x, aux), aux the MoE's load-balance loss (a
        float32 scalar; None for other channels, whose loss is 0)."""
        dt = x.dtype  # the residual stream keeps its dtype
        h = L.apply_norm(cfg.norm, self.norm1, x)
        m = self.mixer
        if m in ("attn", "local"):
            x = x + L.mha(self.mix, h, _attn_dims(cfg), positions=positions,
                          rope_theta=cfg.rope_theta,
                          window=cfg.window if m == "local" else None).to(dt)
        elif m == "bidir":
            x = x + L.mha_bidir(self.mix, h, _attn_dims(cfg),
                                positions=positions,
                                rope_theta=cfg.rope_theta).to(dt)
        elif m == "mla":
            x = x + L.mla(self.mix, h, _mla_dims(cfg), positions=positions,
                          rope_theta=cfg.rope_theta).to(dt)
        elif m == "rglru":
            x = x + ssm_mod.rglru(self.mix, h, _rglru_dims(cfg)).to(dt)
        elif m == "ssd":
            x = x + ssm_mod.ssd(self.mix, h, _ssd_dims(cfg)).to(dt)
        if hasattr(self, "cross"):
            if memory is None:
                raise ValueError(f"{cfg.arch_id}: cross attention needs the "
                                 "encoder's memory (pass frames=)")
            hx = L.apply_norm(cfg.norm, self.norm_x, x)
            x = x + L.cross_attn(self.cross, hx, memory,
                                 _attn_dims(cfg)).to(dt)
        return self._channel(cfg, x)

    def decode(self, cfg: ArchConfig, x: torch.Tensor, cache: Dict[str, Any],
               cur_len: Union[int, L.DecodeAt],
               cross_kv=None) -> torch.Tensor:
        """One token (the reference's ``_layer_decode``): (B, 1, d_model) →
        (B, 1, d_model) at ``cur_len`` (an int for the whole batch, or each
        sequence's own position); ``cache`` is this layer's, updated in
        place."""
        dt = x.dtype
        h = L.apply_norm(cfg.norm, self.norm1, x)
        m = self.mixer
        if m == "attn":
            y = L.mha_decode(self.mix, h, _attn_dims(cfg), cache["k"],
                             cache["v"], cur_len, rope_theta=cfg.rope_theta)
        elif m == "local":
            y = _mha_decode_ring(self.mix, h, cfg, cache, cur_len)
        elif m == "mla":
            y = L.mla_decode(self.mix, h, _mla_dims(cfg), cache["latent"],
                             cache["krope"], cur_len,
                             rope_theta=cfg.rope_theta)
        elif m == "ssd":
            y, cache["h"], cache["conv"] = ssm_mod.ssd_decode(
                self.mix, h, _ssd_dims(cfg), cache["h"], cache["conv"])
        elif m == "rglru":
            y, cache["h"], cache["conv"] = ssm_mod.rglru_decode(
                self.mix, h, _rglru_dims(cfg), cache["h"], cache["conv"])
        else:
            raise ValueError(f"{cfg.arch_id}: no decode for mixer {m!r}")
        x = x + y.to(dt)
        if hasattr(self, "cross") and cross_kv is not None:
            hx = L.apply_norm(cfg.norm, self.norm_x, x)
            x = x + _cross_decode(self.cross, hx, cfg, *cross_kv).to(dt)
        return self._channel(cfg, x)[0]


def _mha_decode_ring(p, h: torch.Tensor, cfg: ArchConfig,
                     cache: Dict[str, torch.Tensor],
                     cur_len: Union[int, L.DecodeAt]) -> torch.Tensor:
    """Sliding-window decode against a ring cache of W slots: this token's
    k and v go to slot ``cur_len mod W`` IN PLACE, with its position in
    the ``pos`` plane; a slot is valid while its position lies in
    ``(cur_len - W, cur_len]``.  Never raises past W: the ring wraps.  The
    ring's one ``pos`` plane serves the whole batch: every sequence at one
    position."""
    if isinstance(cur_len, L.DecodeAt):
        cur_len = cur_len.position
    dims = _attn_dims(cfg)
    b = h.shape[0]
    w = cache["k"].shape[1]
    q = reshape(h @ p["q"]["w"], b, 1, dims.n_heads, dims.d_head)
    k = reshape(h @ p["k"]["w"], b, 1, dims.n_kv, dims.d_head)
    v = reshape(h @ p["v"]["w"], b, 1, dims.n_kv, dims.d_head)
    pos = torch.full((b, 1), cur_len, dtype=torch.int32, device=h.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    slot = cur_len % w
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cpos = cache["pos"]
    cpos[slot] = cur_len
    g = dims.n_heads // dims.n_kv
    qr = reshape(q, b, dims.n_kv, g, dims.d_head)
    sc = torch.einsum("bhgd,bshd->bhgs", qr.float(), cache["k"].float())
    sc = sc / math.sqrt(dims.d_head)
    valid = (cpos >= 0) & (cpos > cur_len - w) & (cpos <= cur_len)
    sc = sc.masked_fill(~valid, float("-inf"))
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", pr, cache["v"].float())
    out = reshape(out, b, 1, dims.n_heads * dims.d_head).to(h.dtype)
    return out @ p["o"]["w"]


def _cross_decode(p, x: torch.Tensor, cfg: ArchConfig, ck: torch.Tensor,
                  cv: torch.Tensor) -> torch.Tensor:
    """One token's cross attention over the cached memory keys and values
    (B, S_enc, Hkv, D), a full float32 softmax."""
    dims = _attn_dims(cfg)
    b = x.shape[0]
    q = reshape(x @ p["q"]["w"], b, 1, dims.n_heads, dims.d_head)
    qr = reshape(q, b, dims.n_kv, dims.n_heads // dims.n_kv, dims.d_head)
    sc = torch.einsum("bhgd,bshd->bhgs", qr.float(), ck.float())
    pr = torch.softmax(sc / math.sqrt(dims.d_head), dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", pr, cv.float())
    return reshape(out, b, 1, -1).to(x.dtype) @ p["o"]["w"]


class LM(nn.Module):
    """Embedding (hot/cold split), ``cfg.n_layers`` blocks in the config's
    pattern (``cfg.layer_kind``: leading dense layers first), final norm;
    the encoder stack and ``enc_norm`` of an enc-dec config;
    ``prefix_proj`` of a VLM config."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        cross = cfg.n_enc_layers > 0
        self.embed = embed_mod.embed_init(_embed_dims(cfg), **kw)
        self.layers = nn.ModuleList(
            Block(cfg, *cfg.layer_kind(i), cross=cross, **kw)
            for i in range(cfg.n_layers))
        if cross:
            self.encoder = nn.ModuleList(Block(cfg, "bidir", "mlp", **kw)
                                         for _ in range(cfg.n_enc_layers))
            self.enc_norm = L.norm_init(cfg.norm, cfg.d_model, **kw)
        if cfg.prefix_len:
            self.prefix_proj = L.dense_init(cfg.d_model, cfg.d_model, **kw)
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


def on_mesh(model: LM):
    """A context in which a sharded model's functions run
    (``dist.sharding.shard_model``): DTensor's implicit replication, so
    the tensors they make themselves (positions, masks, accumulators) join
    DTensor ops as replicated.  Nothing for a model of plain tensors."""
    if not is_sharded(next(model.parameters())):
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication`` made
    re-entrant: that one clears the flag on exit even inside another."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def _on_mesh(fn):
    @functools.wraps(fn)
    def wrapped(model, *args, **kwargs):
        with on_mesh(model):
            return fn(model, *args, **kwargs)
    return wrapped


def _block_with(block: Block, names, cfg, x, positions, memory, *tensors):
    return torch.func.functional_call(block, dict(zip(names, tensors)),
                                      (cfg, x, positions, memory))


def _layer(block: Block, cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor, memory: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if not (cfg.remat and torch.is_grad_enabled()):
        return block(cfg, x, positions, memory)
    # the tensors the block holds now (a cast copy inside train.step's
    # functional_call) go in as inputs and are read again by the recompute
    names, tensors = zip(*block.named_parameters())
    return checkpoint(_block_with, block, names, cfg, x, positions, memory,
                      *tensors, use_reentrant=False)


def _encode(model: LM, frames: torch.Tensor) -> torch.Tensor:
    """The encoder stack over the stub frame embeddings (B, S_src, D), then
    ``enc_norm``: the cross attention's memory."""
    cfg = model.cfg
    if not hasattr(model, "encoder"):
        raise ValueError(f"{cfg.arch_id} has no encoder; frames= is for "
                         "enc-dec configs")
    x = frames
    positions = dist_positions(x)
    for block in model.encoder:
        x, _ = block(cfg, x, positions)
    return L.apply_norm(cfg.norm, model.enc_norm, x)


@_on_mesh
def forward(model: LM, tokens: torch.Tensor, *,
            prefix: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, last_only: bool = False,
            return_hidden: bool = False):
    """Logits (B, S_total, padded V) and the auxiliary loss (a float32
    scalar: the MoE layers' load-balance losses summed, 0 without MoE) of
    ``tokens`` (B, S) integer, one K2 launch on the card for the
    embedding.  ``prefix``: VLM patch embeddings (B, P, D), projected and
    prepended (S_total = P + S); ``frames``: the enc-dec stub's encoder
    input (B, S_src, D).  ``last_only``: unembed the final position only
    (prefill serving); ``return_hidden``: the final-normed hidden states
    instead of logits (the chunked loss)."""
    cfg = model.cfg
    x = embed_mod.embed_lookup(model.embed, tokens)
    if prefix is not None:
        pe = prefix @ model.prefix_proj["w"]
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    memory = _encode(model, frames) if frames is not None else None
    b, s, _ = x.shape
    x = constrain(x, "batch", None, None)
    positions = dist_positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    plen = len(cfg.layer_pattern())
    in_periods = (cfg.n_layers // plen) * plen
    # Megatron-SP: the residual at each period's edges shards along S
    seq_axis = "seq" if cfg.seq_parallel else None
    for i, block in enumerate(model.layers):
        if i < in_periods and i % plen == 0:
            x = constrain(x, "batch", seq_axis, None)
        x, a = _layer(block, cfg, x, positions, memory)
        if a is not None:
            aux = aux + a
        if i < in_periods and i % plen == plen - 1:
            x = constrain(x, "batch", seq_axis, None)
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    if return_hidden:
        return x, aux
    if last_only:
        x = x[:, -1:]
    return constrain(unembed_apply(model, x), "batch", None, "model"), aux


def unembed_apply(model: LM, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) → (B, S, padded V) logits."""
    return embed_mod.unembed(model.embed, x)


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of ``labels`` under ``logits``, in float32."""
    logits = logits.float()
    if is_sharded(logits) and _vocab_split(logits):
        return _sharded_ce(logits, labels).sum()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).sum()


def _vocab_split(logits) -> bool:
    """Whether a DTensor's last dim is split over more than one rank."""
    from torch.distributed.tensor import Shard

    last = logits.dim() - 1
    return any(isinstance(p, Shard) and p.dim == last and n > 1
               for p, n in zip(logits.placements, logits.device_mesh.shape))


def _sharded_ce(logits, labels: torch.Tensor):
    """Per-position ``logsumexp(logits) - logits[labels]`` of a float32
    DTensor whose vocabulary (last dim) may be split: Megatron's
    vocab-parallel cross entropy on the local shards.  DTensor's own
    ``logsumexp`` gathers the whole logits and its ``gather`` of a split
    dim fails.  Each rank takes its slice's max (a max over the ranks that
    split the vocabulary), its sum of exponentials and the labels that
    fall in its slice (sums over those ranks)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh, last = logits.device_mesh, logits.dim() - 1
    lead = [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in logits.placements]
    split = [isinstance(p, Shard) and p.dim == last for p in logits.placements]

    def pending(op, local, grad=True):
        out = [Partial(op) if sp else q for sp, q in zip(split, lead)]
        return DTensor.from_local(local, mesh, out, run_check=False,
                                  grad_placements=lead if grad else None)

    if not is_sharded(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, lead).to_local().long()
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    local = logits.to_local()
    m = pending("max", local.detach().amax(-1), grad=False)
    m = m.redistribute(mesh, lead)
    sumexp = pending("sum", torch.exp(local - m.to_local()[..., None]).sum(-1))
    idx = lab - offset[last]
    inside = (idx >= 0) & (idx < local.shape[-1])
    picked = local.gather(-1, idx.clamp(0, local.shape[-1] - 1)[..., None])
    gold = pending("sum", torch.where(inside, picked[..., 0], 0.0))
    return torch.log(sumexp) + m - gold


def _text(x: torch.Tensor, skip: int) -> torch.Tensor:
    """The positions past a VLM prefix of ``skip``: ``x`` itself when there
    is none (a slice's backward has no DTensor strategy but a replicated
    one, which would gather the whole gradient)."""
    return x[:, skip:] if skip else x


def _chunk_ce(w: torch.Tensor, hx: torch.Tensor,
              lx: torch.Tensor) -> torch.Tensor:
    return _ce_sum(hx @ w, lx)


@_on_mesh
def loss_fn(model: LM, tokens: torch.Tensor, labels: torch.Tensor, *,
            prefix: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, aux_weight: float = 0.01,
            loss_chunk: int = 0) -> torch.Tensor:
    """Next-token cross-entropy (a float32 scalar) of ``labels`` (B, S) over
    the token positions (a VLM prefix's positions are left out), plus
    ``aux_weight`` times the auxiliary loss per layer.

    ``loss_chunk`` > 0 projects onto the vocabulary and takes the
    logsumexp per chunk of that many positions under a checkpoint, so the
    (B, S, V) logits are never held; positions past the last whole chunk
    are left out, as in the reference."""
    cfg = model.cfg
    skip = 0 if prefix is None else prefix.shape[1]
    if loss_chunk:
        hidden, aux = forward(model, tokens, prefix=prefix, frames=frames,
                              return_hidden=True)
        hidden = _text(hidden, skip)
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
        ce = _ce_sum(_text(logits, skip), labels) / labels.numel()
    return ce + aux_weight * aux / max(1, cfg.n_layers)


def _layer_cache(cfg: ArchConfig, mixer: str, b: int, max_len: int, dev,
                 dtype) -> Dict[str, torch.Tensor]:
    """One layer's decode cache: k/v (``attn``), a ring of
    ``min(window, max_len)`` slots with its ``pos`` plane (``local``), the
    MLA latent and rotated key (``mla``), or the float32 recurrent state
    and conv tail (``ssd``, ``rglru``)."""
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if mixer == "attn":
        shape = (b, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": z(*shape), "v": z(*shape)}
    if mixer == "local":
        w = min(cfg.window, max_len)
        shape = (b, w, cfg.n_kv_heads, cfg.head_dim)
        return {"k": z(*shape), "v": z(*shape),
                "pos": torch.full((w,), -1, dtype=torch.int32, device=dev)}
    if mixer == "mla":
        return {"latent": z(b, max_len, cfg.kv_lora),
                "krope": z(b, max_len, cfg.mla_d_rope)}
    if mixer == "ssd":
        d = _ssd_dims(cfg)
        return {"h": z(b, d.n_heads, d.d_state, d.d_head, dt=torch.float32),
                "conv": z(b, d.d_conv - 1, d.d_inner, dt=torch.float32)}
    if mixer == "rglru":
        d = _rglru_dims(cfg)
        return {"h": z(b, d.width, dt=torch.float32),
                "conv": z(b, d.d_conv - 1, d.width, dt=torch.float32)}
    raise ValueError(f"{cfg.arch_id}: no decode cache for mixer {mixer!r}")


def init_cache(cfg: ArchConfig, b: int, max_len: int, *, device=None,
               dtype=torch.bfloat16) -> Dict[str, Any]:
    """``{"layers": [one cache per layer], "len": zeros, "len_dev":
    zeros}``, plus ``cross_k``/``cross_v`` zeros over ``CROSS_MEMORY``
    positions for an enc-dec config (the reference's decode stub: nothing
    fills them, so decode's cross attention adds exactly 0).  ``len`` holds
    each sequence's length on the host ((B,) int64: no device read per
    step), ``len_dev`` the same on the device; ``set_lengths`` sets both."""
    dev = resolve_device(device)
    layers: List[Dict[str, torch.Tensor]] = [
        _layer_cache(cfg, cfg.layer_kind(i)[0], b, max_len, dev, dtype)
        for i in range(cfg.n_layers)]
    cache: Dict[str, Any] = {
        "layers": layers, "len": np.zeros(b, dtype=np.int64),
        "len_dev": torch.zeros(b, dtype=torch.int64, device=dev)}
    if cfg.n_enc_layers:
        shape = (b, CROSS_MEMORY, cfg.n_kv_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def set_lengths(cache: Dict[str, Any], lens: Union[int, Sequence[int]]):
    """Set every sequence's length (an int for all, or (B,) ints): the
    position its next token is written at, the rows below it its history.
    The host lengths, and one copy to the device."""
    b = cache["len"].shape[0]
    host = np.array(np.broadcast_to(np.asarray(lens, dtype=np.int64), (b,)))
    cache["len"] = host
    cache["len_dev"].copy_(torch.from_numpy(host))
    return cache


def takes_ragged(cfg: ArchConfig) -> bool:
    """Whether every layer's cache can hold sequences of different lengths:
    a linear cache (``attn``, ``mla``) can, a ring (``local``, one position
    plane for the batch) or a recurrent state (``ssd``, ``rglru``, no
    positions at all) cannot."""
    return all(cfg.layer_kind(i)[0] in ("attn", "mla")
               for i in range(cfg.n_layers))


def has_linear_cache(cfg: ArchConfig) -> bool:
    """Whether a layer's cache holds one slot per position (``attn``,
    ``mla``), so that ``max_len`` bounds the sequence; a ring (``local``)
    or a recurrent state does not."""
    return any(m in ("attn", "mla") for m, _ in cfg.layer_pattern())


@torch.no_grad()
@_on_mesh
def decode_step(model: LM, cache: Dict[str, Any], token: torch.Tensor,
                fixed: bool = False):
    """One new token for every sequence; token: (B, 1) integer.  Each
    sequence's token goes to its own position, its length (``cache["len"]``):
    rope, cache writes and masks are per sequence.  Returns (logits (B, 1,
    padded V), cache) — the cache's tensors are updated in place and every
    length advanced by one.  A batch of different lengths raises on a model
    whose caches cannot hold it (``takes_ragged``), as does a ``fixed`` step
    (``L.DecodeAt``: the step a CUDA graph records).  In an
    ``lm.decode_step`` span."""
    cfg = model.cfg
    at = L.DecodeAt(cache["len"], cache["len_dev"], fixed=fixed)
    if not at.uniform and not takes_ragged(cfg):
        raise ValueError(f"{cfg.arch_id}: its ring or recurrent caches hold "
                         "one position for the batch; its sequences have "
                         f"lengths {at.lens.min()} to {at.lens.max()}")
    with obs_trace.span("lm.decode_step"):
        x = embed_mod.embed_lookup(model.embed, token)
        cross_kv = ((cache["cross_k"], cache["cross_v"]) if cfg.n_enc_layers
                    else None)
        for block, layer_cache in zip(model.layers, cache["layers"]):
            x = block.decode(cfg, x, layer_cache, at, cross_kv)
        x = L.apply_norm(cfg.norm, model.final_norm, x)
        logits = embed_mod.unembed(model.embed, x)
    cache["len"] = at.lens + 1
    cache["len_dev"].add_(1)
    return logits, cache
