"""DBG-partitioned vocabulary embedding (integration K2).

Port of ``repro.lm.embed``.  After DBG frequency reordering
(``repro_torch.core.vocab``) the first ``hot_rows`` rows of the table are the
hot panel and the rest the cold tail.  A lookup of the split table is one
launch of K2 (``kernels.gather_embed``) on the card, nothing else: the split
gather over ``hot`` / ``cold`` reads int32 or int64 ids through their
stride, so a prefill step's column of the prompt needs no copy.  A table
with no cold tail, or an unsplit one, clamps its ids first (the reference's
function there differs from K2's zero rows) and goes through K2's hot-only
entry.  The lookup is differentiable in the tables (``gather_rows``: K2
forward, a deterministic plain backward), so training reaches them through
the kernel.  The unembedding is a plain matrix product.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..dist.constrain import is_sharded
from ..kernels.gather_embed import gather_rows, split_gather

__all__ = ["EmbedDims", "embed_init", "embed_lookup", "unembed"]


@dataclasses.dataclass(frozen=True)
class EmbedDims:
    vocab: int
    d_model: int
    hot_rows: int = 0  # 0 → no split (one table)
    pad_multiple: int = 2048  # Megatron-style vocab padding: 16 shards x 128

    @property
    def padded_vocab(self) -> int:
        m = self.pad_multiple
        return -(-self.vocab // m) * m

    @property
    def cold_rows(self) -> int:
        return self.padded_vocab - min(self.hot_rows, self.padded_vocab)


def _normal(shape, scale, generator, device, dtype) -> nn.Parameter:
    """N(0, scale²) from ``generator``, or uninitialised when it is None
    (the caller loads the values, as ``convert.lm_params_from_numpy`` does)."""
    t = torch.empty(shape, device=device, dtype=dtype)
    if generator is not None:
        t.normal_(generator=generator).mul_(scale)
    return nn.Parameter(t)


def embed_init(dims: EmbedDims, *, generator=None, device=None,
               dtype=torch.float32) -> nn.ParameterDict:
    """Tables sized to ``padded_vocab``: ``hot`` (and ``cold`` when the
    padded vocabulary is larger) or one ``table``, and ``unembed`` (D, V).
    Pad ids are never produced; pad logits are masked by ``generate``."""
    scale = 1.0 / math.sqrt(dims.d_model)
    v = dims.padded_vocab
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = nn.ParameterDict()
    if dims.hot_rows > 0:
        hot = min(dims.hot_rows, v)
        p["hot"] = _normal((hot, dims.d_model), scale, **kw)
        if v > hot:
            p["cold"] = _normal((v - hot, dims.d_model), scale, **kw)
    else:
        p["table"] = _normal((v, dims.d_model), scale, **kw)
    p["unembed"] = _normal((dims.d_model, v), scale, **kw)
    return p


def embed_lookup(params: nn.ParameterDict, ids: torch.Tensor) -> torch.Tensor:
    """ids: (B, S) integer, any strides → (B, S, D), one K2 launch on the
    card (after a clamp on the unsplit and hot-only tables).  Ids outside
    the padded vocabulary are clamped as the reference's gathers clamp
    them.  With DTensor tables or ids (a sharded model), each rank gathers
    its own ids from the whole tables (:class:`_ShardedLookup`)."""
    keys = tuple(k for k in ("hot", "cold", "table") if k in params)
    tables = tuple(params[k] for k in keys)
    if any(is_sharded(t) for t in (ids,) + tables):
        return _ShardedLookup.apply(ids, keys, *tables)
    return _lookup(params, ids)


def _lookup(params, ids: torch.Tensor) -> torch.Tensor:
    if ids.device.type == "meta":  # the dry run: shapes, no kernel
        table = torch.cat([params[k] for k in ("hot", "cold", "table")
                           if k in params])
        return torch.nn.functional.embedding(ids.long(), table)
    flat = ids.reshape(-1)
    if "table" in params:
        table = params["table"]
        rows = gather_rows(flat.clamp(0, table.shape[0] - 1).to(torch.int32),
                           table)
    elif "cold" in params:
        rows = split_gather(params["hot"], params["cold"], flat)
    else:  # hot only: the reference reads row 0 for an id past the panel
        hot = params["hot"]
        rows = gather_rows(torch.where(flat < hot.shape[0], flat, 0)
                           .to(torch.int32), hot)
    return rows.reshape(*ids.shape, rows.shape[-1])


class _ShardedLookup(torch.autograd.Function):
    """The lookup of a sharded model, on local tensors: K2 has no DTensor
    strategy.  Forward: every table gathered whole (``Replicate``) on every
    rank (the reference's FSDP rule shards the hot panel's columns on
    ``data`` while the ids are sharded on ``data`` too: a gather across
    both is what its sharded step cannot lower), then the plain lookup of
    this rank's ids, one K2 launch on the card; the rows carry the ids'
    placements.  Backward: the rows' gradient on those placements, K2's
    own backward on this rank's ids, each table's gradient a pending sum
    over the mesh dims that split the ids, reduced to the table's
    placements."""

    @staticmethod
    def forward(ctx, ids, keys, *tables):
        from torch.distributed.tensor import DTensor, Replicate

        ref = next(t for t in (ids,) + tables if is_sharded(t))
        mesh = ref.device_mesh
        if is_sharded(ids):
            ids_placements = tuple(ids.placements)
            ids = ids.to_local()
        else:
            ids_placements = (Replicate(),) * mesh.ndim
        whole = [(t.full_tensor() if is_sharded(t) else t).detach()
                 .requires_grad_(need)
                 for t, need in zip(tables, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            rows = _lookup(dict(zip(keys, whole)), ids)
        ctx.mesh, ctx.placements = mesh, ids_placements
        ctx.rows, ctx.whole, ctx.tables = rows, whole, tables
        return DTensor.from_local(rows.detach(), mesh, ids_placements,
                                  run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        grad = grad.redistribute(ctx.mesh, ctx.placements).to_local()
        need = [w for w in ctx.whole if w.requires_grad]
        got = iter(torch.autograd.grad(ctx.rows, need, grad))
        pending = [Partial() if isinstance(p, Shard) else Replicate()
                   for p in ctx.placements]
        out = []
        for w, t in zip(ctx.whole, ctx.tables):
            if not w.requires_grad:
                out.append(None)
                continue
            g = DTensor.from_local(next(got), ctx.mesh, pending,
                                   run_check=False)
            if is_sharded(t):
                g = g.redistribute(ctx.mesh, t.placements)
            else:
                g = g.full_tensor()
            out.append(g)
        ctx.rows = ctx.whole = ctx.tables = None
        return (None, None, *out)


def unembed(params: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) → (B, S, padded V) logits."""
    return x @ params["unembed"]
