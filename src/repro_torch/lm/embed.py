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
    them."""
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


def unembed(params: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) → (B, S, padded V) logits."""
    return x @ params["unembed"]
