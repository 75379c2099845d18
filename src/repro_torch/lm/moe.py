"""Mixture-of-Experts with DBG stable-bin dispatch (integration K3).

Port of ``repro.lm.moe``.  Token→expert dispatch is a binning problem, and
the reference bins the DBG way rather than by Sort: each (token, choice)
slot's rank within its expert is the count of earlier same-expert slots (an
exclusive cumsum over the one-hot expert matrix), so token order is kept
inside every expert's panel.  Static, capacity-bounded shapes (GShard-style
dropping), computed from the input's shape alone; or, for a published model
that drops nothing (``drop_free``), panels of one row per token, which hold
every slot.  The top-k probabilities are renormalised to sum 1, or taken as
they are (``norm_topk`` false: DeepSeek-V2's ``norm_topk_prob``).

The port keeps the reference's arithmetic with three choices of its own:
- the top-k is a stable descending sort's first K, so equal probabilities
  take the lower expert first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order for ties on CUDA; the order feeds the ranks and the
  auxiliary loss);
- the dispatch writes each kept slot's row once, at its unique (expert,
  rank), with an ``index_copy`` (dropped slots land on rows past the panels,
  which are cut off): no float atomics, and the reference's ``.at[].add`` of
  zeros for dropped slots changes no value, so the panels are the same;
- the combine sums each token's K weighted rows in choice order (a reshape
  and a sum, deterministic) where the reference takes a ``segment_sum``.
Every expert's panel is computed, as in the reference, even an empty one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.constrain import constrain
from ..obs import trace as obs_trace
from .embed import _normal

__all__ = ["MoeDims", "capacity", "moe_apply", "moe_apply_ref", "moe_init",
           "route", "stable_bin_dispatch"]


@dataclasses.dataclass(frozen=True)
class MoeDims:
    d_model: int
    d_ff: int  # per-expert intermediate
    n_experts: int
    top_k: int
    n_shared: int = 0
    shared_d_ff: int = 0  # defaults to n_shared * d_ff
    capacity_factor: float = 1.25
    norm_topk: bool = True  # renormalise the top-k probabilities to sum 1
    drop_free: bool = False  # panels hold every slot: nothing drops


def moe_init(dims: MoeDims, *, generator=None, device=None,
             dtype=torch.float32) -> nn.ParameterDict:
    """``router.w`` (d, E), the stacked experts ``gate``/``up`` (E, d, f)
    and ``down`` (E, f, d), and with shared experts ``shared.{gate,up,down}.w``
    of width ``shared_d_ff or n_shared * d_ff``."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    e, d, f = dims.n_experts, dims.d_model, dims.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = nn.ParameterDict({
        "router": nn.ParameterDict({"w": _normal((d, e), s_in, **kw)}),
        "gate": _normal((e, d, f), s_in, **kw),
        "up": _normal((e, d, f), s_in, **kw),
        "down": _normal((e, f, d), s_out, **kw),
    })
    if dims.n_shared:
        sf = dims.shared_d_ff or dims.n_shared * f
        p["shared"] = nn.ParameterDict({
            "gate": nn.ParameterDict({"w": _normal((d, sf), s_in, **kw)}),
            "up": nn.ParameterDict({"w": _normal((d, sf), s_in, **kw)}),
            "down": nn.ParameterDict({
                "w": _normal((sf, d), 1.0 / math.sqrt(sf), **kw)}),
        })
    return p


def capacity(t: int, dims: MoeDims) -> int:
    """Rows per expert panel for ``t`` tokens: ``ceil(t·K·cf / E)`` rounded
    up to a multiple of 8, at least 8 (from the static shape only); with
    ``drop_free``, ``t`` so rounded (a token sends an expert one slot at
    most, so no slot drops)."""
    if dims.drop_free:
        c = t
    else:
        c = int(math.ceil(t * dims.top_k * dims.capacity_factor
                          / dims.n_experts))
    return max(8, -(-c // 8) * 8)


def route(params, xt: torch.Tensor, dims: MoeDims):
    """Router of ``xt`` (T, d): the float32 softmax ``probs`` (T, E), the top-K
    experts ``top_e`` (T, K) int64 in descending probability (ties: lower
    expert first) and their probabilities ``top_p``, renormalized to sum 1
    unless ``dims.norm_topk`` is false.  The logits in float32 whatever the
    weights' dtype, as DeepSeek-V2's gate computes them."""
    logits = xt.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt[:, :dims.top_k], idx[:, :dims.top_k]
    if dims.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, top_e, top_p


def stable_bin_dispatch(expert_ids: torch.Tensor, n_experts: int,
                        capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """DBG stable binning of (token, choice) slots into expert bins.

    ``expert_ids`` (T, K) integer → ``rank`` (T, K) int32, the slot's
    position inside its expert's panel (the number of earlier slots, in
    ``t·K + j`` order, with the same expert), and ``keep`` (T, K), False
    for the slots at or past ``capacity``."""
    t, k = expert_ids.shape
    flat = expert_ids.reshape(t * k).long()
    onehot = F.one_hot(flat, n_experts).to(torch.int32)  # (T*K, E)
    rank = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    rank = rank.gather(1, flat[:, None])[:, 0]
    return rank.reshape(t, k), (rank < capacity).reshape(t, k)


def _shared(params, xt: torch.Tensor) -> torch.Tensor:
    sp = params["shared"]
    hs = F.silu(xt @ sp["gate"]["w"]) * (xt @ sp["up"]["w"])
    return hs @ sp["down"]["w"]


def moe_apply(params, x: torch.Tensor, dims: MoeDims):
    """x: (B, S, d) → (out (B, S, d), aux): the routed top-K experts through
    capacity-bounded panels, plus the shared experts; ``aux`` is the
    Switch load-balance loss ``E · Σ_e f_e · p_e`` over the first
    choices.  In an ``lm.moe`` span."""
    with obs_trace.span("lm.moe"):
        return _moe_apply(params, x, dims)


def _moe_apply(params, x: torch.Tensor, dims: MoeDims):
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e, k = dims.n_experts, dims.top_k
    probs, top_e, top_p = route(params, xt, dims)
    cap = capacity(t, dims)
    rank, keep = stable_bin_dispatch(top_e, e, cap)

    flat_e = top_e.reshape(t * k)
    flat_keep = keep.reshape(t * k)
    flat_r = torch.where(flat_keep, rank.reshape(t * k).long(), cap - 1)
    flat_w = torch.where(keep, top_p, 0.0).reshape(t * k)
    src = torch.arange(t, device=x.device).repeat_interleave(k)
    # each kept slot's unique row of the (E·C) panels; a dropped slot its
    # own row past them
    dest = torch.where(flat_keep, flat_e * cap + flat_r,
                       e * cap + torch.arange(t * k, device=x.device))
    rows = torch.zeros((e * cap + t * k, d), dtype=x.dtype, device=x.device)
    panels = rows.index_copy(0, dest, xt[src])[:e * cap].view(e, cap, d)
    # capacity rows on the batch axes, the FF dim on 'model' through the
    # weights' placements (no-ops off a mesh)
    panels = constrain(panels, None, "batch", None)

    h = F.silu(torch.bmm(panels, params["gate"]))
    h = h * torch.bmm(panels, params["up"])
    h = constrain(h, None, "batch", "model")
    out_panels = torch.bmm(h, params["down"])  # (E, C, d)
    out_panels = constrain(out_panels, None, "batch", None)

    gathered = out_panels[flat_e, flat_r]  # (T*K, d)
    yt = (gathered * flat_w[:, None]).reshape(t, k, d).sum(dim=1)
    if "shared" in params:
        yt = yt + _shared(params, xt)

    frac = F.one_hot(top_e[:, 0], e).float().mean(dim=0)
    aux = e * (frac * probs.mean(dim=0)).sum()
    return yt.reshape(b, s, d).to(x.dtype), aux


def moe_apply_ref(params, x: torch.Tensor, dims: MoeDims) -> torch.Tensor:
    """Dense oracle (no capacity drops): every token through its top-K
    experts by a full (T, E) weighting; the tests hold ``moe_apply`` to it
    where nothing drops."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    _, top_e, top_p = route(params, xt, dims)
    weights = torch.zeros((t, dims.n_experts), dtype=torch.float32,
                          device=x.device).scatter(1, top_e, top_p)
    h = F.silu(torch.einsum("td,edf->tef", xt, params["gate"]))
    h = h * torch.einsum("td,edf->tef", xt, params["up"])
    oe = torch.einsum("tef,efd->ted", h, params["down"])
    yt = torch.einsum("te,ted->td", weights, oe)
    if "shared" in params:
        yt = yt + _shared(params, xt)
    return yt.reshape(b, s, d).to(x.dtype)
