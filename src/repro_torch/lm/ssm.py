"""Recurrent token mixers: Mamba-2's SSD (state-space duality) and Griffin's
RG-LRU (RecurrentGemma).  Both have a full-sequence form (train, prefill)
and a one-token form (decode) that carries explicit state.

Port of ``repro.lm.ssm``, the reference's arithmetic step by step, with
two differences in the order of float operations:
- SSD's inter-chunk state recurrence is a loop over chunks (the reference
  scans), the same sums in the same order;
- RG-LRU's linear recurrence ``h_t = a_t h_{t-1} + b_t`` is a log-depth
  (Hillis-Steele) scan, where the reference takes ``associative_scan``: the
  same recurrence, its products and sums grouped in another tree.
Decode states (``h``, ``conv``) come out in the promoted dtype of the
float32 state and the input (float32 from a float32 cache).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.constrain import einsum, full, reshape
from .embed import _normal
from .layers import _gelu, dense_init

__all__ = ["RglruDims", "SsdDims", "rglru", "rglru_decode",
           "rglru_init", "ssd", "ssd_decode", "ssd_init"]


# ---------------------------------------------------------------- Mamba-2 SSD
@dataclasses.dataclass(frozen=True)
class SsdDims:
    d_model: int
    d_state: int = 128
    d_head: int = 64
    expand: int = 2
    chunk: int = 256
    d_conv: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.d_head


def _const(values: torch.Tensor, device, dtype) -> nn.Parameter:
    return nn.Parameter(values.to(device=device, dtype=dtype))


def ssd_init(dims: SsdDims, *, generator=None, device=None,
             dtype=torch.float32) -> nn.ParameterDict:
    """The fused input projection ``in_proj`` (d, [z | x | B | C | dt]), the
    depthwise ``conv_w`` (K, d_inner) at N(0, 0.01), ``A_log`` = log of
    1..16 spaced evenly over the heads, ``D`` ones, ``dt_bias`` zeros and
    ``out_proj`` (d_inner, d)."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    di, h = dims.d_inner, dims.n_heads
    zxbcdt = 2 * di + 2 * dims.d_state + h
    return nn.ParameterDict({
        "in_proj": dense_init(dims.d_model, zxbcdt, **kw),
        "conv_w": _normal((dims.d_conv, di), 0.1, **kw),
        "A_log": _const(torch.log(torch.linspace(1.0, 16.0, h)), device,
                        dtype),
        "D": _const(torch.ones(h), device, dtype),
        "dt_bias": _const(torch.zeros(h), device, dtype),
        "out_proj": dense_init(di, dims.d_model, **kw),
    })


def _split_proj(p, x: torch.Tensor, dims: SsdDims):
    di, n = dims.d_inner, dims.d_state
    zxbcdt = x @ p["in_proj"]["w"]
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + n],
            zxbcdt[..., 2 * di + n:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(xs: torch.Tensor, conv_w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal convolution along time: xs (B, S, C), conv_w (K, C),
    ``state`` the K-1 inputs before ``xs`` (zeros when None).  Returns
    ``silu`` of the convolution and the last K-1 inputs, before the
    activation: the decode state."""
    k = conv_w.shape[0]
    pad = (full(xs, (xs.shape[0], k - 1, xs.shape[2]), 0.0, xs.dtype)
           if state is None else state)
    xp = torch.cat([pad, xs], dim=1)
    s = xs.shape[1]
    out = sum(xp[:, i:i + s] * conv_w[i] for i in range(k))
    tail = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out), tail


def ssd(params, x: torch.Tensor, dims: SsdDims) -> torch.Tensor:
    """Full-sequence SSD, chunked: within a chunk the 1-semiseparable
    attention form, across chunks the exact state recurrence.  S is padded
    with zeros to a multiple of the chunk after the real tokens (causally
    after them, so they are unaffected) and the output cut back to S."""
    bsz, s_orig, _ = x.shape
    pad = (-s_orig) % dims.chunk
    if pad:
        x = torch.cat([x, full(x, (bsz, pad, x.shape[2]), 0.0, x.dtype)],
                      dim=1)
    s = x.shape[1]
    z, xs, bmat, cmat, dt = _split_proj(params, x, dims)
    xs, _ = _causal_conv(xs, params["conv_w"])
    h, dh, n = dims.n_heads, dims.d_head, dims.d_state
    dt = F.softplus(dt + params["dt_bias"])  # (B, S, H)
    a = -torch.exp(params["A_log"])  # (H,), negative
    log_alpha = dt * a[None, None, :]  # per-step decay exp(dt · a) in (0, 1)

    nc, ch = s // dims.chunk, dims.chunk
    xh = reshape(xs, bsz, nc, ch, h, dh)
    bmat = reshape(bmat, bsz, nc, ch, n)
    cmat = reshape(cmat, bsz, nc, ch, n)
    dtc = reshape(dt, bsz, nc, ch, h)
    la_cum = torch.cumsum(reshape(log_alpha, bsz, nc, ch, h), dim=2)

    # intra-chunk: score[t, u] = C_t · B_u · exp(La_t - La_u) · dt_u, u <= t
    cb = torch.einsum("bntk,bnuk->bntu", cmat, bmat)
    seg = la_cum[:, :, :, None, :] - la_cum[:, :, None, :, :]  # (B,nc,t,u,H)
    tri = torch.ones((ch, ch), dtype=torch.bool, device=x.device).tril()
    # the mask goes INSIDE the exponent: exp of the positive upper triangle
    # would overflow, and its gradient through where() would be NaN
    seg = torch.where(tri[None, None, :, :, None], seg, float("-inf"))
    scores = cb[..., None] * torch.exp(seg) * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bntuh,bnuhd->bnthd", scores, xh)

    # each chunk's state contribution and whole-chunk decay, then the
    # recurrence over chunks: the state entering chunk c
    rem = la_cum[:, :, -1:, :] - la_cum  # (B, nc, ch, H)
    contrib = torch.einsum("bnuh,bnuk,bnuhd->bnhkd", torch.exp(rem) * dtc,
                           bmat, xh).float()  # (B, nc, H, N, dh)
    decay = torch.exp(la_cum[:, :, -1, :])  # (B, nc, H)
    state = full(contrib, (bsz, h, n, dh), 0.0, torch.float32)
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = state * decay[:, c, :, None, None] + contrib[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B, nc, H, N, dh)

    y_inter = torch.einsum("bntk,bnth,bnhkd->bnthd", cmat, torch.exp(la_cum),
                           h_in.to(x.dtype))
    y = reshape(y_intra + y_inter, bsz, s, h, dh)
    y = y + reshape(xh, bsz, s, h, dh) * params["D"][None, None, :, None]
    y = reshape(y, bsz, s, dims.d_inner) * F.silu(z)
    out = y @ params["out_proj"]["w"]
    return out[:, :s_orig] if pad else out


def ssd_decode(params, x: torch.Tensor, dims: SsdDims, hstate: torch.Tensor,
               conv_tail: torch.Tensor):
    """One-token SSD step.  x: (B, 1, d); hstate (B, H, N, dh); conv_tail
    (B, K-1, d_inner).  Returns (y (B, 1, d), hstate, conv_tail)."""
    bsz = x.shape[0]
    z, xs, bvec, cvec, dt = _split_proj(params, x, dims)
    xs, conv_tail = _causal_conv(xs, params["conv_w"], state=conv_tail)
    h, dh = dims.n_heads, dims.d_head
    xh = reshape(xs, bsz, h, dh)
    dt = F.softplus(dt + params["dt_bias"])[:, 0]  # (B, H)
    a = -torch.exp(params["A_log"])
    alpha = torch.exp(dt * a[None, :])
    hstate = hstate * alpha[..., None, None] + einsum(
        "bh,bk,bhd->bhkd", dt, bvec[:, 0], xh)
    y = einsum("bk,bhkd->bhd", cvec[:, 0].to(hstate.dtype), hstate)
    y = y + xh * params["D"][None, :, None]
    y = reshape(y, bsz, 1, dims.d_inner) * F.silu(z)
    return y @ params["out_proj"]["w"], hstate, conv_tail


# ---------------------------------------------------------------- RG-LRU
@dataclasses.dataclass(frozen=True)
class RglruDims:
    d_model: int
    d_rnn: int = 0  # defaults to d_model
    d_conv: int = 4
    c: float = 8.0  # Griffin's recurrence sharpness constant

    @property
    def width(self) -> int:
        return self.d_rnn or self.d_model


def rglru_init(dims: RglruDims, *, generator=None, device=None,
               dtype=torch.float32) -> nn.ParameterDict:
    """Input and gate branches ``in_x``/``in_gate`` (d, W), ``conv_w``
    (K, W) at N(0, 0.01), the recurrence and input gates ``rg_w``/``ig_w``
    (W, W), ``lam`` = log of 9..999 over the width (sigmoid(lam) in
    Griffin's stable band 0.9..0.999) and ``out`` (W, d)."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    w = dims.width
    return nn.ParameterDict({
        "in_x": dense_init(dims.d_model, w, **kw),
        "in_gate": dense_init(dims.d_model, w, **kw),
        "conv_w": _normal((dims.d_conv, w), 0.1, **kw),
        "rg_w": dense_init(w, w, **kw),
        "ig_w": dense_init(w, w, **kw),
        "lam": _const(torch.log(torch.linspace(9.0, 999.0, w)), device, dtype),
        "out": dense_init(w, dims.d_model, **kw),
    })


def _gates(params, xs: torch.Tensor, dims: RglruDims):
    """The step's decay ``a`` = sigmoid(lam)^(c·r) and the gated input
    ``sqrt(max(1 - a², 1e-6)) · i · x``."""
    r = torch.sigmoid(xs @ params["rg_w"]["w"])
    i = torch.sigmoid(xs @ params["ig_w"]["w"])
    log_a = dims.c * r * (-F.softplus(-params["lam"]))  # log sigmoid(lam)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return torch.exp(log_a), gated * (i * xs)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t · h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, in
    ceil(log2 S) steps: step j combines each position with the one 2^j
    before it."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru(params, x: torch.Tensor, dims: RglruDims) -> torch.Tensor:
    """Full-sequence Griffin recurrent block: x → (linear, gelu gate) →
    conv1d → RG-LRU → gate → out."""
    gate = _gelu(x @ params["in_gate"]["w"])
    xs, _ = _causal_conv(x @ params["in_x"]["w"], params["conv_w"])
    a, gated = _gates(params, xs, dims)
    return (_linear_scan(a, gated) * gate) @ params["out"]["w"]


def rglru_decode(params, x: torch.Tensor, dims: RglruDims,
                 hstate: torch.Tensor, conv_tail: torch.Tensor):
    """One-token step.  x: (B, 1, d); hstate (B, W); conv_tail (B, K-1, W).
    Returns (y (B, 1, d), hstate, conv_tail)."""
    gate = _gelu(x @ params["in_gate"]["w"])
    xs, conv_tail = _causal_conv(x @ params["in_x"]["w"], params["conv_w"],
                                 state=conv_tail)
    a, gated = _gates(params, xs[:, 0], dims)
    h = a * hstate + gated
    return (h[:, None, :] * gate) @ params["out"]["w"], h, conv_tail
