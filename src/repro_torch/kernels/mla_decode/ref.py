"""The absorbed MLA decode attention in plain PyTorch: the CPU's path and
the card tests' yardstick for ``csrc/mla_decode.cu``.

The same equations as the kernel, in the same order of the online softmax:
the rows of each sequence in chunks, each chunk upcast to float32 alone
(no float32 copy of the whole cache), scores masked past the sequence's
own row count and the rows there read as zeros, as the kernel never reads
them, a running max, sum and output per head."""
from __future__ import annotations

import torch

__all__ = ["latent_attention_ref"]


def latent_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         cache_latent: torch.Tensor,
                         cache_krope: torch.Tensor, rows: torch.Tensor,
                         scale: float, max_rows: int,
                         chunk: int = 4096) -> torch.Tensor:
    """``o[b, h] = sum_t softmax_t(s[b, h, t]) cache_latent[b, t]`` over
    ``t < rows[b]``, ``s = (q_lat[b, h] . cache_latent[b, t] + q_rope[b, h]
    . cache_krope[b, t]) * scale``; float32 (B, H, C).  ``q_lat`` (B, H,
    C), ``q_rope`` (B, H, R), the caches (B, S, C) and (B, S, R) in any
    float dtype, ``rows`` (B,) integer on their device with ``1 <=
    rows[b] <= max_rows <= S``."""
    b, h, c = q_lat.shape
    dev = q_lat.device
    ql, qr = q_lat.float(), q_rope.float()
    m = torch.full((b, h), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, c), dtype=torch.float32, device=dev)
    for s0 in range(0, max_rows, chunk):
        s1 = min(s0 + chunk, max_rows)
        t = torch.arange(s0, s1, device=dev)
        valid = t[None, :] < rows.to(dev)[:, None]  # (B, s)
        lat = cache_latent[:, s0:s1].float().masked_fill(~valid[..., None], 0)
        sc = torch.einsum("bhc,bsc->bhs", ql, lat)
        sc = sc + torch.einsum("bhr,bsr->bhs", qr,
                               cache_krope[:, s0:s1].float())
        sc = sc * scale
        sc = sc.masked_fill(~valid[:, None, :], float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(torch.isfinite(m_new)[..., None], p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhs,bsc->bhc", p, lat)
        m = m_new
    return acc / l.clamp(min=1e-30)[..., None]
