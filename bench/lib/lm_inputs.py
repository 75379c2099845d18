"""The LM cells' inputs, made on the device from the seed: the model's
weights and each resident conversation's history in the latent cache.

Every tensor has a random stream of its own (``inputs.generator(seed,
stream)``), named after what it fills, so the check can draw any one of
them again without the others.  Weights: every matrix N(0, 1/fan_in), the
program's own initialisation (fan_in the input width: dim -2 of an (in,
out) matrix or of an expert stack (E, in, out), the model width of an
embedding table); every RMSNorm scale U(0.5, 1.5), so that a norm left
out shows.  A history: per layer and slot, latent rows of N(0, 1) scaled
to RMS 1 and times that layer's ``kv_norm`` scale, as the latent norm
leaves a row, and N(0, 1) rotated rope keys.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .inputs import generator

__all__ = ["draw_weights", "history_rows"]


def _fan_in(name: str, shape: Tuple[int, ...], d_model: int) -> int:
    if name in ("embed.hot", "embed.cold", "embed.table"):
        return d_model
    return shape[-2]


def draw_weights(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 d_model: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """One tensor per name of ``shapes`` (name → (shape, dtype)), drawn in
    its dtype on ``device``."""
    out = {}
    for name, (shape, dtype) in shapes.items():
        g = generator(seed, f"weights.{name}", device)
        if name.endswith(".scale"):
            t = torch.rand(shape, generator=g, device=device,
                           dtype=torch.float32).add_(0.5)
        else:
            t = torch.randn(shape, generator=g, device=device,
                            dtype=torch.float32)
            t.mul_(_fan_in(name, shape, d_model) ** -0.5)
        out[name] = t.to(dtype)
        del t
    return out


def history_rows(seed: int, layer: int, slot: int, rows: int,
                 kv_norm_scale: torch.Tensor, d_rope: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``rows`` cached rows of ``slot`` in ``layer``: the latent
    (rows, kv_lora) and the rope key (rows, d_rope), float32."""
    g = generator(seed, f"history.{layer}.{slot}", device)
    latent = torch.randn((rows, kv_norm_scale.shape[0]), generator=g,
                         device=device, dtype=torch.float32)
    latent *= torch.rsqrt(latent.square().mean(-1, keepdim=True))
    latent *= kv_norm_scale.float()
    krope = torch.randn((rows, d_rope), generator=g, device=device,
                        dtype=torch.float32)
    return latent, krope
