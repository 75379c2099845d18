"""Where the port's entry points run.

Entry points run on the CUDA card unless the caller asks for the CPU: a
``device`` of ``None`` resolves to ``torch.device("cuda")``, and raises when
this process has no CUDA — it never moves to the CPU quietly.  The CPU path
exists for the tests, which pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → the CUDA card (or ``RuntimeError`` without one); anything
    else is taken as given, and a CUDA device is checked for availability."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and this process has "
            "none; pass device='cpu' to run the plain PyTorch path")
    return dev


def to_device(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array on ``device``, cast to the numpy ``dtype`` first when one
    is given, else at its stored dtype.  uint32 crosses as its int32 bit
    pattern and is viewed back, so only copies and views ever touch torch's
    thinly supported uint32."""
    a = np.ascontiguousarray(a if dtype is None else a.astype(dtype, copy=False))
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)
    return torch.from_numpy(a).to(device)
