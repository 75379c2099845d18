"""What the program records about itself: the counts and set-up seconds
in its registry (``repro_torch.obs.metrics.get_registry()``), read in the
program's process once the windows are over.  They cover the whole run:
set-up, the warm-up and both windows.  A program that records none of
them reads ``None`` here."""
from __future__ import annotations

from typing import Optional

__all__ = ["value", "total", "phase_seconds"]


def _registry():
    from repro_torch.obs.metrics import get_registry

    return get_registry()


def value(name: str) -> Optional[float]:
    """The registry's counter ``name``; ``None`` where it is absent or 0."""
    v = getattr(_registry().get(name), "value", None)
    return v if v else None


def total(prefix: str) -> Optional[float]:
    """The sum of every counter whose name starts with ``prefix``;
    ``None`` where that is 0."""
    return sum(value(n) or 0 for n in _registry().names()
               if n.startswith(prefix)) or None


def phase_seconds(prefix: str, phase: str) -> Optional[float]:
    """``<prefix>.<phase>_s``, the seconds of one phase of a set-up call,
    where the process made that call once (``<prefix>.calls`` is 1)."""
    if value(f"{prefix}.calls") != 1:
        return None
    return value(f"{prefix}.{phase}_s")
