"""Assigned-architecture registry: one module per arch.

A copy of ``repro.configs`` (the configs are data); the port keeps its own so
that it imports nothing of ``repro``.  The parity tests hold every field of
every arch equal to the reference's."""
from __future__ import annotations

from importlib import import_module

from .base import ArchConfig, SHAPES, ShapeCell, reduced  # noqa: F401

ARCH_IDS = [
    "seamless_m4t_large_v2",
    "yi_9b",
    "yi_34b",
    "granite_20b",
    "olmo_1b",
    "paligemma_3b",
    "grok_1_314b",
    "deepseek_v2_lite_16b",
    "recurrentgemma_9b",
    "mamba2_780m",
]


def get_config(arch_id: str) -> ArchConfig:
    key = arch_id.replace("-", "_")
    mod = import_module(f"{__name__}.{key}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


def applicable_shapes(cfg: ArchConfig):
    """Shape cells that apply to this arch (long_500k needs sub-quadratic)."""
    out = []
    for name, cell in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic:
            continue  # documented skip: pure full-attention arch
        out.append(cell)
    return out
