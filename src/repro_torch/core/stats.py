"""Skew analytics reproducing Tables I-IV of the paper.

The port's copy of ``repro.core.stats`` (numpy only), on the port's
``graph.csr``."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..graph import csr

__all__ = [
    "hot_vertex_stats",
    "hot_per_cache_block",
    "hot_footprint_mb",
    "degree_range_distribution",
]


def hot_vertex_stats(g: csr.Graph) -> Dict[str, float]:
    """Table I: % hot vertices (degree >= avg) and % edges they cover, per direction."""
    out: Dict[str, float] = {}
    for direction, degs in (("in", g.in_degrees()), ("out", g.out_degrees())):
        a = degs.mean() if degs.size else 0.0
        hot = degs >= max(1.0, a)
        out[f"{direction}_hot_vertex_pct"] = 100.0 * hot.mean()
        total = degs.sum()
        out[f"{direction}_edge_coverage_pct"] = (
            100.0 * degs[hot].sum() / total if total else 0.0
        )
    return out


def hot_per_cache_block(
    g: csr.Graph, *, bytes_per_vertex: int = 8, block_bytes: int = 64,
    degree_source: str = "out",
) -> float:
    """Table II: average number of hot vertices per cache block, counting only
    blocks containing at least one hot vertex.  Assumes the ORIGINAL ordering
    (vertex id v lives at block v // vertices_per_block)."""
    degs = g.out_degrees() if degree_source == "out" else g.in_degrees()
    a = degs.mean() if degs.size else 0.0
    hot = degs >= max(1.0, a)
    vpb = block_bytes // bytes_per_vertex
    n_blocks = (g.num_vertices + vpb - 1) // vpb
    block_of = np.arange(g.num_vertices) // vpb
    hot_in_block = np.bincount(block_of[hot], minlength=n_blocks)
    occupied = hot_in_block > 0
    return float(hot_in_block[occupied].mean()) if occupied.any() else 0.0


def hot_footprint_mb(
    g: csr.Graph, *, bytes_per_vertex: int = 8, degree_source: str = "out"
) -> float:
    """Table III: capacity needed to store all hot vertex properties."""
    degs = g.out_degrees() if degree_source == "out" else g.in_degrees()
    a = degs.mean() if degs.size else 0.0
    hot = int((degs >= max(1.0, a)).sum())
    return hot * bytes_per_vertex / (1024 * 1024)


def degree_range_distribution(
    g: csr.Graph, *, degree_source: str = "out", bytes_per_vertex: int = 8
) -> Dict[str, Dict[str, float]]:
    """Table IV: distribution of HOT vertices across geometric degree ranges
    [1A,2A) [2A,4A) [4A,8A) [8A,16A) [16A,32A) [32A,inf)."""
    degs = g.out_degrees() if degree_source == "out" else g.in_degrees()
    a = max(1.0, degs.mean() if degs.size else 1.0)
    hot_degs = degs[degs >= a]
    total_hot = max(1, hot_degs.size)
    out: Dict[str, Dict[str, float]] = {}
    edges = [(1, 2), (2, 4), (4, 8), (8, 16), (16, 32), (32, np.inf)]
    for lo, hi in edges:
        m = (hot_degs >= lo * a) & (hot_degs < (hi * a if np.isfinite(hi) else np.inf))
        label = f"[{lo}A,{'inf' if not np.isfinite(hi) else str(hi)+'A'})"
        out[label] = {
            "vertex_pct": 100.0 * m.sum() / total_hot,
            "footprint_mb": m.sum() * bytes_per_vertex / (1024 * 1024),
        }
    return out
