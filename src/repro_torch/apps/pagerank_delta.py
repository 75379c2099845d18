"""PageRank-Delta (PRD) — push-only (Table VIII).

Vertices are active only while they have accumulated enough change in their
score; active vertices PUSH their delta to out-neighbors (irregular writes —
the coherence-heavy mode analyzed in paper §VI-C / Fig 9).  Port of
``repro.apps.pagerank_delta``; the loop condition is one host sync per
iteration.
"""
from __future__ import annotations

import torch

from ..obs import trace as obs_trace
from ..obs.counters import app_job, host_read
from .engine import edge_map_push

__all__ = ["pagerank_delta"]


@app_job("pagerank_delta")
def pagerank_delta(ga, *, damping: float = 0.85, max_iters: int = 64,
                   epsilon: float = 1e-7):
    """Returns (ranks, iterations).  Converges to the same fixed point as PR;
    ``epsilon`` is the activity threshold on |delta|."""
    v = ga.num_vertices
    out_deg = ga.out_deg.clamp(min=1).to(torch.float32)
    base = (1.0 - damping) / v

    rank = torch.full((v,), base, dtype=torch.float32, device=ga.device)
    delta = rank  # first-round delta = initial mass (standard PRDelta seed)
    it = 0
    while it < max_iters and bool(
            host_read(torch.any(torch.abs(delta) > epsilon))):
        with obs_trace.span("apps.pagerank_delta.iter"):
            frontier = torch.abs(delta) > epsilon
            pushed = edge_map_push(ga, delta / out_deg, reduce="sum",
                                   src_frontier=frontier)
            delta = damping * pushed
            rank = rank + delta
            it += 1
    return rank, it
