"""PageRank (PR) — pull-only (Table VIII), iterated to convergence.

Port of ``repro.apps.pagerank``: the ``lax.while_loop`` is a Python loop
whose condition reads ``err`` on the host, one sync per iteration.
"""
from __future__ import annotations

import torch

from ..obs import trace as obs_trace
from ..obs.counters import app_job, host_read
from .engine import edge_map_pull

__all__ = ["pagerank"]


@app_job("pagerank")
def pagerank(ga, *, damping: float = 0.85, max_iters: int = 64,
             tol: float = 1e-7):
    """Returns (ranks, iterations). Dangling mass redistributed uniformly."""
    v = ga.num_vertices
    out_deg = ga.out_deg.clamp(min=1).to(torch.float32)
    dangling = (ga.out_deg == 0).to(torch.float32)

    rank = torch.full((v,), 1.0 / v, dtype=torch.float32, device=ga.device)
    it, going = 0, True
    while it < max_iters and going:
        with obs_trace.span("apps.pagerank.iter"):
            contrib = rank / out_deg
            pulled = edge_map_pull(ga, contrib, reduce="sum")
            dangling_mass = torch.sum(rank * dangling) / v
            new = (1.0 - damping) / v + damping * (pulled + dangling_mass)
            err = torch.sum(torch.abs(new - rank))
            rank, it = new, it + 1
            # float32 compare, as the reference's cond
            going = bool(host_read(err > tol))
    return rank, it
