"""Betweenness Centrality (BC) — pull-push BFS kernel (Table VIII).

Brandes-style: forward level-synchronous BFS accumulating shortest-path counts
(sigma), then a backward dependency sweep.  The forward sweep is
direction-optimizing: a dense frontier PULLs sigma contributions over
in-edges, a sparse one PUSHes them.  The backward sweep sums over OUT-edges
(``out_edge_sum``, edge-parallel on the flat arrays).  Port of
``repro.apps.bc``; the loops are Python loops with host-read conditions.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..obs import trace as obs_trace
from ..obs.counters import app_job, host_read
from .engine import (edge_map_pull, edge_map_push, out_edge_sum,
                     switch_by_density)

__all__ = ["bc"]


@app_job("bc")
def bc(ga, root: int, *, max_iters: int = 0,
       direction_optimizing: bool = True,
       density_threshold: Optional[float] = None):
    """Returns (centrality, dist, num_levels) for a single root."""
    v = ga.num_vertices
    max_iters = max_iters or v
    dev = ga.device

    dist = torch.full((v,), -1, dtype=torch.int32, device=dev)
    dist[root] = 0
    sigma = torch.zeros((v,), dtype=torch.float32, device=dev)
    sigma[root] = 1.0
    frontier = torch.zeros((v,), dtype=torch.bool, device=dev)
    frontier[root] = True

    # ---- forward BFS ----
    def pull_step(args):
        contrib, _ = args
        return edge_map_pull(ga, contrib, reduce="sum")

    def push_step(args):
        contrib, frontier = args
        return edge_map_push(ga, contrib, reduce="sum", src_frontier=frontier)

    levels = 0
    while levels < max_iters and bool(host_read(torch.any(frontier))):
        with obs_trace.span("apps.bc.iter"):
            # candidate sigma from in-neighbors on the frontier
            contrib = torch.where(frontier, sigma, 0.0)
            if direction_optimizing:
                sig_new = switch_by_density(ga, frontier, pull_step,
                                            push_step, (contrib, frontier),
                                            threshold=density_threshold)
            else:
                sig_new = pull_step((contrib, frontier))
            fresh = (sig_new > 0.0) & (dist < 0)
            dist = torch.where(fresh, levels + 1, dist)
            sigma = torch.where(fresh, sig_new, sigma)
            frontier = fresh
            levels += 1

    # ---- backward dependency sweep ----
    # delta[v] = sum over out-children c (dist[c] == dist[v]+1) of
    #            sigma[v]/sigma[c] * (1 + delta[c])
    sigma_safe = sigma.clamp(min=1e-30)
    delta = torch.zeros((v,), dtype=torch.float32, device=dev)
    with obs_trace.span("apps.bc.backward"):
        for level in range(levels):
            def edge_val(src, child):
                ok = dist[child] == dist[src] + 1
                return torch.where(ok,
                                   (1.0 + delta[child]) / sigma_safe[child],
                                   0.0)

            contrib = sigma * out_edge_sum(ga, edge_val)
            delta = torch.where(dist == (levels - 1 - level), contrib, delta)

    centrality = torch.where(dist >= 0, delta, 0.0)
    centrality[root] = 0.0
    return centrality, dist, levels
