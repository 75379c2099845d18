"""Single-Source Shortest Path (SSSP) — frontier Bellman-Ford (Table VIII).

Direction-optimizing (Ligra's pull/push switch): each round the engine
inspects ``frontier_density`` — a sparse frontier relaxes by PUSH, a dense
one by PULL.  Both directions relax the identical edge set with a
min-reduction, so the result is bit-identical either way.  Port of
``repro.apps.sssp``: the ``lax.cond`` switch is a Python ``if`` and the loop
condition a host read, two syncs per round.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..obs import trace as obs_trace
from ..obs.counters import app_job, host_read
from .engine import edge_map_pull, edge_map_push, switch_by_density

__all__ = ["sssp"]


@app_job("sssp")
def sssp(ga, root: int, *, max_iters: int = 0,
         direction_optimizing: bool = True,
         density_threshold: Optional[float] = None):
    """Returns (dist, iterations). Unreachable vertices keep +inf."""
    v = ga.num_vertices
    max_iters = max_iters or v  # Bellman-Ford bound
    inf = float("inf")

    dist = torch.full((v,), inf, dtype=torch.float32, device=ga.device)
    dist[root] = 0.0
    frontier = torch.zeros((v,), dtype=torch.bool, device=ga.device)
    frontier[root] = True

    def push_step(args):
        dist, frontier = args
        # inactive sources push +inf (neutral for min)
        return edge_map_push(ga, dist, reduce="min", src_frontier=frontier,
                             use_weights=True, neutral=inf, init=dist)

    def pull_step(args):
        dist, frontier = args
        pulled = edge_map_pull(ga, dist, reduce="min", src_frontier=frontier,
                               use_weights=True, neutral=inf)
        return torch.minimum(dist, pulled)

    it = 0
    while it < max_iters and bool(host_read(torch.any(frontier))):
        with obs_trace.span("apps.sssp.iter"):
            if direction_optimizing:
                cand = switch_by_density(ga, frontier, pull_step, push_step,
                                         (dist, frontier),
                                         threshold=density_threshold)
            else:
                cand = push_step((dist, frontier))
            frontier = cand < dist
            dist, it = cand, it + 1
    return dist, it
