"""Batched graph queries: K roots / personalization vectors in ONE edge-map
pass per iteration.

Port of ``repro.serve.batched``.  The paper's case for DBG is hot-vertex
reuse; nothing amplifies that reuse like serving many concurrent queries
over the same reordered graph.  Here the property plane is 2D end-to-end —
``(V, K)`` for K queries — so every iteration of every query rides a single
edge map (on ``ell``/``packed`` one grouped K5 call reads the
tile/idx/frontier structure ONCE for all K lanes), routed through the same
``apps.engine`` primitives as the single-query apps, on any registered
backend (flat oracle, ell, packed, the stream plane's ``StreamBackend``).
Every reduction is the engine's (K5, sorted segments, the stream maps): no
float atomics, so two runs of a batch are bitwise equal.

The reference's ``lax.while_loop``s are Python loops, as in
``apps.pagerank`` / ``apps.sssp``: the loop condition is one host read per
iteration (SSSP reads its pull/push switch in the same read).

Ragged batches are handled with per-query convergence masks: a query that
converged at iteration t is frozen (PageRank) or has an empty frontier
(SSSP), so it stops contributing updates while the rest of the batch runs on
— the batched result for each lane equals the independent single-query run
(min-relaxations bitwise, sums to fp association).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..apps.engine import DENSITY_THRESHOLD, edge_map_pull, edge_map_push

__all__ = ["batched_pagerank", "batched_sssp", "batch_frontier_density"]


def batch_frontier_density(ga, frontier: torch.Tensor) -> torch.Tensor:
    """Fraction of (edge, lane) slots touched by a (V, K) frontier — the
    batched analogue of ``engine.frontier_density`` (Ligra's pull/push
    switch statistic, averaged over the K query lanes); a float32 scalar
    tensor on the frontier's device."""
    k = frontier.shape[1]
    e = ga.out_deg.sum().clamp(min=1) * k
    return torch.where(frontier, ga.out_deg[:, None], 0).sum() / e


def batched_pagerank(
    ga,
    personalization: torch.Tensor,  # (V, K) teleport vectors, columns sum to 1
    *,
    damping: float = 0.85,
    max_iters: int = 64,
    tol: float = 1e-7,
):
    """K personalized-PageRank vectors in one fused pull per iteration.

    Returns ``(ranks (V, K) float32, iters (K,) int32)``.  Per-query
    semantics match a K=1 call exactly: lane k iterates until its OWN
    L1 delta drops below ``tol`` (or ``max_iters``), then freezes while the
    rest of the batch converges — a ragged batch loses nothing.  Dangling
    mass teleports by the lane's personalization vector; a uniform column
    (``1/V``) reproduces global ``apps.pagerank`` to fp association.
    """
    p = personalization.to(torch.float32)
    k = p.shape[1]
    dev = p.device
    out_deg = ga.out_deg.clamp(min=1).to(torch.float32)
    dangling = (ga.out_deg == 0).to(torch.float32)

    rank = p  # start at the teleport distribution (K=1 uniform == pagerank)
    active = torch.ones((k,), dtype=torch.bool, device=dev)
    iters = torch.zeros((k,), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters and bool(active.any()):
        contrib = rank / out_deg[:, None]
        pulled = edge_map_pull(ga, contrib, reduce="sum")  # ONE fused pass
        dmass = torch.sum(rank * dangling[:, None], dim=0)  # (K,)
        new = (1.0 - damping) * p + damping * (pulled + dmass[None, :] * p)
        err = torch.sum(torch.abs(new - rank), dim=0)  # (K,) per-query L1
        rank = torch.where(active[None, :], new, rank)  # frozen lanes hold
        iters = torch.where(active, it + 1, iters).to(torch.int32)
        active = active & (err > tol)
        it += 1
    return rank, iters


def batched_sssp(
    ga,
    roots: torch.Tensor,  # (K,) source vertices
    *,
    max_iters: int = 0,
    direction_optimizing: bool = True,
    density_threshold: Optional[float] = None,
):
    """K SSSP roots in one fused edge map per iteration.

    Returns ``(dist (V, K) float32, iters (K,) int32)``.  Frontier
    Bellman-Ford with a per-query (V, K) frontier: a finished query's lane
    is empty, so it contributes only the min-identity and stops doing work.
    Min-relaxation is exactly associative, so each lane is BIT-identical to
    the independent ``apps.sssp`` run whatever direction the batch takes —
    the pull/push switch (on the batch-mean frontier density) is purely a
    traffic choice.  On an unweighted graph this is K-source BFS levels.
    Duplicate roots in one batch are fine: each lane is its own column.
    """
    v = ga.num_vertices
    dev = ga.out_deg.device
    roots = torch.as_tensor(roots, dtype=torch.int64, device=dev)
    k = roots.shape[0]
    max_iters = max_iters or v  # Bellman-Ford bound
    threshold = (DENSITY_THRESHOLD if density_threshold is None
                 else density_threshold)
    inf = float("inf")

    lanes = torch.arange(k, device=dev)
    dist = torch.full((v, k), inf, dtype=torch.float32, device=dev)
    dist.index_put_((roots, lanes),
                    torch.zeros((), dtype=torch.float32, device=dev))
    frontier = torch.zeros((v, k), dtype=torch.bool, device=dev)
    frontier.index_put_((roots, lanes),
                        torch.ones((), dtype=torch.bool, device=dev))

    def push_step(dist, frontier):
        return edge_map_push(ga, dist, reduce="min", src_frontier=frontier,
                             use_weights=True, neutral=inf, init=dist)

    def pull_step(dist, frontier):
        pulled = edge_map_pull(ga, dist, reduce="min", src_frontier=frontier,
                               use_weights=True, neutral=inf)
        return torch.minimum(dist, pulled)

    iters = torch.zeros((k,), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters:
        # one host read: is anything left, and which direction (a float32
        # comparison on the device, as the reference's lax.cond)
        any_left, dense = torch.stack([
            frontier.any(),
            batch_frontier_density(ga, frontier) > threshold]).tolist()
        if not any_left:
            break
        if direction_optimizing and dense:
            cand = pull_step(dist, frontier)
        else:
            cand = push_step(dist, frontier)
        iters = torch.where(frontier.any(dim=0), it + 1, iters).to(torch.int32)
        frontier = cand < dist
        dist, it = cand, it + 1
    return dist, iters
