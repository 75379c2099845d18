"""The plain reference of the graph cells: DBG and the five apps.

Written from the paper (Listing 1 and Table V for DBG, Table VII for the
apps) in plain PyTorch and NumPy over an edge list in the original vertex
ids.  It imports nothing of the program and takes nothing the program made:
the benchmark hands it the same edges and job parameters it hands the
program, and it works the rest out again.  ``dtype`` is the precision of
every floating-point value and sum; the benchmark runs it in float64, and
its control runs it in bfloat16.  Sums go through ``index_add_`` (float
atomics on a card: their order is free, so only the precision matters).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Edges", "dbg_mapping", "pagerank", "pagerank_delta", "sssp",
           "bc", "radii"]


class Edges(NamedTuple):
    """``src[i] -> dst[i]`` (int64) with weights ``w`` (float32 or None),
    on one device, and the out-degree of every vertex (int64)."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    out_deg: torch.Tensor
    num_vertices: int


def dbg_mapping(degrees: np.ndarray) -> np.ndarray:
    """DBG's new id of every vertex (the paper's 8 groups).

    With A the mean degree, the groups, hottest first, are [32A, inf),
    [16A, 32A), [8A, 16A), [4A, 8A), [2A, 4A), [A, 2A), [A/2, A) and
    [0, A/2), each bound rounded up to a whole degree (A at least 1; two
    bounds that round alike are one).  Vertices keep their original order
    inside a group, and groups are laid out hottest first."""
    degrees = np.asarray(degrees, dtype=np.int64)
    a = max(1.0, float(degrees.mean()) if degrees.size else 1.0)
    bounds = [math.ceil(a * 2 ** i) for i in range(5, -1, -1)]
    bounds += [max(1, math.ceil(a / 2)), 0]
    lower = sorted(set(bounds), reverse=True)
    group = np.zeros(degrees.shape[0], dtype=np.int64)
    for b in lower[:-1]:
        group += degrees < b  # one more group down per bound not reached
    order = np.argsort(group, kind="stable")
    mapping = np.empty_like(order)
    mapping[order] = np.arange(order.shape[0])
    return mapping


def _pull_sum(e: Edges, vals: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((e.num_vertices,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, e.dst, vals[e.src])


def pagerank(e: Edges, *, damping: float, tol: float, dtype,
             max_iters: int = 64):
    """(ranks, iterations): pull PageRank from 1/V, dangling mass spread
    evenly, until the L1 change is at most ``tol``."""
    v = e.num_vertices
    deg = e.out_deg.clamp(min=1).to(dtype)
    dangling = (e.out_deg == 0).to(dtype)
    rank = torch.full((v,), 1.0 / v, dtype=dtype, device=e.src.device)
    it = 0
    while it < max_iters:
        pulled = _pull_sum(e, rank / deg)
        new = (1.0 - damping) / v + damping * (pulled
                                               + (rank * dangling).sum() / v)
        err = (new - rank).abs().sum()
        rank, it = new, it + 1
        if not bool(err > tol):
            break
    return rank, it


def pagerank_delta(e: Edges, *, damping: float, epsilon: float, dtype,
                   max_iters: int = 64):
    """(ranks, iterations): vertices whose last change exceeds
    ``epsilon`` push it, damped, along their out-edges."""
    v = e.num_vertices
    deg = e.out_deg.clamp(min=1).to(dtype)
    rank = torch.full((v,), (1.0 - damping) / v, dtype=dtype,
                      device=e.src.device)
    delta = rank
    it = 0
    while it < max_iters:
        active = delta.abs() > epsilon
        if not bool(active.any()):
            break
        delta = damping * _pull_sum(e, torch.where(active, delta / deg, 0))
        rank = rank + delta
        it += 1
    return rank, it


def sssp(e: Edges, root: int, *, dtype):
    """Shortest distances from ``root`` along weighted edges (+inf where
    unreachable): Bellman-Ford to its fixed point."""
    dist = torch.full((e.num_vertices,), math.inf, dtype=dtype,
                      device=e.src.device)
    dist[root] = 0
    w = e.w.to(dtype)
    while True:
        cand = dist.scatter_reduce(0, e.dst, dist[e.src] + w, reduce="amin",
                                   include_self=True)
        if torch.equal(cand, dist):
            return dist
        dist = cand


def bc(e: Edges, root: int, *, dtype):
    """(centrality, BFS levels) of one root, by Brandes: shortest-path
    counts level by level along out-edges, then each vertex's dependency
    sigma[v] * sum over children c one level deeper of (1 + dep[c]) /
    sigma[c]; the root and unreachable vertices get 0, levels -1 where
    unreachable."""
    v, dev = e.num_vertices, e.src.device
    level = torch.full((v,), -1, dtype=torch.int64, device=dev)
    level[root] = 0
    sigma = torch.zeros(v, dtype=dtype, device=dev)
    sigma[root] = 1
    frontier = torch.zeros(v, dtype=torch.bool, device=dev)
    frontier[root] = True
    depth = 0
    while bool(frontier.any()):
        reached = _pull_sum(e, torch.where(frontier, sigma, 0))
        fresh = (level < 0) & (reached > 0)
        level[fresh] = depth + 1
        sigma = torch.where(fresh, reached, sigma)
        frontier = fresh
        depth += 1
    dep = torch.zeros(v, dtype=dtype, device=dev)
    child = level[e.dst] == level[e.src] + 1
    for d in range(depth - 1, -1, -1):
        term = torch.where(child, (1 + dep[e.dst]) / sigma[e.dst].clamp(
            min=1e-30), 0)
        acc = torch.zeros(v, dtype=dtype, device=dev).index_add_(0, e.src,
                                                                  term)
        dep = torch.where(level == d, sigma * acc, dep)
    dep = torch.where(level >= 0, dep, 0)
    dep[root] = 0
    return dep, level


def radii(e: Edges, sources: torch.Tensor):
    """Radius estimate of every vertex from a multi-source BFS: the last
    round in which the set of sources that reach it grew (0 at a source,
    -1 if no source reaches it)."""
    v, dev = e.num_vertices, e.src.device
    s = int(sources.shape[0])
    reach = torch.zeros((v, s), dtype=torch.bool, device=dev)
    reach[sources.to(dev), torch.arange(s, device=dev)] = True
    rad = torch.where(reach.any(dim=1), 0, -1)
    it = 0
    while True:
        pulled = torch.zeros((v, s), dtype=torch.int32, device=dev)
        pulled.index_add_(0, e.dst, reach[e.src].to(torch.int32))
        nxt = reach | (pulled > 0)
        grew = (nxt != reach).any(dim=1)
        if not bool(grew.any()):
            return rad
        rad = torch.where(grew, it + 1, rad)
        reach, it = nxt, it + 1
