"""Gorder-style structure-aware baseline (paper §II-E, §VI-A2).

Real Gorder [Wei et al., SIGMOD'16] maximizes a windowed locality score
F(pi) = sum over pairs within a window w of (common in-neighbors + direct edges)
with a greedy O(w * E) algorithm.  It is the paper's quality ceiling and its
cost strawman (100-1000x the app runtime).  We implement a faithful-but-cheap
variant with the same ingredients:

  1. BFS from the highest-degree vertex (communities are visited contiguously),
  2. within the BFS frontier, visit children grouped by parent (sibling
     grouping approximates the shared-neighbor term of Gorder's score),

This captures Gorder's *behavior* for the evaluation (structure-aware, high
quality on community graphs, expensive relative to skew-aware techniques) and
is deliberately reported under the honest name ``gorder_lite``.

The port's copy of ``repro.core.gorder_lite`` (numpy only): its mapping is
bitwise equal to the reference's (``tests/test_torch_cachesim.py``).
"""
from __future__ import annotations

import time

import numpy as np

from ..graph import csr
from .reorder import ReorderResult

__all__ = ["gorder_lite"]


def gorder_lite(g: csr.Graph, seed: int = 0) -> ReorderResult:
    t0 = time.perf_counter()
    n = g.num_vertices
    out = g.out_csr
    indptr, indices = out.indptr, out.indices
    deg = out.degrees()
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # vertices by descending degree as BFS seeds (hubs first = hub-adjacent
    # communities are laid out early, like Gorder's priority queue seeding)
    seeds = np.argsort(-deg, kind="stable")
    for s in seeds:
        if visited[s]:
            continue
        # BFS with numpy frontier expansion; children kept in parent order
        frontier = np.array([s], dtype=np.int64)
        visited[s] = True
        while frontier.size:
            order[pos : pos + frontier.size] = frontier
            pos += frontier.size
            # gather all neighbors of the frontier, parent-major order
            starts = indptr[frontier]
            ends = indptr[frontier + 1]
            counts = ends - starts
            total = int(counts.sum())
            if total == 0:
                break
            # ragged gather: offsets within concatenated neighbor lists
            offs = np.repeat(starts, counts) + (
                np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
            )
            nbrs = indices[offs]
            # de-dup while keeping first-seen (parent-major) order
            fresh_mask = ~visited[nbrs]
            nbrs = nbrs[fresh_mask]
            if nbrs.size:
                _, first = np.unique(nbrs, return_index=True)
                first.sort()
                nbrs = nbrs[first]
                visited[nbrs] = True
            frontier = nbrs
    assert pos == n, (pos, n)
    mapping = np.empty(n, dtype=np.int64)
    mapping[order] = np.arange(n, dtype=np.int64)
    # Emulate Gorder's cost profile honestly: report measured time (callers can
    # additionally scale by the paper's observed 100-1000x when modeling).
    return ReorderResult(mapping, time.perf_counter() - t0, "gorder_lite")
