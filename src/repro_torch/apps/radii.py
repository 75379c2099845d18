"""Radii Estimation — multi-source parallel BFS (Table VII, [Magnien et al.]).

Each of S sampled sources runs a BFS simultaneously; vertex v's radius
estimate is the last iteration in which v's reachability set grew.
Reachability is a (V, S) int8 matrix and the bitwise-OR reduction is a
max over {0,1} (Table VIII: 8 bytes/vertex → S=8).

Port of ``repro.apps.radii``.  The reference draws its sources with
``jax.random.choice``, which torch cannot reproduce, so here the sources are
an argument; :func:`radii_sources` draws them from a ``torch.Generator``.
"""
from __future__ import annotations

import torch

from ..obs import trace as obs_trace
from ..obs.counters import app_job, host_read
from .engine import edge_map_pull

__all__ = ["radii", "radii_sources"]


def radii_sources(num_vertices: int, num_samples: int = 8, *,
                  generator: torch.Generator) -> torch.Tensor:
    """``num_samples`` distinct vertex ids (int64) drawn from ``generator``."""
    return torch.randperm(num_vertices, generator=generator)[:num_samples]


@app_job("radii")
def radii(ga, sources: torch.Tensor, *, max_iters: int = 0):
    """Returns (radius_estimate, iterations) from the given source ids."""
    v = ga.num_vertices
    max_iters = max_iters or v
    dev = ga.device
    sources = torch.as_tensor(sources, dtype=torch.int64).to(dev)
    s = int(sources.shape[0])

    reach = torch.zeros((v, s), dtype=torch.int8, device=dev)
    reach[sources, torch.arange(s, device=dev)] = 1
    rad = torch.where(reach.any(dim=1), 0, -1).to(torch.int32)

    it, changed = 0, True
    while it < max_iters and changed:
        with obs_trace.span("apps.radii.iter"):
            pulled = edge_map_pull(ga, reach, reduce="or")
            nxt = torch.maximum(reach, pulled)
            grew = torch.any(nxt != reach, dim=1)
            rad = torch.where(grew, it + 1, rad)
            changed = bool(host_read(torch.any(grew)))
            reach, it = nxt, it + 1
    return rad, it
