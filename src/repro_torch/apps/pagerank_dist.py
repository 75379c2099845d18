"""Sharded PageRank — the apps-level entry to the ``repro_torch.dist.graph``
engine.

Port of ``repro.apps.pagerank_dist``: single-device ``apps.pagerank``
numerics over the ranks of a ``torch.distributed`` process group, one rank
per shard — destination-sharded edges, DBG-hot property replication
(policy ``"replicate_hot"``) or pure owner-partitioning (``"partition"``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..dist import graph as dist_graph
from ..dist.graph import GraphMesh, make_graph_mesh
from .engine import GraphArrays, to_arrays

__all__ = ["pagerank_dist", "make_graph_mesh"]


def pagerank_dist(
    g,
    *,
    mesh: Optional[GraphMesh] = None,
    n_shards: Optional[int] = None,
    policy: str = "replicate_hot",
    backend: str = "flat",
    damping: float = 0.85,
    max_iters: int = 64,
    tol: float = 1e-7,
) -> Tuple[torch.Tensor, int, dist_graph.ShardedGraphArrays]:
    """Run sharded PageRank on ``g`` (a ``csr.Graph``, ``GraphArrays`` or an
    engine backend) on every rank of ``mesh`` (``None``:
    ``make_graph_mesh(n_shards)`` over the initialised default group, on
    this rank's card).

    ``backend`` picks the per-shard edge-map implementation (``"flat"`` |
    ``"ell"``, resolved through ``apps.engine.BACKENDS``).  Every rank
    builds the same layout on the host and moves its own shard to its
    device.  Returns (ranks (V,) on the mesh's device, iterations,
    sharded_graph); keep the sharded graph and call
    :func:`repro_torch.dist.graph.pagerank_sharded` for repeated runs.
    """
    if mesh is None:
        mesh = make_graph_mesh(n_shards)
    if isinstance(g, GraphArrays):
        ga = g
    elif hasattr(g, "ga"):  # an engine backend (FlatBackend / EllBackend)
        ga = g.ga
    else:
        ga = to_arrays(g, backend="arrays", device="cpu")
    sg = dist_graph.shard_graph(ga, mesh.size, policy=policy, backend=backend)
    ranks, iters = dist_graph.pagerank_sharded(
        sg, mesh, damping=damping, max_iters=max_iters, tol=tol)
    return ranks, iters, sg
