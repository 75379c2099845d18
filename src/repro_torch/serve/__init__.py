"""repro_torch.serve — multi-tenant batched graph-query serving.

Port of ``repro.serve``.  K concurrent PageRank/SSSP queries share ONE
edge-map pass per iteration (a 2D ``(V, K)`` property plane on any
``engine.BACKENDS`` backend; on ``ell`` / ``packed`` one grouped K5 call
over every tile class), fed by a bounded admission queue and answered against refcounted
immutable snapshots so ``StreamService`` ingest never blocks — or
corrupts — an in-flight batch.

The reference's ``serve.engine`` (a deprecation shim forwarding to the LM
decode loop) is not ported: the port's ``generate`` is
``repro_torch.lm.serve``.
"""
from .batch import PendingQuery, Query, QueryQueue, QueueFull  # noqa: F401
from .batched import (batch_frontier_density, batched_pagerank,  # noqa: F401
                      batched_sssp)
from .metrics import ServeMetrics  # noqa: F401
from .service import GraphServeService, QueryResult, ServeConfig  # noqa: F401
from .snapshot import Snapshot, SnapshotStore  # noqa: F401

__all__ = [
    "Query", "PendingQuery", "QueryQueue", "QueueFull",
    "batched_pagerank", "batched_sssp", "batch_frontier_density",
    "Snapshot", "SnapshotStore", "ServeMetrics",
    "ServeConfig", "QueryResult", "GraphServeService",
]
