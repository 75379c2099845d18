"""repro_torch.dist — the port of ``repro.dist`` on ``torch.distributed``
(one process per rank: NCCL on the card, gloo on the CPU).

The graph engine:

* ``graph``  — destination-sharded graph engine with the paper's DBG
  insight lifted to the device level: hot degree-groups replicated, cold
  tail owner-partitioned (halo exchange via all-to-all), K5 per shard;
* ``stream`` — O(delta) streaming maintenance of a sharded layout:
  per-shard delta buffers + tombstone planes, halo-aware insert routing,
  per-shard threshold compaction, and the sharded PageRank / SSSP solvers
  over base + delta segment.

The sharded LM, on DTensor over a ``DeviceMesh``:

* ``sharding``  — parameter placements from logical axes (FSDP on
  ``data``, tensor parallelism on ``model``), cache and batch specs;
* ``constrain`` — activation placements by logical axis;
* ``pipeline``  — the GPipe schedule over S ranks.

Submodules load on first use: ``lm.model`` reads ``constrain`` without
pulling in the graph engine.
"""
import importlib

_SUBMODULES = ("constrain", "graph", "pipeline", "sharding", "stream")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
