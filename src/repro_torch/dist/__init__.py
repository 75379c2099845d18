"""repro_torch.dist — the distributed graph engine, the port of
``repro.dist``'s graph half on ``torch.distributed`` (one process per
shard: NCCL on the card, gloo on the CPU).

* ``graph``  — destination-sharded graph engine with the paper's DBG
  insight lifted to the device level: hot degree-groups replicated, cold
  tail owner-partitioned (halo exchange via all-to-all), K5 per shard;
* ``stream`` — O(delta) streaming maintenance of a sharded layout:
  per-shard delta buffers + tombstone planes, halo-aware insert routing,
  per-shard threshold compaction, and the sharded PageRank / SSSP solvers
  over base + delta segment.

The reference's LM layers (``constrain``, ``sharding``, ``pipeline``) are
not ported here.
"""
from . import graph, stream  # noqa: F401
