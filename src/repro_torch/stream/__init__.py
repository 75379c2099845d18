"""repro_torch.stream — dynamic-graph ingestion with incremental DBG
maintenance, the port of ``repro.stream``.

* ``delta``       — ``DeltaGraph``: batched insert/delete over the frozen CSR
  (delta buffers + tombstones, O(batch) apply, threshold compaction);
* ``regroup``     — ``IncrementalDBG``: the paper's degree groups maintained
  online with hysteresis, emitting ``RemapDelta``s;
* ``incremental`` — delta-based PageRank (exact residual carry + forward
  push) and SSSP (insertion relaxation, deletion fallback) refresh, on the
  edge-parallel stream arrays or through K5 over the base+delta tiles;
* ``service``     — the ingest-and-query loop with regroup/compact policies
  and the cachesim locality-decay hook.

The sharded service (``repro.stream.sharded``) waits for the distributed
graph engine (ROADMAP A11).
"""
from . import delta, incremental, regroup, service  # noqa: F401
from .delta import ApplyResult, DeltaGraph  # noqa: F401
from .incremental import (  # noqa: F401
    IncrementalPageRank,
    IncrementalSSSP,
    StreamArrays,
    StreamBackend,
    edge_map_pull_stream,
    edge_map_push_stream,
    edge_map_push_stream_fused,
    stream_arrays,
    stream_push_tiles,
)
from .regroup import IncrementalDBG, RemapDelta  # noqa: F401
from .service import (  # noqa: F401
    IngestStats,
    StreamConfig,
    StreamService,
    layout_mpka,
    packed_mpka,
)
