"""repro_torch.pack — hot/cold segmented, compressed CSR storage.

Port of ``repro.pack``.  A DBG-grouped graph is packed (host-side numpy)
into a fixed-stride **hot segment** and a delta + group-varint compressed
**cold tail**, and the five apps run over it on the card: ``packed_backend``
(or ``apps.to_arrays(g, backend="packed")``) plugs the packed layout into the
``apps.engine`` fused edge-map family (K5 over the hot slot tables and the
decoded cold tiles).
"""
from . import codec, engine, layout  # noqa: F401
from .codec import GroupVarintLists, decode_all, decode_block, encode_values  # noqa: F401
from .engine import PackedBackend, hot_planes, packed_backend  # noqa: F401
from .layout import (  # noqa: F401
    ColdSegment,
    HotGroup,
    PackedAdjacency,
    PackedGraph,
    flat_csr_nbytes,
    pack_adjacency,
    pack_graph,
)
