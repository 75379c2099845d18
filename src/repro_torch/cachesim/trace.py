"""Property-array access traces from CSR traversals (paper §II-C).

The port's copy of ``repro.cachesim.trace``, on the port's ``graph.csr``.

The Vertex/Edge arrays stream with no reuse (paper Fig 1); all interesting
cache behavior comes from the irregular *Property Array* accesses:

  * pull-mode app: while processing destination v (in vertex order), it READS
    property[src] for every in-edge — the trace is exactly ``in_csr.indices``;
  * push-mode app: active source v WRITES property[dst] for every out-edge —
    the trace is ``out_csr.indices``.

Vertex ids map to 64-byte cache blocks at ``bytes_per_vertex`` granularity, so
vertex REORDERING changes the block trace — this is the entire mechanism the
paper studies, reproduced exactly.
"""
from __future__ import annotations

import numpy as np

from ..graph import csr

__all__ = [
    "DEFAULT_TRACE_LEN",
    "STRUCT_REGION",
    "property_trace",
    "to_blocks",
    "flat_structure",
    "interleave_structure",
]

# Canonical trace cap for MPKA measurements: long enough that stack-distance
# statistics stabilize, short enough to simulate in seconds.  The single
# source of truth — callers must not carry private copies.
DEFAULT_TRACE_LEN = 1_500_000


def property_trace(g: csr.Graph, mode: str = "pull", max_len: int | None = None) -> np.ndarray:
    """Vertex-id access trace for one full traversal iteration."""
    if mode == "pull":
        t = g.in_csr.indices
    elif mode == "push":
        t = g.out_csr.indices
    else:
        raise ValueError(mode)
    if max_len is not None and t.shape[0] > max_len:
        t = t[:max_len]
    return t.astype(np.int64)


def to_blocks(trace: np.ndarray, *, bytes_per_vertex: int = 8, block_bytes: int = 64) -> np.ndarray:
    """Map vertex ids to cache-block ids."""
    vpb = max(1, block_bytes // bytes_per_vertex)
    return trace // vpb


# ---------------------------------------------------------------------------
# Structure-aware traces (the packed layout's integration)
#
# The property-only trace above isolates the paper's mechanism; to price a
# *storage format* we must also charge the structure stream the traversal
# reads around every property access: one metadata read per row (indptr
# entry, or a packed degree byte) and one index read per edge (a 4-byte CSR
# slot, or a varint's data bytes).  Structure addresses live in their own
# region of the block-id space so they never alias property blocks.
# ---------------------------------------------------------------------------

# block-id offset separating the structure address space from property blocks
STRUCT_REGION = np.int64(1) << 40


def flat_structure(g: csr.Graph, mode: str = "pull"):
    """(row_counts, meta_addr, edge_addr) byte streams of a flat-CSR traversal.

    Rows are visited in vertex order; per row the 8-byte ``indptr`` entry is
    the metadata read, per edge the 4-byte ``indices`` slot is the index
    read.  Mirrors ``PackedAdjacency.structure_addresses`` for the packed
    layout, so the two formats price against the same access model.
    """
    d = g.in_csr if mode == "pull" else g.out_csr
    counts = np.diff(d.indptr).astype(np.int64)
    v = d.num_vertices
    meta = np.arange(v, dtype=np.int64) * 8
    base = 8 * (v + 1)
    edge = base + np.arange(d.num_edges, dtype=np.int64) * 4
    return counts, meta, edge


def interleave_structure(
    prop_ids: np.ndarray,
    row_counts: np.ndarray,
    meta_addr: np.ndarray,
    edge_addr: np.ndarray,
    *,
    bytes_per_vertex: int = 8,
    block_bytes: int = 64,
    max_len: int | None = None,
) -> np.ndarray:
    """Block trace of a traversal that reads structure AND property arrays.

    Emission order per row: [metadata, (index, property) per edge] — exactly
    the access pattern of a pull/push edge map.  Property accesses map to
    vertex-property blocks; structure accesses map to ``STRUCT_REGION``-
    offset blocks of their byte addresses.  One vectorized pass.
    """
    counts = np.asarray(row_counts, np.int64)
    e = int(counts.sum())
    if prop_ids.shape[0] != e or edge_addr.shape[0] != e:
        raise ValueError("per-edge streams must match row_counts")
    r = counts.shape[0]
    vpb = max(1, block_bytes // bytes_per_vertex)
    out = np.empty(r + 2 * e, dtype=np.int64)
    row_start = np.cumsum(2 * counts + 1) - (2 * counts + 1)
    out[row_start] = STRUCT_REGION + np.asarray(meta_addr, np.int64) // block_bytes
    within = csr.ragged_offsets(np.zeros(r, np.int64), counts)
    spots = np.repeat(row_start + 1, counts) + 2 * within
    out[spots] = STRUCT_REGION + np.asarray(edge_addr, np.int64) // block_bytes
    out[spots + 1] = np.asarray(prop_ids, np.int64) // vpb
    if max_len is not None and out.shape[0] > max_len:
        out = out[:max_len]
    return out
