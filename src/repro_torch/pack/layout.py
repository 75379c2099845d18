"""Hot/cold segmented packed graph storage (the subsystem's data model).

The paper's argument is that DBG wins by shrinking the *footprint* of the
high-reuse vertices; ``PackedGraph`` pushes the same idea into the storage
bytes themselves.  Each adjacency direction is split by DBG degree group:

  * **hot segment** — one fixed-stride slot table per hot group: rows padded
    to the group's degree ceiling, stride rounded up to a cache-line multiple
    (``slot_align`` index entries), ids stored in the minimal fixed-width
    dtype.  Geometric degree ranges bound the padding at < 2x by
    construction — the paper's binning doubles as the slot structure — and
    the fixed stride is what lets the ``pack_spmv`` kernel (K4) use regular
    gathers.  The **packing factor** (true edges / padded slot capacity) is
    explicit and queryable.
  * **cold segment** — the long tail as an *offset-free, degree-implied* CSR:
    no per-row offsets, only a minimal-dtype degree per row, with the
    neighbor lists delta + group-varint encoded in independently-decodable
    blocks (``codec``).

Rows are canonicalized to ascending neighbor order at pack time (gaps >= 0
for the delta codec); ``unpack()`` is the exact inverse up to that per-row
canonicalization — neighbor multisets and weights are preserved bit-for-bit,
and both CSR directions of the unpacked graph come back in canonical sorted
order, which is what makes packed analytics bit-identical to flat CSR runs.

This is the PyTorch port's own copy of ``repro.pack.layout`` (host-side
numpy; ``tests/test_torch_pack.py`` holds the two to bitwise-equal arrays).
The hot id dtype is ``codec.min_uint_dtype(V - 1)``: uint8 up to 256
vertices, uint16 up to 65,536, uint32 above.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.reorder import _assign_groups, dbg_spec
from ..graph import csr
from . import codec

__all__ = [
    "HotGroup",
    "ColdSegment",
    "PackedAdjacency",
    "PackedGraph",
    "pack_adjacency",
    "pack_graph",
    "flat_csr_nbytes",
]


_ragged_offsets = csr.ragged_offsets


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HotGroup:
    """One DBG group's fixed-stride slot table (cache-line-aligned)."""

    group: int  # DBG group index (0 = hottest)
    rows: np.ndarray  # (R,) owning vertex ids, ascending
    deg: np.ndarray  # (R,) int32 true degrees
    idx: np.ndarray  # (R, W) neighbor ids, minimal uint dtype, 0-padded
    w: Optional[np.ndarray]  # (R, W) float32 weights (0-padded) or None

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def stride(self) -> int:
        return int(self.idx.shape[1])

    @property
    def num_edges(self) -> int:
        return int(self.deg.sum())


@dataclasses.dataclass(frozen=True)
class ColdSegment:
    """Offset-free degree-implied CSR tail, varint-compressed."""

    rows: np.ndarray  # (C,) owning vertex ids, ascending
    deg: np.ndarray  # (C,) minimal uint dtype — the only per-row metadata
    lists: codec.GroupVarintLists  # delta+varint encoded sorted neighbors
    w: Optional[np.ndarray]  # (cold_edges,) float32, same order as decode

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.deg.astype(np.int64).sum())

    def neighbors(self) -> np.ndarray:
        """Decode every cold row's neighbor list (row-major)."""
        counts = self.deg.astype(np.int64)
        return codec.delta_decode_values(codec.decode_all(self.lists), counts)


@dataclasses.dataclass(frozen=True)
class PackedAdjacency:
    """One direction of adjacency in hot/cold packed form."""

    num_vertices: int
    num_edges: int
    boundaries: Tuple[int, ...]
    hot_group_count: int  # how many of the hottest groups are slot-packed
    hot: Tuple[HotGroup, ...]
    cold: ColdSegment
    weighted: bool

    # -- structure ------------------------------------------------------------
    @property
    def hot_edges(self) -> int:
        return sum(h.num_edges for h in self.hot)

    @property
    def hot_capacity(self) -> int:
        """Total hot slots (incl. padding) — the packing-factor denominator."""
        return sum(h.num_rows * h.stride for h in self.hot)

    @property
    def packing_factor(self) -> float:
        """Hot slot utilization: true hot edges / padded slot capacity."""
        cap = self.hot_capacity
        return self.hot_edges / cap if cap else 1.0

    def degrees(self) -> np.ndarray:
        """Reconstruct the full per-vertex degree vector."""
        deg = np.zeros(self.num_vertices, np.int64)
        for h in self.hot:
            deg[h.rows] = h.deg
        deg[self.cold.rows] = self.cold.deg.astype(np.int64)
        return deg

    def cold_csr(self) -> csr.CSR:
        """Decode the cold segment into a full-V CSR (hot rows empty).

        The decoded-tile view of the cold tail: the fused edge-map packer
        (``kernels.edge_map.ops.ell_tiles``) bins rows by degree and skips
        empty ones, so handing it this CSR tiles exactly the cold rows — the
        hot slot tables never round-trip through it.
        """
        deg = np.zeros(self.num_vertices, np.int64)
        deg[self.cold.rows] = self.cold.deg.astype(np.int64)
        indptr = np.zeros(self.num_vertices + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        return csr.CSR(indptr=indptr,
                       indices=self.cold.neighbors().astype(np.int32),
                       weights=self.cold.w)

    def decode_edges(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """(owner, neighbor, w) of every edge, hot-then-cold traversal order.

        Within every row, neighbors come back in the canonical ascending
        order; this is the packed layout's native traversal order (hot groups
        hottest-first, then the cold tail).
        """
        owners: List[np.ndarray] = []
        neigh: List[np.ndarray] = []
        ws: List[np.ndarray] = []
        for h in self.hot:
            owners.append(np.repeat(h.rows, h.deg))
            if h.stride:
                cols = _ragged_offsets(
                    np.arange(h.num_rows, dtype=np.int64) * h.stride,
                    h.deg.astype(np.int64))
                neigh.append(h.idx.ravel()[cols].astype(np.int64))
                if h.w is not None:
                    ws.append(h.w.ravel()[cols])
            else:
                neigh.append(np.zeros(0, np.int64))
        owners.append(np.repeat(self.cold.rows,
                                self.cold.deg.astype(np.int64)))
        neigh.append(self.cold.neighbors())
        if self.weighted and self.cold.w is not None:
            ws.append(self.cold.w)
        owner = np.concatenate(owners) if owners else np.zeros(0, np.int64)
        nb = np.concatenate(neigh) if neigh else np.zeros(0, np.int64)
        w = np.concatenate(ws).astype(np.float32) if self.weighted else None
        return owner, nb, w

    # -- bytes accounting -----------------------------------------------------
    def nbytes(self) -> Dict[str, int]:
        """Byte breakdown of the packed storage (all arrays counted)."""
        out = {
            "hot_idx": sum(h.idx.nbytes for h in self.hot),
            "hot_w": sum(h.w.nbytes for h in self.hot if h.w is not None),
            "hot_deg": sum(h.deg.nbytes for h in self.hot),
            "hot_rows": sum(h.rows.nbytes for h in self.hot),
            "cold_data": self.cold.lists.nbytes_data,
            "cold_ctrl": self.cold.lists.nbytes_ctrl,
            "cold_deg": int(self.cold.deg.nbytes),
            "cold_rows": int(self.cold.rows.nbytes),
            "cold_block_meta": self.cold.lists.nbytes_meta,
            "cold_w": int(self.cold.w.nbytes) if self.cold.w is not None else 0,
        }
        out["total"] = sum(out.values())
        return out

    def bytes_per_edge(self) -> float:
        return self.nbytes()["total"] / max(1, self.num_edges)

    # -- address model for the cache simulator --------------------------------
    def structure_addresses(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_counts, meta_addr, edge_addr) in traversal order.

        Byte addresses of what a pull/push traversal actually reads from the
        *structure* arrays: per row one metadata read (the degree entry), per
        edge one index read (a hot slot, or a cold varint's data bytes).
        Regions are laid out back-to-back in one virtual address space;
        ``cachesim.trace.interleave_structure`` turns these into cache-block
        accesses alongside the property stream.
        """
        counts: List[np.ndarray] = []
        meta: List[np.ndarray] = []
        edge: List[np.ndarray] = []
        base = 0
        for h in self.hot:
            counts.append(h.deg.astype(np.int64))
            item = h.idx.dtype.itemsize
            if h.stride:
                cols = _ragged_offsets(
                    np.arange(h.num_rows, dtype=np.int64) * h.stride,
                    h.deg.astype(np.int64))
                edge.append(base + cols * item)
            base += h.idx.nbytes
            meta.append(base + np.arange(h.num_rows, dtype=np.int64)
                        * h.deg.dtype.itemsize)
            base += h.deg.nbytes
        cdeg = self.cold.deg.astype(np.int64)
        counts.append(cdeg)
        lists = self.cold.lists
        edge.append(base + codec.value_data_offsets(lists))
        base += lists.nbytes_data
        meta.append(base + np.arange(self.cold.num_rows, dtype=np.int64)
                    * self.cold.deg.dtype.itemsize)
        cat = lambda parts: (np.concatenate(parts) if parts
                             else np.zeros(0, np.int64))
        return cat(counts), cat(meta), cat(edge)


def pack_adjacency(
    direction: csr.CSR,
    *,
    boundaries: Optional[Sequence[int]] = None,
    hot_groups: Optional[int] = None,
    slot_align: int = 16,
    rows_per_block: int = 64,
) -> PackedAdjacency:
    """Pack one CSR direction into the hot/cold segmented layout.

    ``boundaries`` defaults to the paper's DBG spec over this direction's
    degree vector; ``hot_groups`` defaults to the groups whose lower bound is
    at least the average degree (the paper's hot-vertex threshold).
    ``slot_align`` is the hot stride quantum in index entries (16 x 4B =
    one 64-byte cache line).
    """
    v = direction.num_vertices
    deg = direction.degrees()
    if boundaries is None:
        boundaries = dbg_spec(max(1.0, float(deg.mean())
                                  if deg.size else 1.0)).boundaries
    boundaries = tuple(int(b) for b in boundaries)
    if hot_groups is None:
        mean = max(1.0, float(deg.mean()) if deg.size else 1.0)
        hot_groups = max(1, sum(1 for b in boundaries if b >= mean))
    hot_groups = min(int(hot_groups), len(boundaries))
    grp = _assign_groups(deg, boundaries)

    # canonicalize: per-row ascending neighbor order, stable for ties
    owner = np.repeat(np.arange(v, dtype=np.int64), deg)
    pos = np.arange(direction.num_edges, dtype=np.int64)
    order = np.lexsort((pos, direction.indices.astype(np.int64), owner))
    s_idx = direction.indices.astype(np.int64)[order]
    s_w = (direction.weights[order].astype(np.float32)
           if direction.weights is not None else None)
    indptr = direction.indptr.astype(np.int64)

    id_dtype = codec.min_uint_dtype(max(0, v - 1))
    hot: List[HotGroup] = []
    for k in range(hot_groups):
        rows = np.flatnonzero(grp == k).astype(np.int64)
        if rows.size == 0:
            continue
        rdeg = deg[rows].astype(np.int64)
        wmax = int(rdeg.max())
        if wmax and wmax < slot_align:
            # sub-line slots: power-of-two strides divide the line evenly,
            # so no slot ever straddles a cache-line boundary
            stride = 1 << int(np.ceil(np.log2(wmax)))
        else:
            stride = _round_up(wmax, slot_align)
        idx = np.zeros((rows.size, stride), dtype=id_dtype)
        wgt = (np.zeros((rows.size, stride), np.float32)
               if s_w is not None else None)
        if stride:
            src_off = _ragged_offsets(indptr[rows], rdeg)
            dst_off = _ragged_offsets(
                np.arange(rows.size, dtype=np.int64) * stride, rdeg)
            idx.ravel()[dst_off] = s_idx[src_off].astype(id_dtype)
            if wgt is not None:
                wgt.ravel()[dst_off] = s_w[src_off]
        hot.append(HotGroup(group=k, rows=rows, deg=rdeg.astype(np.int32),
                            idx=idx, w=wgt))

    cold_rows = np.flatnonzero(grp >= hot_groups).astype(np.int64)
    cdeg = deg[cold_rows].astype(np.int64)
    src_off = _ragged_offsets(indptr[cold_rows], cdeg)
    cold_nb = s_idx[src_off]
    lists = codec.encode_values(
        codec.delta_encode_rows(cold_nb, cdeg), cdeg,
        rows_per_block=rows_per_block)
    cold = ColdSegment(
        rows=cold_rows,
        deg=cdeg.astype(codec.min_uint_dtype(int(cdeg.max()) if cdeg.size
                                             else 0)),
        lists=lists,
        w=s_w[src_off] if s_w is not None else None,
    )
    return PackedAdjacency(
        num_vertices=v,
        num_edges=direction.num_edges,
        boundaries=boundaries,
        hot_group_count=hot_groups,
        hot=tuple(hot),
        cold=cold,
        weighted=direction.weights is not None,
    )


@dataclasses.dataclass(frozen=True)
class PackedGraph:
    """Both adjacency directions in packed form (the storage analogue of
    ``graph.csr.Graph``)."""

    in_adj: PackedAdjacency  # pull direction (in-edges per destination)
    out_adj: PackedAdjacency  # push direction (out-edges per source)
    name: str = "packed"
    pack_seconds: float = 0.0

    @property
    def num_vertices(self) -> int:
        return self.in_adj.num_vertices

    @property
    def num_edges(self) -> int:
        return self.in_adj.num_edges

    @property
    def weighted(self) -> bool:
        return self.in_adj.weighted

    def nbytes(self) -> Dict[str, int]:
        i, o = self.in_adj.nbytes(), self.out_adj.nbytes()
        out = {f"in_{k}": n for k, n in i.items() if k != "total"}
        out.update({f"out_{k}": n for k, n in o.items() if k != "total"})
        out["total"] = i["total"] + o["total"]
        return out

    def bytes_per_edge(self) -> float:
        """Bytes per edge over BOTH stored directions (flat CSR keeps both
        directions too, so the comparison is like-for-like)."""
        return self.nbytes()["total"] / max(1, 2 * self.num_edges)

    def unpack(self) -> csr.Graph:
        """Exact inverse: rebuild the flat ``csr.Graph``.

        Edges are emitted sorted by (src, dst) so BOTH rebuilt CSR
        directions come back in canonical per-row ascending order — running
        an app on ``unpack()`` is the flat-CSR reference the packed engine
        is bit-identical to.
        """
        src, dst, w = self.out_adj.decode_edges()
        order = np.lexsort((dst, src))
        return csr.from_edges(src[order], dst[order], self.num_vertices,
                              weights=None if w is None else w[order],
                              name=self.name)

    @classmethod
    def from_delta(cls, dg, **kwargs) -> "PackedGraph":
        """Rebuild hook for ``stream``: pack the current state of a
        ``DeltaGraph`` (call after ``compact()`` so the base is fresh and the
        packed layout tracks the compacted CSR)."""
        return pack_graph(dg.snapshot(), **kwargs)


def pack_graph(
    g: csr.Graph,
    *,
    boundaries: Optional[Sequence[int]] = None,
    hot_groups: Optional[int] = None,
    slot_align: int = 16,
    rows_per_block: int = 64,
    name: Optional[str] = None,
) -> PackedGraph:
    """Pack both directions of ``g``; measures pack (encode) wall time."""
    t0 = time.perf_counter()
    in_adj = pack_adjacency(g.in_csr, boundaries=boundaries,
                            hot_groups=hot_groups, slot_align=slot_align,
                            rows_per_block=rows_per_block)
    out_adj = pack_adjacency(g.out_csr, boundaries=boundaries,
                             hot_groups=hot_groups, slot_align=slot_align,
                             rows_per_block=rows_per_block)
    return PackedGraph(in_adj=in_adj, out_adj=out_adj,
                       name=name or f"{g.name}+pack",
                       pack_seconds=time.perf_counter() - t0)


def flat_csr_nbytes(g: csr.Graph) -> int:
    """Byte footprint of the flat CSR baseline (both directions, as stored)."""
    total = 0
    for d in (g.in_csr, g.out_csr):
        total += d.indptr.nbytes + d.indices.nbytes
        if d.weights is not None:
            total += d.weights.nbytes
    return total
