"""``PackedBackend`` — run the apps straight over a ``PackedGraph``.

Port of ``repro.pack.engine``.  The packed storage is an ``apps.engine``
edge-map backend: the **hot segment**'s fixed-stride slot tables ARE ELL
tiles (rows × stride planes with a true-degree mask — the geometry K5
consumes), so they feed the fused edge-map kernel directly, still packed;
the **cold segment** decodes once into per-degree-group ELL tiles (the
compressed varint bytes stay the storage of record).  One in-direction tile
set serves both primitives (push is the transposed pull with an
``init``-seeded accumulator), so the five apps run over it unchanged.

Parity contract (tested): min/max reductions are bit-identical to
``FlatBackend`` on ``pg.unpack()``; sums agree to fp association, the same
contract as ``EllBackend``.

BC's backward dependency sweep dispatches through ``apps.engine.out_edge_sum``
to :meth:`PackedBackend.out_edge_sum`: a masked row sum per OUT hot slot
table plus a sorted-segment sum over the decoded cold edges, each written
with ``index_copy_`` (every vertex owns one row, so the writes never meet;
no float atomics).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..apps.engine import FusedEdgeMaps
from ..device import resolve_device, to_device
from ..kernels._wrap import class_segments
from ..kernels.edge_map.ops import (EllTileGroup, TileSet, _pad_dim, _round_up,
                                    ell_tiles)
from .layout import PackedAdjacency, PackedGraph

__all__ = [
    "HotDev",
    "ColdDev",
    "hot_planes",
    "PackedBackend",
    "packed_backend",
]

#: Lanes per chunk of an out-direction slot table in ``out_edge_sum``: the
#: edge function's (rows, stride) temporaries stay a few hundred MB even on
#: a hub table of ~10^9 slots.
OUT_SUM_CHUNK_LANES = 1 << 25


class HotDev(NamedTuple):
    """Device view of one hot group's slot table (still packed)."""

    rows: torch.Tensor  # (R,) int64 owning vertex ids
    deg: torch.Tensor  # (R,) int32
    idx: torch.Tensor  # (R, W) int32 (upcast from the storage dtype)
    w: Optional[torch.Tensor]  # (R, W) float32 or None


class ColdDev(NamedTuple):
    """Decoded cold rows in edge-parallel form (row-major, sorted rows)."""

    rows: torch.Tensor  # (C,) int64 owning vertex ids
    owners: torch.Tensor  # (E,) int64 owning vertex id per edge
    ptr: torch.Tensor  # (C+1,) int64 edge offsets of the cold rows
    neigh: torch.Tensor  # (E,) int64 neighbor ids
    w: Optional[torch.Tensor]  # (E,) float32 or None


def hot_planes(adj: PackedAdjacency, *, device, row_tile: int = 1,
               width_tile: int = 1, pad=_round_up, id_view=None):
    """``(group, idx, deg, w)`` per non-empty hot slot table, on ``device``:
    the slot table zero-padded to ``pad(rows, row_tile)`` x
    ``pad(stride, width_tile)`` (tiles of 1: as stored), ``deg`` int32,
    ``w`` float32 or None.  Ids keep their stored width unless ``id_view``
    (numpy ids -> ids) maps them to another."""
    out = []
    for h in adj.hot:
        if h.num_rows == 0 or h.stride == 0:
            continue
        shape = (pad(h.num_rows, row_tile), pad(h.stride, width_tile))
        ids = h.idx if id_view is None else id_view(h.idx)
        w = (None if h.w is None
             else to_device(_zero_pad(h.w, shape, np.float32), device))
        out.append((h, to_device(_zero_pad(ids, shape, ids.dtype), device),
                    to_device(_zero_pad(h.deg, shape[:1], np.int32), device),
                    w))
    return out


def _zero_pad(a: np.ndarray, shape, dtype) -> np.ndarray:
    """``a`` as ``dtype``, zero-padded to ``shape``; no copy when it already
    has both (the hub slot tables are the packed layout's largest arrays)."""
    if a.shape == shape:
        return a.astype(dtype, copy=False)
    out = np.zeros(shape, dtype)
    out[tuple(slice(0, n) for n in a.shape)] = a
    return out


def _int32_ids(idx: np.ndarray) -> np.ndarray:
    """A slot table's ids as int32.  uint32 planes are reinterpreted in
    place (every id is < V < 2^31, so the bits read the same); narrower
    ones are widened."""
    if idx.dtype == np.uint32:
        return idx.view(np.int32)
    return idx.astype(np.int32)


def _k5_ids(idx: np.ndarray) -> np.ndarray:
    """A slot table's ids as K5 reads them (uint16 or int32): a uint32 table
    (V > 65,536) as a zero-copy int32 view — valid because every id is
    < V < 2^31 — and a uint8 table (V <= 256) widened to uint16; uint16
    stays as stored."""
    if idx.dtype == np.uint32:
        return idx.view(np.int32)
    if idx.dtype == np.uint8:
        return idx.astype(np.uint16)
    return idx


def _hot_dev(adj: PackedAdjacency, device: torch.device) -> Tuple[HotDev, ...]:
    return tuple(HotDev(rows=to_device(h.rows, device, np.int64), deg=deg,
                        idx=idx, w=w)
                 for h, idx, deg, w in hot_planes(adj, device=device,
                                                  id_view=_int32_ids))


def _cold_dev(adj: PackedAdjacency, device: torch.device) -> ColdDev:
    cdeg = adj.cold.deg.astype(np.int64)
    ptr = np.zeros(adj.cold.num_rows + 1, np.int64)
    np.cumsum(cdeg, out=ptr[1:])
    return ColdDev(
        rows=to_device(adj.cold.rows, device, np.int64),
        owners=to_device(np.repeat(adj.cold.rows.astype(np.int64), cdeg),
                         device),
        ptr=to_device(ptr, device),
        neigh=to_device(adj.cold.neighbors(), device, np.int64),
        w=None if adj.cold.w is None else to_device(adj.cold.w, device,
                                                    np.float32))


def _hot_tiles(adj: PackedAdjacency, row_tile: int, width_tile: int,
               device: torch.device) -> Tuple[EllTileGroup, ...]:
    """Wrap the hot slot tables as fused-kernel tiles WITHOUT re-packing.

    A slot table is already an ELL plane: rows padded to the group stride,
    minimal-width ids, per-row true degree.  Only the tile-granularity zero
    padding is added here (the reference's ``_pad_dim`` geometry), the
    ids go to K5 at a width it reads (``_k5_ids``), and a wide table gets
    K5's segment list (``class_segments``).
    """
    return tuple(EllTileGroup(rows=to_device(h.rows, device, np.int64),
                              idx=idx, deg=deg, w=w,
                              segments=class_segments(
                                  np.pad(h.deg, (0, idx.shape[0] - h.num_rows)),
                                  idx.shape[1], device))
                 for h, idx, deg, w in hot_planes(
                     adj, device=device, row_tile=row_tile,
                     width_tile=width_tile, pad=_pad_dim, id_view=_k5_ids))


@dataclasses.dataclass(frozen=True)
class PackedBackend(FusedEdgeMaps):
    """``apps.engine`` backend over hot/cold packed storage (see module doc).

    ``packed`` is the host ``PackedGraph`` the backend was built from (the
    storage of record; ``kernels.pack_spmv.pack_spmv`` reads it)."""

    in_tiles: Tuple  # hot slot tables + decoded cold tiles, pull direction
    out_hot: Tuple[HotDev, ...]
    out_cold: ColdDev
    in_deg: torch.Tensor  # (V,) int32
    out_deg: torch.Tensor  # (V,) int32
    row_tile: int = 64
    width_tile: int = 128
    num_edges: int = 0
    packed: Optional[PackedGraph] = dataclasses.field(default=None,
                                                      repr=False)

    @property
    def num_vertices(self) -> int:
        return int(self.in_deg.shape[0])

    @property
    def device(self) -> torch.device:
        return self.in_deg.device

    def out_edge_sum(self, edge_val) -> torch.Tensor:
        """Sum ``edge_val(src, child)`` over OUT-edges grouped by source —
        BC's backward gather, folded per hot table / cold segment."""
        out = torch.zeros((self.num_vertices,), dtype=torch.float32,
                          device=self.device)
        for h in self.out_hot:
            r, width = h.idx.shape
            step = max(1, OUT_SUM_CHUNK_LANES // width)
            cols = torch.arange(width, device=self.device)
            for a in range(0, r, step):
                rows = h.rows[a:a + step]
                child = h.idx[a:a + step].to(torch.int64)
                vals = edge_val(rows[:, None].expand_as(child), child)
                live = cols[None, :] < h.deg[a:a + step, None]
                ys = torch.where(live, vals, 0.0).sum(dim=1)
                out.index_copy_(0, rows, ys.to(torch.float32))
        c = self.out_cold
        if c.neigh.shape[0]:
            vals = edge_val(c.owners, c.neigh).to(torch.float32)
            ys = torch.segment_reduce(vals, "sum", offsets=c.ptr, axis=0,
                                      unsafe=True)
            out.index_copy_(0, c.rows, ys)
        return out


def packed_backend(pg: PackedGraph, *, row_tile: int = 64,
                   width_tile: int = 128,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> PackedBackend:
    """Build the ``apps.engine`` backend for a ``PackedGraph`` on ``device``
    (``None``: the CUDA card, raising without one).

    The pull direction becomes the fused-kernel tile set (hot slot tables
    wrapped in place + cold rows decoded once, binned by the layout's own
    boundaries); the push primitive rides the SAME tiles (transposed-pull
    trick), so only BC's backward sweep touches the out direction.
    """
    dev = resolve_device(device)
    in_adj = pg.in_adj
    in_deg = in_adj.degrees()
    tiles = _hot_tiles(in_adj, row_tile, width_tile, dev)
    tiles += ell_tiles(in_adj.cold_csr(), in_adj.boundaries,
                       row_tile=row_tile, width_tile=width_tile, device=dev)
    return PackedBackend(
        in_tiles=TileSet(tiles),
        out_hot=_hot_dev(pg.out_adj, dev),
        out_cold=_cold_dev(pg.out_adj, dev),
        in_deg=to_device(in_deg, dev, np.int32),
        out_deg=to_device(pg.out_adj.degrees(), dev, np.int32),
        row_tile=row_tile, width_tile=width_tile,
        num_edges=int(in_deg.sum()), packed=pg)
