"""Full pull-mode SpMV over a ``PackedAdjacency``.

Port of ``repro.kernels.pack_spmv.ops``.  ``pack_spmv`` is the decode-free
edge map of the packed layout: one K4 call per hot group (fixed-stride
slots, degree-masked — no stored padding weights on the unweighted path;
the hub group's rows split across blocks by the segment list
``hot_tables`` builds with the planes),
and a decoded path for the cold segment: the varint stream is decoded and
reduced with one sorted-segment sum.  Every vertex owns exactly one row (a
hot slot row or a cold row), so each partial result is written with
``index_copy_`` into zeros — exact, with no float atomics.

Validated against ``kernels.csr_spmv.ref.csr_spmv_ref`` over the unpacked
graph (tests and ``chip_smoke.py``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ...device import to_device
from ...pack.engine import hot_planes
from ...pack.layout import HotGroup, PackedAdjacency
from .._wrap import class_segments
from .pack_spmv import hot_spmv

__all__ = ["HotTable", "decode_cold_tiles", "hot_tables", "pack_spmv"]


class HotTable(NamedTuple):
    """One hot slot table as K4 takes it: the planes padded to the tile, the
    longest row, and the segment list of a table wider than 1,024 slots."""

    group: HotGroup
    idx: torch.Tensor  # (R, W) uint8 / uint16 / uint32, as stored
    deg: torch.Tensor  # (R,) int32, 0 on the padding rows
    w: Optional[torch.Tensor]  # (R, W) float32 or None
    max_deg: int
    segments: Optional[torch.Tensor]  # (S, 3) int32 or None


def hot_tables(adj: PackedAdjacency, *, device, row_tile: int = 64,
               width_tile: int = 128) -> List[HotTable]:
    """``hot_planes`` with K4's walk: each table's ``max_deg`` and, where
    its group takes 256 lanes, ``row_segments`` of its padded degrees, both
    from the host ``h.deg``."""
    out = []
    for h, idx, deg, w in hot_planes(adj, device=device, row_tile=row_tile,
                                     width_tile=width_tile):
        padded = np.zeros(idx.shape[0], np.int64)
        padded[:h.num_rows] = h.deg
        max_deg = int(padded.max())
        out.append(HotTable(h, idx, deg, w, max_deg,
                            class_segments(padded, max_deg, device)))
    return out


def decode_cold_tiles(adj: PackedAdjacency):
    """Decode the cold segment into one edge-parallel tile.

    Returns ``(seg, neigh, w)``: local cold-row index, neighbor id and weight
    per cold edge, row-major — the arrays of the reference's block-by-block
    decode.  The blocks are decoded in one vectorized pass here
    (``ColdSegment.neighbors``); that each block also decodes on its own from
    its (ctrl, data) slice is ``codec.decode_block``'s contract, tested there.
    """
    cdeg = adj.cold.deg.astype(np.int64)
    neigh = adj.cold.neighbors()
    seg = np.repeat(np.arange(adj.cold.num_rows, dtype=np.int32), cdeg)
    return seg, neigh.astype(np.int32), adj.cold.w


def pack_spmv(
    x: torch.Tensor,
    adj: PackedAdjacency,
    *,
    row_tile: int = 64,
    width_tile: int = 128,
) -> torch.Tensor:
    """y (V,) = pull-mode SpMV over the packed pull adjacency, on x's device.

    Unweighted adjacencies multiply by an implicit 1 (the hot path then
    reads only the id plane — the packed layout's bandwidth win).  The host
    planes are copied to the device on every call, as the reference does.
    """
    dev = x.device
    y = torch.zeros((adj.num_vertices,), dtype=x.dtype, device=dev)
    for t in hot_tables(adj, device=dev, row_tile=row_tile,
                        width_tile=width_tile):
        ys = hot_spmv(x, t.idx, t.deg, t.w, max_deg=t.max_deg,
                      segments=t.segments, row_tile=row_tile,
                      width_tile=width_tile)
        y.index_copy_(0, to_device(t.group.rows.astype(np.int64), dev),
                      ys[:t.group.num_rows])

    _, neigh, w = decode_cold_tiles(adj)
    if neigh.shape[0]:
        vals = x[to_device(neigh.astype(np.int64), dev)]
        if w is not None:
            vals = vals * to_device(w, dev)
        ptr = np.zeros(adj.cold.num_rows + 1, np.int64)
        np.cumsum(adj.cold.deg.astype(np.int64), out=ptr[1:])
        ys = torch.segment_reduce(vals, "sum", offsets=to_device(ptr, dev),
                                  axis=0, unsafe=True)
        y.index_copy_(0, to_device(adj.cold.rows.astype(np.int64), dev), ys)
    return y
