"""Carry the reference's state across: numpy arrays in, the port's types out.

The parity tests feed the JAX package's own graph and tiles (as numpy
arrays) through these, so both sides compute on identical inputs whatever
the copied generators do.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .graph.csr import CSR, Graph
from .kernels.csr_spmv.ops import EllGroup
from .kernels.edge_map.ops import EllTileGroup
from .pack import codec
from .pack.layout import ColdSegment, HotGroup, PackedAdjacency

__all__ = ["graph_from_numpy", "tiles_from_numpy",
           "packed_adjacency_from_numpy", "ell_groups_from_numpy"]


def graph_from_numpy(in_indptr, in_indices, in_weights: Optional[np.ndarray],
                     out_indptr, out_indices, out_weights: Optional[np.ndarray],
                     name: str = "graph") -> Graph:
    """A port ``Graph`` holding copies of both CSR directions' arrays."""
    def csr(indptr, indices, weights):
        return CSR(indptr=np.array(indptr, dtype=np.int64),
                   indices=np.array(indices, dtype=np.int32),
                   weights=None if weights is None
                   else np.array(weights, dtype=np.float32))

    return Graph(in_csr=csr(in_indptr, in_indices, in_weights),
                 out_csr=csr(out_indptr, out_indices, out_weights), name=name)


def tiles_from_numpy(
    groups: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray,
                           Optional[np.ndarray], Optional[np.ndarray]]],
    device: Union[str, torch.device],
) -> Tuple[EllTileGroup, ...]:
    """``(rows, idx, deg, w, alive)`` numpy planes → ``EllTileGroup``s on
    ``device``.  ``idx`` keeps its stored width (uint16 stays
    ``torch.uint16``); ``rows`` become int64, torch's index type."""
    def t(a, dtype=None):
        if a is None:
            return None
        a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
        return torch.from_numpy(a.copy()).to(device)

    out = []
    for rows, idx, deg, w, alive in groups:
        idx = np.asarray(idx)
        if idx.dtype not in (np.uint16, np.int32):
            raise TypeError(f"idx must be uint16 or int32, got {idx.dtype}")
        out.append(EllTileGroup(rows=t(rows, np.int64), idx=t(idx),
                                deg=t(deg, np.int32), w=t(w, np.float32),
                                alive=t(alive, np.int8)))
    return tuple(out)


def packed_adjacency_from_numpy(
    *,
    num_vertices: int,
    num_edges: int,
    boundaries: Sequence[int],
    hot_group_count: int,
    hot: Sequence[Dict[str, Optional[np.ndarray]]],
    cold: Dict[str, Optional[np.ndarray]],
    rows_per_block: int,
    weighted: bool,
) -> PackedAdjacency:
    """A port ``PackedAdjacency`` holding copies of the reference's arrays.

    ``hot`` is one dict per hot group with ``group`` and the ``rows``,
    ``deg``, ``idx`` (at its stored width) and ``w`` planes; ``cold`` holds
    the cold segment's ``rows``, ``deg``, ``w`` and its varint stream:
    ``ctrl``, ``data``, ``vpb``, ``block_ctrl``, ``block_data``.
    """
    def c(a):
        return None if a is None else np.array(a, copy=True)

    hot_groups = tuple(HotGroup(group=int(h["group"]), rows=c(h["rows"]),
                                deg=c(h["deg"]), idx=c(h["idx"]), w=c(h["w"]))
                       for h in hot)
    lists = codec.GroupVarintLists(
        ctrl=c(cold["ctrl"]), data=c(cold["data"]), vpb=c(cold["vpb"]),
        block_ctrl=c(cold["block_ctrl"]), block_data=c(cold["block_data"]),
        rows_per_block=int(rows_per_block),
        num_rows=int(np.asarray(cold["rows"]).shape[0]))
    return PackedAdjacency(
        num_vertices=int(num_vertices), num_edges=int(num_edges),
        boundaries=tuple(int(b) for b in boundaries),
        hot_group_count=int(hot_group_count), hot=hot_groups,
        cold=ColdSegment(rows=c(cold["rows"]), deg=c(cold["deg"]),
                         lists=lists, w=c(cold["w"])),
        weighted=bool(weighted))


def ell_groups_from_numpy(
    groups: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    device: Union[str, torch.device],
) -> List[EllGroup]:
    """``(rows, idx, w, num_rows)`` numpy planes → K1 ``EllGroup``s on
    ``device`` (rows int64, idx int32, w float32)."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return [EllGroup(rows=t(rows, np.int64), idx=t(idx, np.int32),
                     w=t(w, np.float32), num_rows=int(num_rows))
            for rows, idx, w, num_rows in groups]
