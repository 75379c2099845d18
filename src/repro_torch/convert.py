"""Carry the reference's state across: numpy arrays in, the port's types out.

The parity tests feed the JAX package's own graph, tiles and LM weights (as
numpy arrays) through these, so both sides compute on identical inputs
whatever the copied generators do.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .configs.base import ArchConfig
from .device import resolve_device
from .graph.csr import CSR, Graph
from .kernels._wrap import class_segments
from .kernels.csr_spmv.ops import EllGroup
from .kernels.edge_map.ops import EllTileGroup
from .pack import codec
from .pack.layout import ColdSegment, HotGroup, PackedAdjacency

__all__ = ["graph_from_numpy", "tiles_from_numpy",
           "packed_adjacency_from_numpy", "ell_groups_from_numpy",
           "lm_params_from_numpy"]


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
    ``torch.uint16``); ``rows`` become int64, torch's index type.  A class
    wider than 1,024 lanes gets its K5 segment list from ``deg``, as
    ``ell_tiles`` builds it."""
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
        out.append(EllTileGroup(
            rows=t(rows, np.int64), idx=t(idx), deg=t(deg, np.int32),
            w=t(w, np.float32), alive=t(alive, np.int8),
            segments=class_segments(np.asarray(deg), idx.shape[1], device)))
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
    ``device`` (rows int64, idx int32, w float32).  ``deg`` stays ``None``:
    the planes cannot give it (an edge may have weight 0), so K1 reads every
    lane of these groups."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return [EllGroup(rows=t(rows, np.int64), idx=t(idx, np.int32),
                     w=t(w, np.float32), num_rows=int(num_rows))
            for rows, idx, w, num_rows in groups]


def _leaves(tree, prefix: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(dotted name, array) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def lm_state_from_numpy(tree: Dict[str, Any],
                        cfg: ArchConfig) -> Dict[str, np.ndarray]:
    """The reference's LM params pytree (numpy leaves) as the port's
    state-dict names.  ``periods[slot]`` is unstacked along axis 0 into
    layer ``period * len(pattern) + slot``; ``tail[i]`` becomes layer
    ``n_periods * len(pattern) + i``; ``embed`` and ``final_norm`` keep
    their names."""
    plen = len(cfg.layer_pattern())
    state = dict(_leaves(tree["embed"], "embed."))
    state.update(_leaves(tree.get("final_norm", {}), "final_norm."))
    for slot, sub in enumerate(tree["periods"]):
        for name, a in _leaves(sub, ""):
            for period in range(a.shape[0]):
                state[f"layers.{period * plen + slot}.{name}"] = a[period]
    base = (cfg.n_layers // plen) * plen
    for i, sub in enumerate(tree.get("tail", ())):
        for name, a in _leaves(sub, ""):
            state[f"layers.{base + i}.{name}"] = a
    return state


def lm_params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, device=None):
    """A port ``LM`` on ``device`` (the card unless the caller asks for the
    CPU) holding copies of the reference's weights; every parameter must be
    matched (``load_state_dict(strict=True)``)."""
    from .lm.model import LM

    state = {k: torch.from_numpy(np.array(a))
             for k, a in lm_state_from_numpy(tree, cfg).items()}
    model = LM(cfg, device=resolve_device(device),
               dtype=state["embed.unembed"].dtype)
    model.load_state_dict(state, strict=True)
    return model
