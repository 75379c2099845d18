"""Carry the reference's state across: numpy arrays in, the port's types out.

The parity tests feed the JAX package's own graph and tiles (as numpy
arrays) through these, so both sides compute on identical inputs whatever
the copied generators do.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .graph.csr import CSR, Graph
from .kernels.edge_map.ops import EllTileGroup

__all__ = ["graph_from_numpy", "tiles_from_numpy"]


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
