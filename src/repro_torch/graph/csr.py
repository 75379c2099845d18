"""Compressed Sparse Row graph representation (paper §II-B).

CSR encodes in-edges for pull-based computations and out-edges for push-based
computations.  We keep BOTH directions around (``in_csr`` / ``out_csr``) exactly
like Ligra does, since the evaluated apps switch directions (pull-push).

Construction is numpy (host-side preprocessing, like a real graph framework's
loader); the arrays are plain ``np.ndarray`` so they can be copied to torch
device tensors once, then traversed by the engine.

This is the PyTorch port's own copy of ``repro.graph.csr``: the port imports
nothing of ``repro``, and ``tests/test_torch_graph.py`` holds the two copies
to bitwise-equal arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["CSR", "Graph", "from_edges", "ragged_offsets", "relabel",
           "validate"]


def ragged_offsets(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated [starts[i], starts[i] + counts[i]) index ranges.

    The segmented-arange primitive behind every vectorized CSR-row gather
    (adjacency slicing, ELL packing, varint block scatter); shared so the
    subsystems don't each carry a private copy.
    """
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    return np.repeat(np.asarray(starts, dtype=np.int64), counts) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(counts) - counts, counts))


@dataclasses.dataclass(frozen=True)
class CSR:
    """One direction of adjacency.

    ``indptr``  : (V+1,) int32/int64 — offsets into ``indices``.
    ``indices`` : (E,)   int32 — neighbor vertex ids, grouped by owning vertex.
    ``weights`` : optional (E,) float32 — edge weights (SSSP).
    """

    indptr: np.ndarray
    indices: np.ndarray
    weights: Optional[np.ndarray] = None

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed graph held in both CSR directions.

    ``in_csr``  : for vertex v, lists its in-neighbors  (sources of edges into v).
    ``out_csr`` : for vertex v, lists its out-neighbors (destinations of v's edges).
    """

    in_csr: CSR
    out_csr: CSR
    name: str = "graph"

    @property
    def num_vertices(self) -> int:
        return self.in_csr.num_vertices

    @property
    def num_edges(self) -> int:
        return self.in_csr.num_edges

    @property
    def avg_degree(self) -> float:
        return self.num_edges / max(1, self.num_vertices)

    def in_degrees(self) -> np.ndarray:
        return self.in_csr.degrees()

    def out_degrees(self) -> np.ndarray:
        return self.out_csr.degrees()


def _build_one_direction(
    key: np.ndarray, other: np.ndarray, num_vertices: int, weights: Optional[np.ndarray]
) -> CSR:
    """Group ``other`` endpoints by ``key`` endpoint (stable) into CSR."""
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    indices = other[order].astype(np.int32)
    counts = np.bincount(sorted_key, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    w = None if weights is None else weights[order].astype(np.float32)
    return CSR(indptr=indptr, indices=indices, weights=w)


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_vertices: int,
    weights: Optional[np.ndarray] = None,
    name: str = "graph",
) -> Graph:
    """Build both CSR directions from an edge list (directed edges src→dst)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if src.size and (src.min() < 0 or src.max() >= num_vertices):
        raise ValueError("src vertex id out of range")
    if dst.size and (dst.min() < 0 or dst.max() >= num_vertices):
        raise ValueError("dst vertex id out of range")
    # in_csr: for each destination, the sources. out_csr: for each source, the dests.
    in_csr = _build_one_direction(dst, src, num_vertices, weights)
    out_csr = _build_one_direction(src, dst, num_vertices, weights)
    return Graph(in_csr=in_csr, out_csr=out_csr, name=name)


def to_edges(g: Graph) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Recover the (src, dst, weight) edge list from out_csr."""
    out = g.out_csr
    src = np.repeat(np.arange(out.num_vertices, dtype=np.int64), out.degrees())
    dst = out.indices.astype(np.int64)
    return src, dst, out.weights


def relabel(g: Graph, mapping: np.ndarray, name: Optional[str] = None) -> Graph:
    """Relabel vertices: ``mapping[v]`` is the NEW id of original vertex ``v``.

    This is exactly what reordering techniques do (paper §II-E): relabel vertex ids
    and rebuild CSR so that arrays are laid out in the new id order.  The graph
    itself (its edge set) is unchanged up to isomorphism.
    """
    mapping = np.asarray(mapping, dtype=np.int64)
    if mapping.shape[0] != g.num_vertices:
        raise ValueError("mapping must cover all vertices")
    src, dst, w = to_edges(g)
    return from_edges(
        mapping[src], mapping[dst], g.num_vertices, weights=w, name=name or g.name
    )


def validate(g: Graph) -> None:
    """Structural invariants used by tests."""
    for csr in (g.in_csr, g.out_csr):
        assert csr.indptr[0] == 0
        assert csr.indptr[-1] == csr.num_edges
        assert np.all(np.diff(csr.indptr) >= 0)
        if csr.num_edges:
            assert csr.indices.min() >= 0 and csr.indices.max() < g.num_vertices
    assert g.in_csr.num_edges == g.out_csr.num_edges
    assert g.in_csr.num_vertices == g.out_csr.num_vertices
    # degree sums must agree between directions
    assert g.in_degrees().sum() == g.out_degrees().sum()
