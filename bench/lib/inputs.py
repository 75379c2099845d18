"""The benchmark's graph inputs, made on the device from the seed.

``rmat_edges`` follows the recipe of the program's host generator
(``repro_torch.graph.generators.rmat``): draw ``1.15 * E + 16`` edges by
R-MAT quadrant bits, drop self-loops and duplicate pairs (the first
occurrence of each pair stays, in draw order), trim to ``E`` edges and
relabel every vertex by a seeded permutation, so the original order is
unstructured (the paper's Table IX, "kr").  The random streams are
``torch.Generator``s on ``device``: the same seed gives the same graph on
the same kind of device.

``csr_arrays`` builds one CSR direction with the arrays
``repro_torch.graph.csr.from_edges`` gives (stable grouping by the key
endpoint, int64 offsets, int32 ids, float32 weights).  The graph is handed
to the program as host arrays, the input format the program reads, as
GAP's ``.sg`` files are.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["EdgeList", "HostCSR", "derive_seed", "generator", "rmat_edges",
           "dedup_first", "integer_weights", "csr_arrays", "make_graph"]


def derive_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run."""
    key = [int(b) for b in stream.encode()]
    state = np.random.SeedSequence(int(seed) % (1 << 64),
                                   spawn_key=key).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, stream))
    return g


class EdgeList(NamedTuple):
    """Directed edges ``src[i] -> dst[i]`` (int64, on the device)."""

    src: torch.Tensor
    dst: torch.Tensor
    num_vertices: int


class HostCSR(NamedTuple):
    """One CSR direction as host arrays: ``indptr`` (V+1,) int64,
    ``indices`` (E,) int32, ``weights`` (E,) float32 or ``None``."""

    indptr: np.ndarray
    indices: np.ndarray
    weights: Optional[np.ndarray]


def dedup_first(src: torch.Tensor, dst: torch.Tensor, num_vertices: int):
    """Drop self-loops and repeated ``(src, dst)`` pairs; the first
    occurrence of each pair stays, and the kept edges keep their order."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    code = src * num_vertices + dst
    ordered, order = torch.sort(code, stable=True)
    first = torch.ones_like(ordered, dtype=torch.bool)
    first[1:] = ordered[1:] != ordered[:-1]
    kept = torch.sort(order[first]).values
    return src[kept], dst[kept]


def rmat_edges(log2_vertices: int, num_edges: int, *, a: float, b: float,
               c: float, oversample: float, gen: torch.Generator,
               device) -> EdgeList:
    """An R-MAT graph of ``2**log2_vertices`` vertices and exactly
    ``num_edges`` distinct non-loop edges (raises if the draw falls short)."""
    v = 1 << log2_vertices
    m = int(num_edges * oversample) + 16
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    r = torch.empty(m, dtype=torch.float32, device=device)
    for _ in range(log2_vertices):
        torch.rand(m, generator=gen, device=device, out=r)
        down = r >= a + b
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src.mul_(2).add_(down)
        dst.mul_(2).add_(right)
    del r
    src, dst = dedup_first(src, dst, v)
    if src.numel() < num_edges:
        raise ValueError(f"R-MAT drew {src.numel()} distinct edges, fewer "
                         f"than {num_edges}: raise the oversampling")
    src, dst = src[:num_edges], dst[:num_edges]
    perm = torch.randperm(v, generator=gen, device=device)
    return EdgeList(perm[src], perm[dst], v)


def integer_weights(num_edges: int, low: int, high: int,
                    gen: torch.Generator, device) -> torch.Tensor:
    """Uniform integers in ``[low, high]`` as float32: every path length
    below 2**24 is exact in float32, in any order of addition."""
    return torch.randint(low, high + 1, (num_edges,), generator=gen,
                         device=device).to(torch.float32)


def csr_arrays(key: torch.Tensor, other: torch.Tensor, num_vertices: int,
               weights: Optional[torch.Tensor]) -> HostCSR:
    """``other`` endpoints grouped by ``key`` (stable), as host arrays."""
    _, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=num_vertices)
    indptr = torch.zeros(num_vertices + 1, dtype=torch.int64,
                         device=key.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    w = None if weights is None else weights[order].cpu().numpy()
    return HostCSR(indptr.cpu().numpy(),
                   other[order].to(torch.int32).cpu().numpy(), w)


def make_graph(edges: EdgeList, weights: Optional[torch.Tensor]):
    """Both directions as the program's ``Graph`` (in: grouped by
    destination, out: grouped by source)."""
    from repro_torch.graph.csr import CSR, Graph

    v = edges.num_vertices
    in_csr = csr_arrays(edges.dst, edges.src, v, weights)
    out_csr = csr_arrays(edges.src, edges.dst, v, weights)
    return Graph(in_csr=CSR(*in_csr), out_csr=CSR(*out_csr), name="input")
