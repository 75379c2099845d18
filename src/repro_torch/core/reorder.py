"""The paper's primary contribution: the degree-based grouping framework.

Listing 1 (DBG) generalized exactly as Table V describes: every skew-aware
technique — Sort, Hub Sorting, Hub Clustering, DBG — is an instance of one
*grouping framework* parameterized by the group degree-ranges.  We implement
the framework once (``GroupingSpec`` + ``group_reorder``) and derive each
technique from it, which is also how the paper's own evaluation implements
HubSort/HubCluster ("implemented using the DBG algorithm as per Table V").

All reorderings return a MAPPING ``M`` with ``M[v] = new id of original vertex
v`` (paper's Listing 1 output), plus the measured reordering wall-time, since
reordering cost is a first-class metric (objective O1, Tables XI/XII).

Degree used for reordering follows Table VIII: out-degree for pull-dominated
apps, in-degree for push-dominated apps — callers pass whichever applies.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph import csr
from ..obs import counters as obs_counters
from ..obs import trace as obs_trace

__all__ = [
    "GroupingSpec",
    "ReorderResult",
    "group_reorder",
    "identity",
    "random_vertex",
    "random_cache_block",
    "sort_by_degree",
    "hubsort",
    "hubcluster",
    "dbg",
    "dbg_spec",
    "sort_spec",
    "hubsort_spec",
    "hubcluster_spec",
    "compose",
    "TECHNIQUES",
    "reorder_graph",
]


@dataclasses.dataclass(frozen=True)
class GroupingSpec:
    """Degree ranges, hottest group first.

    ``boundaries`` is a descending sequence ``[b0, b1, ..., b_{K-1}]``; group k
    holds vertices with degree in ``[b_k, b_{k-1})`` where ``b_{-1} = +inf``.
    The last boundary must be 0 so every vertex lands in exactly one group
    (Listing 1 step 1: ranges are contiguous, exclusive, and cover [min, max]).

    ``sort_within`` — if True, vertices inside every group are additionally
    sorted by descending degree (stable).  False = DBG semantics (preserve
    original relative order); True + unit ranges = Sort semantics.
    """

    boundaries: Tuple[int, ...]
    sort_within: bool = False

    def __post_init__(self):
        b = self.boundaries
        if len(b) == 0 or b[-1] != 0:
            raise ValueError("boundaries must end at 0 to cover all degrees")
        if any(b[i] <= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("boundaries must be strictly descending")

    @property
    def num_groups(self) -> int:
        return len(self.boundaries)


@dataclasses.dataclass(frozen=True)
class ReorderResult:
    mapping: np.ndarray  # M[v] -> new id
    seconds: float  # measured reordering time (relabel-map construction)
    technique: str
    num_groups: int = 1


def _assign_groups(degrees: np.ndarray, boundaries: Sequence[int]) -> np.ndarray:
    """Group index (0 = hottest) for every vertex. Vectorized binning."""
    # boundaries descending; group k: degree >= b_k and degree < b_{k-1}
    b = np.asarray(boundaries, dtype=np.int64)
    # searchsorted on ascending array of lower bounds
    asc = b[::-1]  # ascending lower bounds, last is largest
    idx = np.searchsorted(asc, degrees, side="right") - 1  # index into asc
    groups = (len(b) - 1) - idx
    return groups.astype(np.int64)


def group_reorder(
    degrees: np.ndarray, spec: GroupingSpec, technique: str = "group"
) -> ReorderResult:
    """Listing 1, vectorized.

    Step 1: ranges come from ``spec``.  Step 2: stable binning — original order
    preserved inside each group via stable counting (we use a stable argsort on
    the group key only, NOT on degree).  Step 3: new ids are positions in the
    concatenation of groups (hottest group first).
    """
    t0 = time.perf_counter()
    degrees = np.asarray(degrees)
    groups = _assign_groups(degrees, spec.boundaries)
    if spec.sort_within:
        # lexicographic (group asc, degree desc) stable — np.lexsort: last key primary
        order = np.lexsort((np.arange(degrees.shape[0]), -degrees, groups))
    else:
        # stable sort on group alone keeps original relative order within groups
        order = np.argsort(groups, kind="stable")
    # order[i] = original vertex placed at new position i  →  invert
    mapping = np.empty_like(order)
    mapping[order] = np.arange(order.shape[0], dtype=order.dtype)
    dt = time.perf_counter() - t0
    return ReorderResult(mapping=mapping.astype(np.int64), seconds=dt,
                         technique=technique, num_groups=spec.num_groups)


# ---------------------------------------------------------------------------
# Table V constructors: every technique as a GroupingSpec over the same framework
# ---------------------------------------------------------------------------

def sort_spec(max_degree: int) -> GroupingSpec:
    """Sort == one group per unique degree value: ranges [n, n+1)."""
    return GroupingSpec(tuple(range(int(max_degree), -1, -1)), sort_within=False)


def hubsort_spec(avg_degree: float, max_degree: int) -> GroupingSpec:
    """Hub Sorting == unit ranges above A (sorted hot), single [0, A) cold group."""
    a = max(1, int(np.ceil(avg_degree)))
    bounds = tuple(range(int(max_degree), a - 1, -1)) + (0,)
    if len(bounds) == 1:  # degenerate: everything cold
        return GroupingSpec((0,))
    return GroupingSpec(bounds, sort_within=False)


def hubcluster_spec(avg_degree: float) -> GroupingSpec:
    """Hub Clustering == two groups: [A, M] hot, [0, A) cold."""
    a = max(1, int(np.ceil(avg_degree)))
    return GroupingSpec((a, 0), sort_within=False)


def dbg_spec(avg_degree: float, num_hot_groups: int = 6) -> GroupingSpec:
    """The paper's DBG configuration (§V-C): 8 groups
    [32A,inf) [16A,32A) [8A,16A) [4A,8A) [2A,4A) [A,2A) [A/2,A) [0,A/2).

    ``num_hot_groups`` controls how many geometric ranges sit at/above A
    (6 in the paper), plus the two cold groups [A/2, A) and [0, A/2).
    """
    a = max(1.0, float(avg_degree))
    bounds: List[int] = []
    for i in range(num_hot_groups - 1, -1, -1):  # 32A, 16A, ..., A
        bounds.append(int(np.ceil(a * (2 ** i))))
    bounds.append(max(1, int(np.ceil(a / 2))))  # [A/2, A)
    bounds.append(0)  # [0, A/2)
    # dedupe while keeping descending strictness (tiny A may collide)
    out: List[int] = []
    for b in bounds:
        if not out or b < out[-1]:
            out.append(b)
    return GroupingSpec(tuple(out), sort_within=False)


# ---------------------------------------------------------------------------
# Named techniques (paper §V-C). Each returns ReorderResult for given degrees.
# ---------------------------------------------------------------------------

def identity(degrees: np.ndarray, seed: int = 0) -> ReorderResult:
    n = degrees.shape[0]
    return ReorderResult(np.arange(n, dtype=np.int64), 0.0, "original")


def random_vertex(degrees: np.ndarray, seed: int = 0) -> ReorderResult:
    """RV (Fig 3): random permutation of all vertices — destroys everything."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    mapping = rng.permutation(degrees.shape[0]).astype(np.int64)
    return ReorderResult(mapping, time.perf_counter() - t0, "random_vertex")


def random_cache_block(
    degrees: np.ndarray, n_blocks: int = 1, *, vertices_per_block: int = 8, seed: int = 0
) -> ReorderResult:
    """RCB-n (Fig 3): randomly permute blocks of ``n_blocks`` cache blocks,
    keeping vertices inside each block together — footprint of hot vertices is
    unchanged; only inter-block structure is disrupted."""
    t0 = time.perf_counter()
    n = degrees.shape[0]
    span = n_blocks * vertices_per_block
    num_chunks = (n + span - 1) // span
    rng = np.random.default_rng(seed)
    chunk_perm = rng.permutation(num_chunks)
    # new position of original vertex v: rank of its chunk * span + offset
    chunk_of = np.arange(n) // span
    new_chunk_pos = np.empty(num_chunks, dtype=np.int64)
    new_chunk_pos[chunk_perm] = np.arange(num_chunks, dtype=np.int64)
    # compact: chunks may be ragged at the tail; compute exact offsets
    chunk_sizes = np.full(num_chunks, span, dtype=np.int64)
    chunk_sizes[-1] = n - span * (num_chunks - 1)
    sizes_in_new_order = chunk_sizes[chunk_perm]
    starts_in_new_order = np.zeros(num_chunks, dtype=np.int64)
    np.cumsum(sizes_in_new_order[:-1], out=starts_in_new_order[1:])
    chunk_start_new = np.empty(num_chunks, dtype=np.int64)
    chunk_start_new[chunk_perm] = starts_in_new_order
    offset = np.arange(n, dtype=np.int64) - chunk_of * span
    mapping = chunk_start_new[chunk_of] + offset
    return ReorderResult(
        mapping.astype(np.int64), time.perf_counter() - t0, f"random_cb{n_blocks}"
    )


def sort_by_degree(degrees: np.ndarray, seed: int = 0) -> ReorderResult:
    """Sort: descending degree, stable. (Table V: per-unique-degree groups.)"""
    t0 = time.perf_counter()
    order = np.argsort(-degrees, kind="stable")
    mapping = np.empty_like(order)
    mapping[order] = np.arange(order.shape[0])
    # Table V: Sort is one group per DISTINCT degree value actually present
    n_groups = int(np.unique(degrees).shape[0])
    return ReorderResult(mapping.astype(np.int64), time.perf_counter() - t0, "sort",
                         num_groups=n_groups)


def hubsort(degrees: np.ndarray, seed: int = 0) -> ReorderResult:
    """HubSort: sort hot (deg >= A) descending, cold keep original order."""
    t0 = time.perf_counter()
    a = degrees.mean() if degrees.size else 0.0
    hot = degrees >= max(1.0, a)
    n = degrees.shape[0]
    idx = np.arange(n)
    hot_idx = idx[hot]
    hot_order = hot_idx[np.argsort(-degrees[hot], kind="stable")]
    cold_idx = idx[~hot]
    order = np.concatenate([hot_order, cold_idx])
    mapping = np.empty(n, dtype=np.int64)
    mapping[order] = np.arange(n, dtype=np.int64)
    return ReorderResult(mapping, time.perf_counter() - t0, "hubsort", num_groups=2)


def hubcluster(degrees: np.ndarray, seed: int = 0) -> ReorderResult:
    """HubCluster: segregate hot from cold, no sorting anywhere (2 stable groups)."""
    a = degrees.mean() if degrees.size else 0.0
    spec = hubcluster_spec(max(1.0, a))
    r = group_reorder(degrees, spec, "hubcluster")
    return r


def dbg(degrees: np.ndarray, seed: int = 0, num_hot_groups: int = 6) -> ReorderResult:
    """DBG with the paper's 8-group configuration."""
    a = degrees.mean() if degrees.size else 1.0
    spec = dbg_spec(max(1.0, a), num_hot_groups=num_hot_groups)
    return group_reorder(degrees, spec, "dbg")


def compose(first: np.ndarray, then: np.ndarray) -> np.ndarray:
    """Compose mappings: apply ``first`` then ``then`` (e.g. Gorder+DBG, §VII)."""
    # new_id = then[first[v]]
    return then[first]


TECHNIQUES: Dict[str, Callable[..., ReorderResult]] = {
    "original": identity,
    "random_vertex": random_vertex,
    "sort": sort_by_degree,
    "hubsort": hubsort,
    "hubcluster": hubcluster,
    "dbg": dbg,
}


def reorder_graph(
    g: csr.Graph,
    technique: str,
    *,
    degree_source: str = "out",
    seed: int = 0,
) -> tuple[csr.Graph, ReorderResult]:
    """Apply a named technique end-to-end: compute degrees (Table VIII column
    'Degree Type used for Reordering'), build the mapping, relabel the CSR.
    The relabel (CSR rebuild) time is counted into ``seconds`` — the paper's
    reordering cost includes regenerating the CSR-like structure (§VIII-A).

    Both phases are published (``obs.counters.record_phases``): the
    technique's own ``seconds`` as ``reorder.mapping``, ending where the
    relabel starts, and the relabel as ``reorder.relabel``."""
    degs = g.out_degrees() if degree_source == "out" else g.in_degrees()
    res = TECHNIQUES[technique](degs, seed=seed)
    t0 = obs_trace.now()
    g2 = csr.relabel(g, res.mapping, name=f"{g.name}+{technique}")
    t1 = obs_trace.now()
    obs_counters.record_phases("reorder", ("mapping", "relabel"),
                               (t0 - round(res.seconds * 1e9), t0, t1))
    return g2, dataclasses.replace(res, seconds=res.seconds + (t1 - t0) / 1e9)
