"""Synthetic graph generators reproducing the statistical signatures of Table IX/X.

The paper's datasets cannot be downloaded offline, so we regenerate scaled-down
graphs with the SAME distinguishing properties the paper's analysis rests on:

 * power-law degree skew  (Table I: 9-26% hot vertices own 80-94% of edges),
 * presence (lj/wl/fr/mp) or absence (kr/pl/tw/sd) of community structure in the
   ORIGINAL VERTEX ORDERING (paper §II-A / Table IX "Structured/Unstructured"),
 * no-skew graphs (uni, road) for the Fig 7 control experiment.

"Structured" in the paper means: the dataset's original vertex ids already place
community members nearby (crawl order / LLP post-processing).  We model that by
generating a community graph and assigning ids contiguously within communities.
"Unstructured" = same edge statistics but ids assigned randomly.
"""
from __future__ import annotations

import numpy as np

from . import csr

__all__ = [
    "rmat",
    "powerlaw_community",
    "uniform_random",
    "road_grid",
]


def _dedup(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop self-loops and duplicate directed edges."""
    mask = src != dst
    src, dst = src[mask], dst[mask]
    key = src.astype(np.int64) * np.int64(1) + 0  # placeholder to keep dtype
    # encode pair as single int64 (num_vertices bounded well below 2**31)
    n = max(int(src.max(initial=0)), int(dst.max(initial=0))) + 1
    code = src.astype(np.int64) * n + dst.astype(np.int64)
    _, idx = np.unique(code, return_index=True)
    idx.sort()
    return src[idx], dst[idx]


def rmat(
    num_vertices: int,
    num_edges: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    name: str = "rmat",
) -> csr.Graph:
    """R-MAT / Kronecker generator (kr; and uni with a=b=c=0.25).

    Vectorized: all edges draw their quadrant bits at once.
    ``num_vertices`` is rounded up to a power of two internally then trimmed by
    modulo, matching common practice (Graph500 / GAP kron).
    """
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(2, num_vertices))))
    n = 1 << scale
    # oversample to compensate dedup/self-loop losses
    m = int(num_edges * 1.15) + 16
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    pa, pb, pc = a, b, c
    for bit in range(scale):
        r = rng.random(m)
        # quadrant choice: [a | b / c | d]
        go_right = (r >= pa) & (r < pa + pb) | (r >= pa + pb + pc)
        go_down = r >= pa + pb
        src = (src << 1) | go_down.astype(np.int64)
        dst = (dst << 1) | go_right.astype(np.int64)
    src %= num_vertices
    dst %= num_vertices
    src, dst = _dedup(src, dst)
    src, dst = src[:num_edges], dst[:num_edges]
    # R-MAT correlates LOW ids with HIGH degree; shuffle ids so the original
    # ordering is genuinely unstructured (paper Table IX: kr "Unstructured" —
    # random reordering must leave it indifferent, Fig 3).
    perm = rng.permutation(num_vertices).astype(np.int64)
    src, dst = perm[src], perm[dst]
    return csr.from_edges(src, dst, num_vertices, name=name)


def _powerlaw_degrees(
    rng: np.random.Generator,
    num_vertices: int,
    avg_degree: float,
    alpha: float,
    cap_ratio: float = 200.0,
) -> np.ndarray:
    """Draw a power-law degree sequence with pdf ~ d^-alpha and requested mean.

    Inverse-CDF Pareto sampling (min 1) with a cap at ``cap_ratio`` x mean —
    calibrated so hot-vertex fraction / edge coverage land in the paper's
    Table I envelope (9-26% hot, 70-94% coverage) for alpha in [1.85, 2.15].
    """
    u = rng.random(num_vertices)
    raw = u ** (-1.0 / (alpha - 1.0))
    raw = np.minimum(raw, cap_ratio * raw.mean())
    deg = raw * (avg_degree / raw.mean())
    deg = np.maximum(1, np.round(deg)).astype(np.int64)
    return np.minimum(deg, num_vertices - 1)


def powerlaw_community(
    num_vertices: int,
    avg_degree: float,
    *,
    alpha: float = 1.95,
    num_communities: int = 64,
    p_in: float = 0.8,
    structured_ids: bool = True,
    seed: int = 0,
    name: str = "plc",
) -> csr.Graph:
    """Power-law graph with planted communities (lj/wl/fr/mp-like).

    Every vertex belongs to a community; a fraction ``p_in`` of each vertex's
    edges lands inside its own community (preferential attachment within), the
    rest lands anywhere (global preferential attachment).  With
    ``structured_ids=True`` the vertex ids are contiguous inside communities —
    the "Structured" original ordering of Table IX.  With False, ids are a
    random permutation — same graph statistics, "Unstructured" ordering
    (pl/tw/sd-like).
    """
    rng = np.random.default_rng(seed)
    out_deg = _powerlaw_degrees(rng, num_vertices, avg_degree, alpha)
    total_edges = int(out_deg.sum())

    # Community sizes: power-law too (few big communities), normalized.
    comm_sizes = _powerlaw_degrees(rng, num_communities, num_vertices / num_communities, 2.0)
    comm_sizes = np.maximum(1, (comm_sizes * num_vertices / comm_sizes.sum()).astype(np.int64))
    # fix rounding drift
    while comm_sizes.sum() < num_vertices:
        comm_sizes[rng.integers(num_communities)] += 1
    while comm_sizes.sum() > num_vertices:
        i = rng.integers(num_communities)
        if comm_sizes[i] > 1:
            comm_sizes[i] -= 1
    comm_of = np.repeat(np.arange(num_communities), comm_sizes)  # structured id->community
    comm_start = np.zeros(num_communities + 1, dtype=np.int64)
    np.cumsum(comm_sizes, out=comm_start[1:])

    # In-degree attractiveness ~ power-law as well (independent draw): destination
    # selection is a weighted choice — this creates hub destinations (hot vertices).
    attract = _powerlaw_degrees(rng, num_vertices, avg_degree, alpha).astype(np.float64)

    src = np.repeat(np.arange(num_vertices, dtype=np.int64), out_deg)
    inside = rng.random(total_edges) < p_in

    # Global choices (vectorized weighted sampling via cumulative inverse)
    cum = np.cumsum(attract)
    cum /= cum[-1]
    dst = np.searchsorted(cum, rng.random(total_edges)).astype(np.int64)

    # Intra-community choices: sample within [comm_start[c], comm_start[c+1])
    c_of_src = comm_of[src]
    lo = comm_start[c_of_src]
    hi = comm_start[c_of_src + 1]
    local = lo + (rng.random(total_edges) * (hi - lo)).astype(np.int64)
    dst = np.where(inside, local, dst)

    # Keep the drawn power-law degree sequence intact: drop self-loops only.
    # (Full (src,dst) dedup would collapse repeated edges into hubs and destroy
    # the calibrated skew; the evaluated apps are robust to rare multi-edges.)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    if not structured_ids:
        perm = rng.permutation(num_vertices).astype(np.int64)
        src, dst = perm[src], perm[dst]

    return csr.from_edges(src, dst, num_vertices, name=name)


def uniform_random(
    num_vertices: int, avg_degree: float, *, seed: int = 0, name: str = "uni"
) -> csr.Graph:
    """Erdos-Renyi-ish uniform graph (Table X 'uni' control: no skew)."""
    rng = np.random.default_rng(seed)
    m = int(num_vertices * avg_degree)
    src = rng.integers(0, num_vertices, size=m, dtype=np.int64)
    dst = rng.integers(0, num_vertices, size=m, dtype=np.int64)
    src, dst = _dedup(src, dst)
    return csr.from_edges(src, dst, num_vertices, name=name)


def road_grid(
    side: int, *, diag_frac: float = 0.05, seed: int = 0, name: str = "road"
) -> csr.Graph:
    """Road-network-like planar grid (Table X 'road': avg degree ~1.2-4, no skew,
    huge diameter).  4-neighbor grid with a few random diagonal shortcuts,
    symmetrized (roads are bidirectional)."""
    rng = np.random.default_rng(seed)
    n = side * side
    ids = np.arange(n, dtype=np.int64).reshape(side, side)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=0)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=0)
    e = np.concatenate([right, down], axis=1)
    # sparse shortcuts
    k = int(n * diag_frac)
    extra = rng.integers(0, n, size=(2, k), dtype=np.int64)
    e = np.concatenate([e, extra], axis=1)
    src = np.concatenate([e[0], e[1]])
    dst = np.concatenate([e[1], e[0]])
    # thin out to road-like sparsity: drop a third of grid edges
    keep = rng.random(src.shape[0]) < 0.75
    src, dst = src[keep], dst[keep]
    src, dst = _dedup(src, dst)
    return csr.from_edges(src, dst, n, name=name)


def with_weights(g: csr.Graph, *, seed: int = 0, low: float = 1.0, high: float = 16.0) -> csr.Graph:
    """Attach uniform random positive edge weights (for SSSP)."""
    rng = np.random.default_rng(seed)
    src, dst, _ = csr.to_edges(g)
    w = rng.uniform(low, high, size=src.shape[0]).astype(np.float32)
    return csr.from_edges(src, dst, g.num_vertices, weights=w, name=g.name)
