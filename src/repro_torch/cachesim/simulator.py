"""Exact LRU stack-distance cache model.

The port's copy of ``repro.cachesim.simulator`` (numpy only, bitwise equal
results; ``tests/test_torch_cachesim.py``).

One pass computes the reuse (stack) distance of EVERY access; the stack
distance histogram then yields hit/miss counts for *all* cache capacities at
once (fully-associative LRU; a standard, stated approximation of the paper's
set-associative hierarchy).  Stack distances reduce to per-element inversion
counts over the previous-occurrence array (see ``_fenwick_distances``), which
a fully-vectorized mergesort computes in O(N log^2 N) numpy — multi-million-
access traces take seconds on one CPU core, no sequential simulation.

Hierarchy model mirrors the paper's Xeon E5-2630 v4 (L1 32K / L2 256K /
L3 25M), geometrically scaled to our reduced dataset sizes (see
``scaled_hierarchy``, which states the scaling).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = [
    "stack_distances",
    "stack_distances_np",
    "miss_curve",
    "CacheLevels",
    "scaled_hierarchy",
    "mpka",
    "mpka_pinned",
    "amat_cycles",
]

COLD = np.int64(2**62)  # sentinel distance for cold (first-touch) misses


def _prev_occurrence(trace: np.ndarray) -> np.ndarray:
    """prev[i] = index of previous access to trace[i], or -1 (vectorized)."""
    order = np.argsort(trace, kind="stable")
    sorted_t = trace[order]
    prev_sorted = np.full(trace.shape[0], -1, dtype=np.int64)
    same = sorted_t[1:] == sorted_t[:-1]
    prev_sorted[1:][same] = order[:-1][same]
    prev = np.empty_like(prev_sorted)
    prev[order] = prev_sorted
    return prev


def _count_earlier_greater(p: np.ndarray) -> np.ndarray:
    """c[i] = #{j < i : p[j] > p[i]} — per-element inversion count.

    Fully-vectorized bottom-up mergesort: at each level the array is sorted
    within blocks of width w; every RIGHT-half element counts the left-sibling
    elements greater than it with ONE global ``np.searchsorted`` using the
    block-offset trick (values augmented by block_id * stride so blocks form a
    single ascending array).  O(N log^2 N), all numpy.
    """
    n = p.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    big = 1 << int(np.ceil(np.log2(max(2, n))))
    # -SENT pads never count as "greater"; their own counts are discarded.
    sent = np.int64(n + 2)
    vals = np.concatenate([p.astype(np.int64), np.full(big - n, -sent)])
    perm = np.arange(big, dtype=np.int64)
    counts = np.zeros(big, dtype=np.int64)
    stride = np.int64(4 * sent)  # > any |value| spread inside a block
    pos = np.arange(big, dtype=np.int64)
    w = 1
    while w < big:
        blk_w = pos // w  # w-block id of every position
        # ascending-across-blocks augmented array (vals sorted within w-blocks)
        aug = blk_w * stride + vals
        is_right = (pos % (2 * w)) >= w
        q_pos = pos[is_right]
        left_blk = (q_pos // (2 * w)) * 2  # w-block id of the left sibling
        q_aug = left_blk * stride + vals[is_right]
        # elements in left block <= query value:
        le = np.searchsorted(aug, q_aug, side="right") - left_blk * w
        counts[perm[is_right]] += w - le
        # merge to 2w blocks: stable sort by (2w-block id, value)
        key = (pos // (2 * w)) * stride + vals
        order = np.argsort(key, kind="stable")
        vals = vals[order]
        perm = perm[order]
        w *= 2
    # counts is indexed by ORIGINAL element index throughout (via perm)
    return counts[:n]


def _fenwick_distances(prev: np.ndarray, n: int) -> np.ndarray:
    """Stack distances from previous-occurrence pointers.

    Identity: the distinct blocks strictly inside the window (p_i, i) are
    exactly the j with p_i < j < i whose own previous occurrence lies at or
    before p_i; the complement set {j < i : p_j > p_i} automatically satisfies
    p_i < p_j < j < i.  Hence

        d_i = (i - p_i - 1) - #{j < i : p_j > p_i}

    and the count is a per-element inversion count over ``prev`` — computed by
    the vectorized mergesort above (no sequential cache simulation at all).
    """
    p = prev.astype(np.int64)
    c = _count_earlier_greater(p)
    d = (np.arange(n, dtype=np.int64) - p - 1) - c
    return np.where(p >= 0, d, np.int64(2**30))


def stack_distances(block_trace: np.ndarray) -> np.ndarray:
    """LRU stack distance per access: number of distinct OTHER blocks touched
    since the previous access to the same block (cold miss → 2**30)."""
    trace = np.asarray(block_trace, dtype=np.int64)
    prev = _prev_occurrence(trace)
    n = int(trace.shape[0])
    return _fenwick_distances(prev, n)


def stack_distances_np(block_trace: np.ndarray) -> np.ndarray:
    """Brute-force oracle for tests: simulate an LRU stack in Python."""
    stack: list[int] = []
    out = np.empty(block_trace.shape[0], dtype=np.int64)
    for i, b in enumerate(block_trace):
        try:
            pos = stack.index(b)
            out[i] = pos  # distinct others above it
            stack.pop(pos)
        except ValueError:
            out[i] = 2**30
        stack.insert(0, b)
    return out


def miss_curve(distances: np.ndarray, capacities: np.ndarray) -> np.ndarray:
    """misses(C) for each capacity (in blocks): access misses iff d >= C."""
    d = np.sort(distances)
    return distances.shape[0] - np.searchsorted(d, capacities, side="left")


@dataclasses.dataclass(frozen=True)
class CacheLevels:
    l1_blocks: int
    l2_blocks: int
    l3_blocks: int
    # latencies (cycles) — Broadwell-era figures
    lat_l1: float = 4.0
    lat_l2: float = 12.0
    lat_l3: float = 40.0
    lat_mem: float = 200.0


def scaled_hierarchy(num_vertices: int, *, bytes_per_vertex: int = 8,
                     block_bytes: int = 64) -> CacheLevels:
    """Scale the paper's hierarchy to the reduced dataset.

    The paper's large datasets have property arrays ~30x the LLC.  We keep the
    LLC at ~1/16 of the property footprint (hot footprint ~2-4x LLC → the
    thrashing regime of Table III/IV), with paper-proportioned L1:L2:L3
    spacing compressed to 1:8:64 so every level stays >= 16 blocks at our
    scales."""
    property_blocks = max(64, num_vertices * bytes_per_vertex // block_bytes)
    l3 = max(256, property_blocks // 16)
    l2 = max(32, l3 // 8)
    l1 = max(16, l2 // 8)
    return CacheLevels(l1_blocks=l1, l2_blocks=l2, l3_blocks=l3)


def mpka(distances: np.ndarray, levels: CacheLevels) -> Dict[str, float]:
    """Misses per kilo-access at each level (paper reports MPKI; accesses are
    the app's irregular property accesses ≈ instructions/10, stated)."""
    caps = np.array([levels.l1_blocks, levels.l2_blocks, levels.l3_blocks])
    m = miss_curve(distances, caps)
    n = max(1, distances.shape[0])
    return {
        "l1_mpka": 1000.0 * m[0] / n,
        "l2_mpka": 1000.0 * m[1] / n,
        "l3_mpka": 1000.0 * m[2] / n,
    }


def mpka_pinned(
    block_trace: np.ndarray,
    pinned_blocks: np.ndarray,
    levels: CacheLevels,
) -> Dict[str, float]:
    """GRASP-lite (Faldu et al.): a pinned hot region bypasses LLC demotion.

    Domain-specialized cache management, reduced to its stack-distance
    essence: the pinned blocks (the packed layout's hot segment) are
    permanently resident in the LLC — they miss only on first touch and
    never age out — while every other block competes under plain LRU for
    the remaining ``l3 - |pinned|`` blocks.  Pinned accesses do not disturb
    the LRU stack of the unpinned stream (they bypass it), so the unpinned
    stream's stack distances are computed on its own subtrace.

    Pinning is refused (plain LRU numbers returned) when the touched pinned
    footprint exceeds half the LLC — GRASP's own conservatism: pinning a
    region comparable to the cache would just thrash the tail.

    Returns the plain per-level MPKA plus ``l3_pinned_mpka`` and the number
    of resident ``pinned_blocks``.
    """
    trace = np.asarray(block_trace, dtype=np.int64)
    full = mpka(stack_distances(trace), levels)
    is_pinned = np.isin(trace, np.asarray(pinned_blocks, dtype=np.int64))
    touched = np.unique(trace[is_pinned])
    out = dict(full)
    if touched.size == 0 or touched.size > levels.l3_blocks // 2:
        out["l3_pinned_mpka"] = full["l3_mpka"]
        out["pinned_blocks"] = 0
        return out
    sub = trace[~is_pinned]
    d = stack_distances(sub)
    eff = np.array([levels.l3_blocks - touched.size])
    misses = int(touched.size) + int(miss_curve(d, eff)[0])
    out["l3_pinned_mpka"] = 1000.0 * misses / max(1, trace.shape[0])
    out["pinned_blocks"] = int(touched.size)
    return out


def amat_cycles(distances: np.ndarray, levels: CacheLevels) -> float:
    """Average memory access time over the trace (cycles/access) — the
    speedup model for Fig 3/5/6-style comparisons."""
    n = max(1, distances.shape[0])
    caps = np.array([levels.l1_blocks, levels.l2_blocks, levels.l3_blocks])
    m1, m2, m3 = miss_curve(distances, caps) / n
    h1 = 1.0 - m1
    h2 = m1 - m2
    h3 = m2 - m3
    return (
        h1 * levels.lat_l1 + h2 * levels.lat_l2 + h3 * levels.lat_l3 + m3 * levels.lat_mem
    )
