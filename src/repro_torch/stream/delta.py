"""Batched dynamic-graph layer over the frozen CSR (the stream substrate).

The port's copy of ``repro.stream.delta`` (numpy only, bitwise equal state;
``tests/test_torch_stream.py``); ``_match_directions`` computes the
reference's out/in pairing with a faster sort (``_edge_order``).

``DeltaGraph`` turns the snapshot ``graph.csr.Graph`` into a long-lived,
updatable structure without giving up the flat-array layout every other
subsystem (apps engine, cachesim, dist) is built on:

  * the *base* stays a frozen CSR in both directions;
  * insertions land in append-only delta buffers (amortized O(batch) apply);
  * deletions tombstone edges in place (``base_alive`` / extra alive masks);
    a per-construction bijection between out- and in-edge positions keeps the
    two CSR directions consistent under tombstoning without rebuilding either;
  * per-vertex in/out degrees are maintained incrementally — they are the
    input of the paper's DBG grouping, so the reordering layer never has to
    rescan the graph;
  * once churn (inserted + deleted edges since the last compaction) crosses a
    threshold, ``compact()`` folds everything back into a flat CSR — the
    streaming analogue of an LSM merge.

``apply`` returns an ``ApplyResult`` that carries the pre-batch state the
incremental consumers need (old degrees and old adjacency of the sources the
batch touched), so PageRank/SSSP/DBG maintenance can be driven purely from
the batch, never from an O(V+E) rescan.

The vertex set is fixed at construction (ids ``[0, V)``), like most streaming
graph engines' preallocated id space; grow the id space at compaction time if
a workload ever needs it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from ..graph import csr

__all__ = ["ApplyResult", "DeltaGraph", "occurrence_rank"]


def occurrence_rank(inv: np.ndarray) -> np.ndarray:
    """Rank of each element within its key group (0 for a key's first
    occurrence in array order, 1 for its second, ...).

    The per-key occurrence-claim primitive shared by the deletion staging
    below and ``IncrementalSSSP._scrub_pending``.
    """
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    starts = np.flatnonzero(np.r_[True, np.diff(sorted_inv) != 0])
    counts = np.diff(np.r_[starts, inv.size])
    ranks = np.empty(inv.size, dtype=np.int64)
    ranks[order] = np.arange(inv.size) - np.repeat(starts, counts)
    return ranks


_ragged = csr.ragged_offsets


def _edge_order(key: np.ndarray, w: Optional[np.ndarray]) -> np.ndarray:
    """``np.lexsort((w, src, dst))`` (``np.lexsort((src, dst))`` without
    ``w``) for ``key = dst * V + src``: a stable sort of the integer key,
    then each run of equal keys (parallel edges) re-sorted by weight,
    stably.  Both orders are by (dst, src, w, position)."""
    order = np.argsort(key, kind="stable")
    if w is None:
        return order
    ks = key[order]
    same = ks[1:] == ks[:-1]
    tied = np.zeros(ks.shape[0], dtype=bool)
    tied[1:] |= same
    tied[:-1] |= same
    if tied.any():
        sub = order[tied]  # the runs, each in position order
        order[tied] = sub[np.lexsort((w[sub], key[sub]))]
    return order


@dataclasses.dataclass(frozen=True)
class ApplyResult:
    """One applied update batch, plus the pre-batch context consumers need."""

    add_src: np.ndarray
    add_dst: np.ndarray
    add_w: Optional[np.ndarray]
    del_src: np.ndarray
    del_dst: np.ndarray
    del_w: Optional[np.ndarray]  # weights of the edges actually removed
    touched: np.ndarray  # unique vertices with any endpoint change
    cand_sources: np.ndarray  # unique sources named by the batch
    cand_old_out_deg: np.ndarray  # their out-degrees BEFORE the batch
    old_edges_src: np.ndarray  # pre-batch alive out-edges of cand_sources
    old_edges_dst: np.ndarray
    seconds: float

    @property
    def num_inserted(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def num_deleted(self) -> int:
        return int(self.del_src.shape[0])


def _as_ids(x, num_vertices: int, what: str) -> np.ndarray:
    a = np.asarray(x, dtype=np.int64).ravel()
    if a.size and (a.min() < 0 or a.max() >= num_vertices):
        raise ValueError(f"{what} vertex id out of range [0, {num_vertices})")
    return a


class DeltaGraph:
    """Mutable graph = frozen base CSR + delta buffers + tombstones."""

    def __init__(self, base: csr.Graph, *, initial_capacity: int = 1024):
        self._extra_capacity = max(16, int(initial_capacity))
        self._rebind(base)
        self.out_deg = base.out_degrees().astype(np.int64)
        self.in_deg = base.in_degrees().astype(np.int64)
        self.version = 0

    # -- construction-time indexes over the (new) base ----------------------
    def _rebind(self, base: csr.Graph) -> None:
        self.base = base
        v = base.num_vertices
        out = base.out_csr
        self._base_src = np.repeat(
            np.arange(v, dtype=np.int64), out.degrees())
        self._base_dst = out.indices.astype(np.int64)
        self._base_w = out.weights  # None for unweighted graphs
        self.base_alive = np.ones(out.num_edges, dtype=bool)
        self._out2in = self._match_directions(base)
        # key-sorted view of base out-edges for O(log E) deletion lookup
        key = self._base_src * np.int64(v) + self._base_dst
        self._base_key_order = np.argsort(key, kind="stable")
        self._base_key_sorted = key[self._base_key_order]
        # delta buffers (capacity-doubling append)
        cap = self._extra_capacity
        self._n_extra = 0
        self._ex_src = np.zeros(cap, np.int64)
        self._ex_dst = np.zeros(cap, np.int64)
        self._ex_w = np.ones(cap, np.float32)
        self._ex_alive = np.zeros(cap, dtype=bool)
        self._dead_base = 0
        self._dead_extra = 0
        self.inserted_since_compact = 0
        self.deleted_since_compact = 0

    @staticmethod
    def _match_directions(base: csr.Graph) -> np.ndarray:
        """Bijection out-edge-position -> in-edge-position over equal edges.

        Both directions hold the same (src, dst, w) multiset; sorting each
        by (dst, src, w), stably, aligns them elementwise, giving a pairing
        that lets a tombstone set on out positions mask the in direction
        too.  The reference lexsorts the three keys; ``_edge_order`` gives
        the same permutations several times faster (the graph plane's
        largest cost at 2^21 vertices: it runs at construction and at
        every compaction).
        """
        v = base.num_vertices
        out_src = np.repeat(np.arange(v, dtype=np.int64),
                            base.out_csr.degrees())
        out_dst = base.out_csr.indices.astype(np.int64)
        in_src = base.in_csr.indices.astype(np.int64)
        in_dst = np.repeat(np.arange(v, dtype=np.int64),
                           base.in_csr.degrees())
        weighted = base.out_csr.weights is not None
        o = _edge_order(out_dst * np.int64(v) + out_src,
                        base.out_csr.weights if weighted else None)
        i = _edge_order(in_dst * np.int64(v) + in_src,
                        base.in_csr.weights if weighted else None)
        out2in = np.empty(out_src.shape[0], dtype=np.int64)
        out2in[o] = i
        return out2in

    # -- sizes ---------------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return self.base.num_vertices

    @property
    def num_edges(self) -> int:
        return (self.base.num_edges - self._dead_base
                + self._n_extra - self._dead_extra)

    @property
    def weighted(self) -> bool:
        return self._base_w is not None

    @property
    def churn(self) -> int:
        """Inserted + deleted edges since the last compaction."""
        return self.inserted_since_compact + self.deleted_since_compact

    @property
    def dead_base_edges(self) -> int:
        """Tombstoned BASE edge count — monotone per base, reset by rebind.

        Part of the public contract: ``stream.incremental`` keys its cached
        device alive-masks on ``(base identity, dead_base_edges)``, so any
        mutation of ``base_alive`` must be reflected here (and is: only
        ``apply`` flips base tombstones, incrementing this counter).
        """
        return self._dead_base

    def should_compact(self, threshold: float = 0.25) -> bool:
        return self.churn > threshold * max(1, self.base.num_edges)

    def out_degrees(self) -> np.ndarray:
        return self.out_deg

    def in_degrees(self) -> np.ndarray:
        return self.in_deg

    # -- adjacency enumeration ----------------------------------------------
    def out_edges_of(self, sources: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) of all CURRENT alive out-edges of ``sources``.

        O(sum of out-degrees of sources + n_extra) — the incremental-PageRank
        residual path; never scans the whole base.
        """
        sources = np.asarray(sources, dtype=np.int64).ravel()
        indptr = self.base.out_csr.indptr
        starts = indptr[sources]
        counts = indptr[sources + 1] - starts
        total = int(counts.sum())
        if total:
            offs = np.repeat(starts, counts) + (
                np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts))
            alive = self.base_alive[offs]
            bs = np.repeat(sources, counts)[alive]
            bd = self._base_dst[offs[alive]]
        else:
            bs = bd = np.empty(0, np.int64)
        n = self._n_extra
        if n:
            m = self._ex_alive[:n] & np.isin(self._ex_src[:n], sources)
            es, ed = self._ex_src[:n][m], self._ex_dst[:n][m]
        else:
            es = ed = np.empty(0, np.int64)
        return np.concatenate([bs, es]), np.concatenate([bd, ed])

    def alive_edges(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Full current (src, dst, w) edge list — O(E), for snapshots."""
        m = self.base_alive
        src = [self._base_src[m]]
        dst = [self._base_dst[m]]
        w = None if self._base_w is None else [self._base_w[m]]
        n = self._n_extra
        em = self._ex_alive[:n]
        src.append(self._ex_src[:n][em])
        dst.append(self._ex_dst[:n][em])
        if w is not None:
            w.append(self._ex_w[:n][em])
        return (np.concatenate(src), np.concatenate(dst),
                None if w is None else np.concatenate(w).astype(np.float32))

    def snapshot(self, name: Optional[str] = None) -> csr.Graph:
        """Materialize the current graph as a flat CSR (state unchanged)."""
        src, dst, w = self.alive_edges()
        return csr.from_edges(src, dst, self.num_vertices, weights=w,
                              name=name or f"{self.base.name}@v{self.version}")

    def compact(self, name: Optional[str] = None) -> csr.Graph:
        """Fold base + deltas − tombstones into a fresh flat base CSR."""
        g = self.snapshot(name)
        self._rebind(g)
        if not (np.array_equal(self.out_deg, g.out_degrees())
                and np.array_equal(self.in_deg, g.in_degrees())):
            raise RuntimeError(
                "DeltaGraph degree bookkeeping diverged from the compacted "
                "CSR (max out-degree drift "
                f"{int(np.abs(self.out_deg - g.out_degrees()).max())}, "
                "max in-degree drift "
                f"{int(np.abs(self.in_deg - g.in_degrees()).max())})")
        return g

    # -- the batched update path ---------------------------------------------
    def _grow_extras(self, need: int) -> None:
        cap = self._ex_src.shape[0]
        if self._n_extra + need <= cap:
            return
        while cap < self._n_extra + need:
            cap *= 2
        for attr in ("_ex_src", "_ex_dst", "_ex_w", "_ex_alive"):
            old = getattr(self, attr)
            new = np.zeros(cap, dtype=old.dtype)
            if attr == "_ex_w":
                new[:] = 1.0
            new[: self._n_extra] = old[: self._n_extra]
            setattr(self, attr, new)

    def apply(
        self,
        add_src=None,
        add_dst=None,
        add_w=None,
        del_src=None,
        del_dst=None,
    ) -> ApplyResult:
        """Apply one batch of edge insertions and deletions.

        Cost: O(batch) for inserts and degree upkeep; the deletion lookup
        additionally sorts the live delta buffer, O(churn log churn) — and
        churn is bounded by the compaction threshold, so apply stays
        amortized O(batch) under the service's compaction policy.

        Deleting an edge that does not currently exist raises ``KeyError``
        and leaves the graph unchanged (the whole batch is staged first);
        exactly one occurrence of a parallel edge is removed per request.
        """
        t0 = time.perf_counter()
        v = self.num_vertices
        a_src = _as_ids(add_src if add_src is not None else [], v, "add_src")
        a_dst = _as_ids(add_dst if add_dst is not None else [], v, "add_dst")
        d_src = _as_ids(del_src if del_src is not None else [], v, "del_src")
        d_dst = _as_ids(del_dst if del_dst is not None else [], v, "del_dst")
        if a_src.shape != a_dst.shape or d_src.shape != d_dst.shape:
            raise ValueError("src/dst batch shape mismatch")
        if add_w is not None and not self.weighted:
            raise ValueError("weights supplied for an unweighted base graph")
        k = a_src.shape[0]
        if self.weighted:
            w_add = (np.ones(k, np.float32) if add_w is None
                     else np.asarray(add_w, np.float32).ravel())
            if w_add.shape[0] != k:
                raise ValueError("add_w length mismatch")
        else:
            w_add = None

        # --- stage deletions (no mutation yet: failed batches are no-ops) ----
        # Deletions may target base edges or edges inserted by THIS batch, so
        # staging happens against base ∪ extras ∪ pending inserts.
        #
        # The claim is grouped by key: every key claims the FIRST alive
        # position(s) among its candidates (base candidates in key-sorted
        # order first, then extras ∪ pending).  Keys requested ONCE in the
        # batch — the overwhelming case — are claimed in one vectorized pass
        # (the ``occurrence_rank`` pattern shared with
        # ``IncrementalSSSP._scrub_pending``); only keys named several times
        # in one batch fall back to the per-request loop, because their
        # claims may straddle the base/extras boundary request by request.
        removed_w = np.ones(d_src.shape[0], np.float32)
        kill_base: list = []
        kill_extra: list = []
        if d_src.size:
            keys = d_src * np.int64(v) + d_dst
            ne = self._n_extra
            ex_keys = self._ex_src[:ne] * np.int64(v) + self._ex_dst[:ne]
            pend_keys = a_src * np.int64(v) + a_dst
            all_ex_keys = np.concatenate([ex_keys, pend_keys])
            ex_order = np.argsort(all_ex_keys, kind="stable")
            ex_sorted = all_ex_keys[ex_order]
            ex_alive = np.concatenate(
                [self._ex_alive[:ne], np.ones(k, dtype=bool)])

            uk, inv = np.unique(keys, return_inverse=True)
            need = np.bincount(inv)
            single = need[inv] == 1  # mask over deletion requests

            def _first_alive(sk, sorted_keys, order, alive_flags):
                """First alive candidate position per key (vectorized).

                Returns (found mask over sk, claimed position per found key
                aligned with sk[found]).  Candidates of one key are visited
                in ``order``'s key-sorted stable order — identical to the
                scan order of the per-request loop below.
                """
                lo = np.searchsorted(sorted_keys, sk, side="left")
                counts = np.searchsorted(sorted_keys, sk, side="right") - lo
                owner = np.repeat(
                    np.arange(sk.shape[0], dtype=np.int64), counts)
                pos = order[_ragged(lo, counts)]
                live = alive_flags[pos]
                first = occurrence_rank(owner[live]) == 0
                found = np.zeros(sk.shape[0], dtype=bool)
                found[owner[live][first]] = True
                return found, pos[live][first]

            if np.any(single):
                didx = np.flatnonzero(single)
                # align request order with sorted-unique key order
                didx = didx[np.argsort(keys[didx], kind="stable")]
                sk = keys[didx]
                b_found, b_pos = _first_alive(
                    sk, self._base_key_sorted, self._base_key_order,
                    self.base_alive)
                kill_base.extend(b_pos.tolist())
                if self._base_w is not None:
                    removed_w[didx[b_found]] = self._base_w[b_pos]
                if not b_found.all():
                    rest = np.flatnonzero(~b_found)
                    e_found, e_pos = _first_alive(
                        sk[rest], ex_sorted, ex_order, ex_alive)
                    if not e_found.all():
                        i = int(didx[rest[np.flatnonzero(~e_found)[0]]])
                        raise KeyError(
                            f"edge ({d_src[i]}, {d_dst[i]}) not present")
                    kill_extra.extend(e_pos.tolist())
                    ex_alive[e_pos] = False
                    ew = np.ones(e_pos.shape[0], np.float32)
                    in_buf = e_pos < ne
                    ew[in_buf] = self._ex_w[e_pos[in_buf]]
                    if w_add is not None:
                        ew[~in_buf] = w_add[e_pos[~in_buf] - ne]
                    removed_w[didx[rest]] = ew

            staged_base: set = set(kill_base)
            for i in np.flatnonzero(~single):
                killed = False
                jl = np.searchsorted(self._base_key_sorted, keys[i], "left")
                jr = np.searchsorted(self._base_key_sorted, keys[i], "right")
                for j in range(jl, jr):
                    pos = int(self._base_key_order[j])
                    if self.base_alive[pos] and pos not in staged_base:
                        staged_base.add(pos)
                        kill_base.append(pos)
                        removed_w[i] = (1.0 if self._base_w is None
                                        else float(self._base_w[pos]))
                        killed = True
                        break
                if not killed:
                    jl = np.searchsorted(ex_sorted, keys[i], side="left")
                    jr = np.searchsorted(ex_sorted, keys[i], side="right")
                    for j in range(jl, jr):
                        pos = int(ex_order[j])
                        if ex_alive[pos]:
                            ex_alive[pos] = False
                            kill_extra.append(pos)
                            removed_w[i] = (
                                float(self._ex_w[pos]) if pos < ne
                                else (float(w_add[pos - ne])
                                      if w_add is not None else 1.0))
                            killed = True
                            break
                if not killed:
                    raise KeyError(
                        f"edge ({d_src[i]}, {d_dst[i]}) not present")

        # pre-batch context for incremental consumers
        cand = np.unique(np.concatenate([a_src, d_src]))
        cand_old_deg = self.out_deg[cand].copy()
        old_es, old_ed = self.out_edges_of(cand)

        # --- commit insertions: append to the delta buffers -------------------
        if k:
            self._grow_extras(k)
            n = self._n_extra
            self._ex_src[n : n + k] = a_src
            self._ex_dst[n : n + k] = a_dst
            if self.weighted:
                self._ex_w[n : n + k] = w_add
            self._ex_alive[n : n + k] = True
            self._n_extra = n + k
            np.add.at(self.out_deg, a_src, 1)
            np.add.at(self.in_deg, a_dst, 1)
            self.inserted_since_compact += k

        # --- commit deletions: tombstone --------------------------------------
        if d_src.size:
            kb = np.asarray(kill_base, dtype=np.int64)
            self.base_alive[kb] = False
            self._dead_base += kb.shape[0]
            # staged extra index == buffer index (pending inserts were staged
            # at [ne, ne+k) and committed to the same slots)
            ke = np.asarray(kill_extra, dtype=np.int64)
            self._ex_alive[ke] = False
            self._dead_extra += ke.shape[0]
            np.add.at(self.out_deg, d_src, -1)
            np.add.at(self.in_deg, d_dst, -1)
            self.deleted_since_compact += d_src.shape[0]

        self.version += 1
        touched = np.unique(np.concatenate([a_src, a_dst, d_src, d_dst]))
        return ApplyResult(
            add_src=a_src, add_dst=a_dst,
            add_w=w_add,
            del_src=d_src, del_dst=d_dst,
            del_w=removed_w if self.weighted else None,
            touched=touched,
            cand_sources=cand, cand_old_out_deg=cand_old_deg,
            old_edges_src=old_es, old_edges_dst=old_ed,
            seconds=time.perf_counter() - t0,
        )

    # -- materialization hooks (used by stream.incremental) -------------------
    def in_alive_mask(self) -> np.ndarray:
        """Alive mask over in-CSR edge positions, mirrored from out positions."""
        m = np.empty_like(self.base_alive)
        m[self._out2in] = self.base_alive
        return m

    def extras(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, w, alive) views of the delta buffer (length n_extra)."""
        n = self._n_extra
        return (self._ex_src[:n], self._ex_dst[:n], self._ex_w[:n],
                self._ex_alive[:n])
