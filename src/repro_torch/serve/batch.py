"""Admission control: coalesce arriving queries into batches of width K.

A copy of ``repro.serve.batch`` (numpy only).

The dispatch-queue idiom: producers ``submit`` queries (bounded depth —
``QueueFull`` is the backpressure signal), and the serving loop pulls one
*batch* at a time: up to ``max_width`` queries of one kind, highest priority
first, FIFO within a priority.  A batch dispatches when it is full or when
the oldest waiting query has waited ``deadline`` seconds — the classic
throughput/latency dial (deadline 0 = dispatch whatever is waiting, pure
latency; larger deadlines let the batch fill and amortize the fused pass).

Queries carry per-query epochs: ``submit_epoch`` is the queue's monotone
ticket at admission, and the service stamps each result with the snapshot
version it was answered against — so a client can tell exactly which graph
state its answer reflects (snapshot isolation is enforced by
``serve.snapshot``; the epoch is how it is OBSERVED).

``cancel(qid)`` removes a not-yet-dispatched query; cancelled entries are
dropped lazily at batch formation so cancel is O(1).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Query", "PendingQuery", "QueueFull", "QueryQueue"]

#: query kinds the batched apps can serve (one plane per kind per batch)
KINDS = ("pagerank", "sssp")


class QueueFull(RuntimeError):
    """Backpressure: the queue is at ``max_depth`` — retry later or shed."""


@dataclasses.dataclass(frozen=True)
class Query:
    """One graph query as the client states it.

    ``kind="sssp"`` needs ``root``; ``kind="pagerank"`` takes an optional
    (V,) ``personalization`` teleport vector (None = uniform — global PR) or
    a ``root`` as shorthand for a one-hot teleport (personalized PR from
    that vertex).  Higher ``priority`` dispatches first.
    """

    kind: str
    root: Optional[int] = None
    personalization: Optional[np.ndarray] = None
    priority: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown query kind {self.kind!r}; known kinds: "
                f"{', '.join(KINDS)}")
        if self.kind == "sssp" and self.root is None:
            raise ValueError("sssp query needs a root vertex")


@dataclasses.dataclass
class PendingQuery:
    """A submitted query plus its admission bookkeeping."""

    query: Query
    qid: int
    submit_epoch: int  # queue ticket at admission (monotone)
    submit_time: float
    cancelled: bool = False


class QueryQueue:
    """Bounded admission queue that forms batches of one kind, width <= K."""

    def __init__(self, *, max_width: int = 8, max_depth: int = 64,
                 deadline: float = 0.0, clock=time.monotonic):
        if max_width < 1 or max_depth < 1:
            raise ValueError("max_width and max_depth must be >= 1")
        self.max_width = int(max_width)
        self.max_depth = int(max_depth)
        self.deadline = float(deadline)
        self._clock = clock
        self._pending: List[PendingQuery] = []
        self._by_qid: Dict[int, PendingQuery] = {}
        self._tickets = itertools.count()
        self.submitted = 0
        self.rejected = 0
        self.cancelled = 0

    # -- admission ----------------------------------------------------------
    def __len__(self) -> int:
        return sum(1 for p in self._pending if not p.cancelled)

    @property
    def depth(self) -> int:
        return len(self)

    def submit(self, query: Query) -> int:
        """Admit one query; returns its qid.  Raises :class:`QueueFull` at
        ``max_depth`` — the producer-visible backpressure signal."""
        if len(self) >= self.max_depth:
            self.rejected += 1
            raise QueueFull(
                f"queue at max_depth={self.max_depth}; retry or shed load")
        qid = next(self._tickets)
        pq = PendingQuery(query=query, qid=qid, submit_epoch=qid,
                          submit_time=self._clock())
        self._pending.append(pq)
        self._by_qid[qid] = pq
        self.submitted += 1
        return qid

    def cancel(self, qid: int) -> bool:
        """Cancel a not-yet-dispatched query.  O(1); returns False if the
        query already dispatched (or never existed)."""
        pq = self._by_qid.get(qid)
        if pq is None or pq.cancelled:
            return False
        pq.cancelled = True
        self.cancelled += 1
        return True

    # -- batch formation ----------------------------------------------------
    def _eligible(self) -> List[PendingQuery]:
        live = [p for p in self._pending if not p.cancelled]
        if len(live) != len(self._pending):  # drop cancelled lazily
            self._pending = live
        return live

    def ready(self, now: Optional[float] = None) -> bool:
        """True when a batch should dispatch: a full batch of one kind is
        waiting, or the oldest waiting query has aged past ``deadline``."""
        live = self._eligible()
        if not live:
            return False
        now = self._clock() if now is None else now
        if now - min(p.submit_time for p in live) >= self.deadline:
            return True
        counts: Dict[str, int] = {}
        for p in live:
            counts[p.query.kind] = counts.get(p.query.kind, 0) + 1
            if counts[p.query.kind] >= self.max_width:
                return True
        return False

    def next_batch(self, now: Optional[float] = None) -> List[PendingQuery]:
        """Form one batch: the kind owed service first (highest priority,
        then oldest), up to ``max_width`` members in (priority desc, FIFO)
        order.  Returns [] when nothing is ready yet (deadline not reached
        and no full batch waiting) — the caller polls or sleeps."""
        if not self.ready(now):
            return []
        live = self._eligible()
        head = min(live, key=lambda p: (-p.query.priority, p.qid))
        kind = head.query.kind
        same = sorted((p for p in live if p.query.kind == kind),
                      key=lambda p: (-p.query.priority, p.qid))
        batch = same[: self.max_width]
        taken = {p.qid for p in batch}
        self._pending = [p for p in self._pending if p.qid not in taken]
        for p in batch:
            self._by_qid.pop(p.qid, None)
        return batch
