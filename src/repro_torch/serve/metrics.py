"""Serving observability: per-query latency, per-batch occupancy, quantiles.

A copy of ``repro.serve.metrics`` on the port's ``obs.metrics`` registry.
Counters only — no clocks of its own: the service reports each dispatched
batch (``record_batch``) with the per-query queue latencies and end-to-end
latencies it measured, plus every cancellation (``record_cancelled``) and
admission rejection (``record_rejected``).  Latency / queue-wait /
batch-time distributions live in BOUNDED reservoir histograms
(``obs.metrics.Histogram``), so a long-running service holds
O(``max_samples``) memory instead of O(queries).

``summary()`` has the reference's shape (``chip_smoke.py``'s serving
phase reads it) and carries ``cancelled`` / ``rejected``;
``registry.snapshot()`` exposes the full ``serve.*`` metric family —
including the ``snapshot.*`` gauges when the service shares its registry
with the ``SnapshotStore``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..obs.metrics import MetricsRegistry

__all__ = ["ServeMetrics"]


class ServeMetrics:
    def __init__(self, max_width: int,
                 registry: Optional[MetricsRegistry] = None,
                 max_samples: int = 2048):
        self.max_width = int(max_width)
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._batches = r.counter("serve.batches")
        self._completed = r.counter("serve.completed")
        self._cancelled = r.counter("serve.cancelled")
        self._rejected = r.counter("serve.rejected")
        self._lanes_used = r.counter("serve.lanes_used")
        self._latency = r.histogram("serve.latency_s", max_samples=max_samples)
        self._queue_wait = r.histogram("serve.queue_wait_s",
                                       max_samples=max_samples)
        self._batch_time = r.histogram("serve.batch_s",
                                       max_samples=max_samples)

    # -- recording ----------------------------------------------------------
    def record_batch(self, kind: str, width: int, batch_seconds: float,
                     latencies: Sequence[float],
                     queue_waits: Sequence[float]) -> None:
        self._batches.inc()
        self._completed.inc(width)
        self._lanes_used.inc(width)
        self.registry.counter(f"serve.queries.{kind}").inc(width)
        self._batch_time.observe(float(batch_seconds))
        self._latency.observe_many(float(t) for t in latencies)
        self._queue_wait.observe_many(float(t) for t in queue_waits)

    def record_cancelled(self, n: int = 1) -> None:
        """A not-yet-dispatched query was cancelled (QueryQueue.cancel)."""
        self._cancelled.inc(n)

    def record_rejected(self, n: int = 1) -> None:
        """An admission was refused with ``QueueFull`` (backpressure shed)."""
        self._rejected.inc(n)

    # -- aggregates ---------------------------------------------------------
    @property
    def batches(self) -> int:
        return self._batches.value

    @property
    def completed(self) -> int:
        return self._completed.value

    @property
    def cancelled(self) -> int:
        return self._cancelled.value

    @property
    def rejected(self) -> int:
        return self._rejected.value

    @property
    def lanes_used(self) -> int:
        return self._lanes_used.value

    @property
    def by_kind(self) -> Dict[str, int]:
        return {name.split(".", 2)[2]: self.registry.get(name).value
                for name in self.registry.names()
                if name.startswith("serve.queries.")}

    @property
    def occupancy(self) -> float:
        """Mean fraction of the batch width actually filled."""
        if self.batches == 0:
            return 0.0
        return self.lanes_used / (self.batches * self.max_width)

    def latency_quantiles(self, qs=(0.5, 0.99)) -> Dict[str, float]:
        return self._latency.quantiles(qs)

    def summary(self) -> Dict[str, float]:
        out = {
            "batches": self.batches,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "rejected": self.rejected,
            "occupancy": round(self.occupancy, 4),
        }
        q = self.latency_quantiles()
        out["latency_p50_ms"] = round(q["p50"] * 1e3, 3)
        out["latency_p99_ms"] = round(q["p99"] * 1e3, 3)
        if self._queue_wait.count:
            out["queue_wait_p50_ms"] = round(
                self._queue_wait.quantile(0.5) * 1e3, 3)
        if self._batch_time.count:
            out["batch_ms_mean"] = round(self._batch_time.mean * 1e3, 3)
        for kind, n in sorted(self.by_kind.items()):
            out[f"queries_{kind}"] = n
        return out
