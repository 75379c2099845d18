"""Snapshot isolation for serving over a churning graph.

A copy of ``repro.serve.snapshot`` on the port's ``graph.csr`` and ``obs``.

``stream.DeltaGraph`` mutates in place — base CSR + delta layers change under
``ingest`` and fold entirely on ``compact``.  A query batch that takes many
edge-map iterations must NOT see those mutations mid-flight, or lane results
can mix two graph states (a half-applied delta batch).  The fix is the
classic double-buffered snapshot:

  * ``publish(graph)`` installs an immutable CSR as version N+1 while
    version N keeps serving — readers already pinned to N are untouched.
    ``graph`` may be a thunk (plus a pre-seeded backend cache): the
    O(delta) incremental-publish path, where the version's arrays come
    from the stream plane's cached base + delta and the full CSR is only
    built if a reader explicitly forces ``Snapshot.graph``;
  * ``acquire()`` pins the CURRENT version (refcount++) and returns it; the
    batch runs every iteration against that one immutable graph;
  * ``release(snap)`` unpins; a superseded version is reclaimed (its cached
    backend state dropped) when its last reader releases — epoch-based
    reclamation, no reader ever observes a freed snapshot.

Versions are the observable epochs: each query result is stamped with the
snapshot version it was answered against, so isolation is testable from the
outside (a result computed "against version N" must equal a from-scratch run
on the version-N graph, no matter how much ingest happened meanwhile).

Backends built from a snapshot (ell tiles, packed layouts) are cached ON the
snapshot — build once per published version, reuse for every batch pinned to
it, drop with the snapshot.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from ..graph import csr
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry

__all__ = ["Snapshot", "SnapshotStore"]


@dataclasses.dataclass
class Snapshot:
    """One immutable published graph version plus its reader refcount.

    ``_graph`` is either a materialized ``csr.Graph`` (eager publish) or a
    zero-argument thunk that builds the version-N graph on first access
    (lazy publish — the O(delta) path: the thunk closes over immutable
    version-N arrays, so a late materialization is still isolation-exact).
    """

    version: int
    _graph: Any  # csr.Graph | Callable[[], csr.Graph]
    refs: int = 0
    retired: bool = False  # superseded; reclaim when refs hits 0
    _cache: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _num_vertices: Optional[int] = None  # hint; avoids forcing the thunk

    @property
    def graph(self) -> csr.Graph:
        if callable(self._graph):
            with obs_trace.span("serve.snapshot_materialize", cat="serve",
                                version=self.version, lazy=True):
                self._graph = self._graph()
        return self._graph

    @property
    def materialized(self) -> bool:
        return not callable(self._graph)

    @property
    def num_vertices(self) -> int:
        if self._num_vertices is not None:
            return self._num_vertices
        return self.graph.num_vertices

    def cached(self, key: str, build: Callable[[csr.Graph], Any]) -> Any:
        """Per-snapshot memo for derived state (backend arrays, tiles)."""
        if key not in self._cache:
            self._cache[key] = build(self.graph)
        return self._cache[key]


class SnapshotStore:
    """Double-buffered, refcounted snapshot versions with epoch reclaim.

    Observable: the epoch-reclaim behavior is metered instead of
    assert-only — ``snapshot.live_versions`` / ``snapshot.pinned_readers``
    gauges, ``snapshot.published`` / ``snapshot.reclaimed`` counters, and a
    ``snapshot.publish_seconds`` latency histogram land in ``registry``
    (the service passes its ``ServeMetrics`` registry in, so one
    ``registry.snapshot()`` shows the whole serving plane).

    Self-diagnosing: when retired-but-still-pinned versions pile past
    ``stall_threshold`` at publish time — a reader sitting on old epochs and
    leaking their cached backends — a ``reclaim_stall`` anomaly snapshots
    the flight ring (``repro_torch.obs.flight``)."""

    def __init__(self, graph: Optional[csr.Graph] = None,
                 registry: Optional[MetricsRegistry] = None,
                 stall_threshold: int = 4):
        self._versions: Dict[int, Snapshot] = {}
        self._current: Optional[Snapshot] = None
        self._next_version = 0
        self.published = 0
        self.reclaimed = 0
        #: retired-but-still-pinned versions tolerated before publish() flags
        #: a reclaim stall (a reader holding snapshots across many epochs
        #: leaks every cached backend it pins)
        self.stall_threshold = int(stall_threshold)
        self.last_publish_at = time.monotonic()
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._g_live = r.gauge("snapshot.live_versions")
        self._g_pinned = r.gauge("snapshot.pinned_readers")
        self._c_published = r.counter("snapshot.published")
        self._c_reclaimed = r.counter("snapshot.reclaimed")
        self._h_publish = r.histogram("snapshot.publish_seconds")
        if graph is not None:
            self.publish(graph)

    # -- writer side --------------------------------------------------------
    def publish(self, graph, *, num_vertices: Optional[int] = None,
                cache: Optional[Dict[str, Any]] = None) -> Snapshot:
        """Install ``graph`` as the new current version.  The previous
        version keeps serving its pinned readers and is reclaimed when the
        last of them releases (immediately, if it had none).

        ``graph`` may be a zero-argument thunk: the O(delta) publish path.
        Pre-seed ``cache`` with the backend readers will use (keyed like
        ``Snapshot.cached``) and pass ``num_vertices`` so nothing on the
        query path forces a materialization; ``publish_seconds`` then
        records the delta-sized cost instead of an O(E) rebuild."""
        t0 = time.perf_counter()
        with obs_trace.span("serve.publish", cat="serve",
                            version=self._next_version,
                            lazy=callable(graph)):
            snap = Snapshot(version=self._next_version, _graph=graph,
                            _num_vertices=num_vertices,
                            _cache=dict(cache) if cache else {})
            self._next_version += 1
            prev, self._current = self._current, snap
            self._versions[snap.version] = snap
            self.published += 1
            self._c_published.inc()
            if prev is not None:
                prev.retired = True
                self._maybe_reclaim(prev)
            self._g_live.set(len(self._versions))
            stalled = [s.version for s in self._versions.values()
                       if s.retired and s.refs > 0]
            if len(stalled) > self.stall_threshold:
                obs_flight.trigger("reclaim_stall",
                                   retired_pinned=len(stalled),
                                   versions=sorted(stalled),
                                   threshold=self.stall_threshold)
        self.last_publish_at = time.monotonic()
        self._h_publish.observe(time.perf_counter() - t0)
        return snap

    # -- reader side --------------------------------------------------------
    @property
    def current_version(self) -> int:
        if self._current is None:
            raise RuntimeError("no snapshot published yet")
        return self._current.version

    def acquire(self) -> Snapshot:
        """Pin the current version; every iteration of the caller's batch
        runs against this one immutable graph."""
        if self._current is None:
            raise RuntimeError("no snapshot published yet")
        self._current.refs += 1
        self._g_pinned.inc()
        return self._current

    def release(self, snap: Snapshot) -> None:
        if snap.refs <= 0:
            raise RuntimeError(
                f"release of unpinned snapshot v{snap.version}")
        snap.refs -= 1
        self._g_pinned.dec()
        self._maybe_reclaim(snap)

    # -- reclaim ------------------------------------------------------------
    def _maybe_reclaim(self, snap: Snapshot) -> None:
        if snap.retired and snap.refs == 0:
            self._versions.pop(snap.version, None)
            snap._cache.clear()  # drop cached backend state with the epoch
            self.reclaimed += 1
            self._c_reclaimed.inc()
            self._g_live.set(len(self._versions))
            obs_trace.instant("serve.reclaim", cat="serve",
                              version=snap.version)

    @property
    def live_versions(self) -> int:
        return len(self._versions)
