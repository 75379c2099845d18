"""repro_torch.serve front door: batched graph-query serving over churning
ingest.

Port of ``repro.serve.service`` on the port's ``stream.StreamService`` /
``stream.StreamBackend`` and ``obs``.  The service runs on ``device``
(``None``: the CUDA card, which raises without one): its stream plane, its
backends and its query planes all live there.  ``ServeConfig`` has the
reference's fields and defaults except ``interpret``, the Pallas
interpreter's switch, whose place the service's ``device`` takes (the
``backend="auto"`` cache key names the device).

``GraphServeService`` composes the three serve pieces around a
``stream.StreamService``:

  * **ingest** delegates to the stream plane (delta apply, regroup,
    compaction) and *publishes* an immutable snapshot every
    ``publish_every`` batches — writers never block readers;
  * **submit/cancel** go through the bounded :class:`~repro_torch.serve.
    batch.QueryQueue` (``QueueFull`` is the backpressure signal);
  * **pump** forms one batch (width <= K, one kind, priority-then-FIFO),
    pins the current snapshot, and answers all K queries in ONE
    ``serve.batched`` run — a single edge-map pass per iteration on
    whichever ``engine.BACKENDS`` entry the config names (on ``ell`` /
    ``packed`` and under ``"auto"``, one grouped K5 call over the (V, K)
    plane).

With ``incremental_publish=True`` query batches run on the published
version's ``StreamBackend`` (the stream plane's edge-parallel maps over
base + delta), not on ``backend``: only the version published before any
ingest (version 0, materialized) runs on ``backend``.

Every result is stamped with the snapshot ``version`` it was answered
against: snapshot isolation is an observable contract (a version-N answer
equals a from-scratch run on the version-N graph, however much ingest has
landed since), not just an implementation detail.

Observability — the query path is CAUSALLY traceable and the service is
self-diagnosing:

  * every query's life is an id-tagged chain: a ``serve.query`` flow start
    + async span at submit, a flow step at batch dispatch (stamped with
    ``batch_epoch`` and ``snapshot_version``), and a flow end + async end at
    result (or cancel);
  * :meth:`GraphServeService.health` evaluates declarative SLOs (latency
    p99, rejection rate, snapshot staleness) over rolling windows with
    multi-window burn rates (``repro_torch.obs.slo``);
  * incidents — an SLO breach, a ``QueueFull`` rejection — snapshot the
    always-on flight ring (``repro_torch.obs.flight``);
  * the installed edge-map hook (``obs.counters``) receives each batch's
    per-lane iteration counts (``record_iters``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..apps.engine import get_edge_map_hook, to_arrays
from ..device import resolve_device
from ..graph import csr
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.slo import Objective, SLOTracker
from ..stream.incremental import StreamBackend
from ..stream.service import StreamConfig, StreamService
from .batch import PendingQuery, Query, QueryQueue, QueueFull
from .batched import batched_pagerank, batched_sssp
from .metrics import ServeMetrics
from .snapshot import Snapshot, SnapshotStore

__all__ = ["ServeConfig", "QueryResult", "GraphServeService"]


@dataclasses.dataclass
class ServeConfig:
    # batching / admission
    max_width: int = 8       # K — lanes per fused batch
    max_depth: int = 64      # queue bound; submit raises QueueFull past it
    deadline: float = 0.0    # seconds a partial batch may wait to fill
    # snapshot cadence
    publish_every: int = 1   # ingest batches between snapshot publishes
    # O(delta) publishes: each version reuses the stream plane's cached
    # base arrays (only delta rows differ) via ``stream.StreamBackend``
    # instead of materializing a CSR + rebuilding ``backend`` arrays from
    # scratch; the full graph is only built if a reader forces
    # ``Snapshot.graph``.  Overrides ``backend`` for query batches.
    incremental_publish: bool = False
    # edge-map backend for query batches (engine.BACKENDS name; "auto"
    # resolves the active repro_torch.tune plan per snapshot + query kind)
    backend: str = "flat"
    row_tile: int = 64
    width_tile: int = 128
    # pull/push switch point for batched SSSP; None = engine default or,
    # under backend="auto", whatever the resolved plan tuned
    density_threshold: Optional[float] = None
    # app parameters
    damping: float = 0.85
    pr_tol: float = 1e-7
    pr_max_iters: int = 64
    sssp_max_iters: int = 0  # 0 = Bellman-Ford bound (V)
    # service-level objectives (repro_torch.obs.slo); evaluated by health()
    # and on every recorded result/rejection with multi-window burn rates
    slo_latency_p99_s: float = 2.0     # end-to-end latency the p99 must beat
    slo_rejection_rate: float = 0.05   # QueueFull budget per admission
    slo_staleness_s: float = 60.0      # max age of the current snapshot
    slo_windows: Tuple[float, ...] = (30.0, 300.0)  # rolling, short -> long
    # forwarded to the ingest plane
    stream: Optional[StreamConfig] = None


@dataclasses.dataclass(frozen=True)
class QueryResult:
    qid: int
    kind: str
    value: np.ndarray        # (V,) ranks or distances
    iters: int               # iterations this lane actually ran
    snapshot_version: int    # graph epoch the answer reflects
    submit_epoch: int        # queue ticket at admission
    latency: float           # submit -> result (s)
    queue_wait: float        # submit -> dispatch (s)


class GraphServeService:
    """Multi-tenant serving: batched queries + snapshot-isolated ingest."""

    def __init__(self, g: csr.Graph, config: Optional[ServeConfig] = None,
                 clock=time.monotonic, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config or ServeConfig()
        self._clock = clock
        self.device = resolve_device(device)
        self.stream = StreamService(g, self.config.stream,
                                    device=self.device)
        # one registry for the whole serving plane: serve.* metrics and the
        # snapshot.* gauges/histograms read out of a single snapshot()
        self.metrics = ServeMetrics(self.config.max_width)
        self.store = SnapshotStore(self.stream.snapshot(),
                                   registry=self.metrics.registry)
        self.queue = QueryQueue(
            max_width=self.config.max_width,
            max_depth=self.config.max_depth,
            deadline=self.config.deadline, clock=clock)
        self._ingest_batches = 0
        self._batch_epoch = 0  # monotone id of every dispatched batch
        w = tuple(self.config.slo_windows)
        self.slo = SLOTracker([
            Objective("serve.latency", kind="quantile",
                      target=self.config.slo_latency_p99_s, quantile=0.99,
                      windows=w,
                      description="end-to-end query latency (submit→result)"),
            Objective("serve.rejection_rate", kind="rate",
                      target=self.config.slo_rejection_rate, windows=w,
                      description="QueueFull rejections per admission"),
            Objective("serve.snapshot_staleness", kind="value",
                      target=self.config.slo_staleness_s, windows=w,
                      description="age of the current published snapshot"),
        ], clock=clock, on_breach=self._on_slo_breach)

    def _on_slo_breach(self, name: str, info: Dict[str, Any]) -> None:
        """Edge-triggered by the SLO tracker: snapshot the flight ring with
        the events leading up to the breach (no-op when none is armed)."""
        ctx = info.get("context", {})
        obs_flight.trigger("slo_breach", objective=name,
                           worst_burn=round(float(info["worst_burn"]), 3),
                           **ctx)

    # -- writer plane -------------------------------------------------------
    def ingest(self, add_src=None, add_dst=None, add_w=None,
               del_src=None, del_dst=None):
        """Apply one update batch to the stream plane.  In-flight query
        batches keep their pinned snapshot; a fresh snapshot is published
        every ``publish_every`` batches for FUTURE batches to pin."""
        with obs_trace.span("serve.ingest", cat="serve",
                            batch=self._ingest_batches + 1):
            res = self.stream.ingest(add_src=add_src, add_dst=add_dst,
                                     add_w=add_w, del_src=del_src,
                                     del_dst=del_dst)
            self._ingest_batches += 1
            if self._ingest_batches % max(1, self.config.publish_every) == 0:
                self._publish()
        return res

    def _publish(self) -> None:
        if not self.config.incremental_publish:
            with obs_trace.span("serve.snapshot_materialize", cat="serve"):
                g = self.stream.snapshot()
            self.store.publish(g)
            return
        # O(delta): the backend is built straight from the stream plane's
        # cached base uploads + padded delta buffer; the version's graph is
        # a thunk over those (immutable) arrays, materialized only if a
        # reader forces Snapshot.graph
        backend = StreamBackend.from_delta(self.stream.dg, self.device)
        self.store.publish(backend.materialize,
                           num_vertices=backend.num_vertices,
                           cache={"backend:stream": backend})

    @property
    def snapshot_version(self) -> int:
        return self.store.current_version

    # -- reader plane -------------------------------------------------------
    def submit(self, query: Query) -> int:
        try:
            qid = self.queue.submit(query)
        except QueueFull:
            self.metrics.record_rejected()  # the shed the docstring promises
            self.slo.observe_ok("serve.rejection_rate", False,
                                context={"kind": query.kind,
                                         "depth": self.queue.depth})
            obs_flight.trigger("queue_full", kind=query.kind,
                               depth=self.queue.depth,
                               max_depth=self.config.max_depth)
            raise
        self.slo.observe_ok("serve.rejection_rate", True)
        # the query's causal chain starts here; the same qid links the flow
        # start, the batch-dispatch step, and the result/cancel end
        obs_trace.flow_start("serve.query", qid, cat="serve", kind=query.kind)
        obs_trace.async_begin("serve.query", qid, cat="serve",
                              kind=query.kind)
        return qid

    def cancel(self, qid: int) -> bool:
        ok = self.queue.cancel(qid)
        if ok:
            self.metrics.record_cancelled()
            obs_trace.flow_end("serve.query", qid, cat="serve",
                               cancelled=True)
            obs_trace.async_end("serve.query", qid, cat="serve",
                                cancelled=True)
        return ok

    def pump(self) -> List[QueryResult]:
        """Dispatch ONE batch if the queue says it is ready (full width of
        one kind, or the deadline elapsed).  Returns [] otherwise."""
        batch = self.queue.next_batch()
        if not batch:
            return []
        return self._run_batch(batch)

    def drain(self) -> List[QueryResult]:
        """Dispatch until the queue is empty, ignoring the fill deadline
        (the shutdown / test path)."""
        out: List[QueryResult] = []
        while True:
            batch = self.queue.next_batch(now=float("inf"))
            if not batch:
                return out
            out.extend(self._run_batch(batch))

    # -- batch execution ----------------------------------------------------
    def _backend(self, snap: Snapshot, kind: Optional[str] = None):
        cfg = self.config
        if "backend:stream" in snap._cache:
            # incremental publish pre-seeded the O(delta) stream backend —
            # it IS this version's arrays; nothing to build
            return snap._cache["backend:stream"]
        from ..tune.space import validate_knobs
        if cfg.backend == "auto":
            # the plan owns the tile geometry; only the per-app resolution
            # hint comes from serve config (the device is the service's)
            app = {"pagerank": "pr"}.get(kind, kind)
            knobs = {"app": app}
            key = f"backend:auto:{app}:{self.device}"
        else:
            # filter through the constraint table so flat/arrays do not trip
            # the ignored-knob warning on the tile-geometry defaults
            knobs, _ = validate_knobs(cfg.backend, {
                "row_tile": cfg.row_tile, "width_tile": cfg.width_tile})
            key = f"backend:{cfg.backend}:{cfg.row_tile}:{cfg.width_tile}"
        return snap.cached(key, lambda g: to_arrays(
            g, backend=cfg.backend, device=self.device, **knobs))

    def _sssp_threshold(self, snap: Snapshot) -> Optional[float]:
        """Pull/push switch point for batched SSSP on this snapshot: the
        explicit config wins, else the tuned plan's (backend="auto"), else
        the engine default."""
        if self.config.density_threshold is not None:
            return self.config.density_threshold
        if self.config.backend != "auto":
            return None
        if "backend:stream" in snap._cache:
            # the switch is a traffic choice (both directions are bitwise
            # identical); don't force an O(E) materialization to tune it
            return None
        from ..tune import plan as tune_plan
        return snap.cached("tune:sssp_threshold", lambda g: tune_plan
                           .auto_config(g, app="sssp")
                           .get("density_threshold"))

    def _teleport_plane(self, v: int,
                        batch: List[PendingQuery]) -> torch.Tensor:
        """The batch's (V, K) float32 teleport plane, built on the device:
        a personalization column normalised by its sum on the host in
        float32 (uploaded), a one-hot root, or a uniform ``1/V``."""
        p = torch.zeros((v, len(batch)), dtype=torch.float32,
                        device=self.device)
        for i, pq in enumerate(batch):
            q = pq.query
            if q.personalization is not None:
                col = np.asarray(q.personalization, np.float32)
                p[:, i] = torch.from_numpy(
                    col / max(col.sum(), 1e-30)).to(self.device)
            elif q.root is not None:
                p[q.root, i] = 1.0  # personalized PR from one seed vertex
            else:
                p[:, i] = 1.0 / v   # uniform teleport == global PageRank
        return p

    def _run_batch(self, batch: List[PendingQuery]) -> List[QueryResult]:
        cfg = self.config
        kind = batch[0].query.kind
        snap = self.store.acquire()  # every iteration sees THIS graph
        self._batch_epoch += 1
        epoch = self._batch_epoch
        t0 = self._clock()
        sp = obs_trace.span("serve.batch", cat="serve", kind=kind,
                            width=len(batch), batch_epoch=epoch,
                            version=snap.version, backend=cfg.backend)
        try:
            with sp:
                for pq in batch:
                    # the wait→dispatch hop of each query's causal chain
                    obs_trace.flow_step("serve.query", pq.qid, cat="serve",
                                        batch_epoch=epoch,
                                        snapshot_version=snap.version)
                ga = self._backend(snap, kind)
                v = snap.num_vertices
                with obs_trace.span(f"engine.solve.{kind}", cat="engine",
                                    width=len(batch), batch_epoch=epoch,
                                    version=snap.version,
                                    backend=cfg.backend) as solve_sp:
                    if kind == "pagerank":
                        plane = self._teleport_plane(v, batch)
                        vals, iters = batched_pagerank(
                            ga, plane, damping=cfg.damping,
                            max_iters=cfg.pr_max_iters, tol=cfg.pr_tol)
                    else:
                        roots = torch.tensor([pq.query.root for pq in batch],
                                             dtype=torch.int64,
                                             device=self.device)
                        vals, iters = batched_sssp(
                            ga, roots, max_iters=cfg.sssp_max_iters,
                            density_threshold=self._sssp_threshold(snap))
                    # one copy down per batch; each lane a column of it
                    vals = vals.cpu().numpy()
                    iters = iters.cpu().numpy()
                    solve_sp.add(iters=int(iters.sum()))
                hook = get_edge_map_hook()
                if hook is not None and hasattr(hook, "record_iters"):
                    # the loop owner reports TRUE per-lane iteration counts
                    hook.record_iters(kind, iters)
        finally:
            self.store.release(snap)
        t1 = self._clock()

        results = [
            QueryResult(qid=pq.qid, kind=kind, value=vals[:, i],
                        iters=int(iters[i]),
                        snapshot_version=snap.version,
                        submit_epoch=pq.submit_epoch,
                        latency=t1 - pq.submit_time,
                        queue_wait=t0 - pq.submit_time)
            for i, pq in enumerate(batch)
        ]
        self.metrics.record_batch(
            kind, len(batch), t1 - t0,
            latencies=[r.latency for r in results],
            queue_waits=[r.queue_wait for r in results])
        for r in results:
            obs_trace.flow_end("serve.query", r.qid, cat="serve",
                               iters=r.iters, version=r.snapshot_version)
            obs_trace.async_end("serve.query", r.qid, cat="serve",
                                iters=r.iters, version=r.snapshot_version)
            self.slo.observe("serve.latency", r.latency,
                             context={"qid": r.qid, "kind": kind,
                                      "batch_epoch": epoch,
                                      "snapshot_version": r.snapshot_version})
        return results

    # -- health plane -------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """One JSON-able health snapshot: SLO burn rates, queue pressure,
        and snapshot-store state — what an operator polls."""
        self.slo.observe("serve.snapshot_staleness",
                         time.monotonic() - self.store.last_publish_at)
        h = self.slo.health()
        h["queue"] = {
            "depth": self.queue.depth,
            "submitted": self.queue.submitted,
            "rejected": self.queue.rejected,
            "cancelled": self.queue.cancelled,
        }
        h["snapshots"] = {
            "version": self.store.current_version,
            "live_versions": self.store.live_versions,
            "batch_epoch": self._batch_epoch,
            "ingest_batches": self._ingest_batches,
        }
        return h
