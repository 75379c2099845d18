"""ShardedStreamService — the full ingest loop, O(delta) per batch on a
sharded layout.

Port of ``repro.stream.sharded`` on ``repro_torch.dist``.  Extends
:class:`~repro_torch.stream.service.StreamService`: every ingest batch still
runs the single-device pipeline (DeltaGraph apply, incremental PR/SSSP
refresh, regroup, threshold compaction) and then MIRRORS the same batch into
a sharded :class:`~repro_torch.dist.graph.ShardedGraphArrays` built with
``stream=True`` —

* pending ``RemapDelta``s are routed first (``apply_remaps_to`` →
  ``dist.graph.apply_remap``), so a regroup's vertex moves and the batch's
  edge deltas land in one patch;
* the ``ApplyResult`` is routed by ``dist.stream.apply_edge_delta`` into
  per-shard delta buffers + tombstone planes;
* per-shard compaction folds only the shards whose LOCAL churn crossed the
  threshold.

SPMD: every rank of the mesh runs the same service on the same batches and
keeps the same host state; each moves only its own shard to its device.
Nothing on this path touches all E edges; the only O(E) event left is the
fallback full ``shard_graph`` re-shard when drift exhausts the layout's
reserved headroom (``RemapOverflow`` / ``HaloOverflow`` — both file flight
anomalies and are counted in ``full_rebuilds``).

Queries (``pagerank`` / ``sssp``) run the sharded solvers over base + delta
segment.  Parity with the single-device service on the same churn: SSSP
answers bitwise equal (same per-edge float path sums, exact min); PageRank
iterated to the same epsilon.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..apps import engine as apps_engine
from ..dist import graph as dist_graph
from ..dist import stream as dist_stream
from ..dist.graph import GraphMesh, HaloOverflow, RemapOverflow
from ..graph import csr
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.slo import Objective, SLOTracker
from .delta import ApplyResult
from .service import StreamConfig, StreamService

__all__ = ["ShardedStreamService"]


class ShardedStreamService(StreamService):
    """StreamService whose layout — and queries — live on the ``n_shards``
    ranks of ``mesh``, maintained with per-batch cost O(delta), never O(E).
    ``mesh=None`` makes one over the initialised default process group
    (``make_graph_mesh(n_shards)``, this rank's card); the single-device
    pipeline runs on the mesh's device."""

    def __init__(self, g: csr.Graph, config: Optional[StreamConfig] = None,
                 *, n_shards: Optional[int] = None,
                 mesh: Optional[GraphMesh] = None,
                 backend: str = "flat", policy: str = "replicate_hot",
                 num_hot_groups: int = 6, row_tile: int = 64,
                 width_tile: int = 128, remap_headroom: float = 0.5,
                 shard_compact_threshold: Optional[float] = None):
        if mesh is None:
            mesh = dist_graph.make_graph_mesh(n_shards)
        elif n_shards is not None and int(n_shards) != mesh.size:
            raise ValueError(f"n_shards={n_shards} on a mesh of {mesh.size}")
        super().__init__(g, config, device=mesh.device)
        self.mesh = mesh
        self.n_shards = mesh.size
        self._shard_kw = dict(
            policy=policy, num_hot_groups=num_hot_groups, backend=backend,
            row_tile=row_tile, width_tile=width_tile,
            remap_headroom=remap_headroom, stream=True)
        self.shard_compact_threshold = (
            self.config.compact_threshold if shard_compact_threshold is None
            else shard_compact_threshold)
        with obs_trace.span("stream.shard_build", cat="stream",
                            shards=self.n_shards, backend=backend):
            self.sg = dist_graph.shard_graph(
                apps_engine.to_arrays(g, backend="arrays", device="cpu"),
                self.n_shards, **self._shard_kw)
            self.sg = dist_stream.sync_delta(self.sg)
        self.full_rebuilds = 0
        self.shard_history: List[Dict[str, Any]] = []
        self._last_result: Optional[ApplyResult] = None
        # third objective on the shard plane: routing a batch into the
        # layout must stay inside the same p99 budget as ingest itself
        w = tuple(self.config.slo_windows)
        self.slo = SLOTracker([
            Objective("stream.ingest_seconds", kind="quantile",
                      target=self.config.slo_ingest_p99_s, quantile=0.99,
                      windows=w,
                      description="per-batch ingest wall time p99"),
            Objective("stream.ingest_lag", kind="value",
                      target=self.config.slo_ingest_lag_s, windows=w,
                      description="seconds since the last ingest batch"),
            Objective("stream.shard_ingest_seconds", kind="quantile",
                      target=self.config.slo_ingest_p99_s, quantile=0.99,
                      windows=w,
                      description="per-batch sharded routing wall time p99"),
        ], on_breach=self._on_slo_breach)

    # -- the mirrored batch path ----------------------------------------------
    def _on_apply(self, result: ApplyResult) -> None:
        self._last_result = result

    def _ingest(self, add_src, add_dst, add_w, del_src, del_dst, t0):
        stats = super()._ingest(add_src, add_dst, add_w, del_src, del_dst, t0)
        t1 = time.perf_counter()
        with obs_trace.span("stream.shard_ingest", cat="stream",
                            batch=stats.batch_index,
                            shards=self.n_shards) as sp:
            info = self._route_batch(stats)
            sp.add(full_rebuild=info["full_rebuild"],
                   folds=len(info.get("compacted", ())))
        seconds = time.perf_counter() - t1
        self.slo.observe("stream.shard_ingest_seconds", seconds,
                         context={"batch_index": stats.batch_index,
                                  "inserted": stats.inserted,
                                  "deleted": stats.deleted})
        info["seconds"] = seconds
        info["batch_index"] = stats.batch_index
        self.shard_history.append(info)
        self._last_result = None
        return stats

    def _route_batch(self, stats) -> Dict[str, Any]:
        result = self._last_result
        info: Dict[str, Any] = {"full_rebuild": False, "compacted": []}
        try:
            sg = self.apply_remaps_to(self.sg)
            sg, rstats = dist_stream.apply_edge_delta(
                sg, result, out_deg=self.dg.out_deg, in_deg=self.dg.in_deg,
                batch_index=stats.batch_index)
            sg, folded = dist_stream.compact_shards(
                sg, threshold=self.shard_compact_threshold,
                batch_index=stats.batch_index)
            info.update(rstats)
            info["compacted"] = folded
            self.sg = sg
        except HaloOverflow as exc:
            obs_flight.trigger(
                "halo_overflow", batch_index=stats.batch_index,
                inserted=stats.inserted, deleted=stats.deleted,
                detail=str(exc))
            self._full_reshard()
            info["full_rebuild"] = True
        except RemapOverflow:
            # apply_remaps_to already filed the remap_overflow anomaly
            self._full_reshard()
            info["full_rebuild"] = True
        return info

    def _full_reshard(self) -> None:
        """The O(E) fallback: rebuild the layout from the live snapshot with
        the regrouper's CURRENT hot set (pending remap deltas are therefore
        already reflected and marked consumed)."""
        with obs_trace.span("stream.shard_rebuild", cat="stream",
                            shards=self.n_shards):
            ga = apps_engine.to_arrays(self.snapshot(), backend="arrays",
                                       device="cpu")
            kw = dict(self._shard_kw)
            if (self.regrouper is not None
                    and kw["policy"] == "replicate_hot"):
                kw["hot_override"] = self.regrouper.hot_ids(
                    self.sg.hot_group_count)
            self.sg = dist_graph.shard_graph(ga, self.n_shards, **kw)
            self.sg = dist_stream.sync_delta(self.sg)
        self._remaps_consumed = len(self.remap_deltas)
        self.full_rebuilds += 1

    # -- queries: sharded solvers over base + delta segment -------------------
    def pagerank(self) -> np.ndarray:
        with obs_trace.span("stream.query.pagerank", cat="stream",
                            sharded=True):
            rank, _ = dist_stream.pagerank_sharded_stream(
                self.sg, self.mesh, damping=self.config.damping,
                tol=self.config.pr_epsilon,
                max_iters=self.config.pr_max_iters)
            return rank

    def sssp(self, root: int) -> np.ndarray:
        with obs_trace.span("stream.query.sssp", cat="stream",
                            root=int(root), sharded=True):
            dist, _ = dist_stream.sssp_sharded_stream(self.sg, int(root),
                                                      self.mesh)
            return dist

    # -- health plane ---------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        h = super().health()
        st = (self.sg.host or {}).get("stream", {})
        h["shard_ingest"] = {
            "n_shards": self.n_shards,
            "backend": self.sg.backend,
            "full_rebuilds": self.full_rebuilds,
            "halo_slots": int(self.sg.host["halo_slots"])
            if self.sg.host else 0,
            "delta_capacity": list(self.sg.delta.capacity)
            if self.sg.delta is not None else [0, 0],
            "delta_occupancy": [int(b["n"]) for b in st.get("d", ())],
        }
        return h
