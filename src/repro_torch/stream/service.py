"""The ingest-and-query loop: apply batch → maybe regroup → maybe compact →
answer queries.

Port of ``repro.stream.service`` on the port's ``cachesim``, ``pack`` and
``obs``: the same spans, flight triggers, SLO health and ``cachesim.mpka.*``
gauges.  The incremental consumers run on ``device`` (``None``: the CUDA
card).  ``apply_remaps_to`` routes the regroups into a sharded layout of
``repro_torch.dist``.

``StreamService`` is the subsystem's front door, wired the way ``serve``
batches LM requests: updates arrive in batches, queries are answered from
incrementally-maintained state, and two background-style maintenance actions
amortize cost over the stream:

  * **regroup** — ``IncrementalDBG`` keeps the paper's degree groups current
    (every ``regroup_every`` batches), emitting ``RemapDelta``s and a live
    DBG mapping for the layout-sensitive consumers (cachesim, the sharded
    layout);
  * **compact** — when churn crosses ``compact_threshold`` of the base size,
    the delta layers fold back into a flat CSR and the incremental PageRank
    residual is resynced (shedding accumulated float32 noise).

``locality()`` is the cachesim hook: MPKA of the *current* graph under the
original ids vs. under the incrementally-maintained DBG mapping — the
streaming analogue of the paper's Fig 9 structure-vs-footprint tension
(how fast does locality decay as updates pile up, and how much of it does
cheap online regrouping claw back).

Self-diagnosing: ``health()`` evaluates ingest-plane SLOs (per-batch
ingest time p99, ingest lag) with multi-window burn rates, and an SLO
breach snapshots the always-on flight ring (``obs.flight``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..cachesim import (DEFAULT_TRACE_LEN, flat_structure,
                        interleave_structure, mpka, mpka_pinned,
                        property_trace, scaled_hierarchy, stack_distances,
                        to_blocks)
from ..graph import csr
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from ..obs.slo import Objective, SLOTracker
from ..pack.layout import PackedAdjacency, PackedGraph, pack_graph
from ..device import resolve_device
from .delta import ApplyResult, DeltaGraph
from .incremental import IncrementalPageRank, IncrementalSSSP
from .regroup import IncrementalDBG, RemapDelta

__all__ = ["StreamConfig", "StreamService", "IngestStats", "layout_mpka",
           "packed_mpka"]


def layout_mpka(g: csr.Graph, mapping: Optional[np.ndarray] = None,
                levels=None, mode: str = "pull",
                max_len: int = DEFAULT_TRACE_LEN,
                include_structure: bool = False) -> Dict[str, float]:
    """MPKA of ``g`` under ``mapping`` (None = original ids).

    The single trace-to-MPKA recipe (relabel → property trace → blocks →
    stack distances → MPKA) shared by ``StreamService.locality`` and the
    churn benchmark, so the trace cap and pipeline can't desynchronize.

    ``include_structure=True`` switches to the storage-format-aware trace
    (per-row indptr reads + per-edge index reads interleaved with the
    property stream) — the flat-CSR side of the ``repro.pack`` comparison.
    """
    g2 = g if mapping is None else csr.relabel(g, mapping)
    if levels is None:
        levels = scaled_hierarchy(g.num_vertices)
    if include_structure:
        counts, meta, edge = flat_structure(g2, mode)
        tr = interleave_structure(property_trace(g2, mode), counts, meta,
                                  edge, max_len=max_len)
    else:
        tr = to_blocks(property_trace(g2, mode, max_len=max_len))
    return mpka(stack_distances(tr), levels)


def packed_mpka(packed, levels=None, mode: str = "pull",
                max_len: int = DEFAULT_TRACE_LEN,
                pin_hot: bool = False,
                bytes_per_vertex: int = 8,
                block_bytes: int = 64) -> Dict[str, float]:
    """MPKA of a traversal over the PACKED storage format.

    Same access model as ``layout_mpka(..., include_structure=True)`` — one
    metadata read per row, one index read per edge, one property read per
    edge — but with structure addresses drawn from the packed layout (hot
    slot tables + cold varint bytes + degree-implied metadata) and rows
    visited in packed traversal order (hot groups first, then the cold
    tail).  Comparing the two at equal ``CacheLevels`` quantifies what the
    compression buys in cache capacity.

    ``pin_hot=True`` additionally evaluates the GRASP-lite policy
    (``cachesim.mpka_pinned``): the hot segment's property blocks bypass
    LLC demotion; the result then carries ``l3_pinned_mpka`` next to the
    plain-LRU numbers.
    """
    adj: PackedAdjacency = (packed.in_adj if mode == "pull"
                            else packed.out_adj) \
        if isinstance(packed, PackedGraph) else packed
    if levels is None:
        levels = scaled_hierarchy(adj.num_vertices)
    counts, meta, edge = adj.structure_addresses()
    _, prop_ids, _ = adj.decode_edges()
    tr = interleave_structure(prop_ids, counts, meta, edge,
                              bytes_per_vertex=bytes_per_vertex,
                              block_bytes=block_bytes, max_len=max_len)
    if pin_hot:
        vpb = max(1, block_bytes // bytes_per_vertex)
        hot_ids = (np.concatenate([h.rows for h in adj.hot])
                   if adj.hot else np.zeros(0, np.int64))
        return mpka_pinned(tr, np.unique(hot_ids // vpb), levels)
    return mpka(stack_distances(tr), levels)


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    compact_threshold: float = 0.25
    regroup_every: int = 1  # batches between regroup passes; 0 = never
    # LRU cap on live IncrementalSSSP instances: every retained root pays
    # O(batch) ingest work per update batch and buffers pending edges until
    # its next query, so unbounded roots would leak memory and ingest time
    # in a long-lived service.  Evicted roots just re-solve on next query.
    max_sssp_roots: int = 8
    # keep a PackedGraph view of the base CSR: rebuilt via
    # ``PackedGraph.from_delta`` after every compaction (the pack subsystem's
    # stream hook), so layout-sensitive consumers always see a packed layout
    # of the CURRENT base rather than a stale snapshot
    repack_on_compact: bool = False
    # route the incremental-PageRank push loop through the fused base+delta
    # K5 kernel (the same switch IncrementalSSSP exposes)
    pr_fused_push: bool = False
    hysteresis: float = 0.25
    spec_drift_tol: float = 0.2
    damping: float = 0.85
    pr_epsilon: float = 1e-9
    pr_max_iters: int = 4096
    # ingest-plane SLOs (obs.slo), surfaced by health(): p99 bound on
    # one batch's ingest time, and the max tolerated gap since the last batch
    # landed (ingest lag — a stalled feed shows up here, not in latency)
    slo_ingest_p99_s: float = 5.0
    slo_ingest_lag_s: float = 300.0
    slo_windows: Tuple[float, ...] = (30.0, 300.0)


@dataclasses.dataclass(frozen=True)
class IngestStats:
    batch_index: int
    inserted: int
    deleted: int
    apply_seconds: float
    regroup_seconds: float
    moved_vertices: int
    compacted: bool
    total_seconds: float


class StreamService:
    def __init__(self, g: csr.Graph, config: Optional[StreamConfig] = None,
                 *, device: Optional[Union[str, torch.device]] = None):
        self.config = config or StreamConfig()
        self.device = resolve_device(device)
        self.dg = DeltaGraph(g)
        self.pr = IncrementalPageRank(
            self.dg, damping=self.config.damping,
            epsilon=self.config.pr_epsilon,
            max_iters=self.config.pr_max_iters,
            use_fused_push=self.config.pr_fused_push, device=self.device)
        self.regrouper = (
            IncrementalDBG(self.dg.out_deg,
                           hysteresis=self.config.hysteresis,
                           spec_drift_tol=self.config.spec_drift_tol)
            if self.config.regroup_every else None)
        self._sssp: Dict[int, IncrementalSSSP] = {}
        # at construction the DeltaGraph base IS ``g`` — pack it directly
        self.packed: Optional[PackedGraph] = (
            pack_graph(g) if self.config.repack_on_compact else None)
        self.batches_applied = 0
        self.compactions = 0
        self.history: List[IngestStats] = []
        self.remap_deltas: List[RemapDelta] = []
        self._remaps_consumed = 0  # prefix already routed to a sharded layout
        # batch SOURCES since the last regroup pass (regroup_every > 1 must
        # not drop degree updates from skipped batches; destination-only
        # vertices never change out-degree, so the regrouper — which bins on
        # out-degree — need not see them)
        self._touched_since_regroup: set = set()
        w = tuple(self.config.slo_windows)
        self.slo = SLOTracker([
            Objective("stream.ingest_seconds", kind="quantile",
                      target=self.config.slo_ingest_p99_s, quantile=0.99,
                      windows=w,
                      description="per-batch ingest wall time p99"),
            Objective("stream.ingest_lag", kind="value",
                      target=self.config.slo_ingest_lag_s, windows=w,
                      description="seconds since the last ingest batch"),
        ], on_breach=self._on_slo_breach)
        self._last_ingest_at = time.monotonic()

    def _on_slo_breach(self, name: str, info: Dict[str, Any]) -> None:
        ctx = info.get("context", {})
        obs_flight.trigger("slo_breach", objective=name,
                           worst_burn=round(float(info["worst_burn"]), 3),
                           **ctx)

    # -- ingest ---------------------------------------------------------------
    def ingest(self, add_src=None, add_dst=None, add_w=None,
               del_src=None, del_dst=None) -> IngestStats:
        t0 = time.perf_counter()
        with obs_trace.span("stream.ingest", cat="stream",
                            batch=self.batches_applied + 1):
            return self._ingest(add_src, add_dst, add_w, del_src, del_dst, t0)

    def _ingest(self, add_src, add_dst, add_w, del_src, del_dst,
                t0) -> IngestStats:
        with obs_trace.span("stream.apply", cat="stream"):
            result: ApplyResult = self.dg.apply(
                add_src=add_src, add_dst=add_dst, add_w=add_w,
                del_src=del_src, del_dst=del_dst)
        with obs_trace.span("stream.refresh", cat="stream",
                            sssp_roots=len(self._sssp)):
            self.pr.ingest(result)
            for issp in self._sssp.values():
                issp.ingest(result)
        self._on_apply(result)
        self.batches_applied += 1

        regroup_s, moved = 0.0, 0
        if self.regrouper is not None:
            self._touched_since_regroup.update(result.cand_sources.tolist())
            if (self.batches_applied % self.config.regroup_every == 0
                    and self._touched_since_regroup):
                touched = np.fromiter(self._touched_since_regroup,
                                      dtype=np.int64)
                self._touched_since_regroup.clear()
                with obs_trace.span("stream.regroup", cat="stream",
                                    touched=int(touched.size)) as sp:
                    delta = self.regrouper.update(touched,
                                                  self.dg.out_deg[touched])
                    sp.add(moved=delta.num_moved)
                self.remap_deltas.append(delta)
                regroup_s, moved = delta.seconds, delta.num_moved

        compacted = False
        if self.dg.should_compact(self.config.compact_threshold):
            with obs_trace.span("stream.compact", cat="stream"):
                fresh = self.dg.compact()
                self.pr.resync()
            self.compactions += 1
            compacted = True
            if self.config.repack_on_compact:
                # compact() just materialized the fresh base CSR — pack it
                # directly instead of snapshotting a second time
                with obs_trace.span("stream.repack", cat="stream"):
                    self.packed = pack_graph(fresh)

        stats = IngestStats(
            batch_index=self.batches_applied,
            inserted=result.num_inserted, deleted=result.num_deleted,
            apply_seconds=result.seconds, regroup_seconds=regroup_s,
            moved_vertices=moved, compacted=compacted,
            total_seconds=time.perf_counter() - t0)
        self.history.append(stats)
        self._last_ingest_at = time.monotonic()
        self.slo.observe("stream.ingest_seconds", stats.total_seconds,
                         context={"batch_index": stats.batch_index,
                                  "inserted": stats.inserted,
                                  "deleted": stats.deleted})
        return stats

    def _on_apply(self, result: ApplyResult) -> None:
        """Hook for subclasses that mirror each batch into another layout
        (``ShardedStreamService`` stashes the ApplyResult here); runs after
        the incremental consumers refreshed, before regroup/compaction."""

    # -- queries --------------------------------------------------------------
    def pagerank(self) -> np.ndarray:
        with obs_trace.span("stream.query.pagerank", cat="stream"):
            return self.pr.query()

    def sssp(self, root: int) -> np.ndarray:
        root = int(root)
        with obs_trace.span("stream.query.sssp", cat="stream", root=root):
            issp = self._sssp.pop(root, None)
            if issp is None:
                issp = IncrementalSSSP(self.dg, root, device=self.device)
            self._sssp[root] = issp  # re-insert: dict order tracks recency
            while len(self._sssp) > max(1, self.config.max_sssp_roots):
                self._sssp.pop(next(iter(self._sssp)))
            return issp.query()

    def current_mapping(self) -> Optional[np.ndarray]:
        return (self.regrouper.current_mapping()
                if self.regrouper is not None else None)

    def apply_remaps_to(self, sg):
        """Route the accumulated ``RemapDelta``s into a sharded layout.

        Shard-aware update routing: the deltas emitted since the last call
        are merged (net group moves only) and fed to
        ``repro_torch.dist.graph.apply_remap``, which re-homes exactly the
        vertices that crossed a hot/cold group boundary — instead of
        re-sharding from a full ``current_mapping()``.  Returns the patched
        layout; on ``RemapOverflow`` (drift exceeded the layout's reserved
        headroom) the caller should rebuild via ``shard_graph`` with
        ``hot_override=self.regrouper.hot_ids(sg.hot_group_count)`` — the
        deltas stay UNCONSUMED then (a later call replays them as no-ops
        against the rebuilt layout, so no drift is lost).  Topology deltas
        are not applied here (``ShardedStreamService`` routes them).
        """
        from ..dist.graph import RemapOverflow, apply_remap

        consumed = len(self.remap_deltas)
        try:
            out = apply_remap(
                sg,
                RemapDelta.merge(self.remap_deltas[self._remaps_consumed:]))
        except RemapOverflow as exc:
            obs_flight.trigger(
                "remap_overflow",
                pending_deltas=consumed - self._remaps_consumed,
                detail=str(exc))
            raise
        self._remaps_consumed = consumed  # only after apply_remap succeeded
        return out

    def snapshot(self) -> csr.Graph:
        return self.dg.snapshot()

    # -- health plane ---------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """JSON-able health snapshot of the ingest plane: SLO burn rates
        plus churn-state counters (same shape as
        ``GraphServeService.health()``)."""
        self.slo.observe("stream.ingest_lag",
                         time.monotonic() - self._last_ingest_at)
        h = self.slo.health()
        h["ingest"] = {
            "batches_applied": self.batches_applied,
            "compactions": self.compactions,
            "remap_deltas": len(self.remap_deltas),
            "sssp_roots": len(self._sssp),
        }
        return h

    # -- the cachesim hook ----------------------------------------------------
    def locality(self, mode: str = "pull",
                 max_len: int = DEFAULT_TRACE_LEN) -> Dict[str, Dict[str, float]]:
        """MPKA of the current graph: original ids vs. the live DBG mapping.

        Measures locality decay under churn (the more updates applied without
        regrouping, the further the hot vertices drift from a dense layout)
        and how much the incremental mapping recovers.
        """
        with obs_trace.span("stream.locality", cat="stream", mode=mode):
            g = self.snapshot()
            levels = scaled_hierarchy(g.num_vertices)
            out = {"identity": layout_mpka(g, None, levels, mode, max_len)}
            if self.regrouper is not None:
                out["incremental_dbg"] = layout_mpka(
                    g, self.regrouper.current_mapping(), levels, mode, max_len)
        # cachesim MPKA as live gauges: the latest locality probe is readable
        # off the process registry next to the edge_map.* counters
        reg = get_registry()
        for layout, levels_mpka in out.items():
            for level, v in levels_mpka.items():
                reg.gauge(f"cachesim.mpka.{layout}.{level}").set(float(v))
        return out
