"""Per-edge-map-pass telemetry — the paper's quantities, measured live.

Port of ``repro.obs.counters``.  :class:`EdgeMapCounters` is an
instrumentation hook for the engine's dispatch layer
(``apps.engine.set_edge_map_hook``): once installed, EVERY
``edge_map_pull`` / ``edge_map_push`` / ``out_edge_sum`` on every backend —
flat oracle, fused ELL, packed storage, raw arrays — reports:

  * per-(backend, direction) **pass counts**.  The port's apps loop on the
    host, so every pass is host-dispatched and the hook fires once per pass
    that runs.  The reference's split of passes fired under ``jax.jit``
    tracing (its tracer check, ``traced_passes``, ``compiles`` and
    ``recompiles``) has nothing to count here and is gone;
  * **edges traversed** and **lanes** ((V, K) planes count K lanes sharing
    one structural pass);
  * **modeled bytes** from the reference's cost models:
    ``kernels.edge_map.ops.fused_edge_map_bytes`` for tile-set backends —
    over the PADDED planes, the reference's yardstick and not the traffic
    of K5, which walks only each row's real lanes — and
    :func:`flat_edge_map_bytes` for edge-parallel ones;
  * **frontier density** per pass — the pull/push switch statistic as a
    histogram.  Reading it on the host per pass would copy the frontier
    and synchronize the device on every pass, so the hook keeps the
    frontier's out-degree sum as an int64 tensor on the frontier's device
    and folds it, over the edge total, into the histogram in float64 when
    the registry is read (``summary()``, the registry's ``snapshot()``, or
    :meth:`EdgeMapCounters.flush`): the values equal the reference's, and
    ``on_pass`` never synchronizes the device.

The hook reads shapes and host-side ints, and launches two small reductions
for a frontier pass; it never writes an operand, so instrumented runs are
bitwise identical to uninstrumented ones, and an uninstalled hook costs one
``is not None`` check per dispatch.

``record_iters`` takes the true per-lane iteration counts from a loop's
owner: the serving plane calls it after every query batch, the sharded
engine after every PageRank and SSSP solve.

Always on, whatever the hook and the tracer, the graph path's own counts
(read by the benchmark's per-layer metrics):

  * every device-to-host read of the app loops goes through
    :func:`host_read`, which adds one to the plain integer ``HOST_READS``;
    every ``out_edge_sum`` adds the edges it walks to
    ``OUT_EDGE_SUM_EDGES`` (:func:`count_swept_edges`);
  * :func:`app_job` wraps each app's entry point: a span ``apps.<app>``,
    and at its return ``apps.jobs.<app>``, ``apps.host_reads.<app>`` and
    ``engine.out_edge_sum.edges`` in the registry, one addition each per
    call;
  * :func:`record_phases` publishes a set-up call's phases, timed by the
    caller, as spans and as seconds in the registry (``reorder.*``,
    ``engine.build.*``);
  * :func:`count_grouped` counts each ``fused_edge_map`` on the card that
    K5's grouped entry maps, and the tile classes it covers
    (``edge_map.grouped.calls``, ``edge_map.grouped.classes``).

Sharded passes (``repro_torch.dist``) count under ``sharded_flat`` /
``sharded_ell``, their edges from the layout's host degree vectors (base +
delta − tombstones) and their bytes through
``dist.graph.edge_map_bytes_sharded``, with each shard's share under
``edge_map.shard_edges.{i}`` / ``edge_map.shard_bytes.{i}``.  Every rank
that runs the pass counts it, the whole layout's numbers: the layout is
replicated on every rank's host.
"""
from __future__ import annotations

import functools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.edge_map.ops import fused_edge_map_bytes
from . import trace as obs_trace
from .metrics import MetricsRegistry, get_registry

__all__ = [
    "EdgeMapCounters",
    "flat_edge_map_bytes",
    "backend_name",
    "install",
    "uninstall",
    "host_read",
    "count_swept_edges",
    "app_job",
    "record_phases",
    "count_grouped",
]


def flat_edge_map_bytes(e: int, v: int, *, weighted: bool = False,
                        frontier: bool = False, push_init: bool = False,
                        plane_k: int = 1,
                        frontier_planar: bool = False) -> int:
    """Analytic single-pass HBM bytes of the FLAT (edge-parallel) edge map.

    idx read + property gather + edge-value materialize per pass, then the
    segment pass re-reads values + owner ids and writes (V,).
    ``plane_k > 1`` prices a batched (V, K) plane — value traffic scales
    with K, the edge structure (ids, a shared frontier) is read once.
    """
    k = max(1, int(plane_k))
    b = e * 4 + e * 4 * k + e * 4 * k  # in_src read, prop gather, vals write
    if weighted:
        b += e * 4 + 2 * e * 4 * k     # w plane read + vals rmw
    if frontier:
        b += e * (k if frontier_planar else 1) + 2 * e * 4 * k  # mask + rmw
    b += e * 4 * k + e * 4 + v * 4 * k  # reduce: vals, owner ids, out write
    if push_init:
        b += v * 4 * k                  # init read
    return b


#: engine object type -> short backend label (string-keyed to avoid import
#: cycles; anything unknown falls back to its lowercased class name)
_TYPE_NAMES = {
    "GraphArrays": "arrays",
    "FlatBackend": "flat",
    "EllBackend": "ell",
    "PackedBackend": "packed",
    "ShardedGraphArrays": "sharded",
}


def backend_name(ga: Any) -> str:
    name = _TYPE_NAMES.get(type(ga).__name__, type(ga).__name__.lower())
    if name == "sharded":  # split by the layout's own engine backend
        name = f"sharded_{getattr(ga, 'backend', 'flat')}"
    return name


def _shard_edges(ga: Any, direction: str) -> Optional[np.ndarray]:
    """Alive edges owned by each shard: the (V,) host degree vector of the
    pass direction, split by owner block (``v_blk``).  Destination sharding
    puts every edge at exactly one owner, and the degrees are maintained
    under streaming ingest, so this counts base + delta − tombstones on
    both layouts without touching any O(E) plane."""
    deg = getattr(ga, "out_deg" if direction == "push" else "in_deg", None)
    d = int(getattr(ga, "n_shards", 0) or 0)
    v_blk = int(getattr(ga, "v_blk", 0) or 0)
    if deg is None or d <= 0 or v_blk <= 0:
        return None
    deg = np.asarray(deg)
    if deg.ndim != 1:
        return None
    pad = np.zeros(d * v_blk, np.int64)
    pad[:deg.shape[0]] = deg  # v_pad = d * v_blk >= V
    return pad.reshape(d, v_blk).sum(axis=1)


def _num_edges(ga: Any) -> int:
    """Edge count from shapes and build-time ints only."""
    ne = getattr(ga, "num_edges", None)
    if isinstance(ne, (int, np.integer)):
        return int(ne)
    in_src = getattr(ga, "in_src", None)
    if in_src is not None:
        return int(in_src.shape[0])
    return 0


class EdgeMapCounters:
    """The stack-wide edge-map telemetry recorder (see module doc).

    All metrics land in ``registry`` under the ``edge_map.`` prefix:

      ``edge_map.passes.{backend}.{direction}``   passes, per dispatch
      ``edge_map.edges``                          edges traversed
      ``edge_map.lanes``                          ``K`` summed per pass
      ``edge_map.model_bytes``                    modeled HBM bytes
      ``edge_map.shard_edges.{i}`` / ``edge_map.shard_bytes.{i}``
          sharded passes: shard ``i``'s alive edges and its slice of the
          byte model (``sum_i shard_bytes.i`` is the pass's model bytes)
      ``edge_map.frontier_density``               histogram, per frontier
                                                  pass (folded on read)
      ``edge_map.iters.{app}``                    iterations, summed over
                                                  lanes (``record_iters``)
      ``edge_map.queries.{app}``                  lanes reported

    When tracing is on (or a flight ring is installed), every pass also
    emits a Chrome counter event (``ph == "C"``) named ``edge_map`` with
    the running edge and byte totals.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else get_registry()
        # (frontier degree sum, out_deg, K) per frontier pass, unread
        self._pending: List[Tuple[torch.Tensor, torch.Tensor, int]] = []
        self._lock = threading.Lock()
        self.registry.add_flush(self.flush)

    # -- the engine hook -----------------------------------------------------
    def on_pass(self, ga: Any, direction: str, prop: Any,
                kw: Dict[str, Any]) -> None:
        """Record one edge-map dispatch.  Called by ``apps.engine``'s
        ``edge_map_pull`` / ``edge_map_push`` / ``out_edge_sum``; never
        writes an operand and never synchronizes the device."""
        reg = self.registry
        name = backend_name(ga)
        reg.counter(f"edge_map.passes.{name}.{direction}").inc()

        sharded = name.startswith("sharded")
        per_edges = _shard_edges(ga, direction) if sharded else None
        edges = (int(per_edges.sum()) if per_edges is not None
                 else 0 if sharded else _num_edges(ga))
        plane_k = 1
        shape = getattr(prop, "shape", None)
        if shape is not None and len(shape) > 1:
            plane_k = int(shape[1])
        reg.counter("edge_map.edges").inc(edges)
        reg.counter("edge_map.lanes").inc(plane_k)

        src_frontier = kw.get("src_frontier")
        model_bytes = self._model_bytes(ga, direction, edges, plane_k, kw,
                                        src_frontier)
        if model_bytes:
            reg.counter("edge_map.model_bytes").inc(model_bytes)
        if per_edges is not None:
            per_bytes = model_bytes // max(1, len(per_edges))
            for i, e_i in enumerate(per_edges):
                reg.counter(f"edge_map.shard_edges.{i}").inc(int(e_i))
                reg.counter(f"edge_map.shard_bytes.{i}").inc(per_bytes)

        self._hold_density(ga, src_frontier)

        if obs_trace.recording():  # full tracer OR the flight ring
            obs_trace.counter(
                "edge_map", cat="engine",
                edges=reg.counter("edge_map.edges").value,
                model_bytes=reg.counter("edge_map.model_bytes").value)

    # -- loop-owner reporting ------------------------------------------------
    def record_iters(self, app: str, iters: Any) -> None:
        """Report true iteration counts for a loop (``iters`` is the scalar
        or (K,) per-lane count the apps return)."""
        arr = np.atleast_1d(np.asarray(iters))
        self.registry.counter(f"edge_map.iters.{app}").inc(int(arr.sum()))
        self.registry.counter(f"edge_map.queries.{app}").inc(int(arr.size))

    def summary(self, prefix: str = "edge_map.") -> Dict[str, float]:
        """The counter columns, densities folded."""
        return {k: v for k, v in self.registry.snapshot().items()
                if k.startswith(prefix)}

    # -- models --------------------------------------------------------------
    def _model_bytes(self, ga: Any, direction: str, edges: int, plane_k: int,
                     kw: Dict[str, Any], src_frontier: Any) -> int:
        use_weights = bool(kw.get("use_weights", False))
        has_frontier = src_frontier is not None
        planar = has_frontier and len(getattr(src_frontier, "shape", ())) > 1
        push_init = direction == "push"
        v = int(getattr(ga, "num_vertices", 0) or 0)
        in_tiles = getattr(ga, "in_tiles", None)
        if in_tiles is not None:  # fused tile-set backends (ell / packed)
            return fused_edge_map_bytes(
                in_tiles, v, use_weights=use_weights, frontier=has_frontier,
                push_init=push_init, plane_k=plane_k, frontier_planar=planar)
        if backend_name(ga).startswith("sharded"):
            from ..dist.graph import edge_map_bytes_sharded

            mode = direction if direction in ("pull", "push") else "pull"
            return (edge_map_bytes_sharded(ga, mode=mode,
                                           use_weights=use_weights)
                    * ga.n_shards)
        if edges and v:
            return flat_edge_map_bytes(
                edges, v, weighted=use_weights, frontier=has_frontier,
                push_init=push_init, plane_k=plane_k, frontier_planar=planar)
        return 0

    # -- frontier density: held on the device, folded on read ---------------
    def _hold_density(self, ga: Any, src_frontier: Any) -> None:
        """Queue the frontier's out-degree sum (an int64 tensor where the
        frontier lies); no host copy, no synchronization."""
        out_deg = getattr(ga, "out_deg", None)
        if src_frontier is None or out_deg is None or out_deg.dim() != 1 \
                or src_frontier.shape[0] != out_deg.shape[0]:
            return
        f = src_frontier.to(torch.bool)
        deg = out_deg if f.dim() == 1 else out_deg[:, None]
        num = torch.where(f, deg, 0).sum(dtype=torch.int64)
        k = 1 if f.dim() == 1 else int(f.shape[1])
        with self._lock:
            self._pending.append((num, out_deg, k))

    def flush(self) -> None:
        """Fold the held frontier densities into ``edge_map.frontier_density``
        in pass order: ``sum(out_deg[f]) / (max(1, sum(out_deg)) * K)``, the
        reference's float64 value (exact integers, one rounded division)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for num, out_deg, k in pending:
            hist = self.registry.histogram("edge_map.frontier_density")
            total = max(1, int(out_deg.sum(dtype=torch.int64)))
            hist.observe(int(num) / (total * k))


# ---------------------------------------------------------------------------
# the graph path's always-on counts
# ---------------------------------------------------------------------------

#: device-to-host reads through :func:`host_read` since the process started
HOST_READS = 0
#: edges walked by ``apps.engine.out_edge_sum`` since the process started
OUT_EDGE_SUM_EDGES = 0


def host_read(t: torch.Tensor):
    """``t`` on the host, counted in ``HOST_READS``, inside an
    ``apps.host_read`` span: a Python scalar for a 0-d tensor, else a numpy
    array.  On a card every read waits for the device."""
    global HOST_READS
    HOST_READS += 1
    with obs_trace.span("apps.host_read"):
        return t.item() if t.dim() == 0 else t.cpu().numpy()


def count_swept_edges(ga: Any) -> None:
    """Add the edges one ``out_edge_sum`` over ``ga`` walks (all of them)."""
    global OUT_EDGE_SUM_EDGES
    OUT_EDGE_SUM_EDGES += _num_edges(ga)


def count_grouped(classes: int) -> None:
    """One edge map that K5's grouped entry mapped, ``classes`` tile classes
    in it: ``edge_map.grouped.calls`` and ``edge_map.grouped.classes`` in
    the registry."""
    reg = get_registry()  # looked up per call: reset_registry swaps it
    reg.counter("edge_map.grouped.calls").inc()
    reg.counter("edge_map.grouped.classes").inc(classes)


def app_job(app: str):
    """Decorator of an app's entry point: each call runs in an
    ``apps.<app>`` span and, at its return, adds 1 to ``apps.jobs.<app>``,
    the call's host reads to ``apps.host_reads.<app>`` and the edges its
    ``out_edge_sum`` calls walked (if any) to ``engine.out_edge_sum.edges``
    in the registry."""
    span, jobs, reads = f"apps.{app}", f"apps.jobs.{app}", \
        f"apps.host_reads.{app}"

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            reads0, edges0 = HOST_READS, OUT_EDGE_SUM_EDGES
            with obs_trace.span(span):
                out = fn(*args, **kw)
            reg = get_registry()  # looked up per call: reset_registry swaps it
            reg.counter(jobs).inc()
            reg.counter(reads).inc(HOST_READS - reads0)
            if OUT_EDGE_SUM_EDGES != edges0:
                reg.counter("engine.out_edge_sum.edges").inc(
                    OUT_EDGE_SUM_EDGES - edges0)
            return out

        return wrapper

    return deco


def record_phases(prefix: str, names: Sequence[str],
                  marks: Sequence[int]) -> None:
    """Publish one set-up call's phases, timed by ``len(names) + 1``
    readings of ``obs.trace.now()`` (phase ``i`` runs from ``marks[i]`` to
    ``marks[i + 1]``): a span ``<prefix>.<name>`` each (tracer on), and in
    the registry ``<prefix>.<name>_s`` seconds each and ``<prefix>.calls``."""
    reg = get_registry()
    reg.counter(f"{prefix}.calls").inc()
    for name, start, end in zip(names, marks, marks[1:]):
        obs_trace.complete(f"{prefix}.{name}", start, end)
        reg.counter(f"{prefix}.{name}_s").inc((end - start) / 1e9)


# ---------------------------------------------------------------------------
# one-call install into the engine dispatch layer
# ---------------------------------------------------------------------------

def install(counters: Optional[EdgeMapCounters] = None,
            registry: Optional[MetricsRegistry] = None) -> EdgeMapCounters:
    """Create (or take) an :class:`EdgeMapCounters` and set it as the engine
    edge-map hook.  Returns the active counters."""
    from ..apps import engine

    counters = counters or EdgeMapCounters(registry=registry)
    engine.set_edge_map_hook(counters)
    return counters


def uninstall() -> None:
    from ..apps import engine

    engine.set_edge_map_hook(None)
