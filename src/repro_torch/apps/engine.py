"""Ligra-style vertex-centric engine with pluggable edge-map backends.

Port of ``repro.apps.engine``.  The engine mirrors Ligra's two primitives:

  * ``edge_map_pull``  — for every destination vertex, reduce a function of
    its in-neighbors' properties (irregular READS of the property array);
  * ``edge_map_push``  — for every (active) source vertex, send a function of
    its property to its out-neighbors (irregular WRITES, paper §VI-C).

Frontiers are dense boolean masks; ``frontier_density`` is Ligra's pull/push
switch statistic and drives the direction-optimizing SSSP/BC loops.

Three backends implement the primitives (``pull`` / ``push`` methods):

  * ``FlatBackend`` — the edge-parallel oracle: gather ``prop[src]``, add the
    weight, mask the frontier, then a sorted-segment reduction over the
    in-edges.  Every reduction is deterministic (``torch.segment_reduce``, no
    float atomics).  A push reduces the same edge multiset as the pull of the
    same property, so it is the pull's result combined with ``init``.
  * ``EllBackend`` — the fused K5 kernel over per-DBG-group ELL tiles: one
    launch per width class.  Push is the transposed pull with an
    ``init``-seeded accumulator over the same in-direction tiles.  min/max
    are bit-identical to flat; sums differ only in fp association (~1e-6).
  * ``PackedBackend`` (``repro_torch.pack``) — the same K5 kernel straight
    over the hot/cold packed storage: the hot slot tables as stored, the
    cold varint tail decoded once into ELL tiles.  BC's backward sweep goes
    through its own ``out_edge_sum``.

Apps are written against the dispatching ``edge_map_pull``/``edge_map_push``
and run unchanged on either backend; raw ``GraphArrays`` take the flat path.
Entry points build on the CUDA card unless the caller passes a device.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (Callable, Dict, NamedTuple, Optional, Protocol, Tuple,
                    Union, runtime_checkable)

import numpy as np
import torch

from ..device import resolve_device
from ..graph import csr
from ..kernels.edge_map.edge_map import reduce_identity
from ..obs import counters as obs_counters
from ..obs import trace as obs_trace

__all__ = [
    "EdgeMapBackend",
    "GraphArrays",
    "FlatBackend",
    "EllBackend",
    "BACKENDS",
    "BACKEND_KNOBS",
    "KNOB_SCOPES",
    "resolve_backend",
    "validate_knobs",
    "to_arrays",
    "edge_map_pull",
    "edge_map_push",
    "out_edge_sum",
    "set_edge_map_hook",
    "get_edge_map_hook",
    "vertex_map",
    "frontier_density",
    "switch_by_density",
    "DENSITY_THRESHOLD",
]


class GraphArrays(NamedTuple):
    """Both CSR directions flattened onto one device.

    Edge ids are int64 (torch's index type).  ``in_ptr``/``out_ptr`` are the
    CSR offsets, the segments of the sorted-segment reductions."""

    # pull direction (in-edges, grouped by destination)
    in_src: torch.Tensor  # (E,) int64 — source of each in-edge
    in_w: torch.Tensor    # (E,) float32 — weights (shared ones if unweighted)
    in_ptr: torch.Tensor  # (V+1,) int64
    # push direction (out-edges, grouped by source)
    out_dst: torch.Tensor  # (E,) int64 — destination of each out-edge
    out_src: torch.Tensor  # (E,) int64 — owning source (sorted ascending)
    out_w: torch.Tensor    # (E,) float32
    out_ptr: torch.Tensor  # (V+1,) int64
    in_deg: torch.Tensor   # (V,) int32
    out_deg: torch.Tensor  # (V,) int32

    @property
    def num_vertices(self) -> int:
        return int(self.in_deg.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.in_src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.in_deg.device


def _host_arrays(g: csr.Graph) -> Dict[str, Optional[np.ndarray]]:
    """Both CSR directions flattened on the host, in ``GraphArrays``' field
    dtypes.  Unweighted graphs get no weight arrays (``None``): the upload
    makes ONE ones plane that ``in_w`` and ``out_w`` share."""
    v = g.num_vertices
    in_csr, out_csr = g.in_csr, g.out_csr
    out_deg = out_csr.degrees()

    def h(a, dtype):
        return np.ascontiguousarray(a, dtype=dtype)

    in_w = out_w = None
    if in_csr.weights is not None or out_csr.weights is not None:
        in_w = h(in_csr.weights if in_csr.weights is not None
                 else np.ones(in_csr.num_edges), np.float32)
        out_w = h(out_csr.weights if out_csr.weights is not None
                  else np.ones(out_csr.num_edges), np.float32)
    return dict(
        in_src=h(in_csr.indices, np.int64),
        in_w=in_w,
        in_ptr=h(in_csr.indptr, np.int64),
        out_dst=h(out_csr.indices, np.int64),
        out_src=np.repeat(np.arange(v, dtype=np.int64), out_deg),
        out_w=out_w,
        out_ptr=h(out_csr.indptr, np.int64),
        in_deg=h(in_csr.degrees(), np.int32),
        out_deg=h(out_deg, np.int32),
    )


def _upload_arrays(host: Dict[str, Optional[np.ndarray]],
                   device: torch.device) -> GraphArrays:
    """``_host_arrays``' output on ``device``."""
    out = {k: None if a is None else torch.from_numpy(a).to(device)
           for k, a in host.items()}
    if out["in_w"] is None:
        out["in_w"] = out["out_w"] = torch.ones(
            host["in_src"].shape[0], dtype=torch.float32, device=device)
    return GraphArrays(**out)


# ---------------------------------------------------------------------------
# Flat (edge-parallel) implementations — the oracle path
# ---------------------------------------------------------------------------

def _int_identity(dtype: torch.dtype, reduce: str) -> float:
    """Finite identity for integer-sourced props (matches the flat engine's
    empty segments: a segment max over int8 is iinfo.min, etc.)."""
    info = torch.iinfo(dtype)
    return {"sum": 0.0, "min": float(info.max), "max": float(info.min),
            "or": float(info.min)}[reduce]


def _segment(vals: torch.Tensor, ptr: torch.Tensor, reduce: str) -> torch.Tensor:
    """Sorted-segment reduction along dim 0 (deterministic on every device).

    Empty segments take the identity of ``vals``' dtype: 0 for sum, ±inf for
    float min/max, iinfo.max/min for integers.  Integer values reduce in
    float64 (exact for int32 and narrower) and come back in their dtype."""
    if reduce not in ("sum", "min", "max", "or"):
        raise ValueError(reduce)
    red = "max" if reduce == "or" else reduce
    dtype = vals.dtype
    if dtype.is_floating_point:
        initial = None if red == "sum" else reduce_identity(red)
    else:
        initial = None if red == "sum" else _int_identity(dtype, red)
        vals = vals.to(torch.float64)
    out = torch.segment_reduce(vals, red, offsets=ptr, axis=0, unsafe=True,
                               initial=initial)
    return out.to(dtype)


def _masked_vals(src, w, prop, src_frontier, use_weights, neutral):
    vals = prop[src]  # irregular gather — THE hot access of the paper
    if use_weights:
        vals = vals + (w if vals.dim() == 1 else w[:, None])
    if src_frontier is not None:
        m = src_frontier[src]  # (E,) shared or (E, K) per-query
        if vals.dim() > 1 and m.dim() == 1:
            m = m[:, None]
        vals = torch.where(m.to(torch.bool), vals, neutral)
    return vals


def _pull_flat(ga: GraphArrays, prop: torch.Tensor, *, reduce: str = "sum",
               src_frontier: Optional[torch.Tensor] = None,
               use_weights: bool = False, neutral: float = 0.0):
    vals = _masked_vals(ga.in_src, ga.in_w, prop, src_frontier, use_weights,
                        neutral)
    return _segment(vals, ga.in_ptr, reduce)


def _push_flat(ga: GraphArrays, prop: torch.Tensor, *, reduce: str = "sum",
               src_frontier: Optional[torch.Tensor] = None,
               use_weights: bool = False, neutral: float = 0.0,
               init: Optional[torch.Tensor] = None):
    """``init[dst] OP= f(prop[src])`` over the active sources' out-edges.

    The out-edges pushed into ``dst`` are exactly ``dst``'s in-edges, so the
    push reduces the in-direction segments and combines them with ``init``:
    deterministic (no scatter atomics), exact for min/max, and a sum in
    another association than a scatter's (~1e-7)."""
    pulled = _pull_flat(ga, prop, reduce=reduce, src_frontier=src_frontier,
                        use_weights=use_weights, neutral=neutral)
    if init is None:
        init = torch.full_like(pulled, reduce_identity(reduce))
    if reduce == "sum":
        return init + pulled
    if reduce == "min":
        return torch.minimum(init, pulled)
    return torch.maximum(init, pulled)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

@runtime_checkable
class EdgeMapBackend(Protocol):
    """What an edge-map backend must provide for the five apps to run.

    ``pull``/``push`` are the two Ligra primitives.  Backends whose storage
    is not edge-parallel (``repro_torch.pack``'s ``PackedBackend``)
    additionally implement ``out_edge_sum`` — BC's backward dependency
    gather — otherwise the dispatching :func:`out_edge_sum` takes the
    edge-parallel path over the delegate ``out_src``/``out_dst`` arrays.
    """

    def pull(self, prop, *, reduce="sum", src_frontier=None,
             use_weights=False, neutral=0.0): ...

    def push(self, prop, *, reduce="sum", src_frontier=None,
             use_weights=False, neutral=0.0, init=None): ...


class _Delegate:
    """Field passthrough so backends look like GraphArrays to the apps
    (degrees, BC's backward sweep, ``frontier_density``)."""

    ga: GraphArrays

    def __getattr__(self, name):
        if name == "ga":
            raise AttributeError(name)
        return getattr(self.ga, name)


@dataclasses.dataclass(frozen=True)
class FlatBackend(_Delegate):
    """The gather/segment path — the correctness oracle."""

    ga: GraphArrays

    def pull(self, prop, **kw):
        return _pull_flat(self.ga, prop, **kw)

    def push(self, prop, **kw):
        return _push_flat(self.ga, prop, **kw)


class FusedEdgeMaps:
    """Edge maps through the fused K5 kernel over an in-direction tile set.

    One tile set serves both primitives: pull reduces a row's lanes; push
    seeds the row accumulator with ``init`` and runs the same kernel (a
    push-with-reduction IS the transposed pull).  Subclasses provide
    ``in_tiles``, ``num_vertices`` and the tile geometry fields.
    """

    in_tiles: Tuple  # Tuple[EllTileGroup, ...]
    row_tile: int
    width_tile: int

    def _map1(self, prop, *, reduce, src_frontier, use_weights, neutral, init):
        from ..kernels.edge_map.ops import fused_edge_map

        red = "max" if reduce == "or" else reduce
        if red not in ("sum", "min", "max"):
            raise ValueError(reduce)
        dtype = prop.dtype
        identity = None
        x = prop
        if not dtype.is_floating_point:
            x = prop.to(torch.float32)
            identity = _int_identity(dtype, reduce)
            if init is not None:
                init = init.to(torch.float32)
        out = fused_edge_map(
            self.in_tiles, x, self.num_vertices,
            reduce=red, src_frontier=src_frontier, use_weights=use_weights,
            neutral=neutral, init=init, identity=identity,
            row_tile=self.row_tile, width_tile=self.width_tile)
        return out.to(dtype)

    def pull(self, prop, *, reduce="sum", src_frontier=None,
             use_weights=False, neutral=0.0):
        # (V, K) planes (Radii samples) run as ONE fused pass: all K lanes
        # share the tile/idx/frontier traffic.
        return self._map1(prop, reduce=reduce, src_frontier=src_frontier,
                          use_weights=use_weights, neutral=neutral, init=None)

    def push(self, prop, *, reduce="sum", src_frontier=None,
             use_weights=False, neutral=0.0, init=None):
        if init is None:
            init = torch.full((self.num_vertices,) + tuple(prop.shape[1:]),
                              reduce_identity(reduce), dtype=prop.dtype,
                              device=prop.device)
        return self._map1(prop, reduce=reduce, src_frontier=src_frontier,
                          use_weights=use_weights, neutral=neutral, init=init)


@dataclasses.dataclass(frozen=True)
class EllBackend(_Delegate, FusedEdgeMaps):
    """Fused K5 edge maps over per-DBG-group ELL tiles.

    The flat arrays stay on board for the operations outside the fused hot
    path (BC's backward dependency sweep, ``frontier_density``)."""

    ga: GraphArrays
    in_tiles: Tuple  # Tuple[EllTileGroup, ...]
    row_tile: int = 64
    width_tile: int = 128


# ---------------------------------------------------------------------------
# Backend registry — THE single table behind every backend-name switch
# ---------------------------------------------------------------------------

def _phased_build(pack: Callable[[], object],
                  upload: Callable[[object], object]):
    """``upload(pack())``, published as the build's two phases
    (``obs.counters.record_phases``): ``engine.build.pack`` (host packing)
    and ``engine.build.upload`` (putting it on the device)."""
    t0 = obs_trace.now()
    host = pack()
    t1 = obs_trace.now()
    built = upload(host)
    obs_counters.record_phases("engine.build", ("pack", "upload"),
                               (t0, t1, obs_trace.now()))
    return built


def _build_arrays(g: csr.Graph, *, device: torch.device):
    return _phased_build(lambda: _host_arrays(g),
                         lambda host: _upload_arrays(host, device))


def _build_flat(g: csr.Graph, *, device: torch.device):
    return FlatBackend(_build_arrays(g, device=device))


def _build_ell(g: csr.Graph, *, device: torch.device, row_tile: int = 64,
               width_tile: int = 128):
    from ..core.reorder import dbg_spec
    from ..kernels.edge_map.ops import ell_tiles_host, upload_tiles

    def pack():
        in_deg = g.in_csr.degrees()
        spec = dbg_spec(max(1.0, float(in_deg.mean()) if in_deg.size
                            else 1.0))
        return (ell_tiles_host(g.in_csr, spec.boundaries, row_tile=row_tile,
                               width_tile=width_tile), _host_arrays(g))

    def upload(host):
        tiles, arrays = host
        return EllBackend(_upload_arrays(arrays, device),
                          upload_tiles(tiles, device), row_tile=row_tile,
                          width_tile=width_tile)

    return _phased_build(pack, upload)


def _build_packed(g: csr.Graph, *, device: torch.device, row_tile: int = 64,
                  width_tile: int = 128, slot_align: int = 16,
                  hot_groups: int = 0):
    """Its ``pack`` phase is the host layout (``pack_graph``); its
    ``upload`` phase is ``packed_backend``, which puts the layout on the
    device and decodes the cold tail into ELL tiles on the way."""
    from ..pack.engine import packed_backend
    from ..pack.layout import pack_graph

    return _phased_build(
        lambda: pack_graph(g, slot_align=slot_align,
                           hot_groups=hot_groups if hot_groups > 0 else None,
                           rows_per_block=row_tile),
        lambda pg: packed_backend(pg, row_tile=row_tile,
                                  width_tile=width_tile, device=device))


def _build_auto(g: csr.Graph, *, device: torch.device,
                app: Optional[str] = None, plan=None, **overrides):
    """``backend="auto"``: resolve the tuned execution plan for ``g``
    (``repro_torch.tune.plan``) and build the backend it names.  Explicit
    kwargs override the plan; knobs the resolved backend does not consume
    are dropped silently (the plan may carry ELL geometry while resolving a
    graph to ``flat``)."""
    from ..tune import plan as tune_plan

    name, cfg = tune_plan.resolve_auto(g, app=app, plan=plan)
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    accepted, _ignored = validate_knobs(name, cfg)
    return resolve_backend(name)(g, device=device, **accepted)


#: name -> builder(g, device=..., **knobs).  Extend this table rather than
#: matching backend names elsewhere; ``BACKEND_KNOBS`` declares the knobs
#: each builder consumes — keep the two tables in sync.
BACKENDS: Dict[str, Callable] = {
    "flat": _build_flat,      # edge-parallel oracle (gather/segment)
    "ell": _build_ell,        # fused K5 kernel over DBG-ELL tiles
    "packed": _build_packed,  # fused K5 kernel straight over pack.PackedGraph
    "arrays": _build_arrays,  # raw GraphArrays
    "auto": _build_auto,      # plan-resolved (repro_torch.tune) backend
}

#: backend -> construction knobs its builder consumes: THE constraint table
#: of the port (``repro_torch.tune.space`` re-exports it).  ``auto`` takes
#: the union (the plan decides) plus its own resolution knobs (``app``,
#: ``plan``).
BACKEND_KNOBS: Dict[str, frozenset] = {
    "flat": frozenset(),
    "arrays": frozenset(),
    "ell": frozenset({"row_tile", "width_tile"}),
    "packed": frozenset({"row_tile", "width_tile", "slot_align",
                         "hot_groups"}),
    "auto": frozenset({"row_tile", "width_tile", "slot_align", "hot_groups",
                       "app", "plan"}),
}

#: knob -> scope: ``engine`` knobs build backends, ``app`` knobs thread into
#: the direction-optimizing app loops, ``stream`` knobs into StreamConfig
#: (``repro_torch.tune.space`` re-exports it with ``BACKEND_KNOBS``).
KNOB_SCOPES: Dict[str, str] = {
    "backend": "engine",
    "row_tile": "engine",
    "width_tile": "engine",
    "slot_align": "engine",
    "hot_groups": "engine",
    "density_threshold": "app",
    "hysteresis": "stream",
}


def resolve_backend(name: str) -> Callable:
    """Look up a backend builder, with a clear error on unknown names."""
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown edge-map backend {name!r}; known backends: "
            f"{', '.join(sorted(BACKENDS))}") from None


def validate_knobs(backend: str, knobs: Dict, *, strict: bool = False):
    """Partition ``knobs`` for ``backend``: returns ``(accepted, ignored)``.

    Unknown knob names (any outside ``KNOB_SCOPES``, ``app`` and ``plan``)
    always raise ``ValueError`` (a typo must never be a silent no-op); knobs
    that exist but are no-ops on this backend raise when ``strict``, else
    are returned in ``ignored``."""
    resolve_backend(backend)
    allowed = BACKEND_KNOBS[backend]
    known = set(KNOB_SCOPES) | {"app", "plan"}
    accepted, ignored = {}, {}
    for k, v in knobs.items():
        if k not in known:
            raise ValueError(f"unknown backend knob {k!r}; known knobs: "
                             f"{', '.join(sorted(known))}")
        (accepted if k in allowed else ignored)[k] = v
    if ignored and strict:
        raise ValueError(
            f"knob(s) {sorted(ignored)} are no-ops on backend {backend!r} "
            f"(accepted: {sorted(allowed) or 'none'})")
    return accepted, ignored


def to_arrays(
    g: csr.Graph,
    *,
    backend: str = "flat",
    strict: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    **knobs,
):
    """Build an edge-map backend for ``g`` on ``device``.

    ``device=None`` is the CUDA card, and raises without one.  ``"flat"``
    (default) keeps the edge-parallel oracle path; ``"ell"`` packs the
    in-direction into per-DBG-group ELL tiles (``row_tile``/``width_tile``)
    and routes every edge map through the fused K5 kernel; ``"packed"``
    packs ``g`` into hot/cold storage (``slot_align``, ``hot_groups``; 0 =
    the layout's default) and runs K5 over it; ``"arrays"`` returns the raw
    ``GraphArrays``; ``"auto"`` resolves the active tuned execution plan
    (``repro_torch.tune``; ``app`` picks its per-app entry, ``plan``
    overrides the active one) — the hand-tuned default when there is no
    plan — and builds the backend it names.

    Knobs are validated against ``BACKEND_KNOBS``: unknown names raise;
    knobs the chosen backend does not consume warn and are dropped, or
    raise with ``strict=True``.  The build runs inside an
    ``engine.build_backend`` span (a no-op while tracing is off); the
    backend's builder times its host packing and its upload
    (``engine.build.pack`` / ``engine.build.upload`` spans, and their
    seconds in the registry under ``engine.build.*``).
    """
    dev = resolve_device(device)
    accepted, ignored = validate_knobs(backend, knobs, strict=strict)
    if ignored:
        warnings.warn(
            f"to_arrays(backend={backend!r}): ignoring knob(s) "
            f"{sorted(ignored)} — not consumed by this backend "
            "(pass strict=True to make this an error)",
            stacklevel=2)
    with obs_trace.span("engine.build_backend", cat="engine",
                        backend=backend, vertices=g.num_vertices,
                        edges=g.num_edges):
        return resolve_backend(backend)(g, device=dev, **accepted)


# ---------------------------------------------------------------------------
# instrumentation hook — one check per dispatch
# ---------------------------------------------------------------------------

#: When set (``obs.counters.install()``), every ``edge_map_pull`` /
#: ``edge_map_push`` / ``out_edge_sum`` dispatch calls
#: ``hook.on_pass(ga, direction, prop, kw)`` BEFORE running; the hook must
#: not write operands or synchronize the device.  ``None`` (the default)
#: costs one ``is not None`` per dispatch.
_EDGE_MAP_HOOK = None


def set_edge_map_hook(hook):
    """Install (or clear, with ``None``) the edge-map instrumentation hook.
    Returns the previously installed hook."""
    global _EDGE_MAP_HOOK
    prev, _EDGE_MAP_HOOK = _EDGE_MAP_HOOK, hook
    return prev


def get_edge_map_hook():
    return _EDGE_MAP_HOOK


def edge_map_pull(ga, prop, **kw):
    """dst <- REDUCE over in-edges of f(prop[src]).

    ``prop`` may be (V,) or (V, S).  ``reduce`` in {sum, min, max, or}.
    ``src_frontier`` masks contributing sources (inactive sources contribute
    ``neutral``).  Raw ``GraphArrays`` take the flat path.
    """
    if _EDGE_MAP_HOOK is not None:
        _EDGE_MAP_HOOK.on_pass(ga, "pull", prop, kw)
    with obs_trace.span("engine.edge_map_pull"):
        if isinstance(ga, GraphArrays):
            return _pull_flat(ga, prop, **kw)
        return ga.pull(prop, **kw)


def edge_map_push(ga, prop, **kw):
    """dst <- REDUCE over pushes from active sources, seeded by ``init``."""
    if _EDGE_MAP_HOOK is not None:
        _EDGE_MAP_HOOK.on_pass(ga, "push", prop, kw)
    with obs_trace.span("engine.edge_map_push"):
        if isinstance(ga, GraphArrays):
            return _push_flat(ga, prop, **kw)
        return ga.push(prop, **kw)


def out_edge_sum(ga, edge_val) -> torch.Tensor:
    """src <- SUM over out-edges of ``edge_val(src_ids, dst_ids)``.

    BC's backward dependency gather: a pull in the OUT direction whose edge
    value depends on both endpoints.  Backends with segmented (non-edge-
    parallel) storage provide their own ``out_edge_sum``; everything backed
    by flat arrays takes the sorted-segment sum here.  Every call walks all
    edges: it adds them to ``obs.counters.OUT_EDGE_SUM_EDGES``.
    """
    if _EDGE_MAP_HOOK is not None:
        _EDGE_MAP_HOOK.on_pass(ga, "out_sum", None, {})
    obs_counters.count_swept_edges(ga)
    with obs_trace.span("engine.out_edge_sum"):
        fn = getattr(ga, "out_edge_sum", None)
        if fn is not None:
            return fn(edge_val)
        return _segment(edge_val(ga.out_src, ga.out_dst), ga.out_ptr, "sum")


def vertex_map(frontier: torch.Tensor, fn) -> torch.Tensor:
    """Apply ``fn`` over active vertices (dense mask semantics): ``fn()``
    where ``frontier`` is set, 0 elsewhere, in ``fn()``'s dtype (a boolean
    ``fn()`` gives int32, as the reference's weakly typed 0 promotes it)."""
    vals = fn()
    if vals.dtype == torch.bool:
        vals = vals.to(torch.int32)
    return torch.where(frontier, vals, 0)


def frontier_density(ga, frontier: torch.Tensor) -> torch.Tensor:
    """Fraction of edges touched by the frontier — Ligra's pull/push switch
    statistic (|out-edges of frontier| / E), a float32 scalar tensor."""
    e = ga.out_deg.sum().clamp(min=1)
    return torch.where(frontier, ga.out_deg, 0).sum() / e


# Ligra's heuristic: go pull once the frontier touches > E/20 edges.  Both
# directions reduce the identical edge set, so any threshold gives the same
# result at a different cost.
DENSITY_THRESHOLD = 0.05


def switch_by_density(ga, frontier, pull_step, push_step, operand,
                      threshold: Optional[float] = None):
    """Dense frontier → ``pull_step(operand)``, sparse → ``push_step``.

    The comparison runs in float32 on the device (as the reference's
    ``lax.cond`` does); reading it is one host sync per call
    (``obs.counters.host_read``)."""
    if threshold is None:
        threshold = DENSITY_THRESHOLD
    if bool(obs_counters.host_read(frontier_density(ga, frontier)
                                   > threshold)):
        return pull_step(operand)
    return push_step(operand)
