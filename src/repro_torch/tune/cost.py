"""Analytic cost pre-ranker: price every candidate, run nothing.

Port of ``repro.tune.cost``, on the port's roofline profile
(``repro_torch.roofline.HW``), byte models
(``kernels.edge_map.edge_map_tile_bytes``,
``obs.counters.flat_edge_map_bytes``) and geometry (``kernels.edge_map.ops``,
``pack.layout``, ``core.reorder``).  The measured sweep (``tune.search``)
is the expensive half of the tuner; it can only afford a handful of
candidates per graph.  This module prices the WHOLE configuration space
analytically — the same byte models ``obs.counters`` charges per pass —
and prunes it to a top-k shortlist:

  * ``flat``   — :func:`repro_torch.obs.counters.flat_edge_map_bytes`;
  * ``ell``    — per-width-class tile geometry recomputed from the degree
    vector alone (mirroring ``kernels.edge_map.ops.ell_tiles`` binning
    exactly — held equal to ``fused_edge_map_bytes`` over the built
    tiles), priced with ``edge_map_tile_bytes``;
  * ``packed`` — the hot/cold split of ``pack.layout.pack_adjacency``
    (stride quantization, sub-line power-of-two slots, hot-group
    thresholding) recomputed the same way, hot slot tables + cold ELL
    classes priced per tile.

The model prices the PADDED planes, as the reference's does, and its
rankings are held to the reference's.  On the card that is not the
traffic: K5 reads only each row's real lanes (``c < deg``), so there a
tile geometry moves padding in the planes, not the lanes a pass reads.
The ranking by modeled bytes is the reference's objective, kept as it is.

Bytes become seconds through :class:`repro_torch.roofline.HW`: a memory
term (modeled bytes / bandwidth), a compute term (~2 FLOPs per edge-lane),
and a **dispatch term** — the grid steps each config's tile geometry
implies (the reference's Pallas ``grid=(r//rt, w//wt)``) times the
profile's ``dispatch_overhead``.  The port's ``"h100"`` profile has no
dispatch term (its kernels launch per group of tile classes, not per grid
step), so there ranking
is by modeled bytes; a profile built with a dispatch cost prices it as the
reference does.

Nothing here touches a device array.  The geometry mirrors read the
degree vector once per graph (``GraphCost.dbg_groups``: each DBG group's
rows, rows of degree > 0 and largest degree), where the reference replays
the binning over the whole vector for every candidate; the prices are the
same, and the ~160-candidate space of a 2^21-vertex graph prices in a
fraction of a second instead of ~100 s.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..roofline import HW
from .space import DEFAULT_CONFIG, canonical, split_config

__all__ = [
    "PassProfile",
    "APP_PROFILES",
    "GraphCost",
    "Scored",
    "config_key",
    "config_steps",
    "group_stats",
    "pass_bytes",
    "app_bytes",
    "app_seconds",
    "default_budget",
    "rank",
    "shortlist",
]


# ---------------------------------------------------------------------------
# workload profiles — the pass mix each app pays per iteration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PassProfile:
    """Shape of one edge-map pass (what the byte models charge for)."""

    direction: str  # "pull" | "push"
    use_weights: bool = False
    frontier: bool = False
    frontier_planar: bool = False
    plane_k: int = 1


#: app -> per-iteration pass mix.  PR is one clean pull; PRΔ and SSSP push
#: from a frontier (SSSP with additive weights and an init-seeded
#: accumulator); BC pays its forward sigma pull plus the backward dependency
#: gather (out_edge_sum — pull-shaped traffic in the out direction); Radii
#: rides a (V, S) sample plane through one pull.
APP_PROFILES: Dict[str, Tuple[PassProfile, ...]] = {
    "pr": (PassProfile("pull"),),
    "prd": (PassProfile("push", frontier=True),),
    "sssp": (PassProfile("push", use_weights=True, frontier=True),),
    "bc": (PassProfile("pull"), PassProfile("pull")),
    "radii": (PassProfile("pull", plane_k=4),),
}


# ---------------------------------------------------------------------------
# geometry mirrors (host-side, degree vector only)
# ---------------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_dim(n: int, tile: int, fine: int = 8) -> int:
    # mirrors kernels.edge_map.ops._pad_dim (adaptive fine-grain padding)
    if n >= tile:
        return _round_up(n, tile)
    return _round_up(max(1, n), fine)


def _ell_itemsize(num_vertices: int) -> int:
    # mirrors kernels.edge_map.ops._id_dtype
    return 2 if num_vertices <= np.iinfo(np.uint16).max else 4


def _hot_itemsize(num_vertices: int) -> int:
    # mirrors pack.codec.min_uint_dtype(v - 1) — the hot tables keep the
    # storage dtype in the reference's tiles (the port widens a uint8
    # table, V <= 256, to uint16; the model prices the reference's planes)
    from ..pack.codec import min_uint_dtype

    return np.dtype(min_uint_dtype(max(0, num_vertices - 1))).itemsize


def _dbg_boundaries(deg: np.ndarray) -> Tuple[int, ...]:
    from ..core.reorder import dbg_spec

    mean = max(1.0, float(deg.mean()) if deg.size else 1.0)
    return tuple(int(b) for b in dbg_spec(mean).boundaries)


def group_stats(deg: np.ndarray, boundaries: Sequence[int]) -> np.ndarray:
    """Per degree group k (``core.reorder._assign_groups``): its rows, its
    rows of degree > 0 and its largest degree, as a (K, 3) int64 array —
    all the geometry mirrors read of the degree vector, so a space of
    candidates is priced from one pass over it."""
    from ..core.reorder import _assign_groups

    deg = np.asarray(deg, np.int64)
    grp = _assign_groups(deg, boundaries)
    stats = np.zeros((len(boundaries), 3), np.int64)
    for k in range(len(boundaries)):
        sel = grp == k
        stats[k, 0] = int(sel.sum())
        if stats[k, 0]:
            stats[k, 1] = int((deg[sel] > 0).sum())
            stats[k, 2] = int(deg[sel].max())
    return stats


def ell_tile_geometry(
    stats: np.ndarray,
    *,
    row_tile: int,
    width_tile: int,
    itemsize: int,
    first_group: int = 0,
) -> List[Tuple[int, int, int]]:
    """``[(r_pad, w_pad, idx_itemsize)]`` of ``ell_tiles`` on a degree
    vector's ``group_stats`` — the binning logic replayed without building
    a single plane: deg-0 rows skipped, bins merged by padded width class;
    groups before ``first_group`` hold no rows (the packed layout's cold
    segment, whose hot rows have degree 0)."""
    by_width: Dict[int, int] = {}
    for k in range(first_group, stats.shape[0]):
        n = int(stats[k, 1])
        if n == 0:
            continue
        w_pad = _pad_dim(int(stats[k, 2]), width_tile)
        by_width[w_pad] = by_width.get(w_pad, 0) + n
    return [(_pad_dim(n, row_tile), w_pad, itemsize)
            for w_pad, n in by_width.items()]


def packed_tile_geometry(
    stats: np.ndarray,
    boundaries: Sequence[int],
    mean: float,
    num_vertices: int,
    *,
    row_tile: int,
    width_tile: int,
    slot_align: int = 16,
    hot_groups: int = 0,
) -> List[Tuple[int, int, int]]:
    """Tile geometry of ``PackedBackend.in_tiles`` for one degree vector
    (its DBG ``boundaries``, mean degree and ``group_stats``): hot slot
    tables (stride-quantized per ``pack_adjacency``'s rules, wrapped in
    place at the storage dtype) followed by the cold segment's ELL width
    classes.  ``hot_groups=0`` takes the layout's own threshold (groups
    whose lower bound is at least the mean degree)."""
    if not hot_groups:
        hot_groups = max(1, sum(1 for b in boundaries if b >= mean))
    hot_groups = min(int(hot_groups), len(boundaries))

    geom: List[Tuple[int, int, int]] = []
    hot_item = _hot_itemsize(num_vertices)
    for k in range(hot_groups):
        rows, wmax = int(stats[k, 0]), int(stats[k, 2])
        if rows == 0:
            continue
        if wmax and wmax < slot_align:
            stride = 1 << int(math.ceil(math.log2(wmax)))
        else:
            stride = _round_up(wmax, slot_align)
        if stride == 0:
            continue
        geom.append((_pad_dim(rows, row_tile), _pad_dim(stride, width_tile),
                     hot_item))
    geom.extend(ell_tile_geometry(stats, row_tile=row_tile,
                                  width_tile=width_tile,
                                  itemsize=_ell_itemsize(num_vertices),
                                  first_group=hot_groups))
    return geom


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphCost:
    """Everything the pricer needs from a graph, host-side and tiny."""

    in_deg: np.ndarray  # (V,) — the pull direction's degree vector
    num_vertices: int
    num_edges: int
    weighted: bool = False

    @classmethod
    def from_graph(cls, g, *, weighted: Optional[bool] = None) -> "GraphCost":
        return cls(
            in_deg=np.asarray(g.in_degrees(), np.int64),
            num_vertices=g.num_vertices,
            num_edges=g.num_edges,
            weighted=(g.in_csr.weights is not None
                      if weighted is None else bool(weighted)))

    @functools.cached_property
    def dbg_groups(self) -> Tuple[Tuple[int, ...], float, np.ndarray]:
        """``(boundaries, mean degree, group_stats)`` of ``in_deg``'s DBG
        grouping, computed once: the reference replays the binning per
        candidate, which at 2^21 vertices took minutes per space."""
        deg = self.in_deg
        boundaries = _dbg_boundaries(deg)
        mean = max(1.0, float(deg.mean()) if deg.size else 1.0)
        return boundaries, mean, group_stats(deg, boundaries)


def _tile_set_bytes(geom: List[Tuple[int, int, int]], v: int,
                    p: PassProfile, weighted: bool) -> int:
    from ..kernels.edge_map.edge_map import edge_map_tile_bytes

    push_init = p.direction == "push"
    total = v * 4 * p.plane_k  # the O(V) combine write
    for r_pad, w_pad, itemsize in geom:
        total += edge_map_tile_bytes(
            r_pad, w_pad, v,
            weighted=p.use_weights and weighted,
            frontier=p.frontier, alive=False, init=push_init,
            idx_itemsize=itemsize, plane_k=p.plane_k,
            frontier_planar=p.frontier_planar)
    return total


def pass_bytes(gc: GraphCost, config: Dict, p: PassProfile) -> int:
    """Modeled HBM bytes of ONE edge-map pass of shape ``p`` under
    ``config`` — the same number ``EdgeMapCounters`` would charge for the
    built backend (property-tested)."""
    from ..obs.counters import flat_edge_map_bytes

    cfg = canonical(config)
    backend = cfg["backend"]
    if backend in ("flat", "arrays"):
        return flat_edge_map_bytes(
            gc.num_edges, gc.num_vertices,
            weighted=p.use_weights and gc.weighted, frontier=p.frontier,
            push_init=p.direction == "push", plane_k=p.plane_k,
            frontier_planar=p.frontier_planar)
    if backend not in ("ell", "packed"):
        raise ValueError(f"cannot price backend {backend!r}")
    return _tile_set_bytes(_config_geometry(gc, cfg), gc.num_vertices, p,
                           gc.weighted)


def _config_geometry(gc: GraphCost, cfg: Dict) -> List[Tuple[int, int, int]]:
    backend = cfg["backend"]
    row_tile = int(cfg.get("row_tile", 64))
    width_tile = int(cfg.get("width_tile", 128))
    boundaries, mean, stats = gc.dbg_groups
    if backend == "ell":
        return ell_tile_geometry(stats, row_tile=row_tile,
                                 width_tile=width_tile,
                                 itemsize=_ell_itemsize(gc.num_vertices))
    return packed_tile_geometry(
        stats, boundaries, mean, gc.num_vertices, row_tile=row_tile,
        width_tile=width_tile, slot_align=int(cfg.get("slot_align", 16)),
        hot_groups=int(cfg.get("hot_groups", 0)))


def config_steps(gc: GraphCost, config: Dict, app: str = "pr") -> int:
    """Grid steps one iteration of ``app`` dispatches under ``config`` in
    the reference's Pallas kernels — ``grid = (r_pad // tile, w_pad //
    tile)`` (with whole-dim blocks when a padded dim is smaller than its
    tile, mirroring ``ops._tile_of``) summed over tile groups and passes.
    The flat backend runs no tile kernel — zero steps."""
    cfg = canonical(config)
    if cfg["backend"] in ("flat", "arrays"):
        return 0
    row_tile = int(cfg.get("row_tile", 64))
    width_tile = int(cfg.get("width_tile", 128))
    per_pass = 0
    for r_pad, w_pad, _ in _config_geometry(gc, cfg):
        rt = row_tile if r_pad >= row_tile else r_pad
        wt = width_tile if w_pad >= width_tile else w_pad
        per_pass += (r_pad // rt) * (w_pad // wt)
    return per_pass * len(APP_PROFILES[app])


def app_bytes(gc: GraphCost, config: Dict, app: str = "pr") -> int:
    """Per-iteration modeled HBM bytes of ``app`` under ``config``."""
    return sum(pass_bytes(gc, config, p) for p in APP_PROFILES[app])


def app_seconds(gc: GraphCost, config: Dict, app: str = "pr",
                hw: Optional[HW] = None) -> float:
    """Roofline time of one iteration: memory term from the byte models,
    compute term ~2 FLOPs per (edge, lane), dispatch term = grid steps ×
    the profile's per-step overhead.  Under ``HW.profile("h100")`` the
    dispatch term is 0 and this is effectively the byte ranking."""
    hw = hw if hw is not None else HW.profile()
    bytes_ = app_bytes(gc, config, app)
    flops = sum(2.0 * gc.num_edges * p.plane_k for p in APP_PROFILES[app])
    seconds = bytes_ / hw.hbm_bw + flops / hw.peak_flops
    if hw.dispatch_overhead:
        seconds += config_steps(gc, config, app) * hw.dispatch_overhead
    return seconds


# ---------------------------------------------------------------------------
# ranking
# ---------------------------------------------------------------------------

def config_key(config: Dict) -> str:
    """Deterministic identity of a canonical config (sort/tie-break key)."""
    return json.dumps(canonical(config), sort_keys=True)


@dataclasses.dataclass(frozen=True)
class Scored:
    config: Dict
    model_bytes: int
    cost_s: float
    steps: int = 0  # grid steps per iteration (0 for flat)


def rank(gc: GraphCost, candidates: Sequence[Dict], *, app: str = "pr",
         hw: Optional[HW] = None) -> List[Scored]:
    """Price every candidate, cheapest first (ties broken by modeled bytes,
    then the canonical config key — fully deterministic)."""
    hw = hw if hw is not None else HW.profile()
    scored = []
    for cfg in candidates:
        cfg = canonical(cfg)
        engine_cfg, _, _ = split_config(cfg)
        scored.append(Scored(
            config=cfg,
            model_bytes=app_bytes(gc, engine_cfg, app),
            cost_s=app_seconds(gc, engine_cfg, app, hw=hw),
            steps=config_steps(gc, engine_cfg, app)))
    return sorted(scored, key=lambda s: (s.cost_s, s.model_bytes,
                                         config_key(s.config)))


def shortlist(ranked: Sequence[Scored], k: int, *,
              must_include: Optional[Dict] = None) -> List[Scored]:
    """Top-k *distinct cost classes* of a ranking: candidates tied on
    ``(cost_s, model_bytes)`` build identical-shaped tile sets (e.g. packed
    ``slot_align`` variants whose strides quantize the same), so measuring
    more than one of a tie class spends sweep budget on duplicates —
    instead each class contributes its first (deterministic key-ordered)
    member and the shortlist covers k genuinely different geometries.
    ``must_include`` (normally the hand-tuned :data:`DEFAULT_CONFIG`) is
    appended if pruned — the measured sweep always sees the incumbent, so
    ``backend="auto"`` can never regress past it unnoticed."""
    out: List[Scored] = []
    seen_classes = set()
    for s in ranked:
        if len(out) >= k:
            break
        sig = (s.cost_s, s.model_bytes)
        if sig in seen_classes:
            continue
        seen_classes.add(sig)
        out.append(s)
    if must_include is not None:
        want = config_key(split_config(must_include)[0])
        if not any(config_key(s.config) == want for s in out):
            for s in ranked:
                if config_key(s.config) == want:
                    out.append(s)
                    break
    return out


def default_budget(gc: GraphCost, app: str = "pr") -> int:
    """Modeled bytes of the hand-tuned default — the never-spend-more
    budget the measured selection is constrained by."""
    engine_cfg, _, _ = split_config(DEFAULT_CONFIG)
    return app_bytes(gc, engine_cfg, app)
