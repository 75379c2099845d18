"""Delta-based recompute: PageRank / SSSP refresh over a ``DeltaGraph``.

Port of ``repro.stream.incremental``.  The engine mirrors ``apps.engine``
but runs over *stream arrays*: the frozen base edge arrays (both directions,
with tombstone masks) plus the delta-edge buffer, on one device.

Incremental PageRank maintains the invariant

    residual == F(rank) - rank    (F = the PR operator of the CURRENT graph)

After an update batch, the residual changes only at vertices adjacent to the
batch: ``IncrementalPageRank.ingest`` computes that exact change on the host
in O(batch + adjacency of degree-changed sources) — never a full rescan.
``refresh`` then push-propagates residual mass (Gauss-Jacobi forward push)
until ``max|residual| <= epsilon``.  Since the invariant is maintained
exactly (not re-estimated), repeated batches do not drift: the fixed point
of the push loop is the true PageRank of the current graph.

Incremental SSSP uses the classic asymmetry: edge *insertions* only ever
shorten paths, so relaxation restarts from the improved destinations; an edge
*deletion* is a problem only when the deleted edge supported a shortest path
(``dist[dst] == dist[src] + w``), in which case we conservatively recompute
from scratch — detected at refresh time, exact either way.  A deletion that
lands on an edge still waiting in the pending-insert buffers is scrubbed
from those buffers instead, so ``refresh`` never relaxes through a
tombstoned edge.

What differs from the reference, and why:

  * every edge-parallel reduction is a sorted-segment reduction
    (``torch.segment_reduce``), never a float atomic: a push reduces the
    in-direction segments (tombstones mirrored by ``in_alive_mask``) and
    combines them with ``init``, and the delta buffer is sorted by
    destination once per ``stream_arrays`` call.  min / max are bitwise
    the reference's; sums differ only in association;
  * the delta buffer is not padded to a power of two (the padding only
    bounded XLA recompiles);
  * the convergence loops are host loops that read ``max|res| > eps`` or
    ``any(frontier)`` once per iteration (one device sync each);
  * ``rank``, the residual and ``dist`` stay host numpy between refreshes,
    as in the reference: a refresh uploads them and reads them back.

The fused path (``use_fused_push=True``) runs the push and the resync pull
through K5 over ``stream_push_tiles``: the base in-direction ELL tiles with
a tombstone ``alive`` plane, and the delta buffer as one ``coo_tiles`` group
folded in as ``extra_tiles``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..apps.engine import _segment
from ..core.reorder import dbg_spec
from ..device import resolve_device
from ..graph import csr
from ..kernels.edge_map.edge_map import reduce_identity
from ..kernels.edge_map.ops import (coo_tiles, ell_tiles, fused_edge_map,
                                    refresh_alive)
from .delta import ApplyResult, DeltaGraph, occurrence_rank

__all__ = [
    "StreamArrays",
    "StreamBackend",
    "stream_arrays",
    "edge_map_pull_stream",
    "edge_map_push_stream",
    "stream_push_tiles",
    "edge_map_push_stream_fused",
    "edge_map_pull_stream_fused",
    "IncrementalPageRank",
    "IncrementalSSSP",
]

Device = Optional[Union[str, torch.device]]


class StreamArrays(NamedTuple):
    """Edge-parallel view of base + delta, analogous to engine.GraphArrays.

    Ids are int64 (torch's index type); ``*_ptr`` are the (V+1,) segment
    offsets of the sorted-segment reductions."""

    # base pull direction (in-edges grouped by destination) + tombstone mask
    in_src: torch.Tensor
    in_dst: torch.Tensor
    in_w: torch.Tensor
    in_alive: torch.Tensor
    in_ptr: torch.Tensor
    # base push direction (out-edges grouped by source) + tombstone mask
    out_src: torch.Tensor
    out_dst: torch.Tensor
    out_w: torch.Tensor
    out_alive: torch.Tensor
    out_ptr: torch.Tensor
    # delta buffer sorted by destination (stable); ``ex_pos`` is each
    # entry's position in the buffer, ``ex_ptr`` the destination segments
    ex_src: torch.Tensor
    ex_dst: torch.Tensor
    ex_w: torch.Tensor
    ex_alive: torch.Tensor
    ex_pos: torch.Tensor
    ex_ptr: torch.Tensor
    # CURRENT degrees (base + deltas - tombstones)
    in_deg: torch.Tensor
    out_deg: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return int(self.in_deg.shape[0])


def _t(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A copy of host array ``a`` on ``device`` (never a view of ``a``)."""
    a = np.array(a, dtype=dtype)
    return torch.from_numpy(a).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A writable host copy of ``t``."""
    return t.detach().cpu().numpy().copy() if t.device.type == "cpu" \
        else t.detach().cpu().numpy()


def _segments(keys: np.ndarray, v: int) -> np.ndarray:
    """(V+1,) offsets of sorted ``keys``' segments over vertex ids."""
    ptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=v), out=ptr[1:])
    return ptr


def stream_arrays(dg: DeltaGraph, device: Device = None) -> StreamArrays:
    """Materialize stream arrays on ``device`` (``None``: the CUDA card).

    The base-direction uploads are cached on the ``DeltaGraph`` per (base,
    device); the O(E) alive masks per (base, device, tombstone count), so
    insert-only refreshes skip the host scatter and the two O(E) uploads.
    The delta buffer is sorted by destination here, once per call."""
    dev = resolve_device(device)
    cache = getattr(dg, "_stream_base_cache", None)
    if cache is None or cache[0] is not dg.base or cache[1] != dev:
        base = dg.base
        v = base.num_vertices
        in_csr, out_csr = base.in_csr, base.out_csr
        ones = np.ones(in_csr.num_edges, np.float32)
        bd = dict(
            in_src=_t(in_csr.indices, dev, np.int64),
            in_dst=_t(np.repeat(np.arange(v, dtype=np.int64),
                                in_csr.degrees()), dev),
            in_w=_t(in_csr.weights if in_csr.weights is not None else ones,
                    dev, np.float32),
            in_ptr=_t(in_csr.indptr, dev, np.int64),
            out_src=_t(np.repeat(np.arange(v, dtype=np.int64),
                                 out_csr.degrees()), dev),
            out_dst=_t(out_csr.indices, dev, np.int64),
            out_w=_t(out_csr.weights if out_csr.weights is not None
                     else ones, dev, np.float32),
            out_ptr=_t(out_csr.indptr, dev, np.int64),
        )
        cache = (base, dev, bd)
        dg._stream_base_cache = cache
    bd = cache[2]
    masks = getattr(dg, "_stream_mask_cache", None)
    if (masks is None or masks[0] is not dg.base or masks[1] != dev
            or masks[2] != dg.dead_base_edges):
        masks = (dg.base, dev, dg.dead_base_edges,
                 _t(dg.in_alive_mask(), dev), _t(dg.base_alive, dev))
        dg._stream_mask_cache = masks
    ex_src, ex_dst, ex_w, ex_alive = dg.extras()
    order = np.argsort(ex_dst, kind="stable")
    return StreamArrays(
        **bd,
        in_alive=masks[3],
        out_alive=masks[4],
        ex_src=_t(ex_src[order], dev, np.int64),
        ex_dst=_t(ex_dst[order], dev, np.int64),
        ex_w=_t(ex_w[order], dev, np.float32),
        ex_alive=_t(ex_alive[order], dev),
        ex_pos=_t(order, dev, np.int64),
        ex_ptr=_t(_segments(ex_dst[order], dg.num_vertices), dev),
        in_deg=_t(dg.in_deg, dev, np.int32),
        out_deg=_t(dg.out_deg, dev, np.int32),
    )


def _bcast(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An (E,) mask against (E,) or (E, K) values."""
    return m[:, None] if like.dim() > m.dim() else m


def _masked_reduce(src, w, alive, ptr, prop, reduce, src_frontier,
                   use_weights, neutral):
    """REDUCE over each destination segment of masked ``f(prop[src])``:
    dead and out-of-frontier edges give ``neutral``."""
    vals = prop[src]
    if use_weights:
        vals = vals + _bcast(w, vals)
    mask = _bcast(alive, vals)
    if src_frontier is not None:
        mask = mask & _bcast(src_frontier[src].to(torch.bool), vals)
    return _segment(torch.where(mask, vals, neutral), ptr, reduce)


def _combine(a: torch.Tensor, b: torch.Tensor, reduce: str) -> torch.Tensor:
    if reduce == "sum":
        return a + b
    if reduce == "min":
        return torch.minimum(a, b)
    return torch.maximum(a, b)


def edge_map_pull_stream(
    sa: StreamArrays,
    prop: torch.Tensor,
    *,
    reduce: str = "sum",
    src_frontier: Optional[torch.Tensor] = None,
    use_weights: bool = False,
    neutral: Optional[float] = None,
):
    """dst <- REDUCE over CURRENT in-edges of f(prop[src]) (base + delta).

    Unlike the engine's edge maps, tombstoned edges are ALWAYS masked to
    ``neutral``, so the default neutral must be the reduction's identity
    element (not 0.0, which absorbs under min).  ``prop`` may be a (V, K)
    plane, with a shared (V,) or per-query (V, K) frontier.
    """
    if reduce not in ("sum", "min", "max", "or"):
        raise ValueError(reduce)
    if neutral is None:
        neutral = reduce_identity(reduce)
    out = _masked_reduce(sa.in_src, sa.in_w, sa.in_alive, sa.in_ptr, prop,
                         reduce, src_frontier, use_weights, neutral)
    if sa.ex_src.shape[0] == 0:
        return out
    delta = _masked_reduce(sa.ex_src, sa.ex_w, sa.ex_alive, sa.ex_ptr, prop,
                           reduce, src_frontier, use_weights, neutral)
    return _combine(out, delta, "max" if reduce == "or" else reduce)


def edge_map_push_stream(
    sa: StreamArrays,
    prop: torch.Tensor,
    *,
    reduce: str = "sum",
    src_frontier: Optional[torch.Tensor] = None,
    use_weights: bool = False,
    neutral: Optional[float] = None,
    init: Optional[torch.Tensor] = None,
):
    """dst <- REDUCE over pushes along CURRENT out-edges (base + delta).

    The out-edges pushed into ``dst`` are exactly its current in-edges, so
    the push is the stream pull combined with ``init``: deterministic (no
    scatter atomics), exact for min / max.  Masked (tombstoned or
    out-of-frontier) edges push ``neutral``, which defaults to the
    reduction's identity element.
    """
    pulled = edge_map_pull_stream(sa, prop, reduce=reduce,
                                  src_frontier=src_frontier,
                                  use_weights=use_weights, neutral=neutral)
    if init is None:
        init = torch.full_like(pulled, reduce_identity(reduce))
    return _combine(init, pulled, "max" if reduce == "or" else reduce)


# ---------------------------------------------------------------------------
# Engine-protocol backend over the live base + delta layout
# ---------------------------------------------------------------------------

class StreamBackend:
    """An edge-map backend (``engine.edge_map_pull`` / ``edge_map_push`` /
    ``out_edge_sum``) over :class:`StreamArrays`.

    Construction via :meth:`from_delta` costs O(delta): ``stream_arrays``
    reuses the base-direction uploads cached on the ``DeltaGraph`` (and the
    O(E) alive masks, unless a base tombstone landed) and only re-sorts the
    pending extras.  (V, K) query planes run as one pass over the edges.
    """

    def __init__(self, sa: StreamArrays, weighted: bool = False):
        self.sa = sa
        self.weighted = bool(weighted)

    @classmethod
    def from_delta(cls, dg: DeltaGraph,
                   device: Device = None) -> "StreamBackend":
        return cls(stream_arrays(dg, device),
                   dg.base.out_csr.weights is not None)

    # -- delegate surface ---------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return self.sa.num_vertices

    @property
    def in_deg(self) -> torch.Tensor:
        return self.sa.in_deg

    @property
    def out_deg(self) -> torch.Tensor:
        return self.sa.out_deg

    # -- edge maps ----------------------------------------------------------
    def pull(self, prop, *, src_frontier=None, **kw):
        return edge_map_pull_stream(self.sa, prop, src_frontier=src_frontier,
                                    **kw)

    def push(self, prop, *, src_frontier=None, init=None, reduce="sum", **kw):
        return edge_map_push_stream(self.sa, prop, reduce=reduce,
                                    src_frontier=src_frontier, init=init, **kw)

    def out_edge_sum(self, edge_val) -> torch.Tensor:
        """src <- SUM over CURRENT out-edges of ``edge_val(src, dst)``: the
        base's out segments, then the delta's, sorted by source here."""
        sa = self.sa
        vals = edge_val(sa.out_src, sa.out_dst)
        out = _segment(torch.where(_bcast(sa.out_alive, vals), vals, 0),
                       sa.out_ptr, "sum")
        if sa.ex_src.shape[0] == 0:
            return out
        by_src = torch.sort(sa.ex_src, stable=True).indices
        es, ed = sa.ex_src[by_src], sa.ex_dst[by_src]
        ptr = torch.zeros(self.num_vertices + 1, dtype=torch.int64,
                          device=es.device)
        ptr[1:] = torch.cumsum(torch.bincount(es, minlength=self.num_vertices),
                               0)
        evals = edge_val(es, ed)
        evals = torch.where(_bcast(sa.ex_alive[by_src], evals), evals, 0)
        return out + _segment(evals, ptr, "sum")

    # -- the lazy-snapshot escape hatch -------------------------------------
    def materialize(self) -> csr.Graph:
        """The exact version-N graph these arrays pin (alive base edges +
        alive extras, the extras in buffer order) as an immutable
        ``csr.Graph`` — O(E)."""
        sa = self.sa
        keep = _host(sa.in_alive)
        pos = _host(sa.ex_pos)

        def buffer_order(t):
            a = _host(t)
            out = np.empty_like(a)
            out[pos] = a
            return out

        ekeep = buffer_order(sa.ex_alive)
        src = [_host(sa.in_src)[keep], buffer_order(sa.ex_src)[ekeep]]
        dst = [_host(sa.in_dst)[keep], buffer_order(sa.ex_dst)[ekeep]]
        w = None
        if self.weighted:
            w = np.concatenate([_host(sa.in_w)[keep],
                                buffer_order(sa.ex_w)[ekeep]])
        return csr.from_edges(np.concatenate(src), np.concatenate(dst),
                              self.num_vertices, weights=w)


# ---------------------------------------------------------------------------
# Fused base+delta push (K5 over the stream layout)
# ---------------------------------------------------------------------------

def stream_push_tiles(dg: DeltaGraph, *, row_tile: int = 64,
                      width_tile: int = 128, device: Device = None):
    """(base_tiles, delta_tiles) for the fused stream push, on ``device``.

    The base in-direction is packed once per base snapshot into DBG-ELL
    tiles — tombstones ride as an alive plane that is re-scattered on the
    host and uploaded (idx/w planes untouched) when the tombstone count
    moves, so a deletion does NOT force repacking between compactions.  The
    pending delta buffer becomes one dst-grouped ELL group per call
    (``coo_tiles``) and runs through the SAME K5 kernel as ``extra_tiles``.
    """
    dev = resolve_device(device)
    # Two-level cache, base compared by IDENTITY.  Level 1: the structural
    # pack (degree binning + idx/w fills), invalidated only by compaction.
    # Level 2: the alive planes, re-scattered when the tombstone count moves.
    in_csr = dg.base.in_csr
    struct = getattr(dg, "_push_tile_struct", None)
    if (struct is None or struct[0] is not dg.base
            or struct[1] != (row_tile, width_tile, dev)):
        deg = in_csr.degrees()
        spec = dbg_spec(max(1.0, float(deg.mean()) if deg.size else 1.0))
        tiles = ell_tiles(in_csr, spec.boundaries, row_tile=row_tile,
                          width_tile=width_tile, device=dev)
        struct = (dg.base, (row_tile, width_tile, dev), tiles)
        dg._push_tile_struct = struct
        dg._push_tile_alive = None
    alive_cache = getattr(dg, "_push_tile_alive", None)
    if alive_cache is None or alive_cache[0] != dg.dead_base_edges:
        tiles = struct[2]
        if dg.dead_base_edges:
            tiles = refresh_alive(in_csr, tiles, dg.in_alive_mask())
        alive_cache = (dg.dead_base_edges, tiles)
        dg._push_tile_alive = alive_cache
    base_tiles = alive_cache[1]
    ex_src, ex_dst, ex_w, ex_alive = dg.extras()
    delta_tiles = coo_tiles(ex_src, ex_dst, w=ex_w, alive=ex_alive,
                            row_tile=row_tile, width_tile=width_tile,
                            device=dev)
    return base_tiles, delta_tiles


def edge_map_push_stream_fused(
    base_tiles,
    delta_tiles,
    prop: torch.Tensor,
    num_vertices: int,
    *,
    reduce: str = "sum",
    src_frontier: Optional[torch.Tensor] = None,
    use_weights: bool = False,
    init: Optional[torch.Tensor] = None,
    row_tile: int = 64,
    width_tile: int = 128,
):
    """Fused-kernel twin of :func:`edge_map_push_stream` (base + delta in one
    kernel family, no edge-parallel pass).  Masked edges always take the
    reduction's identity element — the stream engine's default ``neutral``
    — which is what lets tombstones and frontier share one in-kernel mask."""
    red = "max" if reduce == "or" else reduce
    neutral = reduce_identity(reduce)
    if init is None:
        init = torch.full((num_vertices,) + tuple(prop.shape[1:]), neutral,
                          dtype=prop.dtype, device=prop.device)
    return fused_edge_map(
        base_tiles, prop, num_vertices,
        reduce=red, src_frontier=src_frontier, use_weights=use_weights,
        neutral=neutral, init=init, extra_tiles=delta_tiles,
        row_tile=row_tile, width_tile=width_tile)


def edge_map_pull_stream_fused(
    base_tiles,
    delta_tiles,
    prop: torch.Tensor,
    num_vertices: int,
    *,
    reduce: str = "sum",
    src_frontier: Optional[torch.Tensor] = None,
    use_weights: bool = False,
    row_tile: int = 64,
    width_tile: int = 128,
):
    """Fused-kernel twin of :func:`edge_map_pull_stream`: the in-direction
    tiles ``stream_push_tiles`` maintains run in pull mode (``init=None``),
    base + delta in the same kernel family."""
    red = "max" if reduce == "or" else reduce
    return fused_edge_map(
        base_tiles, prop, num_vertices,
        reduce=red, src_frontier=src_frontier, use_weights=use_weights,
        neutral=reduce_identity(reduce), init=None, extra_tiles=delta_tiles,
        row_tile=row_tile, width_tile=width_tile)


def _sssp_converge(relax, dist, frontier, max_iters: int):
    """Frontier Bellman-Ford: ``relax(dist, frontier)`` is one min push
    over the current (base + delta) edges seeded by ``dist``."""
    it = 0
    while it < max_iters and bool(frontier.any()):
        cand = relax(dist, frontier)
        dist, frontier, it = cand, cand < dist, it + 1
    return dist, frontier, it


# ---------------------------------------------------------------------------
# Incremental PageRank
# ---------------------------------------------------------------------------

def _dangling(out_deg: torch.Tensor):
    return out_deg == 0, out_deg.clamp(min=1).to(torch.float32)


def _residual(pulled, rank, dangling, damping: float):
    """F(rank) - rank from the pull of ``rank / out_deg``."""
    v = rank.shape[0]
    d = torch.tensor(damping, dtype=torch.float32, device=rank.device)
    dmass = torch.where(dangling, rank, 0.0).sum() / v
    return (1.0 - d) / v + d * (pulled + dmass) - rank


def _pr_residual(sa: StreamArrays, rank: torch.Tensor, damping: float):
    """Exact residual F(rank) - rank on the current graph (one full pull)."""
    dangling, odeg = _dangling(sa.out_deg)
    contrib = torch.where(dangling, 0.0, rank / odeg)
    pulled = edge_map_pull_stream(sa, contrib, reduce="sum")
    return _residual(pulled, rank, dangling, damping)


def _pr_residual_fused(base_tiles, delta_tiles, out_deg, rank, damping: float):
    """:func:`_pr_residual` with the full pull on the fused base+delta tiles
    (the same in-direction tile set the push loop rides)."""
    dangling, odeg = _dangling(out_deg)
    contrib = torch.where(dangling, 0.0, rank / odeg)
    pulled = edge_map_pull_stream_fused(base_tiles, delta_tiles, contrib,
                                        rank.shape[0], reduce="sum")
    return _residual(pulled, rank, dangling, damping)


def _pr_converge(push, out_deg, rank, residual, damping: float,
                 epsilon: float, max_iters: int):
    """Forward-push until max|residual| <= epsilon, preserving the invariant
    residual == F(rank) - rank at every step; ``push(contrib)`` is one sum
    push over the current edges (edge-parallel, or K5 over the fused tiles:
    sum pushes reassociate, so the two agree to fp association, ~1e-8)."""
    v = rank.shape[0]
    dangling, odeg = _dangling(out_deg)
    d = torch.tensor(damping, dtype=torch.float32, device=rank.device)
    eps = torch.tensor(epsilon, dtype=torch.float32, device=rank.device)
    res, it = residual, 0
    while it < max_iters and bool(res.abs().max() > eps):
        moved = torch.where(res.abs() > eps, res, 0.0)
        contrib = torch.where(dangling, 0.0, moved / odeg)
        pushed = push(contrib)
        dmass = torch.where(dangling, moved, 0.0).sum() / v
        res = res - moved + d * (pushed + dmass)
        rank, it = rank + moved, it + 1
    return rank, res, it


class IncrementalPageRank:
    """PageRank that re-converges from batch-local residual mass.

    ``use_fused_push=True`` routes the push-convergence loop and the resync
    through K5 over the fused base+delta tiles (``stream_push_tiles``); the
    ingest stays identical, so the invariant is maintained either way.
    ``device=None`` is the CUDA card.
    """

    def __init__(self, dg: DeltaGraph, *, damping: float = 0.85,
                 epsilon: float = 1e-9, max_iters: int = 4096,
                 use_fused_push: bool = False, device: Device = None):
        self.dg = dg
        self.damping = float(damping)
        self.epsilon = float(epsilon)
        self.max_iters = int(max_iters)
        self.use_fused_push = bool(use_fused_push)
        self.device = resolve_device(device)
        v = dg.num_vertices
        self.rank = np.full(v, 1.0 / v, np.float32)
        self._residual = np.zeros(v, np.float32)
        # uniform component of the residual (dangling-mass changes), kept as
        # a scalar and folded in at refresh so ingest stays batch-local
        self._res_uniform = 0.0
        self._needs_full_residual = True  # first refresh = initial full solve
        self._dirty = True
        self.last_iters = 0
        self.total_push_iters = 0

    def ingest(self, result: ApplyResult) -> None:
        """Fold one applied batch into the residual — O(batch + touched).

        Every array below is indexed over the batch's candidate sources and
        their adjacency, never the full vertex set: the pre-batch degrees
        come from ``result.cand_old_out_deg`` (all sources the batch named
        are in ``cand_sources``), and the uniform dangling-mass term is
        carried as a scalar instead of being spread over V entries here.
        """
        if self._needs_full_residual:
            self._dirty = True
            return
        dg = self.dg
        rank = self.rank
        odn = dg.out_deg
        cand = result.cand_sources  # sorted (np.unique output)
        odo_cand = result.cand_old_out_deg
        changed = odn[cand] != odo_cand
        c_sources = cand[changed]

        # + contributions of every CURRENT edge whose source changed degree,
        #   plus edges inserted from unchanged sources
        s1s, s1d = dg.out_edges_of(c_sources)
        keep = ~np.isin(result.add_src, c_sources)
        s1s = np.concatenate([s1s, result.add_src[keep]])
        s1d = np.concatenate([s1d, result.add_dst[keep]])
        v1 = rank[s1s].astype(np.float64) / np.maximum(1, odn[s1s])
        # - contributions of every PRE-BATCH edge whose source changed degree,
        #   plus edges deleted from unchanged sources (all such sources are
        #   in ``cand``, so their pre-batch degree is in ``odo_cand``)
        old_c = np.isin(result.old_edges_src, c_sources)
        s2s = result.old_edges_src[old_c]
        s2d = result.old_edges_dst[old_c]
        keep = ~np.isin(result.del_src, c_sources)
        s2s = np.concatenate([s2s, result.del_src[keep]])
        s2d = np.concatenate([s2d, result.del_dst[keep]])
        odo_s2 = odo_cand[np.searchsorted(cand, s2s)]
        v2 = rank[s2s].astype(np.float64) / np.maximum(1, odo_s2)

        idx = np.concatenate([s1d, s2d])
        if idx.size:
            u, inv = np.unique(idx, return_inverse=True)
            acc = np.bincount(inv, weights=np.concatenate([v1, -v2]))
            self._residual[u] = (self._residual[u].astype(np.float64)
                                 + self.damping * acc).astype(np.float32)
        # dangling-mass change (uniformly spread term)
        r_cand = rank[cand].astype(np.float64)
        dmass = float(np.sum(r_cand * ((odn[cand] == 0).astype(np.float64)
                                       - (odo_cand == 0))))
        self._res_uniform += self.damping * dmass / dg.num_vertices
        self._dirty = True

    def resync(self) -> None:
        """Recompute the residual exactly (one O(E) pull) — called after
        compaction to shed accumulated float32 noise."""
        self._needs_full_residual = True
        self._dirty = True

    def refresh(self) -> int:
        """Push-converge; returns the number of push iterations run.

        The fused path uploads only the current out-degrees beside its
        tiles; the edge-parallel path builds the stream arrays."""
        if not self._dirty:
            return 0
        dev = self.device
        if self.use_fused_push:
            base_tiles, delta_tiles = stream_push_tiles(self.dg, device=dev)
            out_deg = _t(self.dg.out_deg, dev, np.int32)
        else:
            sa = stream_arrays(self.dg, dev)
            out_deg = sa.out_deg
        rank = _t(self.rank, dev)
        if self._needs_full_residual:
            if self.use_fused_push:
                res = _pr_residual_fused(base_tiles, delta_tiles, out_deg,
                                         rank, self.damping)
            else:
                res = _pr_residual(sa, rank, self.damping)
            self._needs_full_residual = False
            self._res_uniform = 0.0
        else:
            if self._res_uniform:
                self._residual = (self._residual.astype(np.float64)
                                  + self._res_uniform).astype(np.float32)
                self._res_uniform = 0.0
            res = _t(self._residual, dev)
        v = self.dg.num_vertices
        if self.use_fused_push:
            def push(c):
                return edge_map_push_stream_fused(base_tiles, delta_tiles, c,
                                                  v, reduce="sum")
        else:
            def push(c):
                return edge_map_push_stream(sa, c, reduce="sum")
        rank, res, it = _pr_converge(push, out_deg, rank, res, self.damping,
                                     self.epsilon, self.max_iters)
        self.rank = _host(rank)
        # writable copy: ingest patches the residual in place batch-locally
        self._residual = _host(res)
        self.last_iters = int(it)
        self.total_push_iters += self.last_iters
        self._dirty = False
        return self.last_iters

    def query(self) -> np.ndarray:
        self.refresh()
        return self.rank.copy()


# ---------------------------------------------------------------------------
# Incremental SSSP
# ---------------------------------------------------------------------------

# the per-key occurrence-claim primitive lives in ``delta`` (it is shared
# with the vectorized deletion staging of ``DeltaGraph.apply``)
_occurrence_rank = occurrence_rank


class IncrementalSSSP:
    """SSSP with insertion-driven relaxation and deletion fallback.

    ``use_fused_push=True`` routes the convergence loop through K5 over the
    fused base+delta tiles (``stream_push_tiles``) instead of the
    edge-parallel reductions — identical results (min-relaxation is exactly
    associative).  ``device=None`` is the CUDA card.
    """

    def __init__(self, dg: DeltaGraph, root: int, *, max_iters: int = 0,
                 use_fused_push: bool = False, device: Device = None):
        self.dg = dg
        self.root = int(root)
        self.max_iters = max_iters
        self.use_fused_push = bool(use_fused_push)
        self.device = resolve_device(device)
        self.dist: Optional[np.ndarray] = None
        self._pending_src: list = []
        self._pending_dst: list = []
        self._pending_w: list = []
        self._del_src: list = []
        self._del_dst: list = []
        self._del_w: list = []
        self._needs_full = True
        self.full_recomputes = 0
        self.last_iters = 0

    def _edge_w(self, result: ApplyResult, which: str) -> np.ndarray:
        w = getattr(result, which)
        n = getattr(result, which.replace("_w", "_src")).shape[0]
        return np.ones(n, np.float32) if w is None else w

    def ingest(self, result: ApplyResult) -> None:
        """Record one applied batch — pure O(batch) appends.  The deletion
        analysis (pending scrub + criticality check) is deferred to
        ``refresh``: ``dist`` is static between refreshes, so the deferred
        check is identical, and a long query-free churn stream stays linear
        instead of re-scanning the pending buffers every batch."""
        if self._needs_full or self.dist is None:
            self._needs_full = True
            return
        if result.add_src.size:
            self._pending_src.append(result.add_src)
            self._pending_dst.append(result.add_dst)
            self._pending_w.append(self._edge_w(result, "add_w"))
        if result.del_src.size:
            self._del_src.append(result.del_src)
            self._del_dst.append(result.del_dst)
            self._del_w.append(self._edge_w(result, "del_w"))

    def _settle_deletions(self) -> None:
        """Fold the recorded deletions into the pending state (refresh-time).

        A deletion may target an edge still sitting in the pending insert
        buffers (inserted since the last refresh, so invisible to ``dist`` —
        and to the criticality check below when its destination was
        unreachable).  Scrub one matching (src, dst, w) occurrence per
        deletion first; otherwise the seeding in ``refresh`` would relax a
        finite distance through a tombstoned edge.  A matched deletion needs
        no criticality check: either it killed the pending insert itself
        (never part of ``dist``), or it killed an identical (src, dst, w)
        edge while a pending twin stays alive and preserves every path the
        victim carried.
        """
        if not self._del_src:
            return
        ds = np.concatenate(self._del_src)
        dd = np.concatenate(self._del_dst)
        w = np.concatenate(self._del_w)
        self._del_src, self._del_dst, self._del_w = [], [], []
        unmatched = self._scrub_pending(ds, dd, w)
        if np.any(unmatched):
            dist = self.dist
            ds, dd, w = ds[unmatched], dd[unmatched], w[unmatched]
            # the deletion matters only if the edge supported a shortest path
            reach = np.isfinite(dist[ds])
            slack = dist[ds] + w - dist[dd]
            tol = 1e-4 * (1.0 + np.abs(dist[dd]))
            if np.any(reach & np.isfinite(dist[dd]) & (slack <= tol)):
                self._needs_full = True

    def _scrub_pending(self, ds: np.ndarray, dd: np.ndarray,
                       w: np.ndarray) -> np.ndarray:
        """Drop one pending-insert occurrence matching each deletion.

        Occurrences with identical (src, dst, w) are interchangeable, so the
        matching reduces to per-key counting — each key scrubs
        min(#deletions, #pending) occurrences.  One O((D + P) log(D + P))
        pass per refresh.

        Returns a bool mask over the deletions marking the ones that matched
        nothing (these must still pass the criticality check).
        """
        nd = ds.shape[0]
        unmatched = np.ones(nd, dtype=bool)
        if not self._pending_src:
            return unmatched
        ps = np.concatenate(self._pending_src)
        pd = np.concatenate(self._pending_dst)
        pw = np.concatenate(self._pending_w)
        trip = np.empty(nd + ps.shape[0], dtype=[
            ("s", np.int64), ("d", np.int64), ("w", np.float32)])
        trip["s"] = np.concatenate([ds, ps])
        trip["d"] = np.concatenate([dd, pd])
        trip["w"] = np.concatenate([w, pw])
        uniq, inv = np.unique(trip, return_inverse=True)
        inv_d, inv_p = inv[:nd], inv[nd:]
        nk = uniq.shape[0]
        scrub = np.minimum(np.bincount(inv_d, minlength=nk),
                           np.bincount(inv_p, minlength=nk))
        if not scrub.any():
            return unmatched
        unmatched = _occurrence_rank(inv_d) >= scrub[inv_d]
        keep = _occurrence_rank(inv_p) >= scrub[inv_p]
        if keep.any():
            self._pending_src = [ps[keep]]
            self._pending_dst = [pd[keep]]
            self._pending_w = [pw[keep]]
        else:
            self._clear_pending()
        return unmatched

    def refresh(self) -> int:
        dg = self.dg
        v = dg.num_vertices
        max_iters = self.max_iters or v
        if not self._needs_full and self.dist is not None:
            self._settle_deletions()
        if not self._needs_full and self.dist is not None \
                and not self._pending_src:
            self.last_iters = 0  # nothing changed: skip materialization too
            return 0
        if self._needs_full or self.dist is None:
            dist0 = np.full(v, np.inf, np.float32)
            dist0[self.root] = 0.0
            frontier0 = np.zeros(v, bool)
            frontier0[self.root] = True
            if self.dist is not None:
                self.full_recomputes += 1
        else:
            src = np.concatenate(self._pending_src)
            dst = np.concatenate(self._pending_dst)
            w = np.concatenate(self._pending_w)
            dist0 = self.dist.copy()
            cand = np.where(np.isfinite(dist0[src]), dist0[src] + w, np.inf)
            np.minimum.at(dist0, dst, cand.astype(np.float32))
            frontier0 = dist0 < self.dist
            if not frontier0.any():
                self._clear_pending()
                self.last_iters = 0
                return 0
        dev = self.device
        if self.use_fused_push:
            base_tiles, delta_tiles = stream_push_tiles(dg, device=dev)

            def relax(dist, frontier):
                return edge_map_push_stream_fused(
                    base_tiles, delta_tiles, dist, v, reduce="min",
                    src_frontier=frontier, use_weights=True, init=dist)
        else:
            sa = stream_arrays(dg, dev)

            def relax(dist, frontier):
                return edge_map_push_stream(
                    sa, dist, reduce="min", src_frontier=frontier,
                    use_weights=True, neutral=float("inf"), init=dist)
        dist, _, it = _sssp_converge(relax, _t(dist0, dev),
                                     _t(frontier0, dev), max_iters)
        self.dist = _host(dist)
        self._needs_full = False
        self._clear_pending()
        self.last_iters = int(it)
        return self.last_iters

    def _clear_pending(self) -> None:
        self._pending_src, self._pending_dst, self._pending_w = [], [], []
        self._del_src, self._del_dst, self._del_w = [], [], []

    def query(self) -> np.ndarray:
        self.refresh()
        return self.dist.copy()
