"""Host-side ELL tile packer + device driver for the fused edge map (K5).

Port of ``repro.kernels.edge_map.ops``.  ``ell_tiles`` packs ONE adjacency
direction into per-DBG-group ELL tiles with a per-row true-degree vector,
vectorized through ``csr.ragged_offsets``; its geometry (the uint16 ids when
V ≤ 65535, the 8-lane fine padding, the width-class merge) is the
reference's exactly.

``fused_edge_map`` is the device driver: one K5 launch per tile class, then
an O(V) combine of per-class row results back into vertex space.  Rows are
grouped by degree, so every vertex appears in exactly one class and the
combine is a plain set-scatter (``index_copy_``, exact).  ``extra_tiles``
(the stream's delta segment from ``coo_tiles``, whose destinations
duplicate base rows) fold in with the reduction instead.  Nothing here
materializes an O(E) edge-parallel intermediate.

``refresh_alive`` and ``coo_tiles`` are the stream's packers: both build
their planes on the host exactly as the reference does, then put them on
the device.

``ell_tiles_sharded`` and ``coo_tiles_sharded`` are the sharded engine's
packers (``repro_torch.dist``): D shards' tiles stacked on the host as
numpy planes with a leading shard dim, the reference's planes bit for bit.
A class wider than 1,024 lanes carries one segment list per shard, built
at pack time; ``ShardedTileGroup.shard`` puts one shard's planes and list
on a device as an ``EllTileGroup``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...device import resolve_device
from ...graph import csr as csr_mod
from .._wrap import class_segments, lanes_per_row, row_segments
from .edge_map import REDUCE_IDENTITY, edge_map_tile_bytes, ell_edge_map

__all__ = [
    "EllTileGroup",
    "ShardedTileGroup",
    "ell_tiles",
    "ell_tiles_host",
    "upload_tiles",
    "ell_tiles_sharded",
    "coo_tiles",
    "coo_tiles_sharded",
    "refresh_alive",
    "fused_edge_map",
    "fused_edge_map_bytes",
]


class EllTileGroup(NamedTuple):
    """Device view of one degree class's ELL tiles.

    ``rows``  (R,)  int64 owning vertex ids (true, unpadded count)
    ``idx``   (R_pad, W_pad) uint16 or int32 neighbor ids (0 in padding lanes)
    ``deg``   (R_pad,) int32 true degrees (0 for padding rows)
    ``w``     optional (R_pad, W_pad) float32 additive weights
    ``alive`` optional (R_pad, W_pad) int8 tombstone mask
    ``segments`` optional (S, 3) int32 ``(row, lane_begin, lane_end)`` list
              that splits the rows of a class wider than 1,024 lanes across
              K5's blocks (``_wrap.class_segments``); ``None`` for narrow
              classes
    """

    rows: torch.Tensor
    idx: torch.Tensor
    deg: torch.Tensor
    w: Optional[torch.Tensor] = None
    alive: Optional[torch.Tensor] = None
    segments: Optional[torch.Tensor] = None

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_dim(n: int, tile: int, fine: int = 8) -> int:
    """Adaptive padding: groups smaller than one tile pad to the fine (8-lane)
    granularity; larger ones pad to full tiles.  Keeps per-group padding
    bounded by the geometric-bin argument."""
    if n >= tile:
        return _round_up(n, tile)
    return _round_up(max(1, n), fine)


def _tile_of(pad: int, tile: int) -> int:
    """Tile size for a padded dim (== tile, or the whole dim if small)."""
    return tile if pad >= tile else pad


def _id_dtype(num_vertices: int):
    """Minimal-width storage for neighbor ids: uint16 slots halve the
    dominant idx-plane bytes whenever the ids fit."""
    return np.uint16 if num_vertices <= np.iinfo(np.uint16).max else np.int32


def _slot_coords(degs: np.ndarray):
    """(row_rep, col): the ELL slot of each edge of a group, in row order."""
    row_rep = np.repeat(np.arange(degs.shape[0], dtype=np.int64), degs)
    col = csr_mod.ragged_offsets(np.zeros(degs.shape[0], np.int64), degs)
    return row_rep, col


def _scatter_plane(r_pad: int, w_pad: int, row_rep, col, vals, dtype):
    plane = np.zeros((r_pad, w_pad), dtype)
    plane[row_rep, col] = vals
    return plane


def _fill_planes(adj: csr_mod.CSR, rows: np.ndarray, degs: np.ndarray,
                 r_pad: int, w_pad: int, alive_edges: Optional[np.ndarray]):
    """Vectorized ELL fill for one group; returns (idx, w, alive)."""
    row_rep, col = _slot_coords(degs)
    pos = csr_mod.ragged_offsets(adj.indptr[rows], degs)
    idx = _scatter_plane(r_pad, w_pad, row_rep, col, adj.indices[pos],
                         _id_dtype(adj.num_vertices))
    w = None
    if adj.weights is not None:
        w = _scatter_plane(r_pad, w_pad, row_rep, col, adj.weights[pos],
                           np.float32)
    alive = None
    if alive_edges is not None:
        alive = _scatter_plane(r_pad, w_pad, row_rep, col, alive_edges[pos],
                               np.int8)
    return idx, w, alive


def refresh_alive(
    adj: csr_mod.CSR,
    tiles: Tuple[EllTileGroup, ...],
    alive_edges: Optional[np.ndarray],
) -> Tuple[EllTileGroup, ...]:
    """Rebuild ONLY the alive planes of existing tiles (idx, w, deg and the
    segment list untouched), each on its tile's device.

    A deletion batch re-scatters one int8 plane per class on the host and
    uploads it, instead of repacking the base (no degree binning, no idx/w
    fills).  ``alive_edges`` is a per-edge bool in ``adj``'s storage order;
    ``None`` drops the planes (everything alive again)."""
    out = []
    for t in tiles:
        if alive_edges is None:
            out.append(t._replace(alive=None))
            continue
        rows = t.rows.cpu().numpy()
        degs = t.deg.cpu().numpy()[: rows.shape[0]].astype(np.int64)
        row_rep, col = _slot_coords(degs)
        pos = csr_mod.ragged_offsets(adj.indptr[rows], degs)
        plane = _scatter_plane(t.idx.shape[0], t.idx.shape[1], row_rep, col,
                               alive_edges[pos], np.int8)
        out.append(t._replace(alive=torch.from_numpy(plane).to(t.idx.device)))
    return tuple(out)


def ell_tiles(
    adj: csr_mod.CSR,
    boundaries: Sequence[int],
    *,
    row_tile: int = 64,
    width_tile: int = 128,
    alive_edges: Optional[np.ndarray] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[EllTileGroup, ...]:
    """Pack one CSR direction into per-DBG-group ELL tiles on ``device``
    (``None``: the CUDA card, raising without one).

    Rows (owning vertices) are binned by THEIR degree into the geometric
    ``boundaries`` ranges, then bins that land in the same padded width
    merge into one class (one launch, one x fetch per class).  Zero-degree
    rows are skipped: they take the reduction identity in the combine, and
    a set-combine must not clobber a row another tile set owns.
    ``alive_edges`` is an optional per-edge bool in storage order.

    ``ell_tiles_host`` (the host packing) then ``upload_tiles``.
    """
    device = resolve_device(device)
    return upload_tiles(ell_tiles_host(adj, boundaries, row_tile=row_tile,
                                       width_tile=width_tile,
                                       alive_edges=alive_edges), device)


def upload_tiles(tiles: Sequence[EllTileGroup],
                 device: torch.device) -> Tuple[EllTileGroup, ...]:
    """Host tiles (``ell_tiles_host``) on ``device``."""
    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return tuple(EllTileGroup(*(t(a) for a in g)) for g in tiles)


def ell_tiles_host(
    adj: csr_mod.CSR,
    boundaries: Sequence[int],
    *,
    row_tile: int = 64,
    width_tile: int = 128,
    alive_edges: Optional[np.ndarray] = None,
) -> Tuple[EllTileGroup, ...]:
    """``ell_tiles``' host packing: the same tiles, every plane a numpy
    array (``rows`` int64, the segment list built for a class wider than
    1,024 lanes)."""
    from ...core.reorder import _assign_groups

    deg_all = adj.degrees()
    grp = _assign_groups(deg_all, boundaries)
    by_width = {}
    for k in range(len(boundaries)):
        rows = np.where((grp == k) & (deg_all > 0))[0]
        if rows.size == 0:
            continue
        degs = deg_all[rows].astype(np.int64)
        w_pad = _pad_dim(int(degs.max()), width_tile)
        by_width.setdefault(w_pad, []).append((rows, degs))
    out = []
    for w_pad, parts in by_width.items():  # insertion order: hottest first
        rows = np.concatenate([p[0] for p in parts])
        degs = np.concatenate([p[1] for p in parts])
        r_pad = _pad_dim(rows.size, row_tile)
        idx, w, alive = _fill_planes(adj, rows, degs, r_pad, w_pad,
                                     alive_edges)
        deg_arr = np.zeros(r_pad, np.int32)
        deg_arr[: rows.size] = degs
        out.append(EllTileGroup(
            rows=rows.astype(np.int64), idx=idx, deg=deg_arr, w=w,
            alive=alive, segments=None if lanes_per_row(w_pad) < 256
            else row_segments(deg_arr)))
    return tuple(out)


class ShardedTileGroup(NamedTuple):
    """One width class of D shards' ELL tiles, stacked on the host.

    ``rows``  (D, R_pad) int32 owning row ids (0 in padding rows)
    ``idx``   (D, R_pad, W_pad) uint16 or int32 gather ids
    ``deg``   (D, R_pad) int32 true degrees (0 for padding rows)
    ``w``     optional (D, R_pad, W_pad) float32 additive weights
    ``alive`` optional (D, R_pad, W_pad) int8 tombstone planes
    ``segments`` per shard, the (S_i, 3) int32 K5 segment list of its rows
              when W_pad takes 256 lanes per row (``_wrap.class_segments``),
              else ``None``
    """

    rows: np.ndarray
    idx: np.ndarray
    deg: np.ndarray
    w: Optional[np.ndarray] = None
    alive: Optional[np.ndarray] = None
    segments: Optional[Tuple[np.ndarray, ...]] = None

    def shard(self, i: int, device) -> EllTileGroup:
        """Shard ``i``'s planes, segment list included, as an
        ``EllTileGroup`` on ``device`` (rows widened to int64)."""
        def t(a):
            return None if a is None else torch.from_numpy(a[i]).to(
                device, copy=True)

        return EllTileGroup(
            rows=torch.from_numpy(self.rows[i].astype(np.int64)).to(device),
            idx=t(self.idx), deg=t(self.deg), w=t(self.w), alive=t(self.alive),
            segments=None if self.segments is None else torch.from_numpy(
                self.segments[i]).to(device, copy=True))


def stacked_segments(deg: np.ndarray,
                     w_pad: int) -> Optional[Tuple[np.ndarray, ...]]:
    """Each shard's K5 segment list for a stacked class of width ``w_pad``
    over the (D, R_pad) degrees ``deg``; ``None`` for a narrow class."""
    if lanes_per_row(w_pad) < 256:
        return None
    return tuple(row_segments(d) for d in deg)


def ell_tiles_sharded(
    shard_edges: Sequence[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]],
    *,
    id_upper: int,
    boundaries: Optional[Sequence[int]] = None,
    row_tile: int = 64,
    width_tile: int = 128,
    with_positions: bool = False,
    with_alive: bool = False,
):
    """Pack D per-shard edge lists into ELL classes that STACK across shards.

    ``shard_edges[i] = (rows, cols, w|None)`` is shard *i*'s edge list in
    host numpy (rows in that shard's private row space, cols gather indices
    < ``id_upper``).  Every plane of the returned ``ShardedTileGroup``s has
    a leading shard dim, so all shards share one tile geometry: rows are
    binned by their shard-local degree into the shared geometric
    ``boundaries`` (default: ``dbg_spec`` of the pooled mean degree), each
    bin's padded width is its max over ALL shards, same-width bins merge
    into one class, and each class's row dim pads to the largest shard
    population.  Padding rows have ``deg == 0`` and ``rows == 0``, so a
    combine into an identity-initialized accumulator ignores them.  A class
    wider than 1,024 lanes gets each shard's segment list.

    ``with_positions=True`` also returns, per shard, an ``(E_i, 3)`` int32
    array of each input edge's ``(class, row, col)`` tile slot (the patch
    index of ``repro_torch.dist.graph.apply_remap``); ``with_alive=True``
    attaches an all-ones int8 tombstone plane to every class.
    """
    from ...core.reorder import _assign_groups, dbg_spec

    d = len(shard_edges)
    per = []  # (urows, degs, starts, cols_sorted, w_sorted, order)
    for rows, cols, w in shard_edges:
        order = np.argsort(rows, kind="stable")
        urows, degs = np.unique(rows[order], return_counts=True)
        starts = np.concatenate([[0], np.cumsum(degs)])
        per.append((urows, degs.astype(np.int64), starts, cols[order],
                    None if w is None else w[order], order))
    pooled = (np.concatenate([p[1] for p in per])
              if any(p[1].size for p in per) else np.zeros(0, np.int64))
    if boundaries is None:
        mean = max(1.0, float(pooled.mean()) if pooled.size else 1.0)
        boundaries = dbg_spec(mean).boundaries
    nb = len(boundaries)
    shard_bins = [_assign_groups(p[1], boundaries) for p in per]
    bin_wmax = np.zeros(nb, np.int64)
    for (_, degs, *_), grp in zip(per, shard_bins):
        if degs.size:
            np.maximum.at(bin_wmax, grp, degs)
    by_width: dict = {}  # w_pad -> [bin ids], hottest bin first
    for k in range(nb):
        if bin_wmax[k] == 0:
            continue
        by_width.setdefault(_pad_dim(int(bin_wmax[k]), width_tile),
                            []).append(k)

    weighted = any(p[4] is not None for p in per)
    id_dtype = _id_dtype(id_upper)
    groups = []
    positions = [np.full((rows.shape[0], 3), -1, np.int32)
                 for rows, _, _ in shard_edges]
    for ci, (w_pad, bins) in enumerate(by_width.items()):
        sels = [np.concatenate([np.flatnonzero(g == k) for k in bins])
                if g.size else np.zeros(0, np.int64)
                for g in shard_bins]
        r_pad = _pad_dim(max(int(s.size) for s in sels), row_tile)
        idx = np.zeros((d, r_pad, w_pad), id_dtype)
        deg = np.zeros((d, r_pad), np.int32)
        rws = np.zeros((d, r_pad), np.int32)
        wgt = np.zeros((d, r_pad, w_pad), np.float32) if weighted else None
        for i, ((urows, degs, starts, cs, ws, order), sel) in enumerate(
                zip(per, sels)):
            if sel.size == 0:
                continue
            rdeg = degs[sel]
            row_rep, col = _slot_coords(rdeg)
            pos = csr_mod.ragged_offsets(starts[sel], rdeg)
            idx[i][row_rep, col] = cs[pos].astype(id_dtype)
            if wgt is not None and ws is not None:
                wgt[i][row_rep, col] = ws[pos]
            deg[i, : sel.size] = rdeg
            rws[i, : sel.size] = urows[sel].astype(np.int32)
            if with_positions:
                # sorted-edge position p holds input edge order[p]
                inp = order[pos]
                positions[i][inp, 0] = ci
                positions[i][inp, 1] = row_rep
                positions[i][inp, 2] = col
        groups.append(ShardedTileGroup(
            rows=rws, idx=idx, deg=deg, w=wgt,
            alive=np.ones((d, r_pad, w_pad), np.int8) if with_alive else None,
            segments=stacked_segments(deg, w_pad)))
    tiles = tuple(groups)
    if with_positions:
        return tiles, positions
    return tiles


def coo_tiles(
    src: np.ndarray,
    dst: np.ndarray,
    w: Optional[np.ndarray] = None,
    alive: Optional[np.ndarray] = None,
    *,
    row_tile: int = 64,
    width_tile: int = 128,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[EllTileGroup, ...]:
    """Group a small COO edge list by destination into ONE ELL tile group
    on ``device`` (``None``: the CUDA card, raising without one).

    The stream delta buffer's fused path: destinations become rows (width =
    max multiplicity, padded), so the cold segment rides the same K5 kernel
    as the base tiles, as ``fused_edge_map``'s ``extra_tiles``.  Its
    ``rows`` are the ``np.unique`` destinations, so the combine's
    ``scatter_reduce`` meets each row once: its result does not depend on
    the order the writes land in, sums included.  A row wider than 1,024
    lanes gets its segment list, as ``ell_tiles`` builds it.  Returns ()
    for an empty list.
    """
    device = resolve_device(device)
    if src.shape[0] == 0:
        return ()
    order = np.argsort(dst, kind="stable")
    dsts = dst[order]
    rows, degs = np.unique(dsts, return_counts=True)
    w_pad = _pad_dim(int(degs.max()), width_tile)
    r_pad = _pad_dim(rows.shape[0], row_tile)
    row_rep, col = _slot_coords(degs)
    num_vertices = int(max(src.max(initial=0), dsts.max(initial=0))) + 1
    idx = _scatter_plane(r_pad, w_pad, row_rep, col, src[order],
                         _id_dtype(num_vertices))
    wp = None if w is None else _scatter_plane(
        r_pad, w_pad, row_rep, col, w[order], np.float32)
    ap = None if alive is None else _scatter_plane(
        r_pad, w_pad, row_rep, col, alive[order], np.int8)
    deg_arr = np.zeros(r_pad, np.int32)
    deg_arr[: rows.shape[0]] = degs

    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return (EllTileGroup(
        rows=t(rows.astype(np.int64)), idx=t(idx), deg=t(deg_arr), w=t(wp),
        alive=t(ap), segments=class_segments(deg_arr, w_pad, device)),)


def coo_tiles_sharded(
    shard_edges: Sequence[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]],
    *,
    id_upper: int,
    row_cap: int = 0,
    width_cap: int = 0,
    row_tile: int = 64,
    width_tile: int = 128,
) -> Tuple[ShardedTileGroup, ...]:
    """The delta-segment companion of :func:`ell_tiles_sharded`: D per-shard
    COO delta lists packed into ONE dst-grouped class with a leading shard
    dim.

    ``shard_edges[i] = (rows, cols, w|None)`` is shard *i*'s ALIVE delta
    edges.  The geometry is capacity-driven: the row / width dims pad to at
    least ``row_cap`` / ``width_cap`` (callers pass the running maxima
    back), so the shapes only grow while the buffer fills.  Each shard's
    rows are its ``np.unique`` destinations: a row appears once per shard,
    so the combine meets each real row once.  Delta destinations duplicate
    base rows, so results fold in with the reduction.
    """
    d = len(shard_edges)
    per = []
    max_rows = max_width = 0
    for rows, cols, w in shard_edges:
        order = np.argsort(rows, kind="stable")
        urows, degs = np.unique(rows[order], return_counts=True)
        per.append((urows, degs.astype(np.int64), cols[order],
                    None if w is None else w[order]))
        max_rows = max(max_rows, int(urows.size))
        max_width = max(max_width, int(degs.max()) if degs.size else 0)
    r_pad = _pad_dim(max(1, max_rows, row_cap), row_tile)
    w_pad = _pad_dim(max(1, max_width, width_cap), width_tile)
    weighted = any(p[3] is not None for p in per)
    id_dtype = _id_dtype(id_upper)
    idx = np.zeros((d, r_pad, w_pad), id_dtype)
    deg = np.zeros((d, r_pad), np.int32)
    rws = np.zeros((d, r_pad), np.int32)
    wgt = np.zeros((d, r_pad, w_pad), np.float32) if weighted else None
    for i, (urows, degs, cs, ws) in enumerate(per):
        if urows.size == 0:
            continue
        row_rep, col = _slot_coords(degs)
        idx[i][row_rep, col] = cs.astype(id_dtype)
        if wgt is not None and ws is not None:
            wgt[i][row_rep, col] = ws
        deg[i, : urows.size] = degs
        rws[i, : urows.size] = urows.astype(np.int32)
    return (ShardedTileGroup(rows=rws, idx=idx, deg=deg, w=wgt,
                             segments=stacked_segments(deg, w_pad)),)


def _scatter_combine(out: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                     reduce: str) -> torch.Tensor:
    """Fold rows that duplicate primary rows in with the reduction (exact for
    min / max; a float sum here depends on the order the adds land in,
    unless each row appears once, as in ``coo_tiles``' tiles)."""
    red = {"sum": "sum", "min": "amin", "max": "amax"}[reduce]
    index = rows.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce(0, index, vals, reduce=red, include_self=True)


def fused_edge_map(
    tiles: Tuple[EllTileGroup, ...],
    x: torch.Tensor,
    num_vertices: int,
    *,
    reduce: str = "sum",
    src_frontier: Optional[torch.Tensor] = None,
    use_weights: bool = False,
    neutral: float = 0.0,
    init: Optional[torch.Tensor] = None,
    identity: Optional[float] = None,
    extra_tiles: Tuple[EllTileGroup, ...] = (),
    row_tile: int = 64,
    width_tile: int = 128,
) -> torch.Tensor:
    """Full fused edge map: one K5 launch per tile class + O(V) combine.

    Pull mode (``init is None``): every vertex lands in exactly one primary
    class; uncovered (zero-degree) vertices take the reduction identity —
    matching the flat engine's empty segments.  Push mode (``init`` given):
    the accumulator is seeded per row inside the kernel.  ``extra_tiles``
    (rows that duplicate primary rows) fold in with the reduction.

    ``x`` may be a (V, K) plane; ``init`` is then (V, K) and ``src_frontier``
    either shared (V,) or per-query (V, K).  ``init`` is not modified.
    """
    if identity is None:
        identity = REDUCE_IDENTITY[reduce]
    frontier = None
    if src_frontier is not None:
        frontier = src_frontier.to(torch.int8).contiguous()
    x = x.contiguous()
    lanes = tuple(x.shape[1:])
    out = (torch.full((num_vertices,) + lanes, identity, dtype=x.dtype,
                      device=x.device)
           if init is None else init.to(dtype=x.dtype, copy=True))
    for t in tiles:
        r_pad, w_pad = t.idx.shape
        init_rows = None
        if init is not None:
            init_rows = torch.full((r_pad,) + lanes, identity, dtype=x.dtype,
                                   device=x.device)
            init_rows[: t.num_rows] = out.index_select(0, t.rows)
        y = ell_edge_map(
            x, t.idx, t.deg,
            reduce=reduce,
            w=t.w if use_weights else None,
            unit_weights=use_weights,
            frontier=frontier,
            alive=t.alive,
            init_rows=init_rows,
            neutral=neutral,
            identity=identity,
            segments=t.segments,
            row_tile=_tile_of(r_pad, row_tile),
            width_tile=_tile_of(w_pad, width_tile),
        )
        out.index_copy_(0, t.rows, y[: t.num_rows])
    for t in extra_tiles:
        r_pad, w_pad = t.idx.shape
        y = ell_edge_map(
            x, t.idx, t.deg,
            reduce=reduce,
            w=t.w if use_weights else None,
            unit_weights=use_weights,
            frontier=frontier,
            alive=t.alive,
            neutral=neutral,
            identity=identity,
            segments=t.segments,
            row_tile=_tile_of(r_pad, row_tile),
            width_tile=_tile_of(w_pad, width_tile),
        )
        out = _scatter_combine(out, t.rows, y[: t.num_rows], reduce)
    return out


def fused_edge_map_bytes(
    tiles: Tuple[EllTileGroup, ...],
    num_vertices: int,
    *,
    use_weights: bool = False,
    frontier: bool = False,
    push_init: bool = False,
    extra_tiles: Tuple[EllTileGroup, ...] = (),
    plane_k: int = 1,
    frontier_planar: bool = False,
) -> int:
    """Single-pass HBM bytes of one fused edge map over the padded planes
    (sum of the per-class tile bytes plus the O(V) combine write)."""
    total = num_vertices * 4 * plane_k  # combine write
    for t in tuple(tiles) + tuple(extra_tiles):
        r_pad, w_pad = t.idx.shape
        total += edge_map_tile_bytes(
            r_pad, w_pad, num_vertices,
            weighted=use_weights and t.w is not None,
            frontier=frontier,
            alive=t.alive is not None,
            init=push_init,
            idx_itemsize=t.idx.element_size(),
            plane_k=plane_k,
            frontier_planar=frontier_planar)
    return total
