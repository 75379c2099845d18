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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...device import resolve_device
from ...graph import csr as csr_mod
from .._wrap import class_segments
from .edge_map import REDUCE_IDENTITY, edge_map_tile_bytes, ell_edge_map

__all__ = [
    "EllTileGroup",
    "ell_tiles",
    "coo_tiles",
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
    """
    from ...core.reorder import _assign_groups

    device = resolve_device(device)
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
            rows=torch.from_numpy(rows.astype(np.int64)).to(device),
            idx=torch.from_numpy(idx).to(device),
            deg=torch.from_numpy(deg_arr).to(device),
            w=None if w is None else torch.from_numpy(w).to(device),
            alive=None if alive is None else torch.from_numpy(alive).to(device),
            segments=class_segments(deg_arr, w_pad, device),
        ))
    return tuple(out)


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
