"""O(delta) streaming maintenance of a sharded layout (the dist half of
``ShardedStreamService``).

Port of ``repro.dist.stream``.  ``shard_graph(..., stream=True)`` reserves
what this module needs: per-shard delta buffers, key-sorted deletion indexes
over the base segments, tombstone planes on the fused tiles, and halo
headroom.  Per ingest batch the router does

  * **deletions** — find each removed edge's storage slot via an O(log E)
    key lookup (base) or an O(delta) scan (not-yet-compacted inserts) and
    kill it in place: a mask / tombstone flip on the host planes and on the
    device copies of the shard that owns it, never a repack;
  * **insertions** — compute each new edge's gather slot (hot table /
    owner-local / halo via the same stable allocator ``apply_remap`` uses —
    an insert whose cold source crosses shards lands in the reserved halo
    headroom, or raises :class:`~repro_torch.dist.graph.HaloOverflow`) and
    append it to the owner shard's delta buffer;
  * **degrees** — patch exactly the touched rows of the replicated degree
    vectors.

``sync_delta`` then re-materializes the delta segment from the host masters:
flat (D, C) planes plus, on ``"ell"``, stacked COO delta tiles
(``kernels.edge_map.ops.coo_tiles_sharded``) that ride the same K5 pass as
the base tiles.  Capacities grow in powers of two.

``compact_shards`` folds a shard's delta layer back into its base segment
when LOCAL churn crosses the threshold — only dirty shards pay, and a batch
that overshoots the threshold 2x (the all-deltas-on-one-shard skew case)
files a ``shard_compact_stall`` flight anomaly.

The query solvers at the bottom are the streaming-aware counterparts of
``pagerank_sharded``: host loops over the sharded pull, one sync per
iteration to read the stopping test.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..apps import engine as apps_engine
from ..kernels.edge_map.ops import (_pad_dim, coo_tiles_sharded,
                                    stacked_segments)
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from .graph import (GraphMesh, HaloOverflow, ShardDeltaSegment,
                    ShardedGraphArrays, _halo_slot, _invalidate, _key_index,
                    _patch_lanes, _patch_rows, _view, edge_map_pull_sharded)

__all__ = ["apply_edge_delta", "sync_delta", "compact_shards",
           "pagerank_sharded_stream", "sssp_sharded_stream"]


def _next_pow2(n: int) -> int:
    return 1 << max(3, int(n - 1).bit_length())


def _stream_state(sg: ShardedGraphArrays) -> dict:
    host = sg.host or {}
    st = host.get("stream")
    if st is None:
        raise ValueError("layout carries no streaming bookkeeping "
                         "(shard_graph(..., stream=True))")
    return st


def _buf_append(buf: dict, **cols) -> None:
    """Append len(next(cols)) entries to a capacity-doubling delta buffer."""
    n = buf["n"]
    k = len(next(iter(cols.values())))
    cap = buf["dst"].shape[0]
    if n + k > cap:
        new_cap = _next_pow2(n + k)
        for name, arr in list(buf.items()):
            if name == "n":
                continue
            grown = np.zeros(new_cap, arr.dtype)
            grown[:n] = arr[:n]
            buf[name] = grown
    for name, vals in cols.items():
        buf[name][n:n + k] = vals
    buf["alive"][n:n + k] = True
    buf["n"] = n + k


def _reset_buf(buf: dict) -> None:
    buf["n"] = 0
    for name, arr in buf.items():
        if name != "n":
            arr[:] = 0


# ---------------------------------------------------------------------------
# batch routing: ApplyResult -> patched layout (O(batch log E) host work,
# O(batch + delta) device patches)
# ---------------------------------------------------------------------------

def _kill_pull(sg, st, i: int, s: int, t: int, wv,
               mask_coords, lane_coords) -> str:
    """Tombstone one alive (s -> t) occurrence on shard ``i``'s pull side."""
    keys, order = st["in_key"][i]
    key = s * np.int64(sg.v_pad) + t
    lo = np.searchsorted(keys, key, "left")
    hi = np.searchsorted(keys, key, "right")
    alive = st["in_alive"][i]
    wvs = st["in_wv"][i]
    for p in order[lo:hi]:
        if alive[p] and (wv is None or wvs[p] == wv):
            alive[p] = False
            st["in_dead"][i] += 1
            if sg.host["tile_pos"] is not None:
                c, r, col = sg.host["tile_pos"][i][p]
                lane_coords.setdefault(int(c), []).append((i, int(r), int(col)))
            else:
                mask_coords.append((i, int(p)))
            return "base"
    db = st["d"][i]
    n = db["n"]
    cand = np.flatnonzero((db["src"][:n] == s) & (db["dst"][:n] == t)
                          & db["alive"][:n])
    for p in cand:
        if wv is None or db["w"][p] == wv:
            db["alive"][p] = False
            st["delta_dirty"] = True
            return "delta"
    raise RuntimeError(
        f"deletion ({s}->{t}) not found alive in shard {i}'s pull segment")


def _kill_push(sg, st, j: int, s: int, t: int, wv,
               mask_coords, lane_coords) -> str:
    keys, order = st["out_key"][j]
    key = s * np.int64(sg.v_pad) + t
    lo = np.searchsorted(keys, key, "left")
    hi = np.searchsorted(keys, key, "right")
    alive = st["out_alive"][j]
    wvs = st["out_wv"][j]
    for p in order[lo:hi]:
        if alive[p] and (wv is None or wvs[p] == wv):
            alive[p] = False
            st["out_dead"][j] += 1
            if st["push_tile_pos"] is not None:
                c, r, col = st["push_tile_pos"][j][p]
                lane_coords.setdefault(int(c), []).append((j, int(r), int(col)))
            else:
                mask_coords.append((j, int(p)))
            return "base"
    pb = st["p"][j]
    n = pb["n"]
    srcl = s - j * sg.v_blk
    cand = np.flatnonzero((pb["srcl"][:n] == srcl) & (pb["dst"][:n] == t)
                          & pb["alive"][:n])
    for p in cand:
        if wv is None or pb["w"][p] == wv:
            pb["alive"][p] = False
            st["delta_dirty"] = True
            return "delta"
    raise RuntimeError(
        f"deletion ({s}->{t}) not found alive in shard {j}'s push segment")


def _flip_lanes(sg: ShardedGraphArrays, side: str, lane_coords) -> None:
    """Kill tombstoned lanes of the ``side`` tiles' alive planes, on the
    host and in the owning shard's device copy."""
    tiles = sg.pull_tiles if side == "pull" else sg.push_tiles
    for c, coords in lane_coords.items():
        ii, rr, cc = (np.array(x, np.int64) for x in zip(*coords))
        tiles[c].alive[ii, rr, cc] = 0
        for i in np.unique(ii):
            m = ii == i
            _patch_lanes(sg, side, c, "alive", int(i), rr[m], cc[m], 0)


def _flip_mask(sg: ShardedGraphArrays, name: str, coords) -> None:
    ii, pp = (np.array(x, np.int64) for x in zip(*coords))
    getattr(sg, name)[ii, pp] = False
    for i in np.unique(ii):
        _patch_rows(sg, name, int(i), pp[ii == i], False)


def apply_edge_delta(sg: ShardedGraphArrays, result, *,
                     out_deg: np.ndarray, in_deg: np.ndarray,
                     batch_index: int = 0
                     ) -> Tuple[ShardedGraphArrays, Dict[str, Any]]:
    """Route one ``DeltaGraph.apply`` result into the sharded layout.

    Per-batch cost is O(batch · log E) host bookkeeping plus device patches
    proportional to the batch and the delta-segment capacity — never an
    O(E) rebuild.  Mirrors ``DeltaGraph.apply``: deletions kill base
    occurrences before delta ones; weighted deletions match on the exact
    removed weight (``result.del_w``), which keeps the per-shard edge
    multisets identical to the DeltaGraph's.  Raises :class:`HaloOverflow`
    when an inserted cold cross-shard edge finds no reserved halo slot —
    the caller falls back to a full ``shard_graph`` (host state may be
    part-way routed then; the rebuild discards it).  Returns the patched
    layout (delta segment re-synced) and a routing-stats dict.
    """
    st = _stream_state(sg)
    host = sg.host
    v_blk = sg.v_blk
    weighted = st["weighted"]
    hot_pos = host["hot_pos"]

    pull_mask: List[Tuple[int, int]] = []
    push_mask: List[Tuple[int, int]] = []
    pull_lanes: Dict[int, list] = {}
    push_lanes: Dict[int, list] = {}
    kills = {"base": 0, "delta": 0}

    # inserts first: a deletion may target an edge inserted by THIS batch
    # (ApplyResult lists both), and per-occurrence choice is interchangeable
    # because deletions match the exact removed (src, dst, weight)
    add_src = np.asarray(result.add_src, np.int64)
    add_dst = np.asarray(result.add_dst, np.int64)
    add_w = (np.asarray(result.add_w, np.float32)
             if (weighted and result.add_w is not None)
             else np.ones(add_src.shape[0], np.float32))
    if add_src.shape[0]:
        own = add_dst // v_blk
        for i in np.unique(own):
            i = int(i)
            m = own == i
            ss, dd, ww = add_src[m], add_dst[m], add_w[m]
            slots = np.empty(ss.shape[0], np.int64)
            hp = hot_pos[ss]
            m_hot = hp >= 0
            slots[m_hot] = v_blk + hp[m_hot]
            m_local = ~m_hot & (ss // v_blk == i)
            slots[m_local] = ss[m_local] - i * v_blk
            m_halo = ~m_hot & ~m_local
            if m_halo.any():
                u, inv = np.unique(ss[m_halo], return_inverse=True)
                u_slots = np.array(
                    [_halo_slot(sg, i, int(x), exc=HaloOverflow)
                     for x in u], np.int64)
                slots[m_halo] = u_slots[inv]
            _buf_append(st["d"][i], src=ss, dst=dd, w=ww, slot=slots)
        own = add_src // v_blk
        for j in np.unique(own):
            j = int(j)
            m = own == j
            _buf_append(st["p"][j], srcl=add_src[m] - j * v_blk,
                        dst=add_dst[m], w=add_w[m])
        st["delta_dirty"] = True

    del_src = np.asarray(result.del_src, np.int64)
    del_dst = np.asarray(result.del_dst, np.int64)
    del_w = None if result.del_w is None else np.asarray(result.del_w,
                                                         np.float32)
    for k in range(del_src.shape[0]):
        s, t = int(del_src[k]), int(del_dst[k])
        wv = del_w[k] if (weighted and del_w is not None) else None
        kills[_kill_pull(sg, st, t // v_blk, s, t, wv,
                         pull_mask, pull_lanes)] += 1
        _kill_push(sg, st, s // v_blk, s, t, wv, push_mask, push_lanes)

    # patches, host and device: tombstone flips + degree rows
    if pull_mask:
        _flip_mask(sg, "in_mask", pull_mask)
    if push_mask:
        _flip_mask(sg, "out_mask", push_mask)
    if pull_lanes:
        _flip_lanes(sg, "pull", pull_lanes)
    if push_lanes:
        _flip_lanes(sg, "push", push_lanes)
    touched = np.asarray(result.touched, np.int64)
    if touched.size:
        for name, deg in (("in_deg", in_deg), ("out_deg", out_deg)):
            plane = getattr(sg, name)
            plane[touched] = deg[touched].astype(plane.dtype)
            _patch_rows(sg, name, None, touched, plane[touched])
    sg = sync_delta(sg)
    stats = {
        "batch_index": batch_index,
        "routed_inserts": int(add_src.shape[0]),
        "routed_deletes": int(del_src.shape[0]),
        "base_kills": kills["base"],
        "delta_kills": kills["delta"],
        "delta_occupancy": [int(b["n"]) for b in st["d"]],
        "delta_capacity": list(sg.delta.capacity),
    }
    return sg, stats


# ---------------------------------------------------------------------------
# host masters -> delta segment (capacity-stable pow2 shapes)
# ---------------------------------------------------------------------------

def sync_delta(sg: ShardedGraphArrays) -> ShardedGraphArrays:
    """Re-materialize the delta segment from the host delta buffers.

    No-op unless the buffers changed since the last sync.  Cost is
    O(capacity), bounded by the per-shard compaction threshold — the
    "delta" of the batch path's O(delta).  The device copies rebuild at the
    next edge map."""
    st = _stream_state(sg)
    if not st["delta_dirty"] and sg.delta is not None:
        return sg
    d, v_blk = sg.n_shards, sg.v_blk
    c = max(st["caps"]["c"], _next_pow2(max(b["n"] for b in st["d"])))
    cp = max(st["caps"]["cp"], _next_pow2(max(b["n"] for b in st["p"])))
    st["caps"]["c"], st["caps"]["cp"] = c, cp

    slot = np.zeros((d, c), np.int32)
    dstl = np.zeros((d, c), np.int32)
    w = np.zeros((d, c), np.float32)
    alive = np.zeros((d, c), bool)
    for i, b in enumerate(st["d"]):
        n = b["n"]
        slot[i, :n] = b["slot"][:n]
        dstl[i, :n] = b["dst"][:n] - i * v_blk
        w[i, :n] = b["w"][:n]
        alive[i, :n] = b["alive"][:n]
    p_srcl = np.zeros((d, cp), np.int32)
    p_dst = np.zeros((d, cp), np.int32)
    p_w = np.zeros((d, cp), np.float32)
    p_alive = np.zeros((d, cp), bool)
    for j, b in enumerate(st["p"]):
        n = b["n"]
        p_srcl[j, :n] = b["srcl"][:n]
        p_dst[j, :n] = b["dst"][:n]
        p_w[j, :n] = b["w"][:n]
        p_alive[j, :n] = b["alive"][:n]

    pull_tiles = push_tiles = None
    if sg.backend == "ell":
        weighted = st["weighted"]
        pull_lists, push_lists = [], []
        for i in range(d):
            b, pb = st["d"][i], st["p"][i]
            ka = b["alive"][: b["n"]]
            pa = pb["alive"][: pb["n"]]
            pull_lists.append((
                (b["dst"][: b["n"]][ka] - i * v_blk),
                b["slot"][: b["n"]][ka],
                b["w"][: b["n"]][ka] if weighted else None))
            push_lists.append((
                pb["dst"][: pb["n"]][pa],
                pb["srcl"][: pb["n"]][pa],
                pb["w"][: pb["n"]][pa] if weighted else None))
        pull_tiles = coo_tiles_sharded(
            pull_lists, id_upper=sg.table_len,
            row_cap=st["caps"]["pr"][0], width_cap=st["caps"]["pr"][1],
            row_tile=sg.row_tile, width_tile=sg.width_tile)
        st["caps"]["pr"] = (int(pull_tiles[0].idx.shape[1]),
                            int(pull_tiles[0].idx.shape[2]))
        push_tiles = coo_tiles_sharded(
            push_lists, id_upper=sg.v_blk,
            row_cap=st["caps"]["pp"][0], width_cap=st["caps"]["pp"][1],
            row_tile=sg.row_tile, width_tile=sg.width_tile)
        st["caps"]["pp"] = (int(push_tiles[0].idx.shape[1]),
                            int(push_tiles[0].idx.shape[2]))

    st["delta_dirty"] = False
    _invalidate(sg, "delta")
    return dataclasses.replace(sg, delta=ShardDeltaSegment(
        slot=slot, dstl=dstl, w=w, alive=alive, p_srcl=p_srcl, p_dst=p_dst,
        p_w=p_w, p_alive=p_alive, pull_tiles=pull_tiles,
        push_tiles=push_tiles))


# ---------------------------------------------------------------------------
# per-shard compaction: only dirty shards pay
# ---------------------------------------------------------------------------

def _grow_len(n: int) -> int:
    return int(np.ceil((n + n // 4 + 8) / 64.0) * 64)


def _pad_cols(arr: np.ndarray, width: int, fill) -> np.ndarray:
    if int(arr.shape[1]) >= width:
        return arr
    return np.pad(arr, ((0, 0), (0, width - int(arr.shape[1]))),
                  constant_values=fill)


def _pad3(arr: Optional[np.ndarray], r_pad: int, w_pad: int, fill=0):
    if arr is None:
        return None
    return np.pad(arr, ((0, 0), (0, r_pad - arr.shape[1]),
                        (0, w_pad - arr.shape[2])), constant_values=fill)


def _repack_shard_tiles(sg: ShardedGraphArrays, i: int, side: str,
                        rows: np.ndarray, cols: np.ndarray,
                        w: Optional[np.ndarray]) -> ShardedGraphArrays:
    """Rebuild shard ``i``'s planes of the stacked ELL tiles after a fold.

    Rows are fitted into the EXISTING width classes (smallest padded width
    that holds each row's degree); a class whose row or width capacity no
    longer suffices grows monotonically — all other shards' planes are
    preserved under the padding.  Each changed class gets its segment lists
    anew; shard ``i``'s device copy rebuilds at the next edge map."""
    st = _stream_state(sg)
    host = sg.host
    pull = side == "pull"
    tiles = list(sg.pull_tiles if pull else sg.push_tiles)

    order = np.argsort(rows, kind="stable")
    urows, degs = np.unique(rows[order], return_counts=True)
    starts = np.concatenate([[0], np.cumsum(degs)])
    cols_s = cols[order]
    w_s = None if w is None else w[order]
    nclass = len(tiles)
    widths = np.array([int(t.idx.shape[2]) for t in tiles], np.int64)
    by_width = np.argsort(widths, kind="stable")
    # first class (ascending width) that fits each row's degree; rows wider
    # than every class land in the widest one, growing it below
    fit = np.searchsorted(widths[by_width], degs)
    cls = by_width[np.minimum(fit, nclass - 1)]

    positions = np.full((rows.shape[0], 3), -1, np.int32)
    for c in range(nclass):
        sel = np.flatnonzero(cls == c)
        t = tiles[c]
        r_pad, w_pad = int(t.idx.shape[1]), int(t.idx.shape[2])
        need_r = int(sel.size)
        need_w = int(degs[sel].max()) if sel.size else 0
        if need_r > r_pad or need_w > w_pad:
            r_pad = max(r_pad, _pad_dim(need_r, sg.row_tile))
            w_pad = max(w_pad, _pad_dim(need_w, sg.width_tile))
            t = t._replace(
                rows=_pad_cols(t.rows, r_pad, 0),
                deg=_pad_cols(t.deg, r_pad, 0),
                idx=_pad3(t.idx, r_pad, w_pad), w=_pad3(t.w, r_pad, w_pad),
                alive=_pad3(t.alive, r_pad, w_pad, 1))
        idx_row = np.zeros((r_pad, w_pad), t.idx.dtype)
        deg_row = np.zeros(r_pad, np.int32)
        rows_row = np.zeros(r_pad, np.int32)
        w_row = (np.zeros((r_pad, w_pad), np.float32)
                 if t.w is not None else None)
        if sel.size:
            rdeg = degs[sel]
            row_rep = np.repeat(np.arange(sel.size, dtype=np.int64), rdeg)
            col = np.concatenate([np.arange(k) for k in rdeg]) \
                if rdeg.size else np.zeros(0, np.int64)
            pos = np.concatenate(
                [np.arange(starts[s], starts[s] + rdeg[j])
                 for j, s in enumerate(sel)]) if sel.size \
                else np.zeros(0, np.int64)
            idx_row[row_rep, col] = cols_s[pos].astype(t.idx.dtype)
            if w_row is not None and w_s is not None:
                w_row[row_rep, col] = w_s[pos]
            deg_row[: sel.size] = rdeg
            rows_row[: sel.size] = urows[sel].astype(np.int32)
            inp = order[pos]
            positions[inp, 0] = c
            positions[inp, 1] = row_rep
            positions[inp, 2] = col
        t.idx[i], t.deg[i], t.rows[i] = idx_row, deg_row, rows_row
        if t.w is not None:
            t.w[i] = w_row
        if t.alive is not None:
            t.alive[i] = 1
        tiles[c] = t._replace(segments=stacked_segments(t.deg, w_pad))
    _invalidate(sg, f"{side}_tiles", shard=i)
    if pull:
        host["tile_pos"][i] = positions
        host["tile_idx"] = [t.idx for t in tiles]
        return dataclasses.replace(sg, pull_tiles=tuple(tiles))
    st["push_tile_pos"][i] = positions
    return dataclasses.replace(sg, push_tiles=tuple(tiles))


def _fold_pull(sg: ShardedGraphArrays, i: int) -> ShardedGraphArrays:
    st = _stream_state(sg)
    host = sg.host
    v_blk = sg.v_blk
    keep = st["in_alive"][i]
    b = st["d"][i]
    n = b["n"]
    dk = b["alive"][:n]
    new_src = np.concatenate([host["in_src"][i][keep], b["src"][:n][dk]])
    new_dst = np.concatenate([st["in_dst"][i][keep], b["dst"][:n][dk]])
    new_w = np.concatenate([st["in_wv"][i][keep], b["w"][:n][dk]])
    new_slot = np.concatenate([host["slot"][i][keep], b["slot"][:n][dk]])
    order = np.argsort(new_dst, kind="stable")  # pull segments stay dst-sorted
    new_src, new_dst = new_src[order], new_dst[order]
    new_w, new_slot = new_w[order], new_slot[order]
    e_i = int(new_src.shape[0])

    host["in_src"][i] = new_src
    so = np.argsort(new_src, kind="stable")
    host["src_order"][i] = (new_src[so], so)
    host["slot"][i] = new_slot
    st["in_dst"][i] = new_dst
    st["in_wv"][i] = new_w
    st["in_alive"][i] = np.ones(e_i, bool)
    st["in_dead"][i] = 0
    st["in_key"][i] = _key_index(new_src, new_dst, sg.v_pad)
    _reset_buf(b)
    st["delta_dirty"] = True

    in_slot, in_dstl = sg.in_slot, sg.in_dst_local
    in_w, in_mask = sg.in_w, sg.in_mask
    e_blk = int(in_slot.shape[1])
    if e_i > e_blk:
        e_blk = _grow_len(e_i)
        in_slot = _pad_cols(in_slot, e_blk, 0)
        in_dstl = _pad_cols(in_dstl, e_blk, v_blk - 1)
        in_w = _pad_cols(in_w, e_blk, 0.0)
        in_mask = _pad_cols(in_mask, e_blk, False)
    in_slot[i] = 0
    in_slot[i, :e_i] = new_slot
    in_dstl[i] = v_blk - 1
    in_dstl[i, :e_i] = new_dst - i * v_blk
    in_w[i] = 0.0
    in_w[i, :e_i] = new_w
    in_mask[i] = False
    in_mask[i, :e_i] = True
    _invalidate(sg, "in_slot", "in_ptr", "in_w", "in_mask", shard=i)
    sg = dataclasses.replace(sg, in_slot=in_slot, in_dst_local=in_dstl,
                             in_w=in_w, in_mask=in_mask)
    if sg.pull_tiles is not None:
        sg = _repack_shard_tiles(sg, i, "pull", new_dst - i * v_blk,
                                 new_slot,
                                 new_w if st["weighted"] else None)
    return sg


def _fold_push(sg: ShardedGraphArrays, j: int) -> ShardedGraphArrays:
    st = _stream_state(sg)
    v_blk = sg.v_blk
    keep = st["out_alive"][j]
    b = st["p"][j]
    n = b["n"]
    dk = b["alive"][:n]
    new_src = np.concatenate([st["out_src"][j][keep],
                              b["srcl"][:n][dk] + j * v_blk])
    new_dst = np.concatenate([st["out_dst"][j][keep], b["dst"][:n][dk]])
    new_w = np.concatenate([st["out_wv"][j][keep], b["w"][:n][dk]])
    e_j = int(new_src.shape[0])

    st["out_src"][j] = new_src
    st["out_dst"][j] = new_dst
    st["out_wv"][j] = new_w
    st["out_alive"][j] = np.ones(e_j, bool)
    st["out_dead"][j] = 0
    st["out_key"][j] = _key_index(new_src, new_dst, sg.v_pad)
    _reset_buf(b)
    st["delta_dirty"] = True

    out_srcl, out_dst = sg.out_src_local, sg.out_dst
    out_w, out_mask = sg.out_w, sg.out_mask
    e_blk = int(out_srcl.shape[1])
    if e_j > e_blk:
        e_blk = _grow_len(e_j)
        out_srcl = _pad_cols(out_srcl, e_blk, 0)
        out_dst = _pad_cols(out_dst, e_blk, 0)
        out_w = _pad_cols(out_w, e_blk, 0.0)
        out_mask = _pad_cols(out_mask, e_blk, False)
    out_srcl[j] = 0
    out_srcl[j, :e_j] = new_src - j * v_blk
    out_dst[j] = 0
    out_dst[j, :e_j] = new_dst
    out_w[j] = 0.0
    out_w[j, :e_j] = new_w
    out_mask[j] = False
    out_mask[j, :e_j] = True
    _invalidate(sg, "out_srcl", "out_plan", "out_w", "out_mask", shard=j)
    sg = dataclasses.replace(sg, out_src_local=out_srcl, out_dst=out_dst,
                             out_w=out_w, out_mask=out_mask)
    if sg.push_tiles is not None:
        sg = _repack_shard_tiles(sg, j, "push", new_dst,
                                 new_src - j * v_blk,
                                 new_w if st["weighted"] else None)
    return sg


def compact_shards(sg: ShardedGraphArrays, *, threshold: float = 0.25,
                   batch_index: int = 0
                   ) -> Tuple[ShardedGraphArrays, List[Tuple[str, int]]]:
    """Fold delta layers back into base segments on a per-shard LOCAL
    threshold (churn_i > threshold * base_i) — only dirty shards pay.

    A shard whose churn overshoots the threshold 2x in a single batch files
    a ``shard_compact_stall`` flight anomaly before folding.  Returns the
    (possibly patched) layout and the list of (side, shard) folds."""
    st = _stream_state(sg)
    folded: List[Tuple[str, int]] = []
    for i in range(sg.n_shards):
        base_n = max(1, int(st["in_alive"][i].shape[0]))
        occ = int(st["in_dead"][i]) + int(st["d"][i]["n"])
        if occ > threshold * base_n:
            if occ > 2.0 * threshold * base_n:
                obs_flight.trigger(
                    "shard_compact_stall", shard=i, side="pull",
                    occupancy=occ, base_edges=base_n,
                    threshold=threshold, batch_index=batch_index)
            with obs_trace.span("dist.shard_compact", cat="dist",
                                shard=i, side="pull", occupancy=occ):
                sg = _fold_pull(sg, i)
            folded.append(("pull", i))
        base_n = max(1, int(st["out_alive"][i].shape[0]))
        occ = int(st["out_dead"][i]) + int(st["p"][i]["n"])
        if occ > threshold * base_n:
            if occ > 2.0 * threshold * base_n:
                obs_flight.trigger(
                    "shard_compact_stall", shard=i, side="push",
                    occupancy=occ, base_edges=base_n,
                    threshold=threshold, batch_index=batch_index)
            with obs_trace.span("dist.shard_compact", cat="dist",
                                shard=i, side="push", occupancy=occ):
                sg = _fold_push(sg, i)
            folded.append(("push", i))
    if folded:
        sg = sync_delta(sg)
    return sg, folded


# ---------------------------------------------------------------------------
# streaming-aware sharded queries
# ---------------------------------------------------------------------------

def pagerank_sharded_stream(sg: ShardedGraphArrays, mesh: GraphMesh, *,
                            damping: float = 0.85, tol: float = 1e-9,
                            max_iters: int = 4096):
    """Full sharded PageRank solve over base + delta segment.

    The update rule of ``apps.pagerank`` / ``pagerank_sharded``, iterated to
    an L-inf rank change <= ``tol`` — at the incremental service's default
    epsilon both sit within ~1e-8 of the exact fixed point, the streaming
    parity contract.  Returns (rank np.float32 (V,), iters)."""
    v = sg.num_vertices
    deg = _view(sg, mesh).get(sg, "out_deg")
    out_deg = deg.clamp(min=1).to(torch.float32)
    dangling = (deg == 0).to(torch.float32)
    with obs_trace.span("dist.pagerank_stream", cat="dist",
                        backend=sg.backend, shards=sg.n_shards) as sp:
        rank = torch.full((v,), 1.0 / v, dtype=torch.float32,
                          device=mesh.device)
        it, going = 0, True
        while it < max_iters and going:
            contrib = rank / out_deg
            pulled = edge_map_pull_sharded(sg, contrib, mesh)
            dangling_mass = torch.sum(rank * dangling) / v
            new = (1.0 - damping) / v + damping * (pulled + dangling_mass)
            err = torch.max(torch.abs(new - rank))
            rank, it = new, it + 1
            going = bool(err > tol)  # float32 compare, as the reference's
        sp.add(iters=it)
    hook = apps_engine.get_edge_map_hook()
    if hook is not None and hasattr(hook, "record_iters"):
        hook.record_iters("pagerank_sharded", np.asarray([it]))
    return rank.cpu().numpy(), it


def sssp_sharded_stream(sg: ShardedGraphArrays, root: int, mesh: GraphMesh,
                        *, max_iters: int = 0):
    """Sharded pull Bellman-Ford over base + delta segment.

    Relaxes ``dist[v] <- min(dist[v], min over in-edges dist[u] + w)`` to a
    fixed point: per-edge float path sums are evaluated as the
    single-device incremental SSSP evaluates them, and min is exact, so the
    answers agree BITWISE.  Returns (dist np.float32 (V,), iters)."""
    iters = int(max_iters) if max_iters else sg.num_vertices
    v = sg.num_vertices
    with obs_trace.span("dist.sssp_stream", cat="dist", backend=sg.backend,
                        shards=sg.n_shards, root=int(root)) as sp:
        dist = torch.full((v,), float("inf"), dtype=torch.float32,
                          device=mesh.device)
        dist[int(root)] = 0.0
        it, changed = 0, True
        while changed and it < iters:
            relaxed = edge_map_pull_sharded(sg, dist, mesh, reduce="min",
                                            use_weights=True)
            new = torch.minimum(dist, relaxed)
            changed = bool(torch.any(new < dist))
            dist, it = new, it + 1
        sp.add(iters=it)
    hook = apps_engine.get_edge_map_hook()
    if hook is not None and hasattr(hook, "record_iters"):
        hook.record_iters("sssp_sharded", np.asarray([it]))
    return dist.cpu().numpy(), it
