"""Destination-sharded graph engine with DBG-aware hot-vertex replication.

Port of ``repro.dist.graph`` on ``torch.distributed``, one process per shard.
The paper segregates hot degree-groups from cold ones so the hot working set
fits the fast memory level; this module lifts that to the device level:
vertices in the hot degree-groups of ``core.reorder.dbg_spec`` get their
property slices REPLICATED on every shard (policy ``"replicate_hot"``); the
cold tail is OWNER-PARTITIONED and exchanged on demand.

Layout (built on the host by :func:`shard_graph`, the same numpy planes as
the reference's, bit for bit):

* vertices are 1D-partitioned into ``n_shards`` contiguous blocks of
  ``v_blk`` ids (destination ownership);
* pull: each shard owns the in-edges of its destination block (globally
  sorted by dst, so per-shard segments stay sorted);
* push: each shard owns the out-edges of its source block.

SPMD: every rank builds the same layout on the host (deterministic numpy),
and moves only its own shard's planes to its device, lazily, at the first
edge map (``_ShardView``).  The public functions keep the reference's
signatures — a global (V,) ``prop`` in, a global (V,) result out on every
rank — and a rank reads only its own block of ``prop``; everything else
comes through a collective of the mesh's process group:

* the halo: ``all_to_all_single`` of ``local[send_idx[rank]]``;
* the hot panel: an all-gather of each owner's hot entries (copies, so
  ``-0.0`` stays ``-0.0`` and min/max stay bitwise);
* the push partials: ``reduce_scatter_tensor`` for a sum,
  ``all_reduce(MIN/MAX)`` then this rank's slice otherwise;
* the global result: ``all_gather_into_tensor`` of the blocks.

With one shard the collectives are skipped, as the reference skips them.

Two edge-map backends implement the per-shard compute, resolved through the
same ``apps.engine.BACKENDS`` name table as the single-device engine:

* ``"flat"`` — the edge-parallel oracle (gather → mask → segment reduce),
  every reduction a ``torch.segment_reduce`` over edges sorted by
  destination (no float atomics: the push's and the delta segment's
  repeated destinations are sorted at build or sync time);
* ``"ell"`` — each shard's edge segment packed into DBG-ELL tiles
  (``kernels.edge_map.ops.ell_tiles_sharded``) whose lanes index the SAME
  ``[local | hot | halo]`` table, so the per-shard edge map is one K5
  launch per width class; push is the transposed pull over dst-grouped
  tiles.

Shard-aware update routing: :func:`apply_remap` consumes a
``stream.RemapDelta`` and re-homes ONLY the vertices whose degree group
changed, patching their edge slots and tile lanes on the host and on the
device in place; it raises :class:`RemapOverflow` when the reserved
headroom is exhausted (the caller re-shards).  A patched layout shares its
planes and bookkeeping with its input: treat the input as consumed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from ..apps import engine as apps_engine
from ..apps.engine import GraphArrays, _segment
from ..core import reorder
from ..device import resolve_device
from ..kernels.edge_map.edge_map import (edge_map_tile_bytes, ell_edge_map,
                                         reduce_identity)
from ..kernels.edge_map.ops import (_scatter_combine, _tile_of,
                                    ell_tiles_sharded)
from ..obs import trace as obs_trace

__all__ = ["GraphMesh", "make_graph_mesh", "ShardedGraphArrays",
           "ShardDeltaSegment", "shard_graph", "exchange_table",
           "edge_map_pull_sharded",
           "edge_map_push_sharded", "edge_map_bytes_sharded",
           "pagerank_sharded", "apply_remap", "RemapOverflow",
           "HaloOverflow"]

#: backends the sharded engine implements (a subset of apps.engine.BACKENDS)
SHARDED_BACKENDS = ("flat", "ell")


class RemapOverflow(RuntimeError):
    """apply_remap ran out of reserved hot/halo slots — re-shard instead."""


class HaloOverflow(RemapOverflow):
    """Streaming edge-delta routing ran out of reserved halo slots: an
    inserted cold edge crosses a shard pair whose halo segment is full.
    Subclasses :class:`RemapOverflow` so one fallback covers both."""


# ---------------------------------------------------------------------------
# the mesh: a process group, one rank per shard
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphMesh:
    """The port's 1-D ``("graph",)`` mesh: this process's rank in an
    initialised ``torch.distributed`` group and the device its shard lives
    on.  Made by :func:`make_graph_mesh`."""

    group: Any
    rank: int
    size: int
    device: torch.device


def make_graph_mesh(n_shards: Optional[int] = None, *,
                    device=None) -> GraphMesh:
    """The graph mesh over the initialised default process group.
    ``n_shards`` must equal its world size; ``device=None`` is this rank's
    CUDA card (raising without one).  NCCL carries CUDA tensors and gloo
    CPU ones: any other pairing raises, as does a group that is not
    initialised — nothing runs a layout on fewer ranks than it has
    shards."""
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError(
            "make_graph_mesh needs an initialised torch.distributed process "
            "group (init_process_group with this rank and the world size)")
    group = tdist.group.WORLD
    size = tdist.get_world_size(group)
    rank = tdist.get_rank(group)
    if n_shards is not None and int(n_shards) != size:
        raise ValueError(f"n_shards={n_shards} but the process group has "
                         f"{size} ranks: one rank per shard")
    if device is None:
        resolve_device(None)  # the card, raising without one
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    backend = str(tdist.get_backend(group))
    need = "nccl" if dev.type == "cuda" else "gloo"
    if need not in backend:
        raise ValueError(f"a {dev.type} shard needs a {need} process group, "
                         f"not {backend!r}")
    return GraphMesh(group=group, rank=rank, size=size, device=dev)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

class ShardDeltaSegment(NamedTuple):
    """Host planes of the per-shard streaming delta buffers.

    The flat arrays are the edge-parallel delta (one entry per routed edge,
    padded to capacity ``C``; dead and padding entries have ``alive ==
    False``).  ``pull_tiles``/``push_tiles`` are the fused representation
    (``kernels.edge_map.ops.coo_tiles_sharded``) packed from the same
    buffers for the ``"ell"`` backend.  Capacities grow in powers of two.
    """

    # pull side (owner = destination shard): slots into [local|hot|halo]
    slot: np.ndarray     # (D, C) int32
    dstl: np.ndarray     # (D, C) int32 — dst - i*v_blk
    w: np.ndarray        # (D, C) float32 (ones when unweighted)
    alive: np.ndarray    # (D, C) bool
    # push side (owner = source shard)
    p_srcl: np.ndarray   # (D, Cp) int32
    p_dst: np.ndarray    # (D, Cp) int32 — global (padded space)
    p_w: np.ndarray      # (D, Cp) float32
    p_alive: np.ndarray  # (D, Cp) bool
    # fused COO delta tiles (backend "ell" only)
    pull_tiles: Optional[Tuple] = None
    push_tiles: Optional[Tuple] = None

    @property
    def capacity(self) -> Tuple[int, int]:
        return int(self.slot.shape[1]), int(self.p_srcl.shape[1])


@dataclasses.dataclass(frozen=True)
class ShardedGraphArrays:
    """Host-built sharded layout: the leading dim of every (D, …) plane is
    the shard.  Each rank's device copy of its own row lives in ``views``
    (built at its first edge map, patched in place by the update routers)."""

    n_shards: int
    num_vertices: int
    v_blk: int          # vertices per shard block (last block padded)
    halo_max: int       # padded halo slots per (owner, dest) shard pair
    policy: str         # "replicate_hot" | "partition"
    # pull side (destination-sharded in-edges)
    in_slot: np.ndarray       # (D, E_blk) int32 — index into the value table
    in_dst_local: np.ndarray  # (D, E_blk) int32 — dst - d*v_blk, sorted
    in_w: np.ndarray          # (D, E_blk) float32
    in_mask: np.ndarray       # (D, E_blk) bool — real edge vs pad
    send_idx: np.ndarray      # (D, D, halo_max) int32 — owner-local sends
    hot_ids: np.ndarray       # (H_cap,) int32 — replicated ids (padded w/ 0)
    # push side (source-sharded out-edges)
    out_src_local: np.ndarray  # (D, E_out_blk) int32
    out_dst: np.ndarray        # (D, E_out_blk) int32 — global (padded space)
    out_w: np.ndarray          # (D, E_out_blk) float32
    out_mask: np.ndarray       # (D, E_out_blk) bool
    # replicated degree vectors (apps need them)
    in_deg: np.ndarray   # (V,) int32
    out_deg: np.ndarray  # (V,) int32
    backend: str = "flat"
    hot_cap: int = 0          # hot-table slots incl. remap headroom
    hot_group_count: int = 0  # DBG groups counted as hot at build time
    weighted: bool = False
    row_tile: int = 64
    width_tile: int = 128
    pull_tiles: Optional[Tuple] = None  # ShardedTileGroups (slots → table)
    push_tiles: Optional[Tuple] = None  # ShardedTileGroups (dst → local)
    delta: Optional[ShardDeltaSegment] = None
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # mutable host bookkeeping for apply_remap / dist.stream (shared across
    # patched copies; patching moves it forward)
    host: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)
    # (rank, device) -> _ShardView, shared across patched copies
    views: Dict[Tuple[int, str], "_ShardView"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def v_pad(self) -> int:
        return self.n_shards * self.v_blk

    @property
    def table_len(self) -> int:
        """Per-shard gather-table length: [local | hot | halo]."""
        return self.v_blk + self.hot_cap + self.n_shards * self.halo_max


def _hot_mask(out_deg: np.ndarray, policy: str,
              num_hot_groups: int) -> Tuple[np.ndarray, int]:
    """(mask, n_hot_groups): vertices in the DBG hot degree-groups
    (everything at/above avg degree), plus how many of the spec's groups
    that covers."""
    if policy == "partition" or out_deg.size == 0:
        return np.zeros(out_deg.shape[0], dtype=bool), 0
    if policy != "replicate_hot":
        raise ValueError(policy)
    avg = max(1.0, float(out_deg.mean()))
    spec = reorder.dbg_spec(avg, num_hot_groups=num_hot_groups)
    groups = reorder._assign_groups(out_deg, spec.boundaries)
    # count via the boundary values (dbg_spec dedupes colliding boundaries
    # on tiny A, so a fixed "all but the last 2" offset would miscount)
    a_bound = max(1, int(np.ceil(avg)))
    n_hot = sum(1 for b in spec.boundaries if b >= a_bound)
    return groups < n_hot, n_hot


def _pad2d(rows, fill, dtype) -> np.ndarray:
    width = max(1, max((len(r) for r in rows), default=1))
    out = np.full((len(rows), width), fill, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _with_headroom(n: int, frac: float) -> int:
    return n + int(np.ceil(n * frac)) + 8


def _key_index(srcs: np.ndarray, dsts: np.ndarray,
               v_pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted keys, argsort order) over ``src * v_pad + dst`` — the O(log E)
    deletion lookup the streaming path uses to find an edge's storage slot."""
    keys = srcs.astype(np.int64) * np.int64(v_pad) + dsts.astype(np.int64)
    order = np.argsort(keys, kind="stable")
    return keys[order], order


def _new_delta_buf(pull: bool, cap: int = 8) -> dict:
    """Capacity-doubling host master of one shard's delta buffer."""
    buf = {"dst": np.zeros(cap, np.int64), "w": np.zeros(cap, np.float32),
           "alive": np.zeros(cap, bool), "n": 0}
    if pull:
        buf["src"] = np.zeros(cap, np.int64)
        buf["slot"] = np.zeros(cap, np.int64)
    else:
        buf["srcl"] = np.zeros(cap, np.int64)
    return buf


def _host_arrays(ga: GraphArrays):
    """The numpy planes of ``ga`` (on any device): in-edges as (src, dst,
    w), dst-sorted; out-edges as (src, dst, w), src-sorted; both degree
    vectors; and whether the graph is weighted (unweighted graphs share ONE
    weight plane)."""
    def h(t):
        return t.detach().cpu().numpy()

    in_deg = h(ga.in_deg).copy()  # degrees are patched in place later
    in_dst = np.repeat(np.arange(in_deg.shape[0], dtype=np.int64), in_deg)
    return (h(ga.in_src), in_dst, h(ga.in_w), h(ga.out_src), h(ga.out_dst),
            h(ga.out_w), in_deg, h(ga.out_deg).copy(),
            ga.in_w is not ga.out_w)


def shard_graph(ga: GraphArrays, n_shards: int, *,
                policy: str = "replicate_hot",
                num_hot_groups: int = 6,
                backend: str = "flat",
                row_tile: int = 64,
                width_tile: int = 128,
                hot_override: Optional[np.ndarray] = None,
                remap_headroom: float = 0.25,
                track_remap: Optional[bool] = None,
                stream: bool = False) -> ShardedGraphArrays:
    """Partition ``GraphArrays`` (on any device) for ``n_shards`` ranks, on
    the host; needs no mesh.

    ``backend`` selects the per-shard edge-map implementation (resolved
    against ``apps.engine.BACKENDS``; the sharded engine implements
    ``"flat"`` and ``"ell"``).  ``hot_override`` replaces the DBG hot mask
    with an explicit hot-vertex id set (the full re-shard counterpart of
    :func:`apply_remap`).  ``remap_headroom`` reserves slack hot/halo slots
    for later ``apply_remap`` calls.  ``track_remap`` keeps the O(E) host
    bookkeeping those calls patch; default: only under ``replicate_hot``.

    ``stream=True`` builds the STREAMING layout ``repro_torch.dist.stream``
    maintains in O(delta) per batch: per-shard delta buffers, key-sorted
    deletion indexes over the base segments, and — on ``"ell"`` — all-ones
    tombstone planes plus push-side lane positions.  Implies
    ``track_remap``.
    """
    _check_backend(backend)
    if stream and track_remap is False:
        raise ValueError("stream=True requires the remap bookkeeping "
                         "(track_remap must not be False)")
    if stream:
        track_remap = True
    (in_src, in_dst, in_w, out_src, out_dst, out_w, in_deg, out_deg,
     weighted) = _host_arrays(ga)
    v = int(out_deg.shape[0])
    d = int(n_shards)
    v_blk = -(-v // d)

    hot, hgc = _hot_mask(out_deg, policy, num_hot_groups)
    if hot_override is not None:
        if policy != "replicate_hot":
            raise ValueError("hot_override requires policy='replicate_hot'")
        hot = np.zeros(v, dtype=bool)
        hot[np.asarray(hot_override, dtype=np.int64)] = True
    hot_ids = np.nonzero(hot)[0].astype(np.int32)
    n_hot = int(hot_ids.shape[0])
    hot_cap = (_with_headroom(n_hot, remap_headroom)
               if policy == "replicate_hot" else max(1, n_hot))
    hot_pos = np.full(v, -1, np.int64)
    hot_pos[hot_ids] = np.arange(n_hot)

    def owner_of(ids):
        return ids // v_blk

    # ---- pull side: split in-edges by destination owner (dst-sorted) -------
    edge_owner = owner_of(in_dst)
    bounds = np.searchsorted(edge_owner, np.arange(d + 1))

    # halo: per shard, the remote non-hot sources it reads, grouped by owner
    need: list = []  # need[dst_shard][owner] = sorted unique global ids
    for i in range(d):
        srcs = in_src[bounds[i]:bounds[i + 1]]
        remote = srcs[(owner_of(srcs) != i) & (hot_pos[srcs] < 0)]
        uniq = np.unique(remote)
        need.append([uniq[owner_of(uniq) == o] for o in range(d)])
    halo_used = max(1, max((len(ids) for row in need for ids in row),
                           default=1))
    halo_cap = (_with_headroom(halo_used, remap_headroom)
                if policy == "replicate_hot" else halo_used)

    # sender view: send_idx[o, i] = owner-local indices o ships to shard i
    send_idx = np.zeros((d, d, halo_cap), np.int32)
    need_len = np.zeros((d, d), np.int64)
    halo_slots = 0
    for o in range(d):
        for i in range(d):
            ids = need[i][o]
            send_idx[o, i, : len(ids)] = (ids - o * v_blk).astype(np.int32)
            need_len[i, o] = len(ids)
            halo_slots += len(ids)

    # receiver view: edge slots into the [local | hot | halo] value table
    slot_rows, dstl_rows, w_rows = [], [], []
    for i in range(d):
        sl = slice(bounds[i], bounds[i + 1])
        srcs = in_src[sl]
        slots = np.empty(srcs.shape[0], np.int64)
        is_hot = hot_pos[srcs] >= 0
        is_local = (owner_of(srcs) == i) & ~is_hot
        is_remote = ~is_hot & ~is_local
        slots[is_local] = srcs[is_local] - i * v_blk
        slots[is_hot] = v_blk + hot_pos[srcs[is_hot]]
        rem = srcs[is_remote]
        ro = owner_of(rem)
        pos = np.empty(rem.shape[0], np.int64)
        for o in range(d):
            m = ro == o
            pos[m] = np.searchsorted(need[i][o], rem[m])
        slots[is_remote] = v_blk + hot_cap + ro * halo_cap + pos
        slot_rows.append(slots)
        dstl_rows.append(in_dst[sl] - i * v_blk)
        w_rows.append(in_w[sl])

    in_slot = _pad2d(slot_rows, 0, np.int32)
    in_dst_local = _pad2d(dstl_rows, v_blk - 1, np.int32)  # keeps sortedness
    in_w_p = _pad2d(w_rows, 0.0, np.float32)
    e_blk = in_slot.shape[1]
    in_mask = np.zeros((d, e_blk), bool)
    for i in range(d):
        in_mask[i, : bounds[i + 1] - bounds[i]] = True

    # ---- push side: split out-edges by source owner (src-sorted) -----------
    pedge_owner = owner_of(out_src)
    pbounds = np.searchsorted(pedge_owner, np.arange(d + 1))
    srcl_rows, pdst_rows, pw_rows = [], [], []
    for i in range(d):
        sl = slice(pbounds[i], pbounds[i + 1])
        srcl_rows.append(out_src[sl] - i * v_blk)
        pdst_rows.append(out_dst[sl])
        pw_rows.append(out_w[sl])
    out_src_local = _pad2d(srcl_rows, 0, np.int32)
    out_dst_p = _pad2d(pdst_rows, 0, np.int32)
    out_w_p = _pad2d(pw_rows, 0.0, np.float32)
    out_mask = np.zeros(out_src_local.shape, bool)
    for i in range(d):
        out_mask[i, : pbounds[i + 1] - pbounds[i]] = True

    # ---- fused per-shard tiles (backend "ell") ------------------------------
    if track_remap is None:
        track_remap = policy == "replicate_hot"
    pull_tiles = push_tiles = None
    tile_pos = push_pos = None
    table_len = v_blk + hot_cap + d * halo_cap
    if backend == "ell":
        pulled = ell_tiles_sharded(
            [(dstl_rows[i].astype(np.int64), slot_rows[i],
              w_rows[i] if weighted else None) for i in range(d)],
            id_upper=table_len, row_tile=row_tile, width_tile=width_tile,
            with_positions=track_remap, with_alive=stream)
        pull_tiles, tile_pos = pulled if track_remap else (pulled, None)
        pushed = ell_tiles_sharded(
            [(pdst_rows[i].astype(np.int64), srcl_rows[i].astype(np.int64),
              pw_rows[i] if weighted else None) for i in range(d)],
            id_upper=v_blk, row_tile=row_tile, width_tile=width_tile,
            with_positions=stream, with_alive=stream)
        push_tiles, push_pos = pushed if stream else (pushed, None)

    stats = {
        "policy": policy,
        "backend": backend,
        "n_hot": n_hot,
        "hot_frac": n_hot / max(1, v),
        "halo_slots": int(halo_slots),
        "halo_max": int(halo_cap),
        # bytes one pull moves shard-to-shard (f32 halo payload, padded)
        "halo_bytes_padded": int(d * d * halo_cap * 4),
        "edges_per_shard_max": int(e_blk),
    }
    hot_ids_pad = np.zeros(hot_cap, np.int32)
    hot_ids_pad[:n_hot] = hot_ids
    host = None
    if track_remap:
        shard_srcs = [in_src[bounds[i]:bounds[i + 1]] for i in range(d)]
        # src-sorted edge-position index per shard: apply_remap finds a
        # mover's edges in O(log E + deg) instead of scanning the segment
        src_order = []
        for s in shard_srcs:
            order = np.argsort(s, kind="stable")
            src_order.append((s[order], order))
        host = {
            "in_src": [np.asarray(s) for s in shard_srcs],
            "src_order": src_order,
            "slot": [s.copy() for s in slot_rows],
            "need0": need,                   # original sorted halo id lists
            "need_len": need_len,            # used entries per (i, o)
            "halo_entry": {},                # (i, src) -> appended position
            "send_idx": send_idx,            # the layout's own plane
            "hot_ids": hot_ids_pad,          # the layout's own plane
            "hot_pos": hot_pos,
            "hot_free": list(range(n_hot, hot_cap)),
            "tile_pos": tile_pos,
            # the tiles' own idx planes, patched in place
            "tile_idx": (None if pull_tiles is None
                         else [t.idx for t in pull_tiles]),
            "halo_slots": int(halo_slots),
        }
        if stream:
            vp = d * v_blk
            in_dst_rows = [in_dst[bounds[i]:bounds[i + 1]].astype(np.int64)
                           for i in range(d)]
            out_src_rows = [out_src[pbounds[i]:pbounds[i + 1]]
                            .astype(np.int64) for i in range(d)]
            host["stream"] = {
                "weighted": weighted,
                # pull base segments (dst-sorted) + key-sorted (src,dst)
                # deletion index per shard
                "in_dst": in_dst_rows,
                "in_wv": [np.asarray(w, np.float32) for w in w_rows],
                "in_alive": [np.ones(r.shape[0], bool) for r in in_dst_rows],
                "in_key": [_key_index(shard_srcs[i], in_dst_rows[i], vp)
                           for i in range(d)],
                "in_dead": np.zeros(d, np.int64),
                # push base segments (src-partitioned)
                "out_src": out_src_rows,
                "out_dst": [np.asarray(r, np.int64) for r in pdst_rows],
                "out_wv": [np.asarray(w, np.float32) for w in pw_rows],
                "out_alive": [np.ones(r.shape[0], bool)
                              for r in out_src_rows],
                "out_key": [_key_index(out_src_rows[i],
                                       np.asarray(pdst_rows[i], np.int64),
                                       vp) for i in range(d)],
                "out_dead": np.zeros(d, np.int64),
                # per-shard delta buffers (host masters; the delta segment is
                # rebuilt by dist.stream.sync_delta when dirty)
                "d": [_new_delta_buf(True) for _ in range(d)],
                "p": [_new_delta_buf(False) for _ in range(d)],
                "delta_dirty": True,
                "caps": {"c": 8, "cp": 8, "pr": (0, 0), "pp": (0, 0)},
                "push_tile_pos": push_pos,
            }
    return ShardedGraphArrays(
        n_shards=d, num_vertices=v, v_blk=v_blk, halo_max=halo_cap,
        policy=policy,
        in_slot=in_slot, in_dst_local=in_dst_local, in_w=in_w_p,
        in_mask=in_mask, send_idx=send_idx, hot_ids=hot_ids_pad,
        out_src_local=out_src_local, out_dst=out_dst_p, out_w=out_w_p,
        out_mask=out_mask,
        in_deg=in_deg, out_deg=out_deg,
        backend=backend, hot_cap=hot_cap, hot_group_count=hgc,
        weighted=weighted, row_tile=row_tile, width_tile=width_tile,
        pull_tiles=pull_tiles, push_tiles=push_tiles,
        stats=stats, host=host,
    )


def _check_backend(backend: str) -> str:
    """Resolve a backend name through the engine's single registry, then
    narrow to what the sharded engine implements."""
    apps_engine.resolve_backend(backend)  # clear error on unknown names
    if backend not in SHARDED_BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not supported by the sharded engine; "
            f"choose one of {'|'.join(SHARDED_BACKENDS)}")
    return backend


def _resolve_backend(sg: ShardedGraphArrays, backend: Optional[str]) -> str:
    backend = _check_backend(backend or sg.backend)
    if backend == "ell" and sg.pull_tiles is None:
        raise ValueError(
            "sharded ELL backend requires shard_graph(..., backend='ell') "
            "(per-shard tiles were not packed)")
    return backend


# ---------------------------------------------------------------------------
# one rank's device copy of its shard
# ---------------------------------------------------------------------------

def _t(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
    return torch.from_numpy(a).to(device, copy=True)


def _sorted_plan(keys: np.ndarray, n_segments: int):
    """(stable order by ``keys``, offsets of ``n_segments`` sorted
    segments): a scatter over repeated ``keys`` becomes a
    ``segment_reduce`` over the reordered values — deterministic, with no
    float atomics."""
    order = np.argsort(keys, kind="stable")
    return order, np.searchsorted(keys[order], np.arange(n_segments + 1))


def _hot_plan(sg: ShardedGraphArrays, r: int, device):
    """How the hot panel is gathered exactly, as copies: (rank ``r``'s
    owner-local hot indices to send, padded to the largest owner's count;
    each hot slot's index into the all-gathered (D * hot_max,) buffer)."""
    hot = sg.hot_ids.astype(np.int64)
    owner = hot // sg.v_blk
    counts = np.bincount(owner, minlength=sg.n_shards)
    hot_max = max(1, int(counts.max()))
    order = np.argsort(owner, kind="stable")
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.empty(hot.shape[0], np.int64)
    pos[order] = np.arange(hot.shape[0]) - first[owner[order]]
    send = np.zeros((sg.n_shards, hot_max), np.int64)
    send[owner, pos] = hot - owner * sg.v_blk
    return _t(send[r], device), _t(owner * hot_max + pos, device)


class _ShardView:
    """One rank's planes on its device, built from the host layout name by
    name at first use (an ``"ell"`` pull never uploads the flat planes).
    The update routers patch the planes they change in place
    (:func:`_patch_rows`, :func:`_patch_lanes`) or drop them
    (:func:`_invalidate`) so the next use rebuilds them."""

    def __init__(self, rank: int, device: torch.device):
        self.rank, self.device = rank, device
        self.planes: Dict[str, Any] = {}

    def get(self, sg: ShardedGraphArrays, name: str):
        p = self.planes.get(name)
        if p is None:
            p = self.planes[name] = _BUILD[name](sg, self.rank, self.device)
        return p


def _build_delta(sg, r, dev):
    dl = sg.delta
    if dl is None:
        return None
    out = {"pull_tiles": tuple(t.shard(r, dev) for t in dl.pull_tiles or ()),
           "push_tiles": tuple(t.shard(r, dev) for t in dl.push_tiles or ())}
    if sg.backend == "flat":
        # delta destinations repeat base rows and each other: fold them
        # with a sorted segment reduce, not a scatter
        o, ptr = _sorted_plan(dl.dstl[r].astype(np.int64), sg.v_blk)
        out.update(slot=_t(dl.slot[r][o], dev, np.int64),
                   ptr=_t(ptr, dev, np.int64), w=_t(dl.w[r][o], dev),
                   alive=_t(dl.alive[r][o], dev))
        o, ptr = _sorted_plan(dl.p_dst[r].astype(np.int64), sg.v_pad)
        out.update(p_srcl=_t(dl.p_srcl[r][o], dev, np.int64),
                   p_ptr=_t(ptr, dev, np.int64), p_w=_t(dl.p_w[r][o], dev),
                   p_alive=_t(dl.p_alive[r][o], dev))
    return out


_BUILD = {
    "in_slot": lambda sg, r, dev: _t(sg.in_slot[r], dev, np.int64),
    "in_ptr": lambda sg, r, dev: _t(np.searchsorted(
        sg.in_dst_local[r], np.arange(sg.v_blk + 1)), dev, np.int64),
    "in_w": lambda sg, r, dev: _t(sg.in_w[r], dev),
    "in_mask": lambda sg, r, dev: _t(sg.in_mask[r], dev),
    "out_srcl": lambda sg, r, dev: _t(sg.out_src_local[r], dev, np.int64),
    "out_plan": lambda sg, r, dev: tuple(
        _t(a, dev, np.int64) for a in _sorted_plan(
            sg.out_dst[r].astype(np.int64), sg.v_pad)),
    "out_w": lambda sg, r, dev: _t(sg.out_w[r], dev),
    "out_mask": lambda sg, r, dev: _t(sg.out_mask[r], dev),
    "send": lambda sg, r, dev: _t(sg.send_idx[r].reshape(-1), dev, np.int64),
    "hot": _hot_plan,
    "in_deg": lambda sg, r, dev: _t(sg.in_deg, dev),
    "out_deg": lambda sg, r, dev: _t(sg.out_deg, dev),
    "pull_tiles": lambda sg, r, dev: tuple(t.shard(r, dev)
                                           for t in sg.pull_tiles),
    "push_tiles": lambda sg, r, dev: tuple(t.shard(r, dev)
                                           for t in sg.push_tiles),
    "delta": _build_delta,
}


def _view(sg: ShardedGraphArrays, mesh: GraphMesh) -> _ShardView:
    if sg.n_shards != mesh.size:
        raise ValueError(f"a {sg.n_shards}-shard layout on a mesh of "
                         f"{mesh.size} ranks")
    key = (mesh.rank, str(mesh.device))
    v = sg.views.get(key)
    if v is None:
        v = sg.views[key] = _ShardView(mesh.rank, mesh.device)
    return v


def _invalidate(sg: ShardedGraphArrays, *names: str,
                shard: Optional[int] = None) -> None:
    """Drop ``names`` from the views of ``shard`` (every view when None)."""
    for v in sg.views.values():
        if shard is None or v.rank == shard:
            for n in names:
                v.planes.pop(n, None)


def _patch_rows(sg: ShardedGraphArrays, name: str, shard: Optional[int],
                index: np.ndarray, values) -> None:
    """Write ``values`` at ``index`` of plane ``name`` in the views of
    ``shard`` (every view when None) that hold it: an O(delta) device
    patch of the host change the caller made."""
    for v in sg.views.values():
        p = v.planes.get(name)
        if p is not None and (shard is None or v.rank == shard):
            p[torch.as_tensor(index, device=p.device)] = torch.as_tensor(
                values, device=p.device, dtype=p.dtype)


_NP_OF = {torch.uint16: np.uint16, torch.int32: np.int32, torch.int8: np.int8}


def _patch_lanes(sg: ShardedGraphArrays, side: str, c: int, plane: str,
                 shard: int, rr: np.ndarray, cc: np.ndarray, values) -> None:
    """Set lanes ``(rr, cc)`` of class ``c``'s ``plane`` (``idx`` or
    ``alive``) in shard ``shard``'s device tiles, where a view holds them."""
    for v in sg.views.values():
        tiles = v.planes.get(f"{side}_tiles")
        if tiles is not None and v.rank == shard:
            p = getattr(tiles[c], plane)
            vals = np.asarray(values).astype(_NP_OF[p.dtype])
            if p.dtype == torch.uint16:  # no index_put for uint16: its bits
                p, vals = p.view(torch.int16), vals.view(np.int16)
            p[torch.as_tensor(rr, device=p.device),
              torch.as_tensor(cc, device=p.device)] = torch.from_numpy(
                  vals).to(p.device)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def _own_block(sg: ShardedGraphArrays, prop, mesh: GraphMesh) -> torch.Tensor:
    """This rank's (v_blk,) block of the global ``prop``, zero-padded past
    V: the only part of ``prop`` an edge map reads."""
    prop = torch.as_tensor(prop, device=mesh.device)
    lo = mesh.rank * sg.v_blk
    blk = prop[lo: min(lo + sg.v_blk, sg.num_vertices)]
    if blk.shape[0] < sg.v_blk:
        blk = torch.cat([blk, blk.new_zeros(sg.v_blk - blk.shape[0])])
    return blk.contiguous()


def _table(sg: ShardedGraphArrays, view: _ShardView, local: torch.Tensor,
           mesh: GraphMesh) -> torch.Tensor:
    """The gather table ``[local | hot panel | received halo]``."""
    send, take = view.get(sg, "hot")
    mine = local[send]                       # this rank's hot entries
    halo = local[view.get(sg, "send")]       # (D * halo_max,) to ship
    if sg.n_shards > 1:
        gathered = mine.new_empty(sg.n_shards * mine.shape[0])
        tdist.all_gather_into_tensor(gathered, mine, group=mesh.group)
        mine = gathered
        recv = torch.empty_like(halo)
        tdist.all_to_all_single(recv, halo, group=mesh.group)
        halo = recv
    return torch.cat([local, mine[take], halo])


def _gather_blocks(sg: ShardedGraphArrays, block: torch.Tensor,
                   mesh: GraphMesh) -> torch.Tensor:
    if sg.n_shards > 1:
        out = block.new_empty(sg.v_pad)
        tdist.all_gather_into_tensor(out, block.contiguous(),
                                     group=mesh.group)
        block = out
    return block[: sg.num_vertices]


def exchange_table(sg: ShardedGraphArrays, prop,
                   shard: int) -> torch.Tensor:
    """The gather table ``[local | hot | halo]`` of shard ``shard``, built
    from the global ``prop`` on ``prop``'s device: what the halo all-to-all
    and the hot all-gather deliver to that shard's rank.  Checks one
    shard's tiles without a process group."""
    p = torch.as_tensor(prop)
    pad = torch.cat([p, p.new_zeros(sg.v_pad - sg.num_vertices)])
    owners = np.arange(sg.n_shards, dtype=np.int64)[:, None] * sg.v_blk
    ids = np.concatenate([
        np.arange(shard * sg.v_blk, (shard + 1) * sg.v_blk),
        sg.hot_ids.astype(np.int64),
        (owners + sg.send_idx[:, shard, :]).reshape(-1)])
    return pad[torch.from_numpy(ids).to(pad.device)]


def _combine(a: torch.Tensor, b: torch.Tensor, red: str) -> torch.Tensor:
    if red == "sum":
        return a + b
    return torch.minimum(a, b) if red == "min" else torch.maximum(a, b)


def _k5(x, t, red, use_weights, neutral, identity, sg):
    r_pad, w_pad = t.idx.shape
    return ell_edge_map(
        x, t.idx, t.deg, reduce=red,
        w=t.w if (use_weights and t.w is not None) else None,
        unit_weights=use_weights, alive=t.alive, neutral=neutral,
        identity=identity, segments=t.segments,
        row_tile=_tile_of(r_pad, sg.row_tile),
        width_tile=_tile_of(w_pad, sg.width_tile))


def _class_fold(out, tiles, x, red, use_weights, neutral, identity, sg):
    """K5 over each class, folded into ``out`` with the reduction.  The
    sum's scatter is order-free: within one call a row index repeats only
    for padding rows (``rows == 0``, ``deg == 0``, which add an exact 0,
    the sum's identity), since a base class holds each of its shard's rows
    once and a COO delta class its unique destinations once — so two calls
    agree bit for bit on the card too."""
    for t in tiles:
        y = _k5(x, t, red, use_weights, neutral, identity, sg)
        out = _scatter_combine(out, t.rows, y, red)
    return out


def edge_map_pull_sharded(sg: ShardedGraphArrays, prop, mesh: GraphMesh, *,
                          reduce: str = "sum", use_weights: bool = False,
                          neutral: Optional[float] = None,
                          backend: Optional[str] = None) -> torch.Tensor:
    """dst <- REDUCE over in-edges of f(prop[src]), sharded over ``mesh``.

    Matches the single-device ``apps.engine.edge_map_pull`` (min/max
    bitwise; sums to fp association).  ``prop``: the global (V,) vector on
    every rank; returns the global (V,) result on every rank.  The only
    shard-to-shard traffic is the cold-halo all-to-all and the hot panel's
    all-gather, the same on both backends; ``backend=None`` uses the
    layout's own.
    """
    backend = _resolve_backend(sg, backend)
    hook = apps_engine.get_edge_map_hook()
    if hook is not None:
        hook.on_pass(sg, "pull", prop, {"reduce": reduce,
                                        "use_weights": use_weights})
    red = "max" if reduce == "or" else reduce
    if red not in ("sum", "min", "max"):
        raise ValueError(reduce)
    if neutral is None:
        # pad slots and empty rows take the identity of the REWRITTEN
        # reduction ("or" lowers to max), as the flat engine's empty
        # segment max does
        neutral = reduce_identity(red)
    view = _view(sg, mesh)
    with obs_trace.span("dist.edge_map_pull", cat="dist", backend=backend,
                        shards=sg.n_shards, reduce=reduce):
        local = _own_block(sg, prop, mesh)
        table = _table(sg, view, local, mesh)
        delta = view.get(sg, "delta")
        if backend == "flat":
            vals = table[view.get(sg, "in_slot")]
            if use_weights:
                vals = vals + view.get(sg, "in_w")
            vals = torch.where(view.get(sg, "in_mask"), vals, neutral)
            out = _segment(vals, view.get(sg, "in_ptr"), red)
            if delta is not None:
                dv = table[delta["slot"]]
                if use_weights:
                    dv = dv + delta["w"]
                dv = torch.where(delta["alive"], dv, neutral)
                out = _combine(out, _segment(dv, delta["ptr"], red), red)
        else:
            identity = reduce_identity(red)
            out = torch.full((sg.v_blk,), identity, dtype=table.dtype,
                             device=table.device)
            tiles = view.get(sg, "pull_tiles") + (
                () if delta is None else delta["pull_tiles"])
            out = _class_fold(out, tiles, table, red, use_weights, neutral,
                              identity, sg)
        return _gather_blocks(sg, out, mesh)


def edge_map_push_sharded(sg: ShardedGraphArrays, prop, mesh: GraphMesh, *,
                          reduce: str = "sum", use_weights: bool = False,
                          init: Optional[torch.Tensor] = None,
                          backend: Optional[str] = None) -> torch.Tensor:
    """dst <- REDUCE over pushes from sources, sharded over ``mesh``.

    Sources read their owner-local block (no input communication); the
    shard-to-shard reduction of the partial destination vectors is the
    collective (a reduce-scatter for sum, an all-reduce min/max
    otherwise).  On ``"ell"`` the per-shard partial is the transposed pull
    over dst-grouped tiles; on ``"flat"`` a segment reduce over the
    out-edges sorted by destination.
    """
    backend = _resolve_backend(sg, backend)
    hook = apps_engine.get_edge_map_hook()
    if hook is not None:
        hook.on_pass(sg, "push", prop, {"reduce": reduce,
                                        "use_weights": use_weights})
    red = "max" if reduce == "or" else reduce
    if red not in ("sum", "min", "max"):
        raise ValueError(reduce)
    fill = reduce_identity(reduce)  # untouched rows match the 1-device init
    v_blk, d = sg.v_blk, sg.n_shards
    view = _view(sg, mesh)
    with obs_trace.span("dist.edge_map_push", cat="dist", backend=backend,
                        shards=d, reduce=reduce):
        local = _own_block(sg, prop, mesh)
        delta = view.get(sg, "delta")
        partial = torch.full((sg.v_pad,), fill, dtype=local.dtype,
                             device=local.device)
        if backend == "flat":
            vals = local[view.get(sg, "out_srcl")]
            if use_weights:
                vals = vals + view.get(sg, "out_w")
            vals = torch.where(view.get(sg, "out_mask"), vals, fill)
            order, ptr = view.get(sg, "out_plan")
            partial = _combine(partial, _segment(vals[order], ptr, red), red)
            if delta is not None:
                dv = local[delta["p_srcl"]]
                if use_weights:
                    dv = dv + delta["p_w"]
                dv = torch.where(delta["p_alive"], dv, fill)
                partial = _combine(partial, _segment(dv, delta["p_ptr"], red),
                                   red)
        else:
            identity = reduce_identity(red)  # masked lanes never win a max
            tiles = view.get(sg, "push_tiles") + (
                () if delta is None else delta["push_tiles"])
            partial = _class_fold(partial, tiles, local, red, use_weights,
                                  fill, identity, sg)
        if d == 1:
            block = partial
        elif reduce == "sum":
            block = partial.new_empty(v_blk)
            tdist.reduce_scatter_tensor(block, partial, op=tdist.ReduceOp.SUM,
                                        group=mesh.group)
        else:
            tdist.all_reduce(partial, op=(tdist.ReduceOp.MIN
                                          if reduce == "min"
                                          else tdist.ReduceOp.MAX),
                             group=mesh.group)
            block = partial[mesh.rank * v_blk: (mesh.rank + 1) * v_blk]
        out = _gather_blocks(sg, block, mesh)
    if init is not None:
        out = _combine(torch.as_tensor(init, device=out.device), out, red)
    return out.to(local.dtype)


# ---------------------------------------------------------------------------
# per-iteration HBM byte model
# ---------------------------------------------------------------------------

def edge_map_bytes_sharded(sg: ShardedGraphArrays, *, mode: str = "pull",
                           use_weights: bool = False,
                           backend: Optional[str] = None) -> int:
    """Analytic single-pass HBM bytes of one sharded edge map, PER SHARD.

    The reference's model: for the flat path idx read + table gather +
    edge-value materialize, then the segment pass re-reads values + owner
    ids and writes the block; for the fused path the tile planes (padded)
    plus the gather table, one pass.  The exchange's payload is the same on
    both backends and excluded.
    """
    backend = _resolve_backend(sg, backend)
    e = int(sg.in_slot.shape[1] if mode == "pull" else sg.out_dst.shape[1])
    table = sg.table_len if mode == "pull" else sg.v_blk
    out_len = sg.v_blk if mode == "pull" else sg.v_pad
    delta = sg.delta
    if backend == "flat":
        b = e * 4 + e * 4 + e * 4      # slot ids, table gather, vals write
        if use_weights:
            b += e * 4 + 2 * e * 4     # w plane read + vals rmw
        b += e * 1 + 2 * e * 4         # pad mask + vals rmw
        b += e * 4 + e * 4 + out_len * 4  # reduce pass + out write
        b += table * 4                 # gather-table materialize
        if delta is not None:
            c = int(delta.slot.shape[1] if mode == "pull"
                    else delta.p_dst.shape[1])
            # slot/src read + gather + alive byte + dst read + scatter rmw
            b += c * 4 + c * 4 + c * 1 + c * 4 + 2 * c * 4
            if use_weights:
                b += c * 4
        return b
    tiles = sg.pull_tiles if mode == "pull" else sg.push_tiles
    dtiles = ()
    if delta is not None:
        dtiles = (delta.pull_tiles if mode == "pull"
                  else delta.push_tiles) or ()
    total = out_len * 4                # combine write
    for t in tuple(tiles) + tuple(dtiles):
        r_pad, w_pad = int(t.idx.shape[1]), int(t.idx.shape[2])
        total += edge_map_tile_bytes(
            r_pad, w_pad, table,
            weighted=use_weights and t.w is not None,
            frontier=False, alive=t.alive is not None, init=False,
            idx_itemsize=t.idx.dtype.itemsize)
    return total


# ---------------------------------------------------------------------------
# shard-aware update routing (stream.RemapDelta -> patched layout)
# ---------------------------------------------------------------------------

def _halo_slot(sg: ShardedGraphArrays, i: int, src: int,
               exc=RemapOverflow) -> int:
    """Table slot of remote cold ``src`` on shard ``i`` (stable allocation).

    Build-time halo members resolve through the sorted ``need0`` lists;
    later arrivals (remap movers, streamed edge inserts) append into the
    reserved headroom, memoized in ``halo_entry`` so every (shard, src)
    pair gets exactly one slot.  Raises ``exc`` when the halo segment of
    the owning shard pair is full.
    """
    host = sg.host
    v_blk, hot_cap, halo_cap = sg.v_blk, sg.hot_cap, sg.halo_max
    o = src // v_blk
    base = v_blk + hot_cap + o * halo_cap
    lst = host["need0"][i][o]
    p = np.searchsorted(lst, src)
    if p < len(lst) and lst[p] == src:
        return base + int(p)
    key = (i, src)
    p = host["halo_entry"].get(key)
    if p is None:
        p = int(host["need_len"][i, o])
        if p >= halo_cap:
            raise exc(
                f"halo capacity {halo_cap} exhausted for shard pair "
                f"({o}->{i})")
        host["need_len"][i, o] = p + 1
        host["send_idx"][o, i, p] = src - o * v_blk
        host["halo_entry"][key] = p
        host["halo_slots"] += 1
        _invalidate(sg, "send", shard=o)  # o ships one more value to i
    return base + p


def _retarget_delta_slots(sg: ShardedGraphArrays, movers: np.ndarray) -> None:
    """Recompute the pull-delta slots of ``movers``' streamed edges (host
    masters only — the delta segment is rebuilt at the next
    ``dist.stream.sync_delta``), so a regroup remap and the batch's edge
    deltas land in one patch."""
    host = sg.host
    st = host.get("stream")
    if st is None:
        return
    hot_pos = host["hot_pos"]
    v_blk = sg.v_blk
    for i in range(sg.n_shards):
        db = st["d"][i]
        n = db["n"]
        if n == 0:
            continue
        srcs_d = db["src"][:n]
        m = np.isin(srcs_d, movers) & db["alive"][:n]
        if not m.any():
            continue
        src_t = srcs_d[m]
        new_slots = np.empty(src_t.shape[0], np.int64)
        hp = hot_pos[src_t]
        m_hot = hp >= 0
        new_slots[m_hot] = v_blk + hp[m_hot]
        m_local = ~m_hot & (src_t // v_blk == i)
        new_slots[m_local] = src_t[m_local] - i * v_blk
        m_halo = ~m_hot & ~m_local
        if m_halo.any():
            u, inv = np.unique(src_t[m_halo], return_inverse=True)
            u_slots = np.array([_halo_slot(sg, i, int(s)) for s in u],
                               np.int64)
            new_slots[m_halo] = u_slots[inv]
        db["slot"][: n][m] = new_slots
        st["delta_dirty"] = True


def apply_remap(sg: ShardedGraphArrays, delta) -> ShardedGraphArrays:
    """Re-home ONLY the vertices whose degree group changed.

    ``delta`` is a ``stream.RemapDelta`` (anything with ``moved`` /
    ``new_group``; merge several with ``RemapDelta.merge`` first).  A vertex
    whose new group is hot (``new_group < sg.hot_group_count``) moves into
    the replicated hot table; one that left the hot groups moves back to
    owner-local / halo slots.  Only the edge slots (and, on ``"ell"``, the
    tile lanes) referencing the movers are patched, on the host and in the
    device views, in place.  Raises :class:`RemapOverflow` when the
    reserved hot/halo headroom is exhausted; the caller then falls back to
    a full :func:`shard_graph`.

    The returned layout SHARES its planes and bookkeeping with ``sg``;
    treat the input as consumed.
    """
    if sg.policy != "replicate_hot":
        return sg  # grouping does not affect a pure partition layout
    host = sg.host
    if host is None:
        raise ValueError("layout carries no remap bookkeeping "
                         "(shard_graph(..., track_remap=True))")
    if getattr(delta, "spec_rebuilt", False):
        # group ids under a NEW boundary spec are not comparable to the
        # layout's build-time hot_group_count: force the full re-shard
        raise RemapOverflow(
            "grouping spec was rebuilt (boundary drift) — group ids are not "
            "comparable to this layout's hot_group_count; re-shard with "
            "hot_override=<live hot set>")
    moved = np.asarray(delta.moved, dtype=np.int64).ravel()
    new_group = np.asarray(delta.new_group, dtype=np.int64).ravel()
    if moved.size == 0:
        return sg
    hot_pos = host["hot_pos"]
    wants_hot = new_group < sg.hot_group_count
    newly_hot = moved[wants_hot & (hot_pos[moved] < 0)]
    newly_cold = moved[~wants_hot & (hot_pos[moved] >= 0)]
    if newly_hot.size == 0 and newly_cold.size == 0:
        return sg

    d, v_blk, v = sg.n_shards, sg.v_blk, sg.num_vertices
    hot_cap = sg.hot_cap
    free = host["hot_free"]
    if newly_hot.size > len(free):
        raise RemapOverflow(
            f"{newly_hot.size} vertices turned hot but only {len(free)} "
            f"reserved hot slots remain (cap {hot_cap})")

    # allocate hot slots; release the cold movers' slots afterwards so one
    # delta cannot hand a slot to two owners mid-patch
    hot_slot_of = np.full(v, -1, np.int64)
    for vid in newly_hot.tolist():
        p = free.pop()
        hot_slot_of[vid] = p
        hot_pos[vid] = p
        host["hot_ids"][p] = vid

    movers = np.concatenate([newly_hot, newly_cold])
    for i in range(d):
        srcs = host["in_src"][i]
        srcs_sorted, order = host["src_order"][i]
        lo = np.searchsorted(srcs_sorted, movers, "left")
        hi = np.searchsorted(srcs_sorted, movers, "right")
        if not np.any(hi > lo):
            continue
        touched = np.concatenate(
            [order[a:b] for a, b in zip(lo, hi) if b > a])
        if touched.size == 0:
            continue
        # vectorized retarget: only NEW halo entries (one per unique
        # (shard, src) pair) allocate sequentially
        slots = host["slot"][i]
        src_t = srcs[touched]
        new_slots = np.empty(touched.shape[0], np.int64)
        m_hot = hot_slot_of[src_t] >= 0
        new_slots[m_hot] = v_blk + hot_slot_of[src_t[m_hot]]
        m_local = ~m_hot & (src_t // v_blk == i)
        new_slots[m_local] = src_t[m_local] - i * v_blk
        m_halo = ~m_hot & ~m_local
        if m_halo.any():
            u, inv = np.unique(src_t[m_halo], return_inverse=True)
            u_slots = np.array([_halo_slot(sg, i, int(s)) for s in u],
                               np.int64)
            new_slots[m_halo] = u_slots[inv]
        slots[touched] = new_slots
        sg.in_slot[i, touched] = new_slots
        _patch_rows(sg, "in_slot", i, touched, new_slots)
        if host["tile_pos"] is not None:
            pos = host["tile_pos"][i][touched]
            for c in np.unique(pos[:, 0]):
                m = pos[:, 0] == c
                host["tile_idx"][c][i, pos[m, 1], pos[m, 2]] = new_slots[m]
                _patch_lanes(sg, "pull", int(c), "idx", i, pos[m, 1],
                             pos[m, 2], new_slots[m])

    # release the hot slots the cold movers held (ids stay in the table —
    # nothing references them, and the gather just reads a stale value)
    for vid in newly_cold.tolist():
        free.append(int(hot_pos[vid]))
        hot_pos[vid] = -1
    _invalidate(sg, "hot")

    # streamed (not-yet-compacted) edges of the movers re-home too, so the
    # regroup remap and the edge deltas land in ONE patch
    _retarget_delta_slots(sg, movers)

    stats = dict(sg.stats)
    stats["halo_slots"] = int(host["halo_slots"])
    stats["n_hot"] = int(np.sum(hot_pos >= 0))
    stats["hot_frac"] = stats["n_hot"] / max(1, v)
    return dataclasses.replace(sg, stats=stats)


# ---------------------------------------------------------------------------
# sharded PageRank
# ---------------------------------------------------------------------------

def pagerank_sharded(sg: ShardedGraphArrays, mesh: GraphMesh, *,
                     damping: float = 0.85, max_iters: int = 64,
                     tol: float = 1e-7):
    """Sharded PageRank matching ``apps.pagerank.pagerank``, on whichever
    backend ``sg`` was built with.  The reference's loop over the global
    vector: every rank computes the same ``err`` from the same gathered
    pull and stops at the same iteration, with no collective to decide
    when.  Returns (ranks (V,) on the mesh's device, iterations)."""
    v = sg.num_vertices
    view = _view(sg, mesh)
    deg = view.get(sg, "out_deg")
    out_deg = deg.clamp(min=1).to(torch.float32)
    dangling = (deg == 0).to(torch.float32)
    with obs_trace.span("dist.pagerank", cat="dist", backend=sg.backend,
                        shards=sg.n_shards) as sp:
        rank = torch.full((v,), 1.0 / v, dtype=torch.float32,
                          device=mesh.device)
        it, going = 0, True
        while it < max_iters and going:
            contrib = rank / out_deg
            pulled = edge_map_pull_sharded(sg, contrib, mesh)
            dangling_mass = torch.sum(rank * dangling) / v
            new = (1.0 - damping) / v + damping * (pulled + dangling_mass)
            err = torch.sum(torch.abs(new - rank))
            rank, it = new, it + 1
            going = bool(err > tol)  # float32 compare, as the reference's
        sp.add(iters=it)
    hook = apps_engine.get_edge_map_hook()
    if hook is not None and hasattr(hook, "record_iters"):
        hook.record_iters("pagerank_sharded", np.asarray([it]))
    return rank, it
