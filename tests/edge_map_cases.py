"""Shared cases of the grouped fused edge map's tests
(``test_torch_edge_map_table`` on the CPU, ``test_torch_cuda`` on the
card): tile sets with a class wider than 1,024 lanes or a single narrow
class, uint16 or int32 ids, with or without weight and alive planes, a
``coo_tiles`` extra set; the map's variants; and the oracle, a map of each
class alone (``ell_edge_map``) combined by ``index_copy_`` (push: each
class seeded by its own rows of ``init``) and the extras by
``scatter_reduce``.  Imports only torch and the port.  Not a test module
(pytest collects ``test_*.py`` only)."""
import collections
import functools
import itertools

import numpy as np
import torch

from repro_torch.graph import csr
from repro_torch.kernels._wrap import lanes_per_row
from repro_torch.kernels.edge_map import (coo_tiles, ell_edge_map, ell_tiles,
                                          refresh_alive)

NEUTRAL = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
IDENTITY = NEUTRAL

#: Degree bins of the tiles (descending lower bounds): each hub of
#: ``edges`` lands in a class of its own, 3,000 lanes wide, 640 and 384
#: (narrow, batched) and 40, then the uniform rows' classes.
BOUNDARIES = (2048, 512, 200, 30, 8, 1, 0)

#: (mode, reduce, tile set, id width) of the parametrised tests
CASES = list(itertools.product(("pull", "push"), ("sum", "min", "max"),
                               ("hub", "single", "extra"),
                               ("uint16", "int32")))

#: (weights, frontier, alive, K) each case runs
VARIANTS = [(wt, fr, al, k) for wt, fr, al, k in itertools.product(
    ("none", "unit", "plane"), ("none", "shared", "planar"), (False, True),
    (1, 8)) if not (fr == "planar" and k == 1)]

#: The CPU's share of ``VARIANTS``: every third, which holds every value of
#: each axis (on the CPU ``fused_edge_map`` is the per-class plain version
#: the oracle also runs, so the card's test is the one that needs them all)
CPU_VARIANTS = VARIANTS[::3]


def case_id(case):
    return "-".join(case)


@functools.lru_cache(maxsize=None)
def edges(kind: str, ids: str):
    """``(src, dst, w, v)``: ``v`` is 5,000 (uint16 ids) or 70,000 (int32).
    ``hub``: uniform edges (four a vertex, one at 70,000) plus 3,000 into
    vertex 17 (a class wider than 1,024 lanes), 600 into vertex 23, 300
    into 31 (narrow classes that batch their loads) and 40 into each of
    41–48; ``single``: every vertex has two in-edges (one narrow class)."""
    v = 5000 if ids == "uint16" else 70_000
    rng = np.random.default_rng(7 if ids == "uint16" else 8)
    if kind == "single":
        dst = np.repeat(np.arange(v), 2)
        src = rng.integers(0, v, dst.shape[0])
    else:
        n = 4 * v if ids == "uint16" else v
        hubs = np.concatenate([np.full(3000, 17), np.full(600, 23),
                               np.full(300, 31), np.repeat(np.arange(41, 49),
                                                           40)])
        src = rng.integers(0, v, n + hubs.shape[0])
        dst = np.concatenate([rng.integers(0, v, n), hubs])
    w = rng.uniform(1, 16, src.shape[0]).astype(np.float32)
    return src, dst, w, v


def tile_sets(kind: str, ids: str, device):
    """``{(weighted, alive): (tiles, extra)}`` on ``device``: the
    in-direction tiles of ``edges(kind, ids)`` with and without weights,
    and with an alive plane (80% alive); ``extra`` is a ``coo_tiles`` set
    (one row wider than 1,024 lanes) for ``kind == "extra"``, else ()."""
    src, dst, w, v = edges("hub" if kind == "extra" else kind, ids)
    out = {}
    for weighted in (False, True):
        g = csr.from_edges(src, dst, v, weights=w if weighted else None)
        tiles = ell_tiles(g.in_csr, BOUNDARIES, device=device)
        keep = (np.random.default_rng(3).random(g.in_csr.indices.shape[0])
                < 0.8)
        extra = ()
        if kind == "extra":
            rng = np.random.default_rng(4)
            e_src = rng.integers(0, v, 2000)
            e_dst = np.concatenate([np.full(1500, 29),
                                    rng.integers(0, v, 500)])
            extra = coo_tiles(e_src, e_dst,
                              w=(rng.uniform(1, 16, 2000).astype(np.float32)
                                 if weighted else None),
                              device=device)
        out[weighted, False] = (tiles, extra)
        out[weighted, True] = (refresh_alive(g.in_csr, tiles, keep), extra)
    return out, v


#: The narrow kernel's batch threshold (``csrc/edge_map.cu``'s
#: ``K5_BATCH_ABOVE``) and the classes one grouped launch takes at most
#: (its ``kMaxClasses``), as the launch counts below expect them.
BATCH_ABOVE, LAUNCH_CLASSES = 4, 8


def launches(tiles, extra=()) -> int:
    """K5's launches of one ``fused_edge_map`` on the card, from the tiles
    alone: two for each class wider than 1,024 lanes; one for every eight
    narrow classes of one kind (id width, weight and alive planes,
    batching); and each extra class its own (two when wide)."""
    kinds = collections.Counter()
    n = 0
    for t in tiles:
        width = t.idx.shape[1]
        group = lanes_per_row(width)
        if not t.num_rows:
            continue
        if group == 256:
            n += 2
        else:
            kinds[t.idx.element_size(), t.w is not None, t.alive is not None,
                  width > BATCH_ABOVE * group] += 1
    n += sum(-(-c // LAUNCH_CLASSES) for c in kinds.values())
    return n + sum(2 if lanes_per_row(t.idx.shape[1]) == 256 else 1
                   for t in extra)


def empty_base(v: int, device):
    """The in-direction tiles of a graph of ``v`` vertices and no edges: a
    tile set with no class (a stream whose base starts empty)."""
    none = np.zeros(0, np.int64)
    return ell_tiles(csr.from_edges(none, none, v).in_csr, BOUNDARIES,
                     device=device)


def inputs(v: int, k: int, frontier: str, device, seed: int):
    """``(x, frontier, init)`` for a map over ``v`` vertices and ``k``
    lanes."""
    gen = torch.Generator().manual_seed(seed)
    shape = (v,) if k == 1 else (v, k)
    x = torch.rand(shape, generator=gen) * 8
    init = torch.rand(shape, generator=gen) * 30
    fr = None
    if frontier != "none":
        fr = torch.rand((v,) if frontier == "shared" else shape,
                        generator=gen) < 0.6
    return (x.to(device), None if fr is None else fr.to(device),
            init.to(device))


def map_kw(reduce: str, weights: str):
    return dict(reduce=reduce, use_weights=weights != "none",
                neutral=NEUTRAL[reduce])


def oracle(tiles, x, v, *, reduce, use_weights, neutral, src_frontier=None,
           init=None, extra_tiles=()):
    """The per-class map: each class alone through ``ell_edge_map``, its
    rows copied into vertex space (push: seeded by its own rows of
    ``init``), then the extras folded in by ``scatter_reduce``."""
    identity = IDENTITY[reduce]
    lanes = tuple(x.shape[1:])
    fr = None if src_frontier is None else src_frontier.to(torch.int8)
    out = (torch.full((v,) + lanes, identity, device=x.device)
           if init is None else init.clone())

    def one(t, init_rows=None):
        r, width = t.idx.shape
        return ell_edge_map(
            x, t.idx, t.deg, reduce=reduce,
            w=t.w if use_weights else None, unit_weights=use_weights,
            frontier=fr, alive=t.alive, init_rows=init_rows, neutral=neutral,
            identity=identity, segments=t.segments, row_tile=r,
            width_tile=width)

    for t in tiles:
        init_rows = None
        if init is not None:
            init_rows = torch.full((t.idx.shape[0],) + lanes, identity,
                                   device=x.device)
            init_rows[: t.num_rows] = out.index_select(0, t.rows)
        out.index_copy_(0, t.rows, one(t, init_rows)[: t.num_rows])
    red = {"sum": "sum", "min": "amin", "max": "amax"}[reduce]
    for t in extra_tiles:
        y = one(t)[: t.num_rows]
        index = t.rows.view((-1,) + (1,) * len(lanes)).expand_as(y)
        out = out.scatter_reduce(0, index, y, reduce=red, include_self=True)
    return out
