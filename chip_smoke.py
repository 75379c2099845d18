#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and the CUDA
toolkit (``nvcc``): the kernels are built from ``src/repro_torch`` at first
use.  It imports nothing of JAX and nothing of the JAX package ``repro``.

Phases (any failure raises, and the script exits non-zero):
  1. device: the card's name and power limit from ``nvidia-smi``;
  2. build: compile (or load) the libraries of all four kernels — K5, K4,
     K1 and hist_bin — with every ``nvcc`` started together;
  3. K5 vs its plain version on the card, over every static variant, on all
     rows of every tile class of the ``kr`` registry graph at ``small`` scale
     (uint16 ids) and of the main-path graph (int32 ids): min/max bitwise,
     sums within 2e-6 · (1 + max|y|);
  4. the main path: a ``kr``-signature RMAT graph (a=.57, b=.19, c=.19,
     average degree 20) at 2^21 vertices, reordered with DBG on out-degree,
     then PageRank (original and DBG orderings), PageRank-delta, SSSP, BC and
     Radii on ``backend="ell"``, each held to the ``flat`` oracle on the same
     card; K5's launch count must grow in every app;
  5. times at the main path's PageRank pull: K5, its plain version, one
     library call (cuSPARSE SpMV through ``torch.sparse``) and the bound;
  6. the packed path on the same graphs: ``backend="packed"`` (hot slot
     tables + decoded cold tiles) for the five apps against ``flat``,
     ``pack_spmv`` (K4) and ``dbg_spmv`` (K1) against the flat pull and the
     CSR oracle, and ``dbg_bin`` (hist_bin) against the host DBG mapping,
     bitwise; every kernel's launch count, read from zero, must be positive;
  7. K4, K1 and hist_bin vs their plain versions on the card at the packed
     path's shapes: K4 on every hot table of the main-path graph (uint32
     ids), of ``kr``/small (uint16) and of a 256-vertex graph (uint8), each
     unweighted and weighted; K1 on every DBG group; hist_bin on the
     out-degrees, also with bounds that do not end in 0;
  8. times of K4, K1 and hist_bin at their packed-path calls, beside their
     plain versions, one library call each and their bounds.

It prints the ``kernels`` JSON line (a kernel's time is ``ms``, its worst
error against the plain version ``max_abs_err``, the TPU kernel it replaces
``replaces``, its launches on each path ``launches_by_path``) and, as its
last line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
LOG2_VERTICES = 21         # main-path graph: 2,097,152 vertices
REPS = 20                  # timed calls per measurement (median)
PLAIN_CHUNK_LANES = 1 << 24  # rows per plain-version call, in lanes


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync():
    import torch

    torch.cuda.synchronize()


def _ell_launches():
    from repro_torch.kernels.edge_map import ell_edge_map

    return ell_edge_map.launches


def _wrappers():
    """Kernel name → (wrapper, source, TPU kernel it replaces)."""
    from repro_torch.kernels.csr_spmv import ell_spmv
    from repro_torch.kernels.edge_map import ell_edge_map
    from repro_torch.kernels.hist_bin import hist_bin
    from repro_torch.kernels.pack_spmv import hot_spmv

    k = "src/repro_torch/kernels"
    return {
        "ell_edge_map": (ell_edge_map, f"{k}/edge_map/csrc/edge_map.cu",
                         "src/repro/kernels/edge_map/edge_map.py:159"),
        "hot_spmv": (hot_spmv, f"{k}/pack_spmv/csrc/pack_spmv.cu",
                     "src/repro/kernels/pack_spmv/pack_spmv.py:58"),
        "ell_spmv": (ell_spmv, f"{k}/csr_spmv/csrc/csr_spmv.cu",
                     "src/repro/kernels/csr_spmv/csr_spmv.py:47"),
        "hist_bin": (hist_bin, f"{k}/hist_bin/csrc/hist_bin.cu",
                     "src/repro/kernels/hist_bin/hist_bin.py:49"),
    }


def _reset_launches():
    for fn, _, _ in _wrappers().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, (fn, _, _) in _wrappers().items()}


def _chunked(fn, rows, width, *planes):
    """``fn(*row_chunks)`` over row chunks of at most ``PLAIN_CHUNK_LANES``
    lanes, concatenated: a plain version's (R, W) intermediates stay small
    on the hub tables."""
    import torch

    step = max(1, PLAIN_CHUNK_LANES // max(1, width))
    return torch.cat([fn(*(None if p is None else p[a:a + step]
                           for p in planes))
                      for a in range(0, rows, step)])


# ---------------------------------------------------------------- phase 3
def _assert_close(got, want, reduce, what):
    import torch

    if reduce in ("min", "max"):
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{what}: {bad} lanes differ (must be bitwise)")
        return 0.0
    fin = torch.isfinite(want)
    scale = 1.0 + float(want[fin].abs().max()) if bool(fin.any()) else 1.0
    err = float((got - want).abs().max())
    if not err <= 2e-6 * scale:
        raise AssertionError(f"{what}: max err {err} > {2e-6 * scale}")
    return err


def _plain(x, idx, deg, w=None, alive=None, init_rows=None, **kw):
    """K5's plain version over row chunks (``_chunked``): its (R, W, K)
    intermediates stay small on the hub class."""
    from repro_torch.kernels.edge_map import ell_edge_map_ref

    return _chunked(lambda i, d, ww, a, ir: ell_edge_map_ref(
        x, i, d, w=ww, alive=a, init_rows=ir, **kw),
        idx.shape[0], idx.shape[1], idx, deg, w, alive, init_rows)


def variant_grid(tiles, num_vertices, device, seed):
    """K5 against its plain version over every static variant, on all rows of
    every tile class; returns (variants checked, max |err| of the sums)."""
    import itertools

    import torch

    from repro_torch.kernels.edge_map import ell_edge_map

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    v = num_vertices
    planes = []
    for t in tiles:
        idx, deg = t.idx, t.deg
        r, w = idx.shape
        planes.append(dict(idx=idx, deg=deg, w=rand(r, w),
                           alive=(rand(r, w) < 0.8).to(torch.int8),
                           init1=rand(r), init8=rand(r, 8)))
    xs = {1: rand(v), 8: rand(v, 8)}
    frs = {"shared": (rand(v) < 0.5).to(torch.int8),
           "planar": (rand(v, 8) < 0.5).to(torch.int8)}
    n, max_err = 0, 0.0
    for reduce, weight, frontier, alive, init, k in itertools.product(
            ("sum", "min", "max"), ("none", "unit", "plane"),
            ("none", "shared", "planar"), (False, True), (False, True), (1, 8)):
        if frontier == "planar" and k == 1:
            continue
        neutral = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[reduce]
        for p in planes:
            r, w = p["idx"].shape
            kw = dict(reduce=reduce, w=p["w"] if weight == "plane" else None,
                      unit_weights=weight == "unit",
                      frontier=None if frontier == "none" else frs[frontier],
                      alive=p["alive"] if alive else None,
                      init_rows=p[f"init{k}"] if init else None,
                      neutral=neutral, row_tile=r, width_tile=w)
            got = ell_edge_map(xs[k], p["idx"], p["deg"], **kw)
            want = _plain(xs[k], p["idx"], p["deg"],
                          **{a: b for a, b in kw.items()
                             if a not in ("row_tile", "width_tile")})
            max_err = max(max_err, _assert_close(
                got, want, reduce,
                f"{reduce}/{weight}/{frontier}/alive={alive}/init={init}/K={k}"
                f" on a ({r}, {w}) {p['idx'].dtype} tile"))
        n += 1
    # Radii's plane: {0,1} lanes through float32 with int8's finite identity
    reach = (rand(v, 8) < 0.3).to(torch.float32)
    for p in planes:
        r, w = p["idx"].shape
        kw = dict(reduce="max", identity=-128.0)
        got = ell_edge_map(reach, p["idx"], p["deg"], row_tile=r, width_tile=w,
                           **kw)
        _assert_close(got, _plain(reach, p["idx"], p["deg"], **kw),
                      "max", "radii identity")
    _sync()
    return n + 1, max_err


# ---------------------------------------------------------------- phase 4
def build_graphs(log2_vertices=LOG2_VERTICES, seed=0):
    """The kr-signature RMAT graph at 2^log2 vertices (host, numpy), its DBG
    reordering on out-degree, a weighted copy of that for SSSP, and the
    host reorder's result (its mapping is what ``dbg_bin`` must give)."""
    from repro_torch.core.reorder import reorder_graph
    from repro_torch.graph import datasets, generators

    spec = datasets.REGISTRY["kr"]
    v = 1 << log2_vertices
    t0 = time.perf_counter()
    g = generators.rmat(v, int(v * spec.avg_degree), seed=seed, name="kr",
                        **spec.extra)
    t1 = time.perf_counter()
    g_dbg, res = reorder_graph(g, "dbg", degree_source="out")
    t2 = time.perf_counter()
    gw_dbg = generators.with_weights(g_dbg, seed=seed + 1)
    t3 = time.perf_counter()
    log(f"graph: kr-signature RMAT V={g.num_vertices} E={g.num_edges} "
        f"(generate {t1 - t0:.1f} s; DBG reorder {res.seconds:.2f} s "
        f"(mapping + CSR rebuild), {res.num_groups} groups; weighted copy "
        f"{t3 - t2:.1f} s)")
    return g, g_dbg, gw_dbg, res


def main_path(g, g_dbg, gw_dbg, device):
    """Run the five apps on ``ell`` and on ``flat``; return per-app records."""
    import torch

    from repro_torch import apps

    t0 = time.perf_counter()
    backends = {}
    for key, graph in (("orig", g), ("dbg", g_dbg), ("dbg_w", gw_dbg)):
        backends[key] = (apps.to_arrays(graph, backend="flat", device=device),
                         apps.to_arrays(graph, backend="ell", device=device))
    _sync()
    log(f"backends built in {time.perf_counter() - t0:.1f} s "
        f"(ell classes: {[len(b[1].in_tiles) for b in backends.values()]})")

    sources = apps.radii_sources(g_dbg.num_vertices, 8,
                                 generator=torch.Generator().manual_seed(0))
    runs = {
        "pagerank[original]": ("orig", lambda ga: apps.pagerank(ga)),
        "pagerank[dbg]": ("dbg", lambda ga: apps.pagerank(ga)),
        # The default absolute epsilon (1e-7) is above the first-round delta
        # (0.15 / V) once V > 1.5M, so nothing would be active; a threshold
        # of 1% of the uniform rank (Ligra's relative epsilon2) keeps the
        # push frontier meaningful at this size.
        "pagerank_delta": ("dbg", lambda ga: apps.pagerank_delta(
            ga, epsilon=0.01 / ga.num_vertices)),
        "sssp": ("dbg_w", lambda ga: apps.sssp(ga, 0)),
        "bc": ("dbg", lambda ga: apps.bc(ga, 0)),
        "radii": ("dbg", lambda ga: apps.radii(ga, sources)),
    }
    records = {}
    for name, (key, fn) in runs.items():
        flat, ell = backends[key]
        per = {}
        for bname, ga in (("ell", ell), ("flat", flat)):
            n0 = _ell_launches()
            _sync()
            t = time.perf_counter()
            out = fn(ga)
            _sync()
            per[bname] = (out, time.perf_counter() - t, _ell_launches() - n0)
        (eo, es, el), (fo, fs, fl) = per["ell"], per["flat"]
        if el == 0:
            raise AssertionError(f"{name}: K5 was never launched on ell")
        if fl != 0:
            raise AssertionError(f"{name}: flat launched K5")
        iters = _compare_app(name, eo, fo)
        records[name] = dict(ell_s=es, flat_s=fs, launches=el, iters=iters)
        log(f"app {name}: ell {es:.3f} s, flat {fs:.3f} s, "
            f"iterations {iters}, K5 launches {el}")
    return backends, records


def _compare_app(name, eo, fo):
    import torch

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differ (must be bitwise)")

    def close(a, b, what, rtol, atol):
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            err = float((a - b).abs().max())
            raise AssertionError(f"{name}: {what} max err {err}")

    if name.startswith("pagerank"):
        (r1, i1), (r2, i2) = eo, fo
        if not (torch.isfinite(r1).all() and r1.shape == r2.shape):
            raise AssertionError(f"{name}: ranks not finite")
        # Ranks in units of the uniform rank 1/V: the reference's atol 1e-7
        # at a 2,000-vertex graph is 2e-4 of that unit, and rtol 1e-4 covers
        # the summation-order noise of hub rows with ~10^5 in-edges.  A lane
        # missing from a row of average degree moves its rank by ~4%.
        v = r1.numel()
        a, b = r1.double() * v, r2.double() * v
        used = float(((a - b).abs() / (2e-4 + 1e-4 * b.abs())).max())
        log(f"  {name}: worst rank gap {used:.3g} of the band")
        if not used <= 1.0:
            raise AssertionError(f"{name}: ranks differ by {used:.3g}x the "
                                 "band (rtol 1e-4, atol 2e-4 / V)")
        if abs(i1 - i2) > 1:
            raise AssertionError(f"{name}: iterations {i1} vs {i2}")
        return (i1, i2)
    if name == "sssp":
        (d1, i1), (d2, i2) = eo, fo
        same(d1, d2, "distances")
        if i1 != i2:
            raise AssertionError(f"{name}: iterations {i1} vs {i2}")
        if not bool(torch.isfinite(d1).any()):
            raise AssertionError(f"{name}: nothing reached")
        return i1
    if name == "bc":
        (c1, dist1, l1), (c2, dist2, l2) = eo, fo
        if l1 != l2:
            raise AssertionError(f"{name}: levels {l1} vs {l2}")
        same(dist1, dist2, "BFS levels")
        if not bool(torch.isfinite(c1).all()):
            raise AssertionError(f"{name}: centrality not finite")
        close(c1, c2, "centrality", 1e-5, 1e-5)
        return l1
    (ra1, i1), (ra2, i2) = eo, fo
    same(ra1, ra2, "radii")
    if i1 != i2:
        raise AssertionError(f"{name}: iterations {i1} vs {i2}")
    return i1


# ---------------------------------------------------------------- phase 5
def _events_ms(fn, reps):
    """Median over ``reps`` calls of the device time of ``fn()``."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_pull(flat, ell, reps):
    """K5, its plain version and cuSPARSE at the PageRank pull of the main
    path (DBG ordering): one full edge map each."""
    import torch

    from repro_torch.kernels.edge_map import (ell_edge_map, ell_edge_map_ref,
                                              fused_edge_map,
                                              fused_edge_map_bytes)

    v = ell.num_vertices
    x = (torch.rand(v, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda") / ell.out_deg.clamp(min=1))
    tiles = ell.in_tiles

    def kernels():
        return [ell_edge_map(x, t.idx, t.deg, row_tile=t.idx.shape[0],
                             width_tile=t.idx.shape[1]) for t in tiles]

    def plain():
        return [ell_edge_map_ref(x, t.idx, t.deg) for t in tiles]

    n0 = _ell_launches()
    got = fused_edge_map(tiles, x, v, reduce="sum")
    launches_per_call = _ell_launches() - n0
    want = flat.pull(x, reduce="sum")
    err = _assert_close(got, want, "sum", "timed pull vs flat")
    for a, b in zip(kernels(), plain()):
        err = max(err, _assert_close(a, b, "sum", "timed pull vs plain"))

    ms = _events_ms(kernels, reps)
    fused_ms = _events_ms(lambda: fused_edge_map(tiles, x, v, reduce="sum"),
                          reps)
    plain_ms = _events_ms(plain, reps)
    per_class = [
        (tuple(t.idx.shape), str(t.idx.dtype).replace("torch.", ""),
         int(t.deg.sum()),
         _events_ms(lambda t=t: ell_edge_map(
             x, t.idx, t.deg, row_tile=t.idx.shape[0],
             width_tile=t.idx.shape[1]), reps))
        for t in tiles]
    ga = ell.ga
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(ga.in_ptr, ga.in_src,
                                      torch.ones_like(ga.in_w), size=(v, v),
                                      check_invariants=False)
    lib = (csr @ x[:, None])[:, 0]
    err_lib = float((lib - want).abs().max())
    library_ms = _events_ms(lambda: csr @ x[:, None], reps)

    # The least the card could move: valid lanes of the id plane, deg and y
    # per class, x once; one add per edge.
    edges = int(ga.num_edges)
    need = v * 4 + sum(int(t.deg.sum()) * t.idx.element_size()
                       + t.idx.shape[0] * 8 for t in tiles)
    bound_bytes_ms = need / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = edges / FP32_OPS_PER_S * 1e3
    padded = fused_edge_map_bytes(tiles, v)
    return dict(
        launches_per_call=launches_per_call, ms=ms, fused_ms=fused_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bound_bytes_ms, bound_ops_ms),
        bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        bound_bytes=need, padded_bytes=padded,
        padded_bound_ms=padded / HBM_BYTES_PER_S * 1e3,
        max_abs_err=err, library_max_abs_err=err_lib,
        per_class=per_class)


# ---------------------------------------------------------------- phase 6
def packed_path(g, g_dbg, gw_dbg, res, device):
    """The packed-storage path on the main-path graphs: the five apps on
    ``backend="packed"`` against ``flat``, ``pack_spmv`` (K4) and
    ``dbg_spmv`` (K1) against the flat pull and the CSR oracle, ``dbg_bin``
    (hist_bin) against the host DBG mapping.  Returns what phases 7-8 reuse."""
    import numpy as np
    import torch

    from repro_torch import apps
    from repro_torch.core.reorder import dbg_spec
    from repro_torch.kernels.csr_spmv import (csr_spmv_ref, dbg_spmv,
                                              ell_pack_groups)
    from repro_torch.kernels.hist_bin import dbg_bin
    from repro_torch.kernels.pack_spmv import pack_spmv
    from repro_torch.pack import flat_csr_nbytes

    t0 = time.perf_counter()
    flats = {"dbg": apps.to_arrays(g_dbg, backend="flat", device=device),
             "dbg_w": apps.to_arrays(gw_dbg, backend="flat", device=device)}
    _sync()
    log(f"packed path: flat oracles rebuilt in {time.perf_counter() - t0:.1f} s")
    packs = {}
    for key, graph in (("dbg", g_dbg), ("dbg_w", gw_dbg)):
        t0 = time.perf_counter()
        pb = apps.to_arrays(graph, backend="packed", device=device)
        _sync()
        pg = pb.packed
        a = pg.in_adj
        log(f"  packed backend {key}: {time.perf_counter() - t0:.1f} s "
            f"(host pack {pg.pack_seconds:.1f} s); in-direction hot tables "
            f"{[(h.num_rows, h.stride) for h in a.hot]} {a.hot[0].idx.dtype}, "
            f"packing factor {a.packing_factor:.3f}, cold rows "
            f"{a.cold.num_rows} / edges {a.cold.num_edges}; out-direction "
            f"hot tables {[(h.num_rows, h.stride) for h in pg.out_adj.hot]}; "
            f"bytes per edge "
            f"{pg.bytes_per_edge():.3f} (flat CSR "
            f"{flat_csr_nbytes(graph) / (2 * graph.num_edges):.3f}); K5 "
            f"tile classes {[tuple(t.idx.shape) for t in pb.in_tiles]}")
        packs[key] = pb

    sources = apps.radii_sources(g_dbg.num_vertices, 8,
                                 generator=torch.Generator().manual_seed(0))
    runs = {
        "pagerank[dbg]": ("dbg", lambda ga: apps.pagerank(ga)),
        "pagerank_delta": ("dbg", lambda ga: apps.pagerank_delta(
            ga, epsilon=0.01 / ga.num_vertices)),
        "sssp": ("dbg_w", lambda ga: apps.sssp(ga, 0)),
        "bc": ("dbg", lambda ga: apps.bc(ga, 0)),
        "radii": ("dbg", lambda ga: apps.radii(ga, sources)),
    }
    records = {}
    for name, (key, fn) in runs.items():
        per = {}
        for bname, ga in (("packed", packs[key]), ("flat", flats[key])):
            n0 = _ell_launches()
            _sync()
            t = time.perf_counter()
            out = fn(ga)
            _sync()
            per[bname] = (out, time.perf_counter() - t, _ell_launches() - n0)
        (po, ps, pl), (fo, fs, fl) = per["packed"], per["flat"]
        if pl == 0:
            raise AssertionError(f"{name}: K5 was never launched on packed")
        if fl != 0:
            raise AssertionError(f"{name}: flat launched K5")
        iters = _compare_app(name, po, fo)
        records[name] = dict(packed_s=ps, flat_s=fs, launches=pl, iters=iters)
        log(f"  app {name}: packed {ps:.3f} s, flat {fs:.3f} s, "
            f"iterations {iters}, K5 launches {pl}")

    v = g_dbg.num_vertices
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.rand(v, generator=gen, device=device)
    pull = flats["dbg"].pull(x, reduce="sum")
    t0 = time.perf_counter()
    y = pack_spmv(x, packs["dbg"].packed.in_adj)
    _sync()
    t1 = time.perf_counter()
    err = _assert_close(y, pull, "sum", "pack_spmv vs the flat pull")
    yw = pack_spmv(x, packs["dbg_w"].packed.in_adj)
    ga = flats["dbg_w"].ga
    want_w = csr_spmv_ref(x, ga.in_src, ga.in_ptr, ga.in_w)
    err_w = _assert_close(yw, want_w, "sum", "weighted pack_spmv vs csr_spmv_ref")
    log(f"  pack_spmv: max |err| {err:.3g} vs the flat pull, {err_w:.3g} "
        f"weighted vs csr_spmv_ref ({t1 - t0:.1f} s per call: host planes "
        f"copied to the card and the cold tail decoded, as in the reference)")

    bounds = dbg_spec(float(g_dbg.in_degrees().mean())).boundaries
    t0 = time.perf_counter()
    groups = ell_pack_groups(g_dbg, bounds, row_tile=64, width_tile=128,
                             device=device)
    _sync()
    t1 = time.perf_counter()
    yd = dbg_spmv(x, groups, v, row_tile=64, width_tile=128)
    err_d = _assert_close(yd, pull, "sum", "dbg_spmv vs the flat pull")
    log(f"  dbg_spmv: max |err| {err_d:.3g} vs the flat pull; K1 groups "
        f"{[tuple(gr.idx.shape) for gr in groups]} packed in {t1 - t0:.1f} s")

    out_deg = g.out_degrees()
    spec = dbg_spec(max(1.0, float(out_deg.mean())))
    deg_t = torch.from_numpy(out_deg.astype(np.int32)).to(device)
    b_t = torch.tensor(spec.boundaries, dtype=torch.int32, device=device)
    mapping, _, hist = dbg_bin(deg_t, b_t)
    if not torch.equal(mapping.cpu(), torch.from_numpy(res.mapping)):
        bad = int((mapping.cpu() != torch.from_numpy(res.mapping)).sum())
        raise AssertionError(f"dbg_bin mapping differs from the host DBG "
                             f"mapping at {bad} vertices (must be bitwise)")
    log(f"  dbg_bin: mapping equals the host DBG mapping bitwise; histogram "
        f"{hist.tolist()}")
    return dict(flats=flats, packs=packs, groups=groups, records=records,
                deg_t=deg_t, b_t=b_t, out_deg=out_deg, spec=spec,
                max_err={"hot_spmv": max(err, err_w), "ell_spmv": err_d})


# ---------------------------------------------------------------- phase 7
def new_kernel_grid(pk, small, device):
    """K4, K1 and hist_bin against their plain versions on the card;
    returns the worst sum error of K4 and of K1."""
    import torch

    from repro_torch.graph import datasets, generators
    from repro_torch.kernels.csr_spmv import ell_spmv, ell_spmv_ref
    from repro_torch.kernels.hist_bin import hist_bin, hist_bin_ref
    from repro_torch.kernels.pack_spmv import hot_spmv, hot_spmv_ref
    from repro_torch.pack import hot_planes, pack_graph

    gen = torch.Generator(device=device).manual_seed(3)
    spec = datasets.REGISTRY["kr"]
    tiny = generators.rmat(256, 256 * int(spec.avg_degree), seed=2,
                           name="kr", **spec.extra)
    pg_main = pk["packs"]["dbg"].packed
    pg_small, pg_tiny = pack_graph(small), pack_graph(tiny)
    err4, checked, widths = 0.0, [], set()
    for label, pg in (("main", pg_main), ("kr/small", pg_small),
                      ("256-vertex", pg_tiny)):
        v = pg.num_vertices
        x = torch.rand(v, generator=gen, device=device)
        for direction in ("in_adj", "out_adj"):
            for _, idx, deg, _ in hot_planes(getattr(pg, direction),
                                             device=device):
                r, s = idx.shape
                widths.add(idx.element_size())
                for w in (None, torch.rand((r, s), generator=gen,
                                           device=device)):
                    got = hot_spmv(x, idx, deg, w, row_tile=r, width_tile=s)
                    ref = _chunked(lambda i, d, ww: hot_spmv_ref(x, i, d, ww),
                                   r, s, idx, deg, w)
                    err4 = max(err4, _assert_close(
                        got, ref, "sum", f"K4 on a {label} {direction} "
                        f"({r}, {s}) {idx.dtype} table, w={w is not None}"))
                checked.append((label, direction, r, s))
    _sync()
    log(f"  K4 vs plain: {len(checked)} hot tables x (unweighted, weighted) "
        f"agree, id widths {sorted(widths)} bytes, max |err| {err4:.3g}")

    x = torch.rand(pk["flats"]["dbg"].num_vertices, generator=gen,
                   device=device)
    err1 = 0.0
    for gr in pk["groups"]:
        r, w = gr.idx.shape
        got = ell_spmv(x, gr.idx, gr.w, row_tile=r, width_tile=w)
        ref = _chunked(lambda i, ww: ell_spmv_ref(x, i, ww), r, w, gr.idx,
                       gr.w)
        err1 = max(err1, _assert_close(got, ref, "sum",
                                       f"K1 on a ({r}, {w}) group"))
    _sync()
    log(f"  K1 vs plain: {len(pk['groups'])} groups agree, max |err| "
        f"{err1:.3g}")

    deg_t, b_t = pk["deg_t"], pk["b_t"]
    for bounds in (b_t, b_t[:-1].contiguous()):  # the second ends above 0
        got, ref = hist_bin(deg_t, bounds), hist_bin_ref(deg_t, bounds)
        for a, b, what in zip(got, ref, ("groups", "histogram")):
            if not torch.equal(a, b):
                raise AssertionError(f"hist_bin {what} differ from the plain "
                                     f"version (bounds {bounds.tolist()})")
    _sync()
    log("  hist_bin vs plain: groups and histograms bitwise equal, bounds "
        f"{b_t.tolist()} and {b_t[:-1].tolist()}")
    return err4, err1, widths


# ---------------------------------------------------------------- phase 8
def _bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def _library_csr(crow, col, vals, shape):
    import torch

    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, vals, size=shape,
                                       check_invariants=False)


def time_hot_spmv(pk, reps):
    """K4 at ``pack_spmv``'s call on the main-path graph: one launch per hot
    group of the in-adjacency, on the planes padded as ``pack_spmv`` pads
    them; cuSPARSE over the same rows as the library yardstick."""
    import numpy as np
    import torch

    from repro_torch.graph.csr import ragged_offsets
    from repro_torch.kernels.pack_spmv import hot_spmv, hot_spmv_ref
    from repro_torch.pack import hot_planes

    adj = pk["packs"]["dbg"].packed.in_adj
    dev = pk["deg_t"].device
    planes, cols, degs = [], [], []
    for h, idx, deg, _ in hot_planes(adj, device=dev, row_tile=64,
                                     width_tile=128):
        planes.append((h.num_rows, idx, deg))
        at = ragged_offsets(np.arange(h.num_rows, dtype=np.int64) * h.stride,
                            h.deg.astype(np.int64))
        cols.append(h.idx.ravel()[at].astype(np.int64))
        degs.append(h.deg.astype(np.int64))
    v = adj.num_vertices
    x = torch.rand(v, generator=torch.Generator(device=dev).manual_seed(4),
                   device=dev)

    def kernels():
        return [hot_spmv(x, i, d, row_tile=64, width_tile=128)[:r]
                for r, i, d in planes]

    def plain():
        return [_chunked(lambda ii, dd: hot_spmv_ref(x, ii, dd), r,
                         i.shape[1], i, d)[:r] for r, i, d in planes]

    n0 = hot_spmv.launches
    got = torch.cat(kernels())
    per_call = hot_spmv.launches - n0
    err = _assert_close(got, torch.cat(plain()), "sum", "timed K4 vs plain")
    deg_all = np.concatenate(degs)
    crow = np.zeros(deg_all.size + 1, np.int64)
    np.cumsum(deg_all, out=crow[1:])
    col = torch.from_numpy(np.concatenate(cols)).to(dev)
    csr = _library_csr(torch.from_numpy(crow).to(dev), col,
                       torch.ones(col.shape[0], device=dev),
                       (deg_all.size, v))
    lib_err = float(((csr @ x[:, None])[:, 0] - got).abs().max())
    edges = int(deg_all.sum())
    itemsize = adj.hot[0].idx.dtype.itemsize
    bound_ms, bound_by = _bound(v * 4 + edges * itemsize + deg_all.size * 8,
                                edges)
    return dict(ms=_events_ms(kernels, reps), plain_ms=_events_ms(plain, reps),
                library_ms=_events_ms(lambda: csr @ x[:, None], reps),
                launches_per_call=per_call, max_abs_err=err,
                library_max_abs_err=lib_err, bound_ms=bound_ms,
                bound_by=bound_by, edges=edges, rows=int(deg_all.size),
                per_table=[(tuple(i.shape), str(i.dtype).replace("torch.", ""),
                            _events_ms(lambda i=i, d=d: hot_spmv(
                                x, i, d, row_tile=64, width_tile=128), reps))
                           for _, i, d in planes])


def time_ell_spmv(pk, reps):
    """K1 at ``dbg_spmv``'s call on the main-path graph (64 x 128 geometry):
    one launch per DBG group; cuSPARSE over the in-CSR as the yardstick."""
    import torch

    from repro_torch.kernels.csr_spmv import ell_spmv, ell_spmv_ref

    groups = pk["groups"]
    ga = pk["flats"]["dbg"].ga
    v = ga.num_vertices
    dev = ga.device
    x = torch.rand(v, generator=torch.Generator(device=dev).manual_seed(5),
                   device=dev)

    def kernels():
        return [ell_spmv(x, gr.idx, gr.w, row_tile=64, width_tile=128)
                for gr in groups]

    def plain():
        return [_chunked(lambda i, w: ell_spmv_ref(x, i, w), gr.idx.shape[0],
                         gr.idx.shape[1], gr.idx, gr.w) for gr in groups]

    n0 = ell_spmv.launches
    got = kernels()
    per_call = ell_spmv.launches - n0
    err = 0.0
    for a, b in zip(got, plain()):
        err = max(err, _assert_close(a, b, "sum", "timed K1 vs plain"))
    csr = _library_csr(ga.in_ptr, ga.in_src, torch.ones_like(ga.in_w), (v, v))
    lanes = sum(gr.idx.numel() for gr in groups)
    rows = sum(gr.idx.shape[0] for gr in groups)
    bound_ms, bound_by = _bound(lanes * 8 + v * 4 + rows * 4, 2 * lanes)
    return dict(ms=_events_ms(kernels, reps), plain_ms=_events_ms(plain, reps),
                library_ms=_events_ms(lambda: csr @ x[:, None], reps),
                launches_per_call=per_call, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by, lanes=lanes,
                per_group=[(tuple(gr.idx.shape), _events_ms(
                    lambda gr=gr: ell_spmv(x, gr.idx, gr.w, row_tile=64,
                                           width_tile=128), reps))
                           for gr in groups])


def time_hist_bin(pk, reps):
    """hist_bin at ``dbg_bin``'s call (the main-path graph's out-degrees);
    ``torch.searchsorted`` + ``torch.bincount`` as the yardstick; and the
    whole device DBG (``dbg_bin``) beside the host mapping."""
    import statistics

    import torch

    from repro_torch.core.reorder import group_reorder
    from repro_torch.kernels.hist_bin import dbg_bin, hist_bin, hist_bin_ref

    deg_t, b_t = pk["deg_t"], pk["b_t"]
    v, k = deg_t.shape[0], b_t.shape[0]
    asc = b_t.flip(0).contiguous()

    def library():
        g = (k - 1) - (torch.searchsorted(asc, deg_t, right=True) - 1)
        return g, torch.bincount(g, minlength=k)

    n0 = hist_bin.launches
    groups, hist = hist_bin(deg_t, b_t)
    per_call = hist_bin.launches - n0
    ref_groups, ref_hist = hist_bin_ref(deg_t, b_t)
    err = max(float((groups - ref_groups).abs().max()),
              float((hist - ref_hist).abs().max()))
    if err != 0.0:
        raise AssertionError(f"timed hist_bin differs from the plain version "
                             f"by {err} (must be bitwise)")
    lg, lh = library()
    if not (torch.equal(lg.to(torch.int32), groups)
            and torch.equal(lh.to(torch.int32), hist)):
        raise AssertionError("searchsorted + bincount disagree with hist_bin")
    host = []
    for _ in range(3):
        t = time.perf_counter()
        group_reorder(pk["out_deg"], pk["spec"])
        host.append(time.perf_counter() - t)
    bound_ms, bound_by = _bound(v * 8 + k * 8, v * k)
    return dict(ms=_events_ms(lambda: hist_bin(deg_t, b_t), reps),
                plain_ms=_events_ms(lambda: hist_bin_ref(deg_t, b_t), reps),
                library_ms=_events_ms(library, reps),
                launches_per_call=per_call, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by,
                dbg_bin_ms=_events_ms(lambda: dbg_bin(deg_t, b_t), reps),
                host_mapping_ms=statistics.median(host) * 1e3)


# ---------------------------------------------------------------- main
def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT} holds no src/repro_torch; run "
                         "it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.reorder import dbg_spec
    from repro_torch.graph import datasets
    from repro_torch.kernels import load_all
    from repro_torch.kernels.edge_map import ell_tiles

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    load_all()
    log(f"build: K5, K4, K1 and hist_bin libraries ready in "
        f"{time.perf_counter() - t0:.1f} s (every nvcc started together)")

    # 3. K5 vs plain, every static variant
    dev = torch.device("cuda")
    small = datasets.load("kr", "small")
    spec = dbg_spec(max(1.0, float(small.in_csr.degrees().mean())))
    small_tiles = ell_tiles(small.in_csr, spec.boundaries, device=dev)
    g, g_dbg, gw_dbg, res = build_graphs()
    in_deg = g_dbg.in_csr.degrees()
    big_tiles = ell_tiles(g_dbg.in_csr, dbg_spec(float(in_deg.mean())).boundaries,
                          device=dev)
    t0 = time.perf_counter()
    n1, e1 = variant_grid(small_tiles, small.num_vertices, dev, seed=0)
    n2, e2 = variant_grid(big_tiles, g_dbg.num_vertices, dev, seed=1)
    log(f"kernel vs plain: {n1} variants on kr/small "
        f"({[tuple(t.idx.shape) for t in small_tiles]}, "
        f"{small_tiles[0].idx.dtype}) and {n2} on the main-path graph's "
        f"classes ({[tuple(t.idx.shape) for t in big_tiles]}, int32 ids), "
        f"all rows, all agree; max |err| of sums {max(e1, e2):.3g} "
        f"({time.perf_counter() - t0:.1f} s)")
    del big_tiles
    torch.cuda.empty_cache()

    # 4. the main path; the launch counts are read from zero
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    backends, records = main_path(g, g_dbg, gw_dbg, dev)
    ell_path = _read_launches()
    log(f"main path: launches {ell_path}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. K5 times
    flat, ell = backends["dbg"]
    t = time_pull(flat, ell, REPS)
    for shape, dtype, edges, ms in t["per_class"]:
        log(f"  class {shape} {dtype}: {edges} edges, kernel {ms:.4f} ms")
    log(f"timed pull: kernel {t['ms']:.4f} ms ({t['launches_per_call']} "
        f"launches), full fused_edge_map {t['fused_ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, cuSPARSE {t['library_ms']:.4f} ms (max |err| "
        f"vs flat {t['library_max_abs_err']:.3g}), bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_bytes']} B), padded-plane bound "
        f"{t['padded_bound_ms']:.4f} ms ({t['padded_bytes']} B)")
    log(json.dumps({"apps": records, "edges": g.num_edges,
                    "vertices": g.num_vertices}))
    del backends, flat, ell
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the packed path; the launch counts are read from zero
    t0 = time.perf_counter()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pk = packed_path(g, g_dbg, gw_dbg, res, dev)
    packed = _read_launches()
    idle = [k for k, n in packed.items() if n == 0]
    if idle:
        raise AssertionError(f"packed path: {idle} never launched ({packed})")
    log(f"packed path: launches {packed}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"packed_apps": pk["records"]}))

    # 7. K4, K1 and hist_bin vs their plain versions
    t0 = time.perf_counter()
    err4, err1, widths = new_kernel_grid(pk, small, dev)
    if widths != {1, 2, 4}:
        raise AssertionError(f"K4 was checked on id widths {widths} bytes, "
                             "not on uint8, uint16 and uint32")
    log(f"new kernels vs plain: all agree ({time.perf_counter() - t0:.1f} s)")

    # 8. their times
    t0 = time.perf_counter()
    k4, k1, hb = (time_hot_spmv(pk, REPS), time_ell_spmv(pk, REPS),
                  time_hist_bin(pk, REPS))
    for shape, dtype, ms in k4["per_table"]:
        log(f"  K4 table {shape} {dtype}: {ms:.4f} ms")
    log(f"timed K4 (pack_spmv's hot groups, {k4['rows']} rows, {k4['edges']} "
        f"edges): kernel {k4['ms']:.4f} ms ({k4['launches_per_call']} "
        f"launches), plain {k4['plain_ms']:.4f} ms, cuSPARSE "
        f"{k4['library_ms']:.4f} ms (max |err| vs K4 "
        f"{k4['library_max_abs_err']:.3g}), bound {k4['bound_ms']:.4f} ms")
    for shape, ms in k1["per_group"]:
        log(f"  K1 group {shape}: {ms:.4f} ms")
    log(f"timed K1 (dbg_spmv, {k1['lanes']} lanes): kernel {k1['ms']:.4f} ms "
        f"({k1['launches_per_call']} launches), plain {k1['plain_ms']:.4f} ms, "
        f"cuSPARSE {k1['library_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms")
    log(f"timed hist_bin: kernel {hb['ms']:.4f} ms, plain "
        f"{hb['plain_ms']:.4f} ms, searchsorted + bincount "
        f"{hb['library_ms']:.4f} ms, bound {hb['bound_ms']:.4f} ms; device "
        f"DBG (dbg_bin) {hb['dbg_bin_ms']:.4f} ms vs host mapping "
        f"(group_reorder) {hb['host_mapping_ms']:.2f} ms "
        f"({time.perf_counter() - t0:.1f} s)")

    timed = {
        "ell_edge_map": dict(t, max_abs_err=max(e1, e2, t["max_abs_err"])),
        "hot_spmv": dict(k4, max_abs_err=max(err4, k4["max_abs_err"],
                                             pk["max_err"]["hot_spmv"])),
        "ell_spmv": dict(k1, max_abs_err=max(err1, k1["max_abs_err"],
                                             pk["max_err"]["ell_spmv"])),
        "hist_bin": hb,
    }
    kernels = []
    for kname, (_, source, replaces) in _wrappers().items():
        m = timed[kname]
        by_path = {"ell": ell_path[kname], "packed": packed[kname]}
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            # K5 carries the main (ell) path, the new kernels the packed one
            "launches": by_path["ell" if kname == "ell_edge_map" else "packed"],
            "launches_by_path": by_path,
            "launches_per_call": m["launches_per_call"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
