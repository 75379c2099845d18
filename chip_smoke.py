#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and the CUDA
toolkit (``nvcc``): the K5 kernel is built from ``src/repro_torch`` at first
use.  It imports nothing of JAX and nothing of the JAX package ``repro``.

Phases (any failure raises, and the script exits non-zero):
  1. device: the card's name and power limit from ``nvidia-smi``;
  2. build: compile (or load) the K5 libraries, with the seconds it took;
  3. kernel vs plain version on the card, over every static variant, on all
     rows of every tile class of the ``kr`` registry graph at ``small`` scale
     (uint16 ids) and of the main-path graph (int32 ids): min/max bitwise,
     sums within 2e-6 · (1 + max|y|);
  4. the main path: a ``kr``-signature RMAT graph (a=.57, b=.19, c=.19,
     average degree 20) at 2^21 vertices, reordered with DBG on out-degree,
     then PageRank (original and DBG orderings), PageRank-delta, SSSP, BC and
     Radii on ``backend="ell"``, each held to the ``flat`` oracle on the same
     card; K5's launch count must grow in every app;
  5. times at the main path's PageRank pull: the kernel, its plain version,
     one library call (cuSPARSE SpMV through ``torch.sparse``) and the bound.

It prints the ``kernels`` JSON line (the kernel's time is ``ms``, its worst
error against the plain version ``max_abs_err``, the TPU kernel it replaces
``replaces``) and, as its last line, ``{"ok": true, "device": {...}}``.
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


def _plain(x, idx, deg, **kw):
    """The plain version over row chunks of at most ``PLAIN_CHUNK_LANES``
    lanes, so its (R, W, K) intermediates stay small on the hub class."""
    import torch

    from repro_torch.kernels.edge_map import ell_edge_map_ref

    step = max(1, PLAIN_CHUNK_LANES // idx.shape[1])
    out = []
    for a in range(0, idx.shape[0], step):
        rows = {k: (v[a:a + step] if k in ("w", "alive", "init_rows")
                    and v is not None else v) for k, v in kw.items()}
        out.append(ell_edge_map_ref(x, idx[a:a + step], deg[a:a + step],
                                    **rows))
    return torch.cat(out)


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
    reordering on out-degree, and a weighted copy of that for SSSP."""
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
    return g, g_dbg, gw_dbg


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


# ---------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT} holds no src/repro_torch; run "
                         "it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph import datasets
    from repro_torch.core.reorder import dbg_spec
    from repro_torch.kernels.edge_map import ell_edge_map, ell_tiles, load_kernels

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    load_kernels()
    log(f"build: K5 libraries ready in {time.perf_counter() - t0:.1f} s")

    # 3. kernel vs plain, every static variant
    dev = torch.device("cuda")
    small = datasets.load("kr", "small")
    spec = dbg_spec(max(1.0, float(small.in_csr.degrees().mean())))
    small_tiles = ell_tiles(small.in_csr, spec.boundaries, device=dev)
    g, g_dbg, gw_dbg = build_graphs()
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

    # 4. the main path; the launch count is read from zero
    ell_edge_map.launches = 0
    torch.cuda.reset_peak_memory_stats()
    backends, records = main_path(g, g_dbg, gw_dbg, dev)
    main_launches = ell_edge_map.launches
    log(f"main path: K5 launches {main_launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. times
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
    kernel = {
        "name": "ell_edge_map", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_map/csrc/edge_map.cu",
        "replaces": "src/repro/kernels/edge_map/edge_map.py:159",
        "launches": main_launches, "launches_per_call": t["launches_per_call"],
        "max_abs_err": max(e1, e2, t["max_abs_err"]), "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
