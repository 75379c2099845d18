#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and the CUDA
toolkit (``nvcc``): the kernels are built from ``src/repro_torch`` at first
use.  It imports nothing of JAX and nothing of the JAX package ``repro``.

Phases (any failure raises, and the script exits non-zero):
  1. device: the card's name and power limit from ``nvidia-smi``;
  2. build: compile (or load) the libraries of all five TPU kernels' ports
     — K5, K4, K1, hist_bin (with the stable-rank kernel in its source) and
     K2 — the two ``NARROW_BUILDS`` of K5's sum and hist_bin's
     ``HIST_BIN_BUILDS``, with every ``nvcc`` started together;
  3. K5 vs its plain version on the card, over every static variant, on all
     rows of every tile class of the ``kr`` registry graph at ``small`` scale
     (uint16 ids) and of the main-path graph (int32 ids), a class wider
     than 1,024 lanes through its segment list: min/max bitwise, sums within
     2e-6 · (1 + max|y|), and every sum on the hub class bitwise equal over
     two calls;
  4. the main path: a ``kr``-signature RMAT graph (a=.57, b=.19, c=.19,
     average degree 20) at 2^21 vertices, reordered with DBG on out-degree,
     then PageRank (original and DBG orderings), PageRank-delta, SSSP, BC and
     Radii on ``backend="ell"``, each held to the ``flat`` oracle on the same
     card; K5's launch count must grow in every app; then each app's warm
     median (``warm_median``: one warm-up run, then the median, min and max
     of ``EVAL_REPS`` runs on the host clock, synced at each end) on ``ell``
     and ``flat``;
  5. times at the main path's PageRank pull: K5, its plain version, one
     library call (cuSPARSE SpMV through ``torch.sparse``) and the bound;
     K5 per tile class (device time alone, the host's issue time hidden
     behind a device sleep) with its lanes per row and its launches (two for a
     class wider than 1,024 lanes: pieces, then the fold; the hub class
     named); on the hub class the split against a block per whole row, and
     on each narrower class the kept narrow kernel against two builds of
     K5's sum that batch every thread's loads and none (``NARROW_BUILDS``),
     the three bitwise equal;
  6. the packed path on the same graphs: ``backend="packed"`` (hot slot
     tables + decoded cold tiles) for the five apps against ``flat``,
     ``pack_spmv`` (K4) and ``dbg_spmv`` (K1) against the flat pull and the
     CSR oracle, and ``dbg_bin`` (hist_bin, then the stable-rank kernel)
     against the host DBG mapping, bitwise; every kernel's launch count,
     read from zero, must be positive; the apps' warm medians on
     ``packed``;
  7. K4, K1 and hist_bin vs their plain versions on the card at the packed
     path's shapes: K4 on every hot table of the main-path graph (uint32
     ids), of ``kr``/small (uint16) and of a 256-vertex graph (uint8), each
     unweighted and weighted, as ``pack_spmv`` calls it (``max_deg`` and
     the segment list); a split table also twice and through the list the
     wrapper builds, bitwise; K1 on every DBG group, walking the degrees
     and every lane, each against the plain version and the two bitwise
     against each other; hist_bin on the out-degrees, also with bounds that
     do not end in 0; ``dbg_bin`` against the plain path (``hist_bin_ref``,
     then ``stable_mapping_ref``) bitwise, and the stable mapping from the
     plain groups alone, at V of 0, 1, a tile and a tile ± 1, 3 tiles + 5,
     2^21 and 2^21 + 5, K of 1, 7, 8 and 32, every vertex in one group;
  8. times of K4, K1, hist_bin and the stable rank at their packed-path
     calls, beside their plain versions, one library call each and their
     bounds (K1 both ways, per DBG group, with the bound over the real
     lanes and over the padded planes), each from an idle device and on the
     device alone; K4 per hot table too, with its lane group, pieces and
     launches (2 for a split table, else 1); the whole ``dbg_bin`` both
     ways beside its bound, its plain path and a library path
     (``searchsorted``, a stable ``argsort`` inverted with ``scatter_``),
     and its launches (one of each kernel); hist_bin also as its two-op
     comparison build (``HIST_BIN_BUILDS``: a memset, then atomics), checked
     bitwise;
  9. the paper's evaluation on the phase-4 graph (nothing regenerated): the
     orderings of ``EVAL_ORDERINGS`` (the paper's five techniques, the
     original order and ``random_vertex``), each built once as ``ell``
     (``original`` and ``dbg`` reuse phase 4's backends), with its host
     reorder seconds; the five apps on the same problem (the main path's
     root and Radii sources mapped through each ordering, SSSP on phase
     4's weighted graph relabelled), held after mapping back to the
     original order's results (PageRank in phase 4's band, SSSP and Radii
     bitwise, BC's levels bitwise and centrality within 1e-5); each app's
     warm median; one run with ``obs.counters`` installed, bitwise equal,
     whose K5 launches must equal its passes times K5's launches per pass
     (read from the tiles), with its passes, edges, modeled bytes and
     modeled GB/s; PageRank-delta and BC also timed with the counters
     installed; the cache model's L1/L2/L3 MPKA and AMAT of each
     ordering's pull trace (``cachesim``, ``DEFAULT_TRACE_LEN``
     accesses); Tables I-IV (``core.stats``) once; and one PageRank run
     traced (``EVAL_TRACED``'s build and the run), saved, loaded back
     through ``load_trace``, with one ``engine.build_backend`` span and an
     ``edge_map`` counter event per pass; it prints a ``paper_eval`` JSON
     line;
 10. the streaming plane on phase 4's weighted DBG graph (nothing
     regenerated; phase 4's backends freed): a ``StreamService``
     (``STREAM_CONFIG``: the fused PageRank push, DBG regrouped every
     batch, a compaction threshold that only the final batch crosses) whose
     ``_on_apply`` hook also feeds an unfused ``IncrementalPageRank`` and a
     fused ``IncrementalSSSP`` from the main path's root, beside the
     service's own unfused SSSP; the reference churn benchmark's traffic
     (``ChurnStream``: 75% inserts drawn by degree + 1, weights in [1, 16),
     deletions uniform over the alive edges), ``STREAM_BATCHES`` batches of
     each of ``STREAM_SIZES`` edges, then one batch of
     ``STREAM_INSERT_ONLY`` inserts alone, whose SSSP refreshes must relax
     from the new edges without a full recompute.  After every batch:
     fused SSSP bitwise equal to the unfused, fused PageRank within 1e-8 of
     the unfused (at 2^21 vertices; held in units of 1/V), and K5's
     launches in each fused refresh equal to its passes x the launches per
     pass over the tiles it rode (the base classes with their alive
     planes, and the ``coo_tiles`` delta tile); after the first series and
     after the insert-only batch the fused PageRank within 1e-5 of
     ``apps.pagerank`` on ``flat`` of the snapshot, and after the last the
     fused SSSP bitwise equal to ``apps.sssp``.  Per batch it prints the
     deployment's ingest (less the comparison consumers' folds, printed
     apart), apply, folds, regroup, tile (alive refresh, ``coo_tiles``) and
     refresh seconds and iterations, per series their median [min-max];
     the cold solves, the ``DeltaGraph``, the compaction and the resync;
     one fused and one unfused push on the device alone (each twice
     bitwise, against each other in the sum band) beside the fused push's
     bound over the real lanes; one ``locality()``; the phase's peak
     device memory; and a ``stream`` JSON line;
 11. (the graph state freed) K2 vs its plain version on the card, bitwise:
     ``hot_gather`` and the split gather, float32 and bfloat16, at reduced
     widths, at Yi-9B's (H 8192, C 57,344, D 4096) on 8,192 DBG-remapped
     Zipf ids, and at a T that is not a multiple of 32; all-hot and
     all-cold batches, int64 and strided ids too;
 12. the LM serving path at reduced size, card against CPU: reduced Yi-9B
     (GQA) and reduced OLMo-1B, same weights, ``generate`` (batch 2, prompt
     8, 8 new): logits of every step within rtol 1e-4, atol 1e-5, tokens
     equal;
 13. the LM serving path at full width: Yi-9B (48 layers, d_model 4096,
     float32, random weights from a seeded generator on the card) serves 4
     requests of 32 Zipf prompt tokens (DBG vocabulary) + 32 greedy tokens;
     K2 must launch once per ``decode_step`` (64), every token lies in the
     vocabulary, the last logits are finite, and the split gather of the
     served ids equals its plain version bitwise;
 14. K2's times at the decode call (T = 4) and at T = 8,192 Zipf ids, beside
     the plain version, ``F.embedding`` over the joined table and the
     bound, from an idle device and on the device alone; the wrapper's host
     time per call; and, under ``torch.profiler``, the device operations
     of one ``embed_lookup`` at a prefill and at a decode step (1 each) and
     of one hist_bin (1) and one dbg_bin call (2) at phase 8's call, read
     together here: in runs that first profiled in phase 8, phase 14's
     profile of the prefill lookup held no device event.

It prints the ``kernels`` JSON line (a kernel's time is ``ms`` from an idle
device and ``device_ms`` on the device alone, its library call's
``library_ms`` and ``library_device_ms``, its worst error against the plain
version ``max_abs_err``, the TPU kernel it replaces ``replaces``, its
launches on each path ``launches_by_path``, ``stream`` among them; K5's
``stream_push`` times one push over the stream's tiles, its ``bound_ms``
over the real lanes and ``padded_bound_ms`` over the planes; K1's ``ms`` and
``bound_ms`` are
its degree walk's, ``padded_ms`` and ``padded_bound_ms`` its every-lane
path's; hist_bin's ``dbg_bin_*`` keys time its caller, the device DBG,
``device_ops_per_call`` counts its device operations, and ``two_ops_ms`` and
``two_ops_device_ms`` time its two-op comparison build; ``stable_rank``
replaces no TPU kernel, and its ``replaces`` names the reference's XLA
stable mapping) and, as its last line,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
LOG2_VERTICES = 21         # main-path graph: 2,097,152 vertices
REPS = 20                  # timed calls per measurement (median)
PLAIN_CHUNK_LANES = 1 << 24  # rows per plain-version call, in lanes
SLEEP_CYCLES = 2_000_000   # ~1 ms of device sleep ahead of a device-only time
# K5's sum built with the narrow kernel's batch threshold forced (phase 5)
NARROW_BUILDS = {"batched": ["-DK5_REDUCE=0", "-DK5_BATCH_ABOVE=0"],
                 "unbatched": ["-DK5_REDUCE=0", "-DK5_BATCH_ABOVE=32"]}
# hist_bin with its histogram from a memset and K atomics per block, not
# the last block's fold (phase 8)
HIST_BIN_BUILDS = {"two_ops": ["-DHIST_BIN_TWO_OPS=1"]}
LM_ARCH = "yi_9b"          # the LM serving path's model, at full width
LM_BATCH, LM_PROMPT, LM_NEW = 4, 32, 32  # requests, prompt and new tokens
K2_ZIPF_T = 8192           # Zipf ids of K2's large check and timing
EVAL_REPS = 5              # timed warm runs per app (median), after one warm-up
# the paper's orderings (Fig. 3: random_vertex destroys structure), phase 9
EVAL_ORDERINGS = ("original", "sort", "hubsort", "hubcluster", "dbg",
                  "gorder_lite", "random_vertex")
EVAL_TRACED = "sort"       # phase 9 traces this ordering's build and a PageRank
# phase 10: the reference churn benchmark's traffic (benchmarks/stream_churn.py)
# with its 256-edge series left out: on the H100's host that series took
# ~60 s of a phase that ran 448 s (PERF.md, the stream cell), and the script
# must stay inside its time limit
STREAM_SIZES = (1024, 4096)       # edges per batch, one series each
STREAM_BATCHES = 10               # batches per series, all on one service
STREAM_INSERT_FRAC = 0.75
# the incremental_dbg policy (regroup every batch) with the fused PageRank
# push; the threshold puts exactly the final batch over it: 47,104 edges of
# churn before it, 51,200 with it, against 0.0012 x 41,943,040 = 50,331.6
STREAM_CONFIG = dict(pr_fused_push=True, regroup_every=1,
                     compact_threshold=0.0012)
# then one batch of inserts alone: the incremental SSSP relaxation
STREAM_INSERT_ONLY = 4096
STREAM_KEYS = ("ingest_s", "edges_per_s", "apply_s", "folds_s", "regroup_s",
               "moved", "extra_folds_s", "ingest_total_s", "tiles_s",
               "alive_s", "coo_s", "pr_fused_s", "pr_fused_iters",
               "pr_flat_s", "pr_flat_iters", "sssp_fused_s", "sssp_flat_s",
               "sssp_iters", "pr_gap", "pr_gap_v")


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
    from repro_torch.kernels.gather_embed import hot_gather
    from repro_torch.kernels.hist_bin import hist_bin, stable_rank
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
        # no TPU kernel: the XLA stable mapping beside hist_bin_pallas
        "stable_rank": (stable_rank, f"{k}/hist_bin/csrc/hist_bin.cu",
                        "src/repro/kernels/hist_bin/ops.py:30"),
        "hot_gather": (hot_gather, f"{k}/gather_embed/csrc/gather_embed.cu",
                       "src/repro/kernels/gather_embed/gather_embed.py:36"),
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
    every tile class (a wide class through its segment list); every sum on a
    wide class twice, bitwise.  Returns (variants checked, max |err| of the
    sums, sums checked twice)."""
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
        planes.append(dict(idx=idx, deg=deg, segments=t.segments,
                           w=rand(r, w),
                           alive=(rand(r, w) < 0.8).to(torch.int8),
                           init1=rand(r), init8=rand(r, 8)))
    xs = {1: rand(v), 8: rand(v, 8)}
    frs = {"shared": (rand(v) < 0.5).to(torch.int8),
           "planar": (rand(v, 8) < 0.5).to(torch.int8)}
    n, max_err, twice = 0, 0.0, 0
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
                      neutral=neutral)
            got = ell_edge_map(xs[k], p["idx"], p["deg"],
                               segments=p["segments"], row_tile=r,
                               width_tile=w, **kw)
            want = _plain(xs[k], p["idx"], p["deg"], **kw)
            if reduce == "sum" and p["segments"] is not None:
                again = ell_edge_map(xs[k], p["idx"], p["deg"],
                                     segments=p["segments"], row_tile=r,
                                     width_tile=w, **kw)
                if not torch.equal(got, again):
                    raise AssertionError(
                        f"sum/{weight}/{frontier}/alive={alive}/init={init}/"
                        f"K={k}: two calls on the ({r}, {w}) class differ")
                twice += 1
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
        got = ell_edge_map(reach, p["idx"], p["deg"], segments=p["segments"],
                           row_tile=r, width_tile=w, **kw)
        _assert_close(got, _plain(reach, p["idx"], p["deg"], **kw),
                      "max", "radii identity")
    _sync()
    return n + 1, max_err, twice


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


def app_runs(v, sources, root=0):
    """App name -> the call on a backend: the five apps as the main path
    runs them (SSSP takes the weighted backend)."""
    from repro_torch import apps

    return {
        "pagerank": lambda ga: apps.pagerank(ga),
        # The default absolute epsilon (1e-7) is above the first-round delta
        # (0.15 / V) once V > 1.5M, so nothing would be active; a threshold
        # of 1% of the uniform rank (Ligra's relative epsilon2) keeps the
        # push frontier meaningful at this size.
        "pagerank_delta": lambda ga: apps.pagerank_delta(
            ga, epsilon=0.01 / v),
        "sssp": lambda ga: apps.sssp(ga, root),
        "bc": lambda ga: apps.bc(ga, root),
        "radii": lambda ga: apps.radii(ga, sources),
    }


def warm_median(fn, reps=None):
    """One warm-up call of ``fn()``, then ``reps`` (``EVAL_REPS``) timed
    calls on the host clock, each between two device syncs: the median,
    min and max seconds, and the last call's output."""
    import statistics

    out = fn()
    _sync()
    times = []
    for _ in range(reps or EVAL_REPS):
        _sync()
        t = time.perf_counter()
        out = fn()
        _sync()
        times.append(time.perf_counter() - t)
    return dict(median_s=statistics.median(times), min_s=min(times),
                max_s=max(times)), out


def _span(t, prefix=""):
    """``median [min-max]`` of a ``warm_median`` record (keys ``prefix`` +
    ``median_s``, ...)."""
    return (f"{t[prefix + 'median_s']:.4f} [{t[prefix + 'min_s']:.4f}-"
            f"{t[prefix + 'max_s']:.4f}]")


def main_path(g, g_dbg, gw_dbg, device):
    """Run the five apps on ``ell`` and on ``flat``, once each, checked;
    return the backends, the runs and per-app records."""
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
    fns = app_runs(g_dbg.num_vertices, sources)
    runs = {"pagerank[original]": ("orig", fns["pagerank"]),
            "pagerank[dbg]": ("dbg", fns["pagerank"]),
            "pagerank_delta": ("dbg", fns["pagerank_delta"]),
            "sssp": ("dbg_w", fns["sssp"]),
            "bc": ("dbg", fns["bc"]),
            "radii": ("dbg", fns["radii"])}
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
        records[name] = dict(ell_first_s=es, flat_first_s=fs, launches=el,
                             iters=iters)
        log(f"app {name}: ell {es:.3f} s, flat {fs:.3f} s (first runs), "
            f"iterations {iters}, K5 launches {el}")
    return backends, runs, records


def time_apps(runs, backends, records, names):
    """Warm medians (``warm_median``) of every app on each backend of
    ``names`` (index into ``backends[key]``), into ``records``."""
    for app, (key, fn) in runs.items():
        for bname, i in names.items():
            t, _ = warm_median(lambda: fn(backends[key][i]))
            records[app].update({f"{bname}_{k}": x for k, x in t.items()})


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
def _events_ms(fn, reps, device_only=False):
    """Median over ``reps`` calls of the time between two events around
    ``fn()``.  From an idle device that includes the host's time to issue
    ``fn``'s launches; with ``device_only`` the device first sleeps
    (``SLEEP_CYCLES``) while the host issues them, so the time is the
    device's alone."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _with_build(module, libs, fn):
    """``fn()`` with the wrapper module ``module`` (under
    ``repro_torch.kernels``) bound to ``libs`` (variant → a comparison
    build's library), then its kept entries back."""
    from importlib import import_module

    m = import_module(f"repro_torch.kernels.{module}")
    kept = dict(m.load_kernels())
    m._bind(libs)
    try:
        return fn()
    finally:
        m._KERNELS.update(kept)


def time_pull(flat, ell, reps, narrow_builds):
    """K5, its plain version and cuSPARSE at the PageRank pull of the main
    path (DBG ordering): one full edge map each."""
    import torch

    from repro_torch.kernels._wrap import lanes_per_row
    from repro_torch.kernels.edge_map import (ell_edge_map, ell_edge_map_ref,
                                              fused_edge_map,
                                              fused_edge_map_bytes,
                                              row_segments)

    v = ell.num_vertices
    dev = ell.out_deg.device
    x = (torch.rand(v, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev) / ell.out_deg.clamp(min=1))
    tiles = ell.in_tiles

    def call(t, segments):
        return ell_edge_map(x, t.idx, t.deg, segments=segments,
                            row_tile=t.idx.shape[0], width_tile=t.idx.shape[1])

    def kernels():
        return [call(t, t.segments) for t in tiles]

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
    device_ms = _events_ms(kernels, reps, True)
    fused_ms = _events_ms(lambda: fused_edge_map(tiles, x, v, reduce="sum"),
                          reps)
    plain_ms = _events_ms(plain, reps)
    per_class = []
    for t in tiles:
        r, w = t.idx.shape
        edges = int(t.deg.sum())
        share = (edges * t.idx.element_size() + r * 8) / HBM_BYTES_PER_S * 1e3
        n0 = _ell_launches()
        kept = call(t, t.segments)
        launches = _ell_launches() - n0
        # what the wrapper launched: the split's two kernels above 1,024
        # lanes (a block per piece of a row, then the fold), one below
        if launches != (2 if w > 1024 else 1):
            raise AssertionError(f"class {(r, w)}: {launches} K5 launches")
        group = lanes_per_row(w)
        c = dict(shape=(r, w), dtype=str(t.idx.dtype).replace("torch.", ""),
                 edges=edges, max_deg=int(t.deg.max()), group=group,
                 launches=launches, bound_share_ms=share,
                 segments=None if t.segments is None else int(t.segments.shape[0]),
                 ms=_events_ms(lambda t=t: call(t, t.segments), reps, True))
        if t.segments is not None:
            # the other design on the same inputs: a block per whole row
            # (one segment per row)
            whole = torch.from_numpy(row_segments(t.deg.cpu().numpy(), w))
            whole = whole.to(dev)
            c["block_per_row_ms"] = _events_ms(lambda t=t: call(t, whole),
                                               reps, True)
        else:
            c["lanes_per_thread"] = -(-w // group)
            for name, lib in narrow_builds.items():
                got = _with_build("edge_map.edge_map", {"sum": lib},
                                  lambda t=t: call(t, None))
                if not torch.equal(got, kept):
                    raise AssertionError(f"class {(r, w)}: the {name} build "
                                         "differs from the kept kernel")
                c[f"{name}_ms"] = _with_build(
                    "edge_map.edge_map", {"sum": lib},
                    lambda t=t: _events_ms(lambda: call(t, None), reps, True))
        per_class.append(c)
    ga = ell.ga
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(ga.in_ptr, ga.in_src,
                                      torch.ones_like(ga.in_w), size=(v, v),
                                      check_invariants=False)
    lib = (csr @ x[:, None])[:, 0]
    err_lib = float((lib - want).abs().max())
    library_ms = _events_ms(lambda: csr @ x[:, None], reps)
    library_device_ms = _events_ms(lambda: csr @ x[:, None], reps, True)

    # The least the card could move: valid lanes of the id plane, deg and y
    # per class, x once; one add per edge.
    edges = int(ga.num_edges)
    need = v * 4 + sum(int(t.deg.sum()) * t.idx.element_size()
                       + t.idx.shape[0] * 8 for t in tiles)
    bound_bytes_ms = need / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = edges / FP32_OPS_PER_S * 1e3
    padded = fused_edge_map_bytes(tiles, v)
    return dict(
        launches_per_call=launches_per_call, ms=ms, device_ms=device_ms,
        fused_ms=fused_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library_device_ms=library_device_ms,
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
    fns = app_runs(g_dbg.num_vertices, sources)
    runs = {"pagerank[dbg]": ("dbg", fns["pagerank"]),
            "pagerank_delta": ("dbg", fns["pagerank_delta"]),
            "sssp": ("dbg_w", fns["sssp"]),
            "bc": ("dbg", fns["bc"]),
            "radii": ("dbg", fns["radii"])}
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
        records[name] = dict(packed_first_s=ps, flat_first_s=fs, launches=pl,
                             iters=iters)
        log(f"  app {name}: packed {ps:.3f} s, flat {fs:.3f} s (first "
            f"runs), iterations {iters}, K5 launches {pl}")

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
                runs=runs,
                deg_t=deg_t, b_t=b_t, out_deg=out_deg, spec=spec,
                max_err={"hot_spmv": max(err, err_w), "ell_spmv": err_d})


# ---------------------------------------------------------------- phase 7
def new_kernel_grid(pk, small, device):
    """K4, K1 and hist_bin against their plain versions on the card (K4 as
    ``pack_spmv`` calls it, with each table's ``max_deg`` and segment list;
    a split table also through the wrapper's own list, and twice, bitwise);
    returns the worst sum error of K4 and of K1, K4's id widths and the
    number of split K4 tables checked."""
    import torch

    from repro_torch.graph import datasets, generators
    from repro_torch.kernels.csr_spmv import ell_spmv, ell_spmv_ref
    from repro_torch.kernels.hist_bin import hist_bin, hist_bin_ref
    from repro_torch.kernels.pack_spmv import hot_spmv, hot_spmv_ref, hot_tables
    from repro_torch.pack import pack_graph

    gen = torch.Generator(device=device).manual_seed(3)
    spec = datasets.REGISTRY["kr"]
    tiny = generators.rmat(256, 256 * int(spec.avg_degree), seed=2,
                           name="kr", **spec.extra)
    pg_main = pk["packs"]["dbg"].packed
    pg_small, pg_tiny = pack_graph(small), pack_graph(tiny)
    err4, checked, widths, split = 0.0, [], set(), 0
    for label, pg in (("main", pg_main), ("kr/small", pg_small),
                      ("256-vertex", pg_tiny)):
        v = pg.num_vertices
        x = torch.rand(v, generator=gen, device=device)
        for direction in ("in_adj", "out_adj"):
            for t in hot_tables(getattr(pg, direction), device=device,
                                row_tile=1, width_tile=1):
                idx, deg = t.idx, t.deg
                r, s = idx.shape
                widths.add(idx.element_size())
                for w in (None, torch.rand((r, s), generator=gen,
                                           device=device)):
                    what = (f"K4 on a {label} {direction} ({r}, {s}) "
                            f"{idx.dtype} table, w={w is not None}")
                    got = hot_spmv(x, idx, deg, w, max_deg=t.max_deg,
                                   segments=t.segments, row_tile=r,
                                   width_tile=s)
                    ref = _chunked(lambda i, d, ww: hot_spmv_ref(x, i, d, ww),
                                   r, s, idx, deg, w)
                    err4 = max(err4, _assert_close(got, ref, "sum", what))
                    if t.segments is not None:
                        # twice, and through the list the wrapper builds
                        for again in (hot_spmv(x, idx, deg, w,
                                               max_deg=t.max_deg,
                                               segments=t.segments,
                                               row_tile=r, width_tile=s),
                                      hot_spmv(x, idx, deg, w, row_tile=r,
                                               width_tile=s)):
                            if not torch.equal(got, again):
                                raise AssertionError(f"{what}: two split "
                                                     "calls differ")
                        split += 1
                checked.append((label, direction, r, s))
    _sync()
    log(f"  K4 vs plain: {len(checked)} hot tables x (unweighted, weighted) "
        f"agree, id widths {sorted(widths)} bytes, max |err| {err4:.3g}; "
        f"{split} split calls bitwise equal over two calls and with the "
        "wrapper's own list")

    x = torch.rand(pk["flats"]["dbg"].num_vertices, generator=gen,
                   device=device)
    err1 = 0.0
    for gr in pk["groups"]:
        r, w = gr.idx.shape
        got = ell_spmv(x, gr.idx, gr.w, deg=gr.deg, max_deg=gr.max_deg,
                       segments=gr.segments, row_tile=r, width_tile=w)
        every = ell_spmv(x, gr.idx, gr.w, row_tile=r, width_tile=w)
        if not torch.equal(got, every):
            raise AssertionError(f"K1 on a ({r}, {w}) group: the degree walk "
                                 "and the every-lane path differ (must be "
                                 "bitwise on a finite x)")
        for y, d, what in ((got, gr.deg, "degree walk"),
                           (every, None, "every lane")):
            ref = _chunked(lambda i, ww, dd: ell_spmv_ref(x, i, ww, deg=dd),
                           r, w, gr.idx, gr.w, d)
            err1 = max(err1, _assert_close(y, ref, "sum",
                                           f"K1 ({what}) on a ({r}, {w}) group"))
    _sync()
    log(f"  K1 vs plain: {len(pk['groups'])} groups agree, the degree walk and "
        f"the every-lane path each against the plain version (max |err| "
        f"{err1:.3g}) and bitwise against each other")

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
    log(f"  dbg_bin vs plain: {dbg_bin_grid(deg_t, b_t)}")
    return err4, err1, widths, split


def dbg_bin_grid(deg_t, b_t):
    """``dbg_bin`` on the card (the binning kernel, then the rank kernel)
    against the plain path (``hist_bin_ref``, then ``stable_mapping_ref``)
    bitwise, and ``stable_mapping_from_groups`` on the plain groups, on
    shapes that stress the tiles: V of 0, 1, a tile and a tile ± 1, the
    main-path graph's 2^21 and 2^21 + 5; K = 1, 8 (DBG), 7 (ending above
    0) and 32; every vertex in one group.  Returns a summary line."""
    import torch

    from repro_torch.kernels.hist_bin import (TILE, dbg_bin, hist_bin_ref,
                                              stable_mapping_from_groups,
                                              stable_mapping_ref)

    dev = deg_t.device
    v = deg_t.shape[0]
    wide = torch.arange(31 * 16, -1, -16, dtype=torch.int32, device=dev)
    median = deg_t.float().median().int().reshape(1)
    longer = torch.cat([deg_t, deg_t[:5]])
    cases = [(deg_t, b_t), (deg_t, b_t[:-1].contiguous()), (deg_t, wide),
             (deg_t, median), (longer, b_t), (longer, wide),
             (torch.zeros(v, dtype=torch.int32, device=dev), b_t),  # all last
             (deg_t + int(b_t.max()), b_t)]                         # all first
    for n in (0, 1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5):
        for b in (b_t, wide, median):
            cases.append((deg_t[:n], b))
    shapes = set()
    for d, b in cases:
        k = b.shape[0]
        what = f"dbg_bin at V = {d.shape[0]}, K = {k}"
        mapping, groups, hist = dbg_bin(d, b)
        ref_groups, ref_hist = hist_bin_ref(d, b)
        ref_mapping = stable_mapping_ref(ref_groups, k)
        for got, want, name in ((groups, ref_groups, "groups"),
                                (hist, ref_hist, "histogram"),
                                (mapping, ref_mapping, "mapping"),
                                (stable_mapping_from_groups(ref_groups, k),
                                 ref_mapping, "stable_mapping_from_groups")):
            if got.dtype != want.dtype or not torch.equal(got, want):
                bad = int((got != want).sum()) if got.shape == want.shape else -1
                raise AssertionError(f"{what}: {name} differs from the plain "
                                     f"path at {bad} places (must be bitwise)")
        shapes.add((d.shape[0], k))
    _sync()
    return (f"{len(cases)} cases bitwise equal (mapping, groups, histogram, "
            f"and the mapping from the plain groups alone), (V, K) in "
            f"{sorted(shapes)}")


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
    them; cuSPARSE over the same rows as the library yardstick.  Each time
    is taken from an idle device (``ms``) and on the device alone
    (``device_ms``), the whole call and each table."""
    import numpy as np
    import torch

    from repro_torch.graph.csr import ragged_offsets
    from repro_torch.kernels._wrap import lanes_per_row
    from repro_torch.kernels.pack_spmv import hot_spmv, hot_spmv_ref, hot_tables

    adj = pk["packs"]["dbg"].packed.in_adj
    dev = pk["deg_t"].device
    tables, cols, degs = hot_tables(adj, device=dev), [], []
    for t in tables:
        h = t.group
        at = ragged_offsets(np.arange(h.num_rows, dtype=np.int64) * h.stride,
                            h.deg.astype(np.int64))
        cols.append(h.idx.ravel()[at].astype(np.int64))
        degs.append(h.deg.astype(np.int64))
    v = adj.num_vertices
    x = torch.rand(v, generator=torch.Generator(device=dev).manual_seed(4),
                   device=dev)

    def one(t):  # as ops.pack_spmv calls it
        return hot_spmv(x, t.idx, t.deg, max_deg=t.max_deg,
                        segments=t.segments, row_tile=64, width_tile=128)

    def kernels():
        return [one(t)[:t.group.num_rows] for t in tables]

    def plain():
        return [_chunked(lambda ii, dd: hot_spmv_ref(x, ii, dd),
                         t.idx.shape[0], t.idx.shape[1], t.idx,
                         t.deg)[:t.group.num_rows] for t in tables]

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
    per_table = []
    for t, dh in zip(tables, degs):
        n0 = hot_spmv.launches
        one(t)
        group = lanes_per_row(t.max_deg)
        launches = hot_spmv.launches - n0
        # what the wrapper launched: the split's two kernels for a 256-lane
        # group (a block per piece of a row, then the fold), one below
        if launches != (2 if group == 256 else 1):
            raise AssertionError(f"K4 table {tuple(t.idx.shape)}: {launches} "
                                 "launches")
        per_table.append(dict(
            shape=tuple(t.idx.shape),
            dtype=str(t.idx.dtype).replace("torch.", ""),
            edges=int(dh.sum()), max_deg=t.max_deg, group=group,
            segments=(None if t.segments is None
                      else int(t.segments.shape[0])),
            launches=launches,
            ms=_events_ms(lambda t=t: one(t), reps),
            device_ms=_events_ms(lambda t=t: one(t), reps, True)))
    return dict(ms=_events_ms(kernels, reps),
                device_ms=_events_ms(kernels, reps, True),
                plain_ms=_events_ms(plain, reps),
                library_ms=_events_ms(lambda: csr @ x[:, None], reps),
                library_device_ms=_events_ms(lambda: csr @ x[:, None], reps,
                                             True),
                launches_per_call=per_call, max_abs_err=err,
                library_max_abs_err=lib_err, bound_ms=bound_ms,
                bound_by=bound_by, edges=edges, rows=int(deg_all.size),
                per_table=per_table)


def time_ell_spmv(pk, reps):
    """K1 at ``dbg_spmv``'s call on the main-path graph (64 x 128 geometry):
    one launch per DBG group, with the groups' degrees (``ms``) and without
    (``padded_ms``); cuSPARSE over the in-CSR as the yardstick."""
    import torch

    from repro_torch.kernels._wrap import lanes_per_row
    from repro_torch.kernels.csr_spmv import ell_spmv, ell_spmv_ref

    groups = pk["groups"]
    ga = pk["flats"]["dbg"].ga
    v = ga.num_vertices
    dev = ga.device
    x = torch.rand(v, generator=torch.Generator(device=dev).manual_seed(5),
                   device=dev)

    def one(gr, walk=True):
        kw = (dict(deg=gr.deg, max_deg=gr.max_deg, segments=gr.segments)
              if walk else {})
        return ell_spmv(x, gr.idx, gr.w, row_tile=64, width_tile=128, **kw)

    def kernels():
        return [one(gr) for gr in groups]

    def padded():
        return [one(gr, False) for gr in groups]

    def plain():
        return [_chunked(lambda i, w, d: ell_spmv_ref(x, i, w, deg=d),
                         gr.idx.shape[0], gr.idx.shape[1], gr.idx, gr.w,
                         gr.deg) for gr in groups]

    n0 = ell_spmv.launches
    got = kernels()
    per_call = ell_spmv.launches - n0
    err = 0.0
    for a, b, c in zip(got, plain(), padded()):
        err = max(err, _assert_close(a, b, "sum", "timed K1 vs plain"))
        if not torch.equal(a, c):
            raise AssertionError("timed K1: degree walk != every-lane path")
    csr = _library_csr(ga.in_ptr, ga.in_src, torch.ones_like(ga.in_w), (v, v))
    lanes = sum(gr.idx.numel() for gr in groups)
    edges = sum(int(gr.deg.sum()) for gr in groups)
    rows = sum(gr.idx.shape[0] for gr in groups)
    # The degree walk must read the real lanes' ids and weights, x once, and
    # deg and y per row; the every-lane path reads every lane and no deg.
    bound_ms, bound_by = _bound(edges * 8 + v * 4 + rows * 8, 2 * edges)
    padded_bound_ms, _ = _bound(lanes * 8 + v * 4 + rows * 4, 2 * lanes)
    return dict(ms=_events_ms(kernels, reps),
                device_ms=_events_ms(kernels, reps, True),
                plain_ms=_events_ms(plain, reps),
                padded_ms=_events_ms(padded, reps),
                library_ms=_events_ms(lambda: csr @ x[:, None], reps),
                library_device_ms=_events_ms(lambda: csr @ x[:, None], reps,
                                             True),
                launches_per_call=per_call, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by,
                padded_bound_ms=padded_bound_ms, lanes=lanes, edges=edges,
                per_group=[(tuple(gr.idx.shape), int(gr.deg.sum()),
                            lanes_per_row(gr.max_deg),
                            _events_ms(lambda gr=gr: one(gr), reps),
                            _events_ms(lambda gr=gr: one(gr, False), reps))
                           for gr in groups])


def time_hist_bin(pk, reps, builds):
    """hist_bin at ``dbg_bin``'s call (the main-path graph's out-degrees),
    ``torch.searchsorted`` + ``torch.bincount`` as its yardstick, and its
    two-op comparison build (``builds["two_ops"]``); the whole
    device DBG (``dbg_bin``: hist_bin, then the rank kernel) beside its
    plain path, a library path (``searchsorted``, a stable ``argsort``
    inverted with ``scatter_``) and the host mapping; the rank kernel
    alone; each from an idle device and on the device alone.  (Phase 12
    lists the device operations of one hist_bin and one dbg_bin call.)"""
    import statistics

    import torch

    from repro_torch.core.reorder import group_reorder
    from repro_torch.kernels.hist_bin import (bin_tiles, dbg_bin, hist_bin,
                                              hist_bin_ref, stable_mapping_ref,
                                              stable_rank)

    deg_t, b_t = pk["deg_t"], pk["b_t"]
    v, k = deg_t.shape[0], b_t.shape[0]
    asc = b_t.flip(0).contiguous()
    ids = torch.arange(v, device=deg_t.device)

    def library():
        g = (k - 1) - (torch.searchsorted(asc, deg_t, right=True) - 1)
        return g, torch.bincount(g, minlength=k)

    def library_rank(g):
        return torch.empty_like(ids).scatter_(
            0, torch.argsort(g, stable=True), ids)

    def dbg_library():
        return library_rank((k - 1) - (torch.searchsorted(
            asc, deg_t, right=True) - 1))

    def dbg_plain():
        g, _ = hist_bin_ref(deg_t, b_t)
        return stable_mapping_ref(g, k)

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
    n0, r0 = hist_bin.launches, stable_rank.launches
    mapping, _, _ = dbg_bin(deg_t, b_t)
    dbg_launches = (hist_bin.launches - n0, stable_rank.launches - r0)
    if dbg_launches != (1, 1):
        raise AssertionError(f"dbg_bin launched (hist_bin, stable_rank) "
                             f"{dbg_launches} times, not (1, 1)")
    ref_mapping = dbg_plain()
    for got, name in ((mapping, "dbg_bin"), (dbg_library(), "the library "
                                                "path (argsort + scatter_)")):
        if not torch.equal(got, ref_mapping):
            raise AssertionError(f"timed {name} differs from the plain "
                                 "mapping (must be bitwise)")
    _, hist_t, tiles = bin_tiles(deg_t, b_t)
    host = []
    for _ in range(3):
        t = time.perf_counter()
        group_reorder(pk["out_deg"], pk["spec"])
        host.append(time.perf_counter() - t)
    bound_ms, bound_by = _bound(v * 8 + k * 8, v * k)
    # dbg_bin must read the degrees and write the groups and the int64
    # mapping: 16 bytes per vertex; the rank alone reads the groups and
    # writes the mapping: 12
    dbg_bound_ms, _ = _bound(v * 16 + k * 8, v * k)
    rank_bound_ms, rank_bound_by = _bound(v * 12 + (tiles.numel() + k) * 4,
                                          0)

    def rank():
        return stable_rank(groups, hist_t, tiles)

    r0 = stable_rank.launches
    rank_err = float((rank() - ref_mapping).abs().max())
    rank_per_call = stable_rank.launches - r0
    if rank_err != 0.0:
        raise AssertionError(f"timed stable_rank differs from the plain "
                             f"mapping by {rank_err} (must be bitwise)")
    def two_ops():  # the histogram from a memset and atomics
        got = hist_bin(deg_t, b_t)
        if not (torch.equal(got[0], groups) and torch.equal(got[1], hist)):
            raise AssertionError("hist_bin's two-op build differs from the "
                                 "kept kernel (must be bitwise)")
        return (_events_ms(lambda: hist_bin(deg_t, b_t), reps),
                _events_ms(lambda: hist_bin(deg_t, b_t), reps, True))

    two_ms, two_device_ms = _with_build(
        "hist_bin.hist_bin", {"all": builds["two_ops"]}, two_ops)
    rank_out = dict(
        ms=_events_ms(rank, reps), device_ms=_events_ms(rank, reps, True),
        plain_ms=_events_ms(lambda: stable_mapping_ref(groups, k), reps),
        library_ms=_events_ms(lambda: library_rank(groups), reps),
        library_device_ms=_events_ms(lambda: library_rank(groups), reps,
                                     True),
        launches_per_call=rank_per_call, max_abs_err=rank_err,
        bound_ms=rank_bound_ms,
        bound_by=rank_bound_by)
    return dict(ms=_events_ms(lambda: hist_bin(deg_t, b_t), reps),
                device_ms=_events_ms(lambda: hist_bin(deg_t, b_t), reps, True),
                plain_ms=_events_ms(lambda: hist_bin_ref(deg_t, b_t), reps),
                library_ms=_events_ms(library, reps),
                library_device_ms=_events_ms(library, reps, True),
                launches_per_call=per_call, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by,
                two_ops_ms=two_ms, two_ops_device_ms=two_device_ms,
                dbg_bin_ms=_events_ms(lambda: dbg_bin(deg_t, b_t), reps),
                dbg_bin_device_ms=_events_ms(lambda: dbg_bin(deg_t, b_t), reps,
                                             True),
                dbg_bin_bound_ms=dbg_bound_ms,
                dbg_bin_plain_ms=_events_ms(dbg_plain, reps),
                dbg_bin_library_ms=_events_ms(dbg_library, reps),
                dbg_bin_library_device_ms=_events_ms(dbg_library, reps, True),
                host_mapping_ms=statistics.median(host) * 1e3,
                stable_rank=rank_out)


# ---------------------------------------------------------------- phase 9
def _same(a, b):
    """Bitwise equality of two app outputs (tuples of tensors and ints)."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def _mapped_back(app, out, m):
    """An app's output under an ordering with mapping ``m`` (original id ->
    new id, a device tensor), indexed by original vertex id."""
    if app == "bc":
        c, dist, levels = out
        return c[m], dist[m], levels
    y, it = out
    return y[m], it


def _k5_launches_per_pass(tiles):
    """K5 launches of one ``fused_edge_map`` pass over ``tiles``: two for a
    tile wider than 1,024 lanes (pieces, then the fold), else one."""
    from repro_torch.kernels._wrap import lanes_per_row

    return sum(2 if lanes_per_row(t.idx.shape[1]) == 256 else 1
               for t in tiles)


def _cache_model(graph):
    """L1/L2/L3 MPKA and AMAT of ``graph``'s pull trace, capped at
    ``DEFAULT_TRACE_LEN`` accesses, on the hierarchy scaled to its size."""
    from repro_torch import cachesim

    t0 = time.perf_counter()
    levels = cachesim.scaled_hierarchy(graph.num_vertices)
    d = cachesim.stack_distances(cachesim.to_blocks(cachesim.property_trace(
        graph, "pull", max_len=cachesim.DEFAULT_TRACE_LEN)))
    out = dict(cachesim.mpka(d, levels), amat_cycles=cachesim.amat_cycles(
        d, levels), accesses=int(d.shape[0]))
    out["seconds"] = time.perf_counter() - t0
    return out


def paper_eval(g, g_dbg, gw_dbg, res, ells, device):
    """The paper's evaluation at the main path's size: every ordering of
    ``EVAL_ORDERINGS`` x the five apps on ``ell``, held to the original
    order after mapping back; warm medians; a counted run per cell against
    K5's launches; the cache model per ordering; Tables I-IV; one traced
    PageRank.  ``ells`` holds phase 4's ``orig``, ``dbg`` and ``dbg_w``
    ell backends.  Returns the rows of the ``paper_eval`` line and the
    tables."""
    import gc

    import numpy as np
    import torch

    from repro_torch import apps
    from repro_torch.core import stats
    from repro_torch.graph import csr
    from repro_torch.launch.quickstart import reordered
    from repro_torch.obs import MetricsRegistry, counters
    from repro_torch.obs import trace as obs_trace

    v = g.num_vertices
    inv_dbg = np.empty(v, np.int64)
    inv_dbg[res.mapping] = np.arange(v, dtype=np.int64)
    # the main path's SSSP/BC root (0) and Radii sources, drawn in DBG ids,
    # as original ids: the DBG ordering runs phase 4's problem
    root = int(inv_dbg[0])
    sources = inv_dbg[apps.radii_sources(
        v, 8, generator=torch.Generator().manual_seed(0)).numpy()]
    tables = json.loads(json.dumps({  # numpy scalars as plain floats
        "hot_vertices": stats.hot_vertex_stats(g),
        "hot_per_cache_block": stats.hot_per_cache_block(g),
        "hot_footprint_mb": stats.hot_footprint_mb(g),
        "degree_ranges": stats.degree_range_distribution(g)}))
    log(f"  Table I (hot vertices, % of V and of E): "
        f"{tables['hot_vertices']}")
    log(f"  Table II (hot vertices per cache block): "
        f"{tables['hot_per_cache_block']:.4f}; Table III (hot footprint): "
        f"{tables['hot_footprint_mb']:.4f} MB")
    log(f"  Table IV (hot vertices by degree range): "
        f"{tables['degree_ranges']}")

    rows, want, trace_tr = [], {}, None
    for ordering in EVAL_ORDERINGS:
        t0 = time.perf_counter()
        if ordering == "original":
            g_x, mapping, reorder_s = g, np.arange(v, dtype=np.int64), 0.0
        elif ordering == "dbg":
            g_x, mapping, reorder_s = g_dbg, res.mapping, res.seconds
        else:
            g_x, r = reordered(g, ordering)
            mapping, reorder_s = r.mapping, r.seconds
        t1 = time.perf_counter()
        gw_x = (gw_dbg if ordering == "dbg"
                else csr.relabel(gw_dbg, mapping[inv_dbg]))
        t2 = time.perf_counter()
        traced = ordering == EVAL_TRACED
        if ordering in ("original", "dbg"):  # phase 4's backends
            ell = ells["orig" if ordering == "original" else "dbg"]
        else:
            if traced:  # the trace holds this build's span
                trace_tr = obs_trace.enable()
            ell = apps.to_arrays(g_x, backend="ell", device=device)
            obs_trace.disable()
        ell_w = (ells["dbg_w"] if ordering == "dbg"
                 else apps.to_arrays(gw_x, backend="ell", device=device))
        _sync()
        t3 = time.perf_counter()
        cache = _cache_model(g_x)
        # the layer under the apps: one PageRank-shaped pull (K5 over every
        # class) on the device alone, in this ordering
        x = torch.rand(v, generator=torch.Generator(device=device)
                       .manual_seed(2), device=device)
        pull_ms = _events_ms(lambda: ell.pull(x, reduce="sum"), REPS,
                             device_only=True)
        log(f"  ordering {ordering}: host reorder {reorder_s:.2f} s (mapping "
            f"+ CSR rebuild; {t1 - t0:.1f} s here), weighted relabel "
            f"{t2 - t1:.1f} s, ell backends {t3 - t2:.1f} s; one pull on "
            f"the device alone {pull_ms:.4f} ms; cache model of the pull "
            f"trace ({cache['accesses']} accesses, {cache['seconds']:.1f} "
            f"s): L1 {cache['l1_mpka']:.2f}, L2 {cache['l2_mpka']:.2f}, L3 "
            f"{cache['l3_mpka']:.2f} MPKA, AMAT {cache['amat_cycles']:.3f} "
            "cycles")
        m = torch.from_numpy(mapping).to(device)
        fns = app_runs(v, torch.from_numpy(mapping[sources]),
                       root=int(mapping[root]))
        for app, fn in fns.items():
            ga = ell_w if app == "sssp" else ell
            t, out = warm_median(lambda: fn(ga))
            if ordering == "original":
                want[app] = out
            else:
                try:
                    _compare_app(app, _mapped_back(app, out, m), want[app])
                except AssertionError as e:
                    raise AssertionError(f"{ordering}: {e}") from None
            # one counted run: bitwise the same output, K5's launches from
            # the counters' passes and the tiles
            n0 = _ell_launches()
            c = counters.install(registry=MetricsRegistry())
            try:
                counted = fn(ga)
            finally:
                counters.uninstall()
            _sync()
            launches = _ell_launches() - n0
            if not _same(counted, out):
                raise AssertionError(f"{ordering} {app}: the counted run's "
                                     "output differs (must be bitwise)")
            s = c.summary()
            passes = {d: int(s.get(f"edge_map.passes.ell.{d}", 0))
                      for d in ("pull", "push", "out_sum")}
            expect = ((passes["pull"] + passes["push"])
                      * _k5_launches_per_pass(ga.in_tiles))
            if launches == 0 or launches != expect:
                raise AssertionError(
                    f"{ordering} {app}: {launches} K5 launches, the counters' "
                    f"passes {passes} give {expect}")
            row = dict(ordering=ordering, app=app, **t, reorder_s=reorder_s,
                       pull_device_ms=pull_ms,
                       iters=out[-1], launches=launches, passes=passes,
                       edges=int(s["edge_map.edges"]),
                       model_bytes=int(s["edge_map.model_bytes"]),
                       model_gb_per_s=s["edge_map.model_bytes"]
                       / t["median_s"] / 1e9,
                       **{k: cache[k] for k in ("l1_mpka", "l2_mpka",
                                                "l3_mpka", "amat_cycles")})
            if app in ("pagerank_delta", "bc"):  # the counters' own cost
                counters.install(registry=MetricsRegistry())
                try:
                    ti, _ = warm_median(lambda: fn(ga))
                finally:
                    counters.uninstall()
                row.update({f"instrumented_{k}": x for k, x in ti.items()})
            if traced and app == "pagerank":
                row["trace_events"] = _traced_pagerank(trace_tr, fn, ga, out)
            rows.append(row)
            cost = ("" if "instrumented_median_s" not in row else
                    f"; counters installed {_span(row, 'instrumented_')}")
            log(f"    {app}: {_span(t)} s{cost}, iterations "
                f"{row['iters']}, K5 launches {launches}, passes {passes}, "
                f"edges {row['edges']}, modeled {row['model_bytes']} B "
                f"({row['model_gb_per_s']:.1f} GB/s, the reference's model "
                f"over the padded planes)")
        del ell, ell_w, g_x, gw_x, m, x
        gc.collect()
        torch.cuda.empty_cache()
    # The DBG ordering's backends are phase 4's and still on the card: its
    # five apps timed again after every other ordering show how far a cell
    # drifts within the phase.
    fns = app_runs(v, torch.from_numpy(res.mapping[sources]),
                   root=int(res.mapping[root]))
    for row in rows:
        if row["ordering"] == "dbg":
            ga = ells["dbg_w"] if row["app"] == "sssp" else ells["dbg"]
            t, _ = warm_median(lambda: fns[row["app"]](ga))
            row.update({f"again_{k}": x for k, x in t.items()})
            log(f"    dbg {row['app']} again, after the other orderings: "
                f"{_span(t)} s (first {_span(row)})")
    return rows, tables


def _traced_pagerank(tr, fn, ga, want):
    """One PageRank run on ``ga`` with the counters installed and tracing
    on (``tr`` already holds the backend's ``engine.build_backend`` span),
    saved to a temporary file and loaded back through ``load_trace``: the
    output bitwise equal to ``want``, one ``edge_map`` counter event per
    pass.  Returns the trace's event count."""
    import os
    import tempfile

    from repro_torch.obs import MetricsRegistry, counters, load_trace
    from repro_torch.obs import trace as obs_trace

    obs_trace.enable(tr)
    c = counters.install(registry=MetricsRegistry())
    try:
        out = fn(ga)
    finally:
        counters.uninstall()
        obs_trace.disable()
    _sync()
    if not _same(out, want):
        raise AssertionError("the traced PageRank's output differs (must be "
                             "bitwise)")
    passes = sum(v for k, v in c.summary().items()
                 if k.startswith("edge_map.passes."))
    with tempfile.TemporaryDirectory() as d:
        events = load_trace(tr.save(os.path.join(d, "trace.json")))[
            "traceEvents"]
    builds = [e for e in events
              if e["ph"] == "X" and e["name"] == "engine.build_backend"]
    samples = [e for e in events if e["ph"] == "C" and e["name"] == "edge_map"]
    if len(builds) != 1 or len(samples) != passes:
        raise AssertionError(f"trace: {len(builds)} engine.build_backend "
                             f"spans, {len(samples)} edge_map counter events "
                             f"for {passes} passes")
    log(f"    trace of one PageRank run: {len(events)} events, valid; the "
        f"build span {builds[0]['dur'] / 1e6:.2f} s, {len(samples)} counter "
        f"events = passes")
    return len(events)


# ---------------------------------------------------------------- phase 10
class ChurnStream:
    """The reference churn benchmark's update stream
    (``benchmarks/stream_churn.py``, ``ChurnStream``): inserts draw their
    endpoints preferentially by degree + 1, deletions uniformly over the
    current alive edges; ``weights`` draws insert weights uniform in
    [1, 16) from the same generator, as ``generators.with_weights`` does."""

    def __init__(self, g, insert_frac: float = 0.75, seed: int = 0):
        import numpy as np

        self.rng = np.random.default_rng(seed)
        self.insert_frac = insert_frac
        out_p = (g.out_degrees() + 1.0)
        in_p = (g.in_degrees() + 1.0)
        self._out_cum = np.cumsum(out_p / out_p.sum())
        self._in_cum = np.cumsum(in_p / in_p.sum())

    def _pick(self, cum, k):
        import numpy as np

        # clip: float rounding can leave cum[-1] a hair under 1.0
        idx = np.searchsorted(cum, self.rng.random(k))
        return np.minimum(idx, cum.shape[0] - 1).astype(np.int64)

    def next_batch(self, dg, batch_size: int):
        n_add = int(round(batch_size * self.insert_frac))
        n_del = batch_size - n_add
        add_src = self._pick(self._out_cum, n_add)
        add_dst = self._pick(self._in_cum, n_add)
        es, ed, _ = dg.alive_edges()
        idx = self.rng.choice(es.shape[0], size=min(n_del, es.shape[0]),
                              replace=False)
        return add_src, add_dst, es[idx], ed[idx]

    def inserts(self, n: int):
        """``n`` inserts alone, endpoints drawn as ``next_batch`` draws
        them."""
        return self._pick(self._out_cum, n), self._pick(self._in_cum, n)

    def weights(self, n: int):
        import numpy as np

        return self.rng.uniform(1.0, 16.0, size=n).astype(np.float32)


class _Timed:
    """Wraps ``name`` of ``module`` for the phase, for the functions that
    open no span of their own: each call synced at its end, its seconds
    (and, with ``keep``, its result) recorded.  Leaving the block raises if
    no call came through the wrapper (the call site moved)."""

    def __init__(self, module, name, keep=False):
        self.module, self.name, self.keep = module, name, keep
        self.fn = getattr(module, name)
        self.seconds, self.results, self.calls = [], [], 0

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        out = self.fn(*args, **kw)
        _sync()
        self.seconds.append(time.perf_counter() - t)
        self.calls += 1
        if self.keep:
            self.results.append(out)
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, exc_type, *exc):
        setattr(self.module, self.name, self.fn)
        if exc_type is None and not self.calls:
            raise AssertionError(f"{self.module.__name__}.{self.name} was "
                                 "never called through its timer")

    def take(self):
        """Seconds since the last ``take`` (summed), and the results."""
        s, r = sum(self.seconds), self.results
        self.seconds, self.results = [], []
        return s, r


def _median_span(xs):
    import statistics

    return dict(median=statistics.median(xs), min=min(xs), max=max(xs))


def _span_seconds(events):
    """Seconds of each complete span among trace ``events``, summed by name."""
    out = {}
    for e in events:
        if e["ph"] == "X":
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return out


def _stream_service(gw, root, device):
    """The stream service of phase 10 (``STREAM_CONFIG``) on ``gw``, with
    the reference's ``_on_apply`` hook feeding two more consumers on its
    ``DeltaGraph``: an unfused ``IncrementalPageRank`` and a fused
    ``IncrementalSSSP`` from ``root``.  Their folds are not the
    deployment's work: ``on_apply_s`` holds the last batch's seconds of
    them.  Returns the service and the seconds of its ``DeltaGraph`` and
    of the rest of its construction."""
    from repro_torch.stream import (IncrementalPageRank, IncrementalSSSP,
                                    StreamConfig, StreamService)
    from repro_torch.stream import service as service_mod

    class Service(StreamService):
        def __init__(self, g, config):
            super().__init__(g, config, device=device)
            self.pr_flat = IncrementalPageRank(
                self.dg, damping=config.damping, epsilon=config.pr_epsilon,
                max_iters=config.pr_max_iters, device=device)
            self.sssp_fused = IncrementalSSSP(self.dg, root,
                                              use_fused_push=True,
                                              device=device)
            self.on_apply_s = 0.0

        def _on_apply(self, result):
            t = time.perf_counter()
            self.pr_flat.ingest(result)
            self.sssp_fused.ingest(result)
            self.on_apply_s = time.perf_counter() - t

    t0 = time.perf_counter()
    with _Timed(service_mod, "DeltaGraph") as made:
        svc = Service(gw, StreamConfig(**STREAM_CONFIG))
    total = time.perf_counter() - t0
    return svc, made.seconds[0], total - made.seconds[0]


def stream_plane(gw, root, device):
    """The streaming plane at the main path's size: phase 4's weighted DBG
    graph under ``STREAM_SIZES`` x ``STREAM_BATCHES`` batches of the
    reference churn benchmark's traffic, then one batch of
    ``STREAM_INSERT_ONLY`` inserts, all on one service, the fused PageRank
    and SSSP on K5 over the base+delta tiles beside the unfused
    edge-parallel ones; checked and timed per batch.  Apply, regroup,
    compaction and the service's own folds are read from its spans.
    Returns the ``stream`` JSON record and K5's launches over the drive."""
    import gc

    import numpy as np
    import torch

    from repro_torch import apps
    from repro_torch.obs import trace as obs_trace
    from repro_torch.stream import incremental

    v = gw.num_vertices
    # fused vs unfused PageRank: the reference's CPU band of 1e-8 at 2^21
    # vertices, held in units of the mean rank 1/V so that a smaller
    # rehearsal keeps its meaning
    pr_band = 1e-8 * 2**21 / v
    out = dict(vertices=v, edges=gw.num_edges, config=STREAM_CONFIG,
               root=root, sizes=list(STREAM_SIZES), batches=STREAM_BATCHES,
               insert_only=STREAM_INSERT_ONLY, pr_band=pr_band)
    timers = [_Timed(incremental, "stream_push_tiles", keep=True),
              _Timed(incremental, "refresh_alive"),
              _Timed(incremental, "coo_tiles")]
    push_tiles, alive_t, coo_t = timers

    def tile_parts(rec):
        """The alive refresh's and ``coo_tiles``' seconds since the last
        call, added into ``rec``."""
        for key, tm in (("alive_s", alive_t), ("coo_s", coo_t)):
            rec[key] = rec.get(key, 0.0) + tm.take()[0]

    def refresh(fn, passes, fused):
        """One consumer's refresh ``fn()``: its result, seconds, K5
        launches and ``stream_push_tiles`` seconds; a fused refresh's
        launches must equal ``passes()`` x the launches per pass over the
        tiles it rode, an unfused one launches none."""
        n0 = _ell_launches()
        t = time.perf_counter()
        res = fn()
        _sync()
        dt = time.perf_counter() - t
        launches = _ell_launches() - n0
        tiles_s, tiles = push_tiles.take()
        if fused:
            want = sum(passes() * _k5_launches_per_pass(b + d)
                       for b, d in tiles)
            if len(tiles) > 1 or launches != want:
                raise AssertionError(f"fused refresh: {launches} K5 launches "
                                     f"for {passes()} passes over "
                                     f"{len(tiles)} tile sets (want {want})")
        elif launches or tiles:
            raise AssertionError(f"unfused refresh launched K5 {launches}x")
        return res, dt, launches, tiles_s

    def pr_gap(label):
        """max|fused - unfused PageRank|, held to ``pr_band``."""
        gap = float(np.abs(svc.pr.rank - svc.pr_flat.rank).max())
        if not gap <= pr_band:
            raise AssertionError(f"{label}: fused PageRank {gap} from unfused "
                                 f"(band {pr_band:.3g})")
        return gap

    def full_check(label, last=False):
        """PageRank (and after the last batch SSSP) recomputed on ``flat``
        of the current snapshot, against the fused consumers."""
        t = time.perf_counter()
        snap = svc.snapshot()
        ga = apps.to_arrays(snap, backend="flat", device=device)
        full, it = apps.pagerank(ga, tol=1e-10, max_iters=256)
        full = full.cpu().numpy()
        gap = float(np.abs(svc.pr.rank - full).max())
        if not gap <= 1e-5:
            raise AssertionError(f"{label}: fused PageRank {gap} from a full "
                                 "recompute (band 1e-5)")
        rec = dict(pagerank_gap=gap, pagerank_iters=int(it))
        if last:
            d, _ = apps.sssp(ga, root)
            if not np.array_equal(svc.sssp_fused.dist, d.cpu().numpy()):
                raise AssertionError(f"{label}: fused SSSP differs from a "
                                     "full recompute (must be bitwise)")
            rec["sssp_bitwise"] = True
        del ga, snap
        gc.collect()
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t
        log(f"  {label}: fused PageRank within {gap:.3g} of a full recompute "
            f"on flat ({it} iterations, tol 1e-10)"
            + ("; fused SSSP bitwise equal to apps.sssp" if last else "")
            + f" ({rec['seconds']:.1f} s)")
        return rec

    def batch(size, draw_s, a_s, a_d, a_w, d_s=None, d_d=None):
        """One ingest and every consumer's refresh, checked; its record.
        ``ingest_s`` is the deployment's: ``IngestStats.total_seconds``
        less the comparison consumers' folds (``extra_folds_s``)."""
        n0 = len(tr.events)
        st = svc.ingest(add_src=a_s, add_dst=a_d, add_w=a_w,
                        del_src=d_s, del_dst=d_d)
        spans = _span_seconds(tr.events[n0:])
        ingest_s = st.total_seconds - svc.on_apply_s
        rec = dict(size=size, batch=st.batch_index, draw_s=draw_s,
                   apply_s=st.apply_seconds, folds_s=spans["stream.refresh"],
                   regroup_s=st.regroup_seconds,
                   moved=st.moved_vertices, compacted=st.compacted,
                   ingest_s=ingest_s,
                   edges_per_s=(st.inserted + st.deleted) / ingest_s,
                   extra_folds_s=svc.on_apply_s,
                   ingest_total_s=st.total_seconds)
        if st.compacted:
            # the service resynced its own PageRank; the unfused consumer
            # sheds its noise the same way
            svc.pr_flat.resync()
            rec["compact_s"] = spans["stream.compact"]
        resync = svc.pr._needs_full_residual
        (_, rec["pr_fused_s"], rec["pr_fused_launches"],
         pr_tiles_s) = refresh(
            svc.pagerank, lambda: svc.pr.last_iters + resync, True)
        rec["pr_fused_iters"] = svc.pr.last_iters
        _, rec["pr_flat_s"], _, _ = refresh(svc.pr_flat.query, None, False)
        rec["pr_flat_iters"] = svc.pr_flat.last_iters
        d_u, rec["sssp_flat_s"], _, _ = refresh(lambda: svc.sssp(root), None,
                                                False)
        (d_f, rec["sssp_fused_s"], rec["sssp_fused_launches"],
         sssp_tiles_s) = refresh(svc.sssp_fused.query,
                                 lambda: svc.sssp_fused.last_iters, True)
        rec["tiles_s"] = pr_tiles_s + sssp_tiles_s
        rec["sssp_iters"] = svc.sssp_fused.last_iters
        rec["sssp_full"] = svc.sssp_fused.full_recomputes
        tile_parts(rec)
        if not np.array_equal(d_u, d_f):
            raise AssertionError(f"batch {st.batch_index}: fused SSSP "
                                 "differs from unfused (bitwise)")
        if svc._sssp[root].full_recomputes != rec["sssp_full"]:
            raise AssertionError("SSSP consumers recomputed apart")
        gap = pr_gap(f"batch {st.batch_index}")
        rec.update(pr_gap=gap, pr_gap_v=gap * v)
        log(f"    batch {st.batch_index} ({size} edges): ingest "
            f"{rec['ingest_s']:.3f} s (apply {rec['apply_s']:.3f}, folds "
            f"{rec['folds_s']:.3f}, regroup {rec['regroup_s']:.3f}, "
            f"{rec['moved']} moved"
            + (f", compaction {rec['compact_s']:.2f}" if st.compacted else "")
            + f"; the comparison consumers' folds {rec['extra_folds_s']:.3f} "
            f"apart); tiles {rec['tiles_s']:.3f} s (alive "
            f"{rec['alive_s']:.3f}, coo {rec['coo_s']:.4f}); "
            f"PageRank fused {rec['pr_fused_s']:.3f} s "
            f"({rec['pr_fused_iters']} pushes"
            + (" + the resync pull" if resync else "")
            + f", {rec['pr_fused_launches']} K5 launches), unfused "
            f"{rec['pr_flat_s']:.3f} s ({rec['pr_flat_iters']}), "
            f"max|d| {gap:.3g} (x V {gap * v:.3g}; band {pr_band:.3g}); SSSP "
            f"fused "
            f"{rec['sssp_fused_s']:.3f} s ({rec['sssp_iters']} "
            f"iterations, {rec['sssp_fused_launches']} launches), "
            f"unfused {rec['sssp_flat_s']:.3f} s, bitwise equal; "
            f"full SSSP recomputes so far {rec['sssp_full']}")
        return rec

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    svc, dg_s, rest_s = _stream_service(gw, root, device)
    out.update(delta_graph_s=dg_s, service_rest_s=rest_s)
    log(f"  service: DeltaGraph {dg_s:.1f} s, IncrementalDBG and consumers "
        f"{rest_s:.1f} s; StreamConfig {STREAM_CONFIG}")
    stream = ChurnStream(gw, insert_frac=STREAM_INSERT_FRAC, seed=3)
    for tm in timers:
        tm.__enter__()
    tr = obs_trace.enable()
    _reset_launches()
    try:
        # the cold solves (the fused PageRank's first refresh is the resync
        # pull, then the pushes)
        cold = {}
        (_, cold["pr_fused_s"], cold["pr_fused_launches"],
         cold["pr_fused_tiles_s"]) = refresh(
            svc.pagerank, lambda: svc.pr.last_iters + 1, True)
        cold["pr_fused_iters"] = svc.pr.last_iters
        _, cold["pr_flat_s"], _, _ = refresh(svc.pr_flat.query, None, False)
        cold["pr_flat_iters"] = svc.pr_flat.last_iters
        d_u, cold["sssp_flat_s"], _, _ = refresh(lambda: svc.sssp(root),
                                                 None, False)
        d_f, cold["sssp_fused_s"], _, _ = refresh(
            svc.sssp_fused.query, lambda: svc.sssp_fused.last_iters, True)
        cold["sssp_iters"] = svc.sssp_fused.last_iters
        tile_parts(cold)
        if not np.array_equal(d_u, d_f):
            raise AssertionError("cold SSSP: fused differs from unfused")
        gap = pr_gap("cold PageRank")
        cold["pr_fused_vs_flat"] = gap
        out["cold"] = cold
        log(f"  cold solves: PageRank fused {cold['pr_fused_s']:.3f} s "
            f"({cold['pr_fused_iters']} pushes + the resync pull, "
            f"{cold['pr_fused_launches']} K5 launches), unfused "
            f"{cold['pr_flat_s']:.3f} s ({cold['pr_flat_iters']} pushes), "
            f"max|d| {gap:.3g} (band {pr_band:.3g}); SSSP unfused "
            f"{cold['sssp_flat_s']:.3f} s, "
            f"fused {cold['sssp_fused_s']:.3f} s ({cold['sssp_iters']} "
            f"iterations), bitwise equal; the tiles built in "
            f"{cold['pr_fused_tiles_s']:.2f} s")

        records, checks, push_device = [], [], None
        for size in STREAM_SIZES:
            for i in range(STREAM_BATCHES):
                t = time.perf_counter()
                a_s, a_d, d_s, d_d = stream.next_batch(svc.dg, size)
                a_w = stream.weights(a_s.shape[0])
                records.append(batch(size, time.perf_counter() - t,
                                     a_s, a_d, a_w, d_s, d_d))
                if size == STREAM_SIZES[-1] and i == STREAM_BATCHES - 2:
                    # before the compacting batch, while the delta is full;
                    # its launches and tiles are not the drive's
                    counts = _read_launches()
                    push_device = _stream_push_device(svc.dg, device)
                    for name, (fn, _, _) in _wrappers().items():
                        fn.launches = counts[name]
                    for tm in timers:
                        tm.take()
            if size != STREAM_SIZES[-1]:
                checks.append(full_check(f"after the {size}-edge series"))
        compacted = [r["batch"] for r in records if r["compacted"]]
        if compacted != [records[-1]["batch"]] or svc.compactions != 1:
            raise AssertionError(f"compactions at batches {compacted}: only "
                                 "the final batch must compact")
        # every churn batch deletes a tight edge, so each SSSP refresh above
        # is a full recompute; with no deletion both consumers relax from
        # the new edges alone
        t = time.perf_counter()
        a_s, a_d = stream.inserts(STREAM_INSERT_ONLY)
        a_w = stream.weights(a_s.shape[0])
        full0 = svc.sssp_fused.full_recomputes
        ins = batch(STREAM_INSERT_ONLY, time.perf_counter() - t, a_s, a_d,
                    a_w)
        if ins["sssp_full"] != full0 or not ins["sssp_iters"]:
            raise AssertionError(
                f"insert-only batch: {ins['sssp_full'] - full0} full SSSP "
                f"recomputes, {ins['sssp_iters']} relaxation iterations "
                "(want 0 and at least 1)")
        checks.append(full_check(f"after the {STREAM_SIZES[-1]}-edge series "
                                 "and the insert-only batch", last=True))
        stream_launches = _read_launches()
    finally:
        obs_trace.disable()
        for tm in timers:
            tm.__exit__(sys.exc_info()[0])
    t = time.perf_counter()
    loc = svc.locality()
    loc_s = time.perf_counter() - t
    out.update(records=records, insert_only_batch=ins, checks=checks,
               push_device=push_device, locality=loc, locality_s=loc_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=stream_launches)
    out["series"] = {}
    for size in STREAM_SIZES:
        rs = [r for r in records if r["size"] == size]
        out["series"][size] = ser = {k: _median_span([r[k] for r in rs])
                                     for k in STREAM_KEYS}
        log(f"  {size}-edge series, median [min-max] of {len(rs)} batches: "
            + "; ".join(f"{k} {ser[k]['median']:.4g} [{ser[k]['min']:.4g}-"
                        f"{ser[k]['max']:.4g}]" for k in STREAM_KEYS))
    last = records[-1]
    log(f"  compaction (batch {last['batch']}): {last['compact_s']:.2f} s; "
        f"the resync refresh {last['pr_fused_s']:.2f} s (tiles rebuilt in "
        f"{last['tiles_s']:.2f} s); insert-only batch: SSSP relaxed in "
        f"{ins['sssp_iters']} iterations, fused {ins['sssp_fused_s']:.3f} s, "
        f"unfused {ins['sssp_flat_s']:.3f} s, no full recompute; locality() "
        f"{loc_s:.1f} s: MPKA "
        + "; ".join(f"{k} " + ", ".join(f"{lv} {x:.2f}" for lv, x in m.items())
                    for k, m in loc.items()))
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _stream_push_device(dg, device):
    """One fused push (base + delta, sum, ``init``) and one unfused push of
    the same function on the device alone, each checked twice bitwise and
    against each other in the sum band, beside the fused push's bound (the
    real lanes' bytes at ``HBM_BYTES_PER_S``, or its operations if more;
    ``padded_bound_ms`` prices ``fused_edge_map_bytes``' padded planes).
    ``x`` is a PageRank contribution (``rand / out-degree``), ``init`` of
    the same order, so every row's value stands above the band."""
    import torch

    from repro_torch.kernels.edge_map import fused_edge_map_bytes
    from repro_torch.stream import incremental

    base, delta = incremental.stream_push_tiles(dg, device=device)
    sa = incremental.stream_arrays(dg, device)
    v = dg.num_vertices
    gen = torch.Generator(device=device).manual_seed(4)
    out_deg = torch.from_numpy(dg.out_deg).to(device).clamp(min=1)
    x = torch.rand(v, generator=gen, device=device) / out_deg
    init = torch.rand(v, generator=gen, device=device)

    def fused():
        return incremental.edge_map_push_stream_fused(base, delta, x, v,
                                                      init=init)

    def flat():
        return incremental.edge_map_push_stream(sa, x, init=init)

    n0 = _ell_launches()
    a = fused()
    launches = _ell_launches() - n0
    b, c, d = fused(), flat(), flat()
    if not (torch.equal(a, b) and torch.equal(c, d)):
        raise AssertionError("a stream push differs between two calls")
    err = _assert_close(a, c, "sum", "fused vs unfused stream push")
    band = 2e-6 * (1.0 + float(c.abs().max()))
    padded = fused_edge_map_bytes(base, v, push_init=True, extra_tiles=delta)
    edges = sum(int(t.deg.sum()) for t in base + delta)
    # what K5 must move at the least: the real lanes' ids and alive bytes,
    # deg, init and y per row, x once
    real = v * 4 + sum(int(t.deg.sum()) * (t.idx.element_size() + 1)
                       + t.idx.shape[0] * 12 for t in base + delta)
    bound_bytes_ms = real / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = edges / FP32_OPS_PER_S * 1e3
    rec = dict(
        launches=launches, delta_rows=int(delta[0].num_rows) if delta else 0,
        delta_shape=tuple(delta[0].idx.shape) if delta else None,
        delta_edges=int(delta[0].deg.sum()) if delta else 0,
        base_classes=len(base), max_abs_err=err, band=band,
        min_abs_y=float(c.abs().min()), max_abs_y=float(c.abs().max()),
        fused_device_ms=_events_ms(fused, REPS, device_only=True),
        flat_device_ms=_events_ms(flat, REPS, device_only=True),
        fused_ms=_events_ms(fused, REPS), flat_ms=_events_ms(flat, REPS),
        bound_ms=max(bound_bytes_ms, bound_ops_ms),
        bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        bound_bytes=real, padded_bound_ms=padded / HBM_BYTES_PER_S * 1e3,
        padded_bytes=padded)
    log(f"  one push on the device alone (base {len(base)} classes with "
        f"alive planes + a delta tile {rec['delta_shape']}, "
        f"{rec['delta_edges']} lanes; {launches} K5 launches): fused "
        f"{rec['fused_device_ms']:.4f} ms (idle device "
        f"{rec['fused_ms']:.4f}), unfused {rec['flat_device_ms']:.4f} ms "
        f"(idle {rec['flat_ms']:.4f}), bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: {real} B over the real lanes, {edges} edges; "
        f"{rec['padded_bound_ms']:.4f} ms over the padded planes, {padded} "
        f"B); both twice bitwise, max |err| {err:.3g} against a band of "
        f"{band:.3g} (|y| {rec['min_abs_y']:.3g} to {rec['max_abs_y']:.3g})")
    return rec


# ---------------------------------------------------------------- phase 11
def _zipf_tokens(vocab_size, batch, seq_len):
    """(batch, seq_len) int32 ids of the port's ``ZipfPipeline`` (seed 0),
    remapped through DBG over the pipeline's own token frequencies, and the
    reordering."""
    from repro_torch.core.vocab import reorder_vocab
    from repro_torch.data import DataConfig, ZipfPipeline

    base = ZipfPipeline(DataConfig(vocab_size=vocab_size, seq_len=seq_len,
                                   batch_size=batch, seed=0))
    vm = reorder_vocab(base.frequencies())
    return ZipfPipeline(base.cfg, vocab_map=vm).batch(0)["tokens"], vm


def _bitwise(got, want, what):
    """Raise unless equal bit for bit; return the measured max |err| (0)."""
    import torch

    if not torch.equal(got, want):
        bad = int((got != want).any(dim=-1).sum())
        raise AssertionError(f"{what}: {bad} rows differ (must be bitwise)")
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def k2_grid(device):
    """K2 against its plain version, both entry points, float32 and
    bfloat16, at reduced and at Yi-9B widths, int32 and int64 ids,
    contiguous and strided.  Returns (cases, max |err|)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.gather_embed import (hot_gather, hot_gather_ref,
                                                  split_gather_ref)
    from repro_torch.lm.embed import EmbedDims

    full = get_config(LM_ARCH)
    zipf, _ = _zipf_tokens(full.vocab_size, 1, K2_ZIPF_T)
    zipf = torch.from_numpy(zipf.reshape(-1)).to(device)
    gen = torch.Generator(device=device).manual_seed(6)
    cases, err = 0, 0.0
    for cfg in (reduced(full), full):
        dims = EmbedDims(cfg.vocab_size, cfg.d_model, cfg.hot_vocab_rows)
        h, c, d = dims.hot_rows, dims.cold_rows, dims.d_model
        table = torch.randn((h + c, d), generator=gen, device=device)
        uniform = torch.randint(-2, h + c + 64, (K2_ZIPF_T,), generator=gen,
                                device=device, dtype=torch.int32)
        pair = torch.stack([uniform, zipf], dim=1)  # columns of stride 2
        ids = {"zipf": zipf.clamp(max=h + c - 1), "uniform": uniform,
               "ragged": zipf[:1000], "all_hot": zipf.clamp(0, h - 1),
               "all_cold": zipf.clamp(h, h + c - 1),
               "int64": uniform.long(), "strided": pair[:, 0],
               "int64_strided": pair.long()[:, 1]}
        for dtype, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            t = table.to(dtype)
            hot, cold = t[:h], t[h:]
            for what, b in ids.items():
                label = (f"K2 {what} T={b.shape[0]} H={h} C={c} D={d} "
                         f"{dtype}")
                err = max(err, _bitwise(hot_gather(b, hot, cold),
                                        split_gather_ref(hot, cold, b),
                                        label + " split"),
                          _bitwise(hot_gather(b, hot), hot_gather_ref(b, hot),
                                   label + " hot-only"))
                cases += 2
            del t, hot, cold
        del table
    _sync()
    return cases, err


# ---------------------------------------------------------------- phase 12
def lm_parity(device):
    """Reduced Yi-9B (GQA) and OLMo-1B, the same weights on the CPU and the
    card: greedy tokens equal, every step's logits within rtol 1e-4, atol
    1e-5.  Returns the worst share of that band used."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.lm.model import init_params
    from repro_torch.lm.serve import generate

    worst = 0.0
    for arch, kw in (("yi_9b", dict(n_kv_heads=2)), ("olmo_1b", {})):
        cfg = reduced(get_config(arch), **kw)
        model = init_params(cfg, seed=0, device="cpu")
        prompt = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1))
        want, want_lg = generate(model, prompt, max_new=8, return_logits=True)
        got, got_lg = generate(model.to(device), prompt.to(device), max_new=8,
                               return_logits=True)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{arch}: card and CPU tokens differ")
        for step, (a, b) in enumerate(zip(got_lg, want_lg)):
            used = float(((a.cpu() - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
            if not used <= 1.0:
                raise AssertionError(f"{arch} step {step}: logits off by "
                                     f"{used:.3g}x the band (rtol 1e-4, "
                                     "atol 1e-5)")
            worst = max(worst, used)
        log(f"  {cfg.arch_id} reduced ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, norm "
            f"{cfg.norm}): {len(got_lg)} steps agree, tokens equal")
    return worst


# ---------------------------------------------------------------- phase 13
def lm_serve(device):
    """Yi-9B at full width serves LM_BATCH requests through ``generate``.
    Returns the model and what phase 14 and the ``kernels`` line need."""
    import statistics

    import torch

    import repro_torch.lm.model as model_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_embed import split_gather, split_gather_ref
    from repro_torch.lm.serve import generate

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_mod.init_params(cfg, seed=0, device=device)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens, vm = _zipf_tokens(cfg.vocab_size, LM_BATCH, LM_PROMPT)
    prompt = torch.from_numpy(tokens).to(device)
    hot_share = float((prompt < cfg.hot_vocab_rows).float().mean())
    if not 0.0 < hot_share < 1.0:
        raise AssertionError(f"prompt hot share {hot_share}: hot and cold "
                             "ids must both occur")
    log(f"  {cfg.arch_id}: {n_params} parameters (float32) on the card in "
        f"{init_s:.1f} s; prompt ({LM_BATCH}, {LM_PROMPT}) from the "
        f"DBG-remapped Zipf pipeline, {hot_share:.4f} of its ids below "
        f"hot_vocab_rows {cfg.hot_vocab_rows} (DBG's own hot set: "
        f"{vm.hot_rows} rows, {vm.coverage:.4f} of the mass)")

    t0 = time.perf_counter()
    generate(model, prompt, max_new=LM_NEW)  # first call: cuBLAS set-up
    _sync()
    first_s = time.perf_counter() - t0

    events = []
    plain_step = model_mod.decode_step

    def timed_step(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = plain_step(*args)
        b.record()
        events.append((a, b))
        return out

    _reset_launches()
    model_mod.decode_step = timed_step
    try:
        t0 = time.perf_counter()
        out, logits = generate(model, prompt, max_new=LM_NEW,
                               return_logits=True)
        _sync()
        gen_s = time.perf_counter() - t0
    finally:
        model_mod.decode_step = plain_step
    launches = _read_launches()
    steps = len(events)
    if launches["hot_gather"] != steps or steps != LM_PROMPT + LM_NEW:
        raise AssertionError(f"K2 launched {launches['hot_gather']} times "
                             f"over {steps} decode steps")
    others = {k: n for k, n in launches.items() if k != "hot_gather" and n}
    if others:
        raise AssertionError(f"graph kernels launched on the LM path: {others}")
    if not (int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size):
        raise AssertionError("generated ids outside the vocabulary")
    if not bool(torch.isfinite(logits[-1]).all()):
        raise AssertionError("last logits not finite")
    ms = [a.elapsed_time(b) for a, b in events]
    decode_ms = statistics.median(ms[LM_PROMPT:])
    prefill_ms = statistics.median(ms[:LM_PROMPT])
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        ids = out.reshape(-1)
        hot, cold = model.embed["hot"], model.embed["cold"]
        err = _bitwise(split_gather(hot, cold, ids),
                       split_gather_ref(hot, cold, ids),
                       "K2 on the served ids")
    served = LM_BATCH * (LM_PROMPT + LM_NEW)
    log(f"  generate: {gen_s:.3f} s per call (first call {first_s:.3f} s), "
        f"{steps} decode_step calls, decode step {decode_ms:.3f} ms "
        f"(median of {LM_NEW}; prefill steps {prefill_ms:.3f} ms), "
        f"{LM_BATCH / decode_ms * 1e3:.1f} decode tokens/s, {served / gen_s:.1f}"
        f" tokens/s over the call; peak device memory {peak / 2**30:.2f} GiB; "
        f"K2 launches {launches['hot_gather']}; K2 on the served ids bitwise "
        "equal to the plain version")
    return model, out, dict(
        launches=launches, gen_s=gen_s, first_s=first_s, decode_ms=decode_ms,
        prefill_ms=prefill_ms, peak_gib=peak / 2**30, hot_share=hot_share,
        max_abs_err=err, n_params=n_params)


def profile_decode_step(model, tokens):
    """One full-width decode step under ``torch.profiler``: its wall time
    (CUDA events), the device time of every kernel, summed by name (one
    stream, so the sum is the device's busy time), and the launch count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.lm.model as model_mod

    cache = model_mod.init_cache(model.cfg, tokens.shape[0], 2,
                                 device=tokens.device, dtype=torch.float32)
    model_mod.decode_step(model, cache, tokens[:, :1])  # warm
    _sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings():  # "Profiler clears events at the end..."
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a.record()
            model_mod.decode_step(model, cache, tokens[:, 1:2])
            b.record()
            _sync()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(step_ms=a.elapsed_time(b),
                busy_ms=sum(ms for _, ms in by_name.values()),
                launches=sum(n for n, _ in by_name.values()),
                top=[(name[:90], n, ms) for name, (n, ms) in top[:8]])


# ---------------------------------------------------------------- phase 14
def _host_us(fn, n=1000):
    """Host microseconds per ``fn()`` over ``n`` calls issued with no sync
    between them: what the caller's thread spends to issue one call."""
    fn()
    _sync()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    _sync()
    return dt / n * 1e6


def _device_ops(calls, tries=3):
    """The device activities (kernels, copies, fills) of one call of each
    function in ``calls`` (name → fn), after a warm call of each, under
    ``torch.profiler``.  The profiler on the card's machine can drop device
    events from a session, and its device timestamps can drift from the
    host's.  So each call runs in its own ``record_function`` range; a
    device event belongs to the range that holds, on the host's clock, the
    CUDA runtime call that launched it (the two share a correlation id);
    and the session runs again, up to ``tries`` times, until two sessions
    agree, keeping each call's longest list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in calls.values():
        fn()
    _sync()
    tag = "chip_smoke:"
    best = {name: [] for name in calls}
    for _ in range(tries):
        with warnings.catch_warnings():  # "Profiler clears events at..."
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for name, fn in calls.items():
                    with record_function(tag + name):
                        fn()
                        _sync()
        events = prof.events()
        device = {e.id: e.name[:60] for e in events
                  if e.device_type == DeviceType.CUDA}
        ranges = [(e.time_range, e.name[len(tag):]) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith(tag)]
        got = {name: [] for name in calls}
        for e in sorted(events, key=lambda e: e.time_range.start):
            if (e.device_type == DeviceType.CPU and e.name.startswith("cu")
                    and e.id in device):
                for r, name in ranges:
                    if r.start <= e.time_range.start <= r.end:
                        got[name].append(device[e.id])
        stable = got == best
        for name, ops in got.items():
            if len(ops) > len(best[name]):
                best[name] = ops
        if stable:
            break
    return best


def time_k2(model, served, reps):
    """K2 at the decode call (the last step's LM_BATCH ids) and at K2_ZIPF_T
    Zipf ids, against its plain version and ``F.embedding`` over the
    joined table (built once, outside the timed region), each from an idle
    device (``ms``) and on the device alone (``device_ms``); and the host
    time of one call at the decode call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.gather_embed import hot_gather, split_gather_ref

    cfg = model.cfg
    with torch.no_grad():
        hot, cold = model.embed["hot"].detach(), model.embed["cold"].detach()
        table = torch.cat([hot, cold])
        zipf, _ = _zipf_tokens(cfg.vocab_size, 1, K2_ZIPF_T)
        calls = {"decode": served[:, -1].contiguous(),
                 "zipf": torch.from_numpy(zipf.reshape(-1)).to(hot.device)}
        out = {}
        for label, ids in calls.items():
            n0 = hot_gather.launches
            got = hot_gather(ids, hot, cold)
            per_call = hot_gather.launches - n0
            err = max(_bitwise(got, split_gather_ref(hot, cold, ids),
                               f"timed K2 ({label}) vs plain"),
                      _bitwise(got, F.embedding(ids, table),
                               f"timed K2 ({label}) vs F.embedding"))
            # The least traffic: each distinct row read once, each output
            # row written once, the ids read once.
            t, d = ids.shape[0], hot.shape[1]
            rows = int(torch.unique(ids).numel())
            row_bytes = d * hot.element_size()
            bound_ms, bound_by = _bound((rows + t) * row_bytes + t * 4, 0)

            def kernel(ids=ids):
                return hot_gather(ids, hot, cold)

            def library(ids=ids):
                return F.embedding(ids, table)

            out[label] = dict(
                distinct_rows=rows,
                bound_ms_t_rows=_bound(2 * t * row_bytes + t * 4, 0)[0],
                t=t, ms=_events_ms(kernel, reps),
                device_ms=_events_ms(kernel, reps, True),
                plain_ms=_events_ms(lambda: split_gather_ref(hot, cold, ids),
                                    reps),
                library_ms=_events_ms(library, reps),
                library_device_ms=_events_ms(library, reps, True),
                bound_ms=bound_ms, bound_by=bound_by,
                launches_per_call=per_call, max_abs_err=err)
        ids = calls["decode"]
        out["decode"]["host_us"] = _host_us(lambda: hot_gather(ids, hot, cold))
        out["decode"]["library_host_us"] = _host_us(
            lambda: F.embedding(ids, table))
        del table
    return out


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
    from repro_torch.kernels import _build, load_all
    from repro_torch.kernels.edge_map import ell_tiles
    from repro_torch.kernels.edge_map.edge_map import _SOURCE as K5_SOURCE
    from repro_torch.kernels.hist_bin import dbg_bin, hist_bin
    from repro_torch.kernels.hist_bin.hist_bin import (
        _SOURCE as HIST_BIN_SOURCE)
    from repro_torch.lm.embed import embed_lookup

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = torch.cuda.get_device_name(0)
    log(f"device: {card} ({smi}); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        extra = pool.submit(_build.load_many,
                            [(K5_SOURCE, NARROW_BUILDS),
                             (HIST_BIN_SOURCE, HIST_BIN_BUILDS)])
        load_all()
        narrow_builds, hist_builds = extra.result()
    log(f"build: K5, K4, K1, hist_bin (with the stable rank) and K2 "
        f"libraries, K5's sum {' and '.join(NARROW_BUILDS)} and hist_bin "
        f"{' and '.join(HIST_BIN_BUILDS)}, ready in "
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
    n1, e1, _ = variant_grid(small_tiles, small.num_vertices, dev, seed=0)
    n2, e2, twice = variant_grid(big_tiles, g_dbg.num_vertices, dev, seed=1)
    if twice == 0:
        raise AssertionError("the main-path graph has no class wider than "
                             "1,024 lanes to check twice")
    log(f"kernel vs plain: {n1} variants on kr/small "
        f"({[tuple(t.idx.shape) for t in small_tiles]}, "
        f"{small_tiles[0].idx.dtype}) and {n2} on the main-path graph's "
        f"classes ({[tuple(t.idx.shape) for t in big_tiles]}, int32 ids), "
        f"all rows, all agree; max |err| of sums {max(e1, e2):.3g}; "
        f"{twice} sums on the hub class bitwise equal over two calls "
        f"({time.perf_counter() - t0:.1f} s)")
    del big_tiles
    torch.cuda.empty_cache()

    # 4. the main path; the launch counts are read from zero
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    backends, runs, records = main_path(g, g_dbg, gw_dbg, dev)
    ell_path = _read_launches()
    log(f"main path: launches {ell_path}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    time_apps(runs, backends, records, {"ell": 1, "flat": 0})
    log(f"main path: warm medians of {EVAL_REPS} runs each, ell and flat "
        f"({time.perf_counter() - t0:.1f} s)")

    # 5. K5 times
    flat, ell = backends["dbg"]
    t = time_pull(flat, ell, REPS, narrow_builds)
    for c in t["per_class"]:
        hub = " (the hub class)" if c["segments"] is not None else ""
        line = (f"  class {c['shape']} {c['dtype']}{hub}: {c['edges']} edges, "
                f"longest row {c['max_deg']}, {c['group']} lanes per row, "
                f"{c['launches']} launch(es)")
        if c["segments"] is not None:
            line += (f", split into {c['segments']} segments: kernel "
                     f"{c['ms']:.4f} ms; a block per whole row "
                     f"{c['block_per_row_ms']:.4f} ms")
        else:
            line += (f", {c['lanes_per_thread']} lanes per thread: kernel "
                     f"{c['ms']:.4f} ms; " + ", ".join(
                         f"{n} {c[n + '_ms']:.4f}" for n in NARROW_BUILDS)
                     + " ms")
        log(line + f"; its share of the bound {c['bound_share_ms']:.4f} ms")
    log(f"timed pull: kernel {t['ms']:.4f} ms ({t['launches_per_call']} "
        f"launches; the device's time alone {t['device_ms']:.4f} ms), full fused_edge_map {t['fused_ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, cuSPARSE {t['library_ms']:.4f} ms (max |err| "
        f"vs flat {t['library_max_abs_err']:.3g}), bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_bytes']} B), padded-plane bound "
        f"{t['padded_bound_ms']:.4f} ms ({t['padded_bytes']} B)")
    log(json.dumps({"apps": records, "edges": g.num_edges,
                    "vertices": g.num_vertices, "k5_per_class": t["per_class"]}))
    ells = {key: b[1] for key, b in backends.items()}  # phase 9's
    del backends, flat, ell
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the packed path; the launch counts are read from zero
    t0 = time.perf_counter()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pk = packed_path(g, g_dbg, gw_dbg, res, dev)
    packed = _read_launches()
    idle = [k for k, n in packed.items() if n == 0 and k != "hot_gather"]
    if idle:
        raise AssertionError(f"packed path: {idle} never launched ({packed})")
    log(f"packed path: launches {packed}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    time_apps(pk["runs"], {key: (pk["packs"][key],) for key in pk["packs"]},
              pk["records"], {"packed": 0})
    log(f"packed path: warm medians of {EVAL_REPS} runs each "
        f"({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"packed_apps": pk["records"]}))
    for app, rec in records.items():
        p = pk["records"].get(app)
        log(f"app {app}, seconds per run (median [min-max] of {EVAL_REPS} "
            f"warm runs): ell {_span(rec, 'ell_')}, packed "
            + ("-" if p is None else _span(p, "packed_"))
            + f", flat {_span(rec, 'flat_')}")

    # 7. K4, K1 and hist_bin vs their plain versions
    t0 = time.perf_counter()
    err4, err1, widths, split = new_kernel_grid(pk, small, dev)
    if widths != {1, 2, 4}:
        raise AssertionError(f"K4 was checked on id widths {widths} bytes, "
                             "not on uint8, uint16 and uint32")
    if split == 0:
        raise AssertionError("no K4 table wider than 1,024 slots was checked")
    log(f"new kernels vs plain: all agree ({time.perf_counter() - t0:.1f} s)")

    # 8. their times
    t0 = time.perf_counter()
    k4, k1, hb = (time_hot_spmv(pk, REPS), time_ell_spmv(pk, REPS),
                  time_hist_bin(pk, REPS, hist_builds))
    for c in k4["per_table"]:
        split = ("" if c["segments"] is None
                 else f", split into {c['segments']} pieces")
        log(f"  K4 table {c['shape']} {c['dtype']}: {c['edges']} edges, "
            f"longest row {c['max_deg']}, {c['group']} lanes per row"
            f"{split}, {c['launches']} launch(es): {c['ms']:.4f} ms "
            f"(device alone {c['device_ms']:.4f})")
    log(f"timed K4 (pack_spmv's hot groups, {k4['rows']} rows, {k4['edges']} "
        f"edges): kernel {k4['ms']:.4f} ms (device alone "
        f"{k4['device_ms']:.4f}; {k4['launches_per_call']} launches per "
        f"call), plain {k4['plain_ms']:.4f} ms, cuSPARSE "
        f"{k4['library_ms']:.4f} ms (device alone "
        f"{k4['library_device_ms']:.4f}; max |err| vs K4 "
        f"{k4['library_max_abs_err']:.3g}), bound {k4['bound_ms']:.4f} ms")
    for shape, edges, lanes, ms, pms in k1["per_group"]:
        log(f"  K1 group {shape}: {edges} edges, degree walk {ms:.4f} ms "
            f"({lanes} lanes per row{', split' if lanes == 256 else ''}), "
            f"every lane {pms:.4f} ms")
    log(f"timed K1 (dbg_spmv, {k1['edges']} edges in {k1['lanes']} lanes): "
        f"degree walk {k1['ms']:.4f} ms (device alone "
        f"{k1['device_ms']:.4f}; {k1['launches_per_call']} launches), "
        f"every lane {k1['padded_ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
        f"cuSPARSE {k1['library_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
        f"(real lanes), {k1['padded_bound_ms']:.4f} ms (padded planes)")
    sr = hb["stable_rank"]
    log(f"timed hist_bin: kernel {hb['ms']:.4f} ms (device alone "
        f"{hb['device_ms']:.4f}), plain "
        f"{hb['plain_ms']:.4f} ms, searchsorted + bincount "
        f"{hb['library_ms']:.4f} ms (device alone "
        f"{hb['library_device_ms']:.4f}), bound {hb['bound_ms']:.4f} ms; "
        f"two-op build (memset + atomics, bitwise equal) "
        f"{hb['two_ops_ms']:.4f} ms (device alone "
        f"{hb['two_ops_device_ms']:.4f})")
    log(f"timed stable_rank: kernel {sr['ms']:.4f} ms (device alone "
        f"{sr['device_ms']:.4f}), plain {sr['plain_ms']:.4f} ms, argsort + "
        f"scatter_ {sr['library_ms']:.4f} ms (device alone "
        f"{sr['library_device_ms']:.4f}), bound {sr['bound_ms']:.4f} ms")
    log(f"timed device DBG (dbg_bin: hist_bin, then stable_rank): "
        f"{hb['dbg_bin_ms']:.4f} ms (device alone "
        f"{hb['dbg_bin_device_ms']:.4f}), plain "
        f"{hb['dbg_bin_plain_ms']:.4f} ms, searchsorted + argsort + scatter_ "
        f"{hb['dbg_bin_library_ms']:.4f} ms (device alone "
        f"{hb['dbg_bin_library_device_ms']:.4f}), bound "
        f"{hb['dbg_bin_bound_ms']:.4f} ms; host mapping (group_reorder) "
        f"{hb['host_mapping_ms']:.2f} ms ({time.perf_counter() - t0:.1f} s)")

    pk_err = pk["max_err"]
    deg_t, b_t = pk["deg_t"], pk["b_t"]  # phase 14 profiles dbg_bin on them
    del pk
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the paper's evaluation: every ordering x app on ell
    t0 = time.perf_counter()
    evals, tables = paper_eval(g, g_dbg, gw_dbg, res, ells, dev)
    log(f"paper evaluation: {len(EVAL_ORDERINGS)} orderings x "
        f"{len(evals) // len(EVAL_ORDERINGS)} apps, all checks hold "
        f"({time.perf_counter() - t0:.1f} s)")
    log(json.dumps({"paper_eval": evals, "tables": tables, "card": smi}))

    # 10. the streaming plane on phase 4's weighted DBG graph; the launch
    # counts are read from zero inside
    del ells
    gc.collect()
    torch.cuda.empty_cache()
    st = stream_plane(gw_dbg, 0, dev)  # the main path's SSSP root
    stream_path = st.pop("launches")
    if stream_path["ell_edge_map"] == 0:
        raise AssertionError("stream: K5 was never launched")
    log(f"streaming plane: launches {stream_path}; peak device memory "
        f"{st['peak_gib']:.2f} GiB ({st['seconds']:.1f} s)")
    log(json.dumps({"stream": st, "card": smi}))

    # 11. K2 vs plain, once the graph state has left the card
    del small_tiles, small, g, g_dbg, gw_dbg, res
    gc.collect()
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must not run in TF32")
    log("float32 matmuls: full float32 (torch.backends.cuda.matmul."
        "allow_tf32 = False)")
    t0 = time.perf_counter()
    n9, e9 = k2_grid(dev)
    log(f"K2 vs plain: {n9} cases "
        f"bitwise equal, max |err| {e9} "
        f"({time.perf_counter() - t0:.1f} s)")

    # 12. the LM serving path at reduced size, card against CPU
    t0 = time.perf_counter()
    used = lm_parity(dev)
    log(f"LM parity, card vs CPU: worst logit gap {used:.3g} of the band "
        f"({time.perf_counter() - t0:.1f} s)")

    # 13. the LM serving path at full width; counts read from zero inside
    t0 = time.perf_counter()
    model, served, lm = lm_serve(dev)
    prof = profile_decode_step(model, served)
    lm["profile"] = prof
    log(f"LM serving path: launches {lm['launches']} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"  one decode step under torch.profiler: {prof['step_ms']:.3f} ms "
        f"(CUDA events), device busy {prof['busy_ms']:.3f} ms "
        f"({prof['launches']} device launches)")
    for kname, n, ms in prof["top"]:
        log(f"    {ms:9.3f} ms  {n:4d} x  {kname}")

    # 14. K2's times
    t0 = time.perf_counter()
    k2 = time_k2(model, served, REPS)
    for label, m in k2.items():
        log(f"timed K2 ({label}, T={m['t']}, D={model.cfg.d_model} float32): "
            f"kernel {m['ms']:.4f} ms (device alone {m['device_ms']:.4f}), "
            f"plain {m['plain_ms']:.4f} ms, F.embedding "
            f"{m['library_ms']:.4f} ms (device alone "
            f"{m['library_device_ms']:.4f}), bound {m['bound_ms']:.5f}"
            f" ms ({m['bound_by']}; {m['distinct_rows']} distinct rows; "
            f"{m['bound_ms_t_rows']:.5f} ms if every row were read)")
    m = k2["decode"]
    log(f"  host time per call at the decode call (1,000 calls, no sync): "
        f"hot_gather {m['host_us']:.2f} us, F.embedding "
        f"{m['library_host_us']:.2f} us")
    # the device operations of what the serving loop passes to embed_lookup
    # (a prefill step's strided column of the prompt, a decode step's (B, 1)
    # greedy pick) and of hist_bin and dbg_bin at phase 8's call: all here,
    # after phase 13's session, as this process's profiler reads reliably
    prefill, decode = served[:, 1:2], served[:, -1:].contiguous()
    with torch.no_grad():
        ops = _device_ops({
            "prefill": lambda: embed_lookup(model.embed, prefill),
            "decode": lambda: embed_lookup(model.embed, decode),
            "hist_bin": lambda: hist_bin(deg_t, b_t),
            "dbg_bin": lambda: dbg_bin(deg_t, b_t)})
    want = {"prefill": 1, "decode": 1, "hist_bin": 1, "dbg_bin": 2}
    for what, names in ops.items():
        log(f"  one {what} call: {len(names)} device operation(s) {names}")
        if len(names) != want[what]:
            raise AssertionError(f"one {what} call made {len(names)} device "
                                 f"operations, not {want[what]}")
    lookups = {k: ops[k] for k in ("prefill", "decode")}
    hb["device_ops_per_call"] = len(ops["hist_bin"])
    hb["dbg_bin_device_ops_per_call"] = len(ops["dbg_bin"])
    log(f"K2 timings done ({time.perf_counter() - t0:.1f} s)")
    del model, deg_t, b_t
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"lm_serve": {k: v for k, v in lm.items()
                                 if k != "launches"},
                    "k2": k2, "embed_lookup_launches": lookups}))

    timed = {
        "ell_edge_map": dict(t, max_abs_err=max(e1, e2, t["max_abs_err"])),
        "hot_spmv": dict(k4, max_abs_err=max(err4, k4["max_abs_err"],
                                             pk_err["hot_spmv"])),
        "ell_spmv": dict(k1, max_abs_err=max(err1, k1["max_abs_err"],
                                             pk_err["ell_spmv"])),
        "hist_bin": hb,
        "stable_rank": hb["stable_rank"],
        "hot_gather": dict(k2["decode"], max_abs_err=max(
            e9, lm["max_abs_err"], k2["decode"]["max_abs_err"],
            k2["zipf"]["max_abs_err"]), at_zipf_8192=k2["zipf"]),
    }
    # K5 carries the main (ell) path, K2 the LM path, the others the packed one
    home = {"ell_edge_map": "ell", "hot_gather": "lm_serve"}
    kernels = []
    for kname, (_, source, replaces) in _wrappers().items():
        m = timed[kname]
        by_path = {"ell": ell_path[kname], "packed": packed[kname],
                   "stream": stream_path[kname],
                   "lm_serve": lm["launches"][kname]}
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": by_path[home.get(kname, "packed")],
            "launches_by_path": by_path,
            "launches_per_call": m["launches_per_call"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "library_device_ms": m["library_device_ms"],
        }
        if "dbg_bin_ms" in m:  # hist_bin: its caller, the device DBG
            for key in ("device_ops_per_call", "two_ops_ms",
                        "two_ops_device_ms", "dbg_bin_ms",
                        "dbg_bin_device_ms", "dbg_bin_bound_ms",
                        "dbg_bin_plain_ms", "dbg_bin_library_ms",
                        "dbg_bin_library_device_ms",
                        "dbg_bin_device_ops_per_call"):
                entry[key] = m[key]
        if kname == "ell_edge_map":  # one stream push, base + delta
            entry["stream_push"] = {k: st["push_device"][k] for k in (
                "fused_ms", "fused_device_ms", "flat_ms", "flat_device_ms",
                "bound_ms", "bound_by", "padded_bound_ms", "launches",
                "max_abs_err", "band")}
        if "padded_ms" in m:  # K1 without the degrees: every lane
            entry["padded_ms"] = m["padded_ms"]
            entry["padded_bound_ms"] = m["padded_bound_ms"]
        if "at_zipf_8192" in m:
            entry["at_zipf_8192"] = {k: m["at_zipf_8192"][k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by",
                "distinct_rows")}
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
