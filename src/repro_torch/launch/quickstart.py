"""Quickstart: the paper in a minute, on the port.

    python -m repro_torch.launch.quickstart [--graph mp] [--scale small]
        [--backend ell] [--device cpu]

The twin of the reference's ``examples/quickstart.py``.  It loads a
structured power-law registry graph, reorders it by every technique of the
DBG framework (Table V) and by ``gorder_lite``, runs PageRank on each
ordering with the edge-map counters installed, checks that the ranks are
invariant under the relabelling, and prints the cache model's MPKA and AMAT
of the pull trace beside the counters' passes and modeled bytes.  Runs on
the CUDA card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..apps import pagerank, to_arrays
from ..cachesim import (amat_cycles, mpka, property_trace, scaled_hierarchy,
                        stack_distances, to_blocks)
from ..core import reorder
from ..core.gorder_lite import gorder_lite
from ..device import resolve_device
from ..graph import csr, datasets
from ..obs import MetricsRegistry, counters

TECHNIQUES = ("original", "sort", "hubsort", "hubcluster", "dbg",
              "gorder_lite", "random_vertex")


def reordered(g: csr.Graph, technique: str):
    """``(graph, ReorderResult)`` of ``g`` under ``technique``: a DBG-family
    technique on out-degree, or ``gorder_lite`` (relabel time counted in
    ``seconds``, as ``reorder_graph`` does)."""
    if technique != "gorder_lite":
        return reorder.reorder_graph(g, technique, degree_source="out")
    res = gorder_lite(g)
    t0 = time.perf_counter()
    g2 = csr.relabel(g, res.mapping, name=f"{g.name}+{technique}")
    return g2, dataclasses.replace(
        res, seconds=res.seconds + time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="mp",
                    help="registry key (mp is structured, like MPI-Twitter)")
    ap.add_argument("--scale", default="small",
                    choices=sorted(datasets.SCALES))
    ap.add_argument("--backend", default="ell")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    g = datasets.load(args.graph, scale=args.scale)
    print(f"graph: {g.name}  V={g.num_vertices:,} E={g.num_edges:,} "
          f"avg_deg={g.avg_degree:.1f}  backend={args.backend} device={dev}")
    base_rank, iters = pagerank(to_arrays(g, backend=args.backend,
                                          device=dev))
    print(f"PageRank converged in {iters} iterations\n")

    levels = scaled_hierarchy(g.num_vertices)
    print(f"{'technique':14s} {'reorder_s':>9s} {'L1 MPKA':>8s} "
          f"{'L3 MPKA':>8s} {'AMAT cyc':>8s} {'passes':>6s} "
          f"{'model MB':>9s}  PR invariant?")
    all_same = True
    for tech in TECHNIQUES:
        g2, res = reordered(g, tech)
        ga2 = to_arrays(g2, backend=args.backend, device=dev)
        c = counters.install(registry=MetricsRegistry())
        try:
            rank2, _ = pagerank(ga2)
        finally:
            counters.uninstall()
        s = c.summary()
        passes = sum(v for k, v in s.items()
                     if k.startswith("edge_map.passes."))
        # invariance: rank of original vertex v == rank2 at its new id
        mapping = torch.from_numpy(res.mapping).to(dev)
        same = bool(torch.allclose(rank2[mapping], base_rank, atol=1e-5))
        all_same &= same
        d = stack_distances(to_blocks(property_trace(g2, "pull")))
        m = mpka(d, levels)
        print(f"{tech:14s} {res.seconds:9.4f} {m['l1_mpka']:8.1f} "
              f"{m['l3_mpka']:8.1f} {amat_cycles(d, levels):8.1f} "
              f"{passes:6d} {s.get('edge_map.model_bytes', 0) / 1e6:9.2f}  "
              f"{same}")

    print("\nExpected on a structured graph: DBG lowest AMAT; Sort reduces L3 "
          "misses but inflates L1 (paper Fig 8); random destroys everything.")
    if not all_same:
        raise SystemExit("PageRank is not invariant under a reordering")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
