"""Graph jobs: the paper's user reorders a skewed graph once with DBG, then
runs the Ligra-style apps on it again and again.

Set-up makes the configuration's graph on the device from the seed
(``bench.lib.inputs``), hands it to the program as host CSR arrays, and
times the program's own steps: ``reorder_graph`` (the ``reorder`` span) and
the backend build ``apps.to_arrays`` (the ``build`` span, synced).  A job
is one app call of ``repro_torch.apps`` on that backend; its roots and
sources are drawn in original ids and mapped through the program's
mapping.  The check works the DBG mapping and a sample of the window's
answers out again with the plain reference (``bench.reference``) and
compares them in original ids.

A configuration file names this system (``"system": "graph_jobs"``) and
gives the graph: ``generator`` (``"rmat"``), ``log2_vertices``,
``avg_degree``, the R-MAT ``a``, ``b``, ``c``, ``oversample``, the integer
edge weights ``weight_low`` to ``weight_high`` (made only where the mix
says ``"weighted": true``), and the program's ``ordering``, ``degree`` and
``backend``.  A mix's jobs take ``pagerank`` (``damping``, ``tol``),
``pagerank_delta`` (``damping``, ``epsilon``), ``sssp`` and ``bc``
(``root``) and ``radii`` (``sources``); a parameter may be drawn per job:
``{"draw": "vertex", "min_out_degree": 1}``, ``{"draw": "vertices",
"count": 8, "min_out_degree": 1}``, or scaled: ``{"per_vertex": x}`` is
``x / V``.
"""
from __future__ import annotations

import gc
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..lib import inputs, traffic, work
from ..reference import compare, graph as reference

__all__ = ["Problem", "Cell", "program_answer", "worst"]


class Problem:
    """The cell's inputs, made from the seed, and its jobs' draws: what the
    program and the reference are both handed."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device, spans):
        if config.get("generator") != "rmat":
            raise ValueError("graph_jobs makes R-MAT graphs only")
        self.device, self.seed, self.config, self.mix = (device, seed,
                                                         config, mix)
        v = 1 << int(config["log2_vertices"])
        e = int(round(config["avg_degree"] * v))
        with spans("inputs", sync=True):
            edges = inputs.rmat_edges(
                int(config["log2_vertices"]), e, a=config["a"],
                b=config["b"], c=config["c"],
                oversample=config["oversample"],
                gen=inputs.generator(seed, "graph", device), device=device)
            w = None
            if mix.get("weighted"):
                w = inputs.integer_weights(
                    e, int(config["weight_low"]), int(config["weight_high"]),
                    inputs.generator(seed, "weights", device), device)
            self.graph = inputs.make_graph(edges, w)
            del edges, w
        self.out_deg = self.graph.out_degrees()
        self._pools: Dict[int, np.ndarray] = {}

    # -- jobs -------------------------------------------------------------
    def _resolve(self, spec: dict, rng: np.random.Generator):
        v = self.graph.num_vertices
        if "per_vertex" in spec:
            return float(spec["per_vertex"]) / v
        least = int(spec.get("min_out_degree", 1))
        if least not in self._pools:  # drawn per job: kept, not rebuilt
            self._pools[least] = np.flatnonzero(self.out_deg >= least)
        pool = self._pools[least]
        if spec.get("draw") == "vertex":
            return int(pool[rng.integers(pool.shape[0])])
        if spec.get("draw") == "vertices":
            return [int(x) for x in rng.choice(pool, int(spec["count"]),
                                               replace=False)]
        raise ValueError(f"cannot resolve job parameter {spec}")

    def jobs(self, stream: str = "jobs"):
        """Endless ``(app, params)`` in original ids."""
        return traffic.jobs(self.mix, np.random.default_rng(
            inputs.derive_seed(self.seed, stream)), self._resolve)

    # -- what the reference is handed -----------------------------------
    def reference_edges(self) -> reference.Edges:
        out = self.graph.out_csr
        v, dev = self.graph.num_vertices, self.device
        src = torch.from_numpy(np.repeat(np.arange(v, dtype=np.int64),
                                         self.out_deg)).to(dev)
        dst = torch.from_numpy(out.indices.astype(np.int64)).to(dev)
        w = None if out.weights is None else torch.from_numpy(
            out.weights).to(dev)
        return reference.Edges(src, dst, w,
                               torch.from_numpy(self.out_deg).to(dev), v)

    def reference_mapping(self) -> np.ndarray:
        if (self.config["ordering"], self.config["degree"]) != ("dbg", "out"):
            raise ValueError("the reference knows DBG on out-degree only")
        return reference.dbg_mapping(self.out_deg)


class Cell(Problem):
    """The program on the problem: set-up, jobs, and the check."""

    def __init__(self, config: dict, mix: dict, check: dict, seed: int,
                 device: torch.device, spans):
        from repro_torch import apps
        from repro_torch.core.reorder import reorder_graph

        super().__init__(config, mix, seed, device, spans)
        if device.type == "cuda":  # the peak counts the program's state only
            torch.cuda.reset_peak_memory_stats(device)
        self.apps = apps
        self.sample_per_app = int(check["sample_per_app"])
        with spans("reorder"):
            g2, res = reorder_graph(self.graph, config["ordering"],
                                    degree_source=config["degree"])
        self.mapping = res.mapping
        with spans("build", sync=True):
            self.backend = apps.to_arrays(g2, backend=config["backend"],
                                          device=device)
        del g2
        v, e = self.graph.num_vertices, self.graph.num_edges
        self.sizes = {"pull_work_bytes": work.pull_bytes(v, e)}
        self.counters: Dict[str, float] = {"pagerank.pulls": 0}
        self.per_app: Dict[str, List[float]] = {}
        self._seen: Dict[str, int] = {}
        self._sample: Dict[str, list] = {}
        self._sample_rng = np.random.default_rng(
            inputs.derive_seed(seed, "sample"))

    def run(self, app: str, p: dict):
        """One job on the program: its answer, in the program's ids."""
        a, ga = self.apps, self.backend
        if app == "pagerank":
            return a.pagerank(ga, damping=p["damping"], tol=p["tol"])
        if app == "pagerank_delta":
            return a.pagerank_delta(ga, damping=p["damping"],
                                    epsilon=p["epsilon"])
        if app == "sssp":
            return a.sssp(ga, int(self.mapping[p["root"]]))
        if app == "bc":
            return a.bc(ga, int(self.mapping[p["root"]]))
        if app == "radii":
            return a.radii(ga, torch.as_tensor(self.mapping[p["sources"]]))
        raise ValueError(f"unknown app {app!r}")

    def warm_up(self, rounds: int = 2):
        """Every app of the mix, ``rounds`` times, on warm-up draws."""
        stream = self.jobs("warm_up")
        apps = {entry["app"] for entry in self.mix["jobs"]}
        done: Dict[str, int] = {}
        while any(done.get(a, 0) < rounds for a in apps):
            app, p = next(stream)
            if done.get(app, 0) < rounds:
                self.run(app, p)
                done[app] = done.get(app, 0) + 1

    def done(self, app: str, p: dict, out, seconds: float):
        """Book a finished job: its counters, and a seeded reservoir sample
        of ``sample_per_app`` answers of each app for the check."""
        self.per_app.setdefault(app, []).append(seconds)
        if app == "pagerank":
            self.counters["pagerank.pulls"] += out[1]
        n = self._seen[app] = self._seen.get(app, 0) + 1
        kept = self._sample.setdefault(app, [])
        if len(kept) < self.sample_per_app:
            kept.append((p, out))
        else:
            j = int(self._sample_rng.integers(n))
            if j < self.sample_per_app:
                kept[j] = (p, out)

    def release(self):
        """Free the program's state: the check runs after it."""
        self.backend = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def samples(self) -> List[Tuple[str, dict, object]]:
        return [(app, p, out) for app, kept in self._sample.items()
                for p, out in kept]

    def check(self) -> Dict[str, float]:
        """Every compared number: the worst over the sampled jobs."""
        want_map = self.reference_mapping()
        found = {"mapping_mismatch": compare.mapping_mismatch(self.mapping,
                                                              want_map)}
        edges = self.reference_edges()
        to_orig = torch.from_numpy(want_map).to(self.device)
        for app, p, out in self.samples():
            got = program_answer(app, out, to_orig)
            want = compare.run(app, edges, p, torch.float64)
            worst(found, compare.numbers(app, got, want))
        return found


def program_answer(app: str, out, to_orig: torch.Tensor):
    """The program's answer to ``app`` in original ids (``to_orig[v]`` is
    the program's id of original vertex ``v``)."""
    if app == "bc":
        return out[0][to_orig], out[1][to_orig]
    return out[0][to_orig]


def worst(found: Dict[str, float], new: Dict[str, float]) -> None:
    """Keep the larger of each number (a NaN stays: it fails any limit)."""
    for k, x in new.items():
        old = found.get(k)
        if old is None or math.isnan(x) or x > old:
            found[k] = x
