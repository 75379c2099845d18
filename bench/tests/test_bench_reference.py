"""The plain reference agrees with the program's DBG mapping and apps on a
small graph, and its control (the reference in bfloat16) fails each cell's
check."""
import numpy as np
import pytest
import torch

from bench.lib.harness import Spans
from bench.reference import compare, graph as reference


@pytest.mark.parametrize("degrees", [
    np.zeros(5, np.int64),
    np.array([0, 1, 2, 3, 50, 7, 7, 1, 0, 400]),
    np.random.default_rng(0).zipf(1.8, 5000).clip(max=10**6),
    np.random.default_rng(1).integers(0, 3, 1000),
])
def test_dbg_mapping_matches_the_program(degrees):
    from repro_torch.core.reorder import dbg

    np.testing.assert_array_equal(reference.dbg_mapping(degrees),
                                  dbg(np.asarray(degrees)).mapping)


def _problem(small_spec, cell, seed):
    from bench.systems.graph_jobs import Problem

    spec = small_spec(cell)
    return spec, Problem(spec.config, spec.mix, seed, torch.device("cpu"),
                         Spans(lambda: None))


@pytest.mark.parametrize("backend", ["flat", "ell"])
@pytest.mark.parametrize("cell", ["kron-s21.pagerank", "uni-s21.pagerank",
                                  "kron-s21.traverse"])
def test_reference_agrees_with_the_program(small_spec, cell, backend):
    from repro_torch import apps
    from repro_torch.core.reorder import reorder_graph
    from bench.systems.graph_jobs import program_answer

    spec, prob = _problem(small_spec, cell, 2**31 + 3)
    g2, res = reorder_graph(prob.graph, "dbg", degree_source="out")
    ga = apps.to_arrays(g2, backend=backend, device="cpu")
    want_map = prob.reference_mapping()
    assert compare.mapping_mismatch(res.mapping, want_map) == 0
    to_orig = torch.from_numpy(want_map)
    edges = prob.reference_edges()
    stream = prob.jobs()
    for _ in range(8):
        app, p = next(stream)
        m = res.mapping
        out = {"pagerank": lambda: apps.pagerank(ga, damping=p["damping"],
                                                 tol=p["tol"]),
               "pagerank_delta": lambda: apps.pagerank_delta(
                   ga, damping=p["damping"], epsilon=p["epsilon"]),
               "sssp": lambda: apps.sssp(ga, int(m[p.get("root", 0)])),
               "bc": lambda: apps.bc(ga, int(m[p.get("root", 0)])),
               "radii": lambda: apps.radii(
                   ga, torch.as_tensor(m[p.get("sources", [0])]))}[app]()
        got = program_answer(app, out, to_orig)
        nums = compare.numbers(app, got,
                               compare.run(app, edges, p, torch.float64))
        for name, value in nums.items():
            # the float32 program against the float64 reference: rounding
            # only (under 1e-5), and exact where the answer is an integer
            limit = 1e-5 if name.endswith("gap") else 0.0
            assert value <= limit, (app, name, value)


@pytest.mark.parametrize("cell", ["kron-s21.pagerank", "uni-s21.pagerank",
                                  "kron-s21.traverse"])
def test_control_fails_the_cell_check(small_spec, cell):
    from bench.control import readings

    spec = small_spec(cell)
    total, _ = readings(spec, [11, 12, 13], torch.device("cpu"))
    limits = spec.check["limits"]
    assert set(total) <= set(limits)
    assert any(not v <= limits[k] for k, v in total.items()), total


def test_exact_numbers_count_every_differing_vertex():
    a = torch.tensor([0.0, 1.0, float("inf"), 3.0])
    b = torch.tensor([0.0, 2.0, float("inf"), float("nan")])
    assert compare.numbers("sssp", a, b)["sssp_mismatch"] == 2.0
    assert compare.numbers("radii", torch.tensor([1, 2]),
                           torch.tensor([1, 3]))["radii_mismatch"] == 1.0


def test_gaps_read_nan_as_failure():
    want = torch.full((4,), 0.25, dtype=torch.float64)
    got = want.clone().float()
    got[1] = float("nan")
    value = compare.numbers("pagerank", got, want)["pr_gap"]
    assert not value <= 1.0
