"""The metrics read from the program's own registry, on small traced CPU
runs: each reads where its cell lists it, and agrees with what the
program and the benchmark's own spans say."""
from pathlib import Path

import pytest
import torch

from bench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 7
SETUP = ("reorder_mapping_s", "reorder_relabel_s", "build_pack_s",
         "build_upload_s")


def _traced(spec):
    """A traced run on a fresh registry: its counts cover this run alone.
    The windows run on the real clock (the spans are compared with the
    program's seconds), long enough for every app of the mix to finish a
    job on a loaded machine."""
    from repro_torch.obs.metrics import reset_registry

    reset_registry()
    result, compared = harness.run_cell(spec, SEED, 1.0, True,
                                        torch.device("cpu"), 0.0,
                                        {"hbm_bytes_per_s": 3.35e12})
    assert result["correct"], compared
    return {k: m["value"] for k, m in result["metrics"].items()}


def _pairs_within_spans(got):
    assert all(got[k] > 0 for k in SETUP)
    assert got["reorder_mapping_s"] + got["reorder_relabel_s"] <= got[
        "reorder_s"]
    assert got["build_pack_s"] + got["build_upload_s"] <= got[
        "backend_build_s"]


def _cell(spec):
    """The run's cell made again from the same seed (the same graph)."""
    from bench.systems import graph_jobs

    return graph_jobs.Cell(spec.config, spec.mix, spec.check, SEED,
                           torch.device("cpu"), harness.Spans(lambda: None))


def test_pagerank_reads_a_host_read_per_iteration(small_spec):
    from repro_torch import apps

    spec = small_spec("uni-s21.pagerank")
    got = _traced(spec)
    assert set(SETUP + ("host_reads_per_job",)) <= set(got)
    assert "bc_sweep_edges_per_bc_job" not in got
    _pairs_within_spans(got)
    # one read per iteration of every job
    cell = _cell(spec)
    p = spec.mix["jobs"][0]
    _, iters = apps.pagerank(cell.backend, damping=p["damping"], tol=p["tol"])
    assert got["host_reads_per_job"] == iters


def test_traverse_reads_all_six(small_spec):
    spec = small_spec("kron-s21.traverse")
    got = _traced(spec)
    assert set(SETUP + ("host_reads_per_job",
                        "bc_sweep_edges_per_bc_job")) <= set(got)
    _pairs_within_spans(got)
    # PR-delta it + 1, SSSP and BC 2 it + 1, Radii it: more than one a job
    assert got["host_reads_per_job"] > 1
    # every edge once per level, at least one level a job (the roots have
    # out-edges)
    e = _cell(spec).graph.num_edges
    assert e <= got["bc_sweep_edges_per_bc_job"] <= e * 64


def test_kron_pagerank_reads_none_of_them(small_spec):
    """The cell lists none of the program's metrics: its traced run reads
    the three it always did."""
    got = _traced(small_spec("kron-s21.pagerank"))
    assert set(got) == {"reorder_s", "backend_build_s", "pagerank_roofline"}


@pytest.mark.parametrize("name", SETUP + ("host_reads_per_job",
                                          "bc_sweep_edges_per_bc_job"))
def test_a_program_without_the_counts_reads_none(name):
    from repro_torch.obs.metrics import reset_registry

    reset_registry()
    assert harness._reader(name)(None) is None
