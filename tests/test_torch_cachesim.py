"""The port's paper-evaluation surface against ``repro``'s, bitwise.

``cachesim`` (stack distances, miss curves, MPKA, pinned MPKA, AMAT, the
scaled hierarchy, property and structure traces), ``core.stats`` (Tables
I-IV) and ``core.gorder_lite`` (its mapping), on seeded traces and on every
registry graph at test scale; and the quickstart on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import cachesim as ref_cachesim  # noqa: E402
from repro.core import gorder_lite as ref_gorder  # noqa: E402
from repro.core import reorder as ref_reorder  # noqa: E402
from repro.core import stats as ref_stats  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro.pack.layout import pack_graph as ref_pack_graph  # noqa: E402
from repro_torch import cachesim  # noqa: E402
from repro_torch.apps import engine  # noqa: E402
from repro_torch.core import gorder_lite, reorder, stats  # noqa: E402
from repro_torch.graph import datasets  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.obs import flight, metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.pack.layout import pack_graph  # noqa: E402

GRAPHS = tuple(datasets.REGISTRY)
SEEDS = (0, 1, 2, 3)


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """The quickstart installs the port's edge-map counters: reset the
    process-global tracer, flight sink, registry and engine hook around
    each test."""
    def reset():
        obs_trace.disable()
        ref_trace.disable()
        flight.uninstall()
        engine.set_edge_map_hook(None)
        metrics.reset_registry()

    reset()
    yield
    reset()


def _graphs(key, technique="original"):
    g, rg = datasets.load(key, "test"), ref_datasets.load(key, "test")
    if technique != "original":
        g, _ = reorder.reorder_graph(g, technique)
        rg, _ = ref_reorder.reorder_graph(rg, technique)
    return g, rg


def _trace(seed):
    """A skewed block trace with reuse at every distance."""
    rng = np.random.default_rng(seed)
    n = [1, 700, 5_000, 40_000][seed]
    return (rng.zipf(1.3, n) % (50 + 400 * seed)).astype(np.int64)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b and type(a) is type(b)


def _fields(levels):
    return {k: getattr(levels, k) for k in levels.__dataclass_fields__}


@pytest.mark.parametrize("seed", SEEDS)
def test_stack_distances_and_cache_model_are_bitwise(seed):
    t = _trace(seed)
    d = cachesim.stack_distances(t)
    assert _same(d, ref_cachesim.stack_distances(t))
    if t.shape[0] <= 5_000:
        assert _same(cachesim.stack_distances_np(t), d)
        assert _same(ref_cachesim.stack_distances_np(t), d)
    caps = np.array([1, 2, 8, 64, 1 << 20])
    assert _same(cachesim.miss_curve(d, caps),
                 ref_cachesim.miss_curve(d, caps))
    for v in (10, 5_000, 1 << 21):
        lv, rlv = (cachesim.scaled_hierarchy(v),
                   ref_cachesim.scaled_hierarchy(v))
        assert _fields(lv) == _fields(rlv)
        assert _same(cachesim.mpka(d, lv), ref_cachesim.mpka(d, rlv))
        assert _same(cachesim.amat_cycles(d, lv),
                     ref_cachesim.amat_cycles(d, rlv))
        pinned = np.unique(t)[: 1 + seed * 3]
        assert _same(cachesim.mpka_pinned(t, pinned, lv),
                     ref_cachesim.mpka_pinned(t, pinned, rlv))


def test_empty_trace_and_constants():
    e = np.zeros(0, np.int64)
    assert _same(cachesim.stack_distances(e), ref_cachesim.stack_distances(e))
    assert cachesim.DEFAULT_TRACE_LEN == ref_cachesim.DEFAULT_TRACE_LEN == 1_500_000
    assert cachesim.STRUCT_REGION == ref_cachesim.STRUCT_REGION


@pytest.mark.parametrize("key", GRAPHS)
def test_property_traces_and_their_cache_model_are_bitwise(key):
    for tech in ("original", "dbg"):
        g, rg = _graphs(key, tech)
        levels = cachesim.scaled_hierarchy(g.num_vertices)
        rlevels = ref_cachesim.scaled_hierarchy(rg.num_vertices)
        for mode in ("pull", "push"):
            t = cachesim.property_trace(g, mode, max_len=30_000)
            assert _same(t, ref_cachesim.property_trace(rg, mode,
                                                        max_len=30_000))
            b = cachesim.to_blocks(t, bytes_per_vertex=4)
            assert _same(b, ref_cachesim.to_blocks(t, bytes_per_vertex=4))
            d = cachesim.stack_distances(cachesim.to_blocks(t))
            rd = ref_cachesim.stack_distances(ref_cachesim.to_blocks(t))
            assert _same(d, rd)
            assert _same(cachesim.mpka(d, levels),
                         ref_cachesim.mpka(rd, rlevels))
            assert _same(cachesim.amat_cycles(d, levels),
                         ref_cachesim.amat_cycles(rd, rlevels))
    with pytest.raises(ValueError):
        cachesim.property_trace(g, "sideways")


@pytest.mark.parametrize("key", ["kr", "mp", "road"])
def test_structure_traces_are_bitwise(key):
    g, rg = _graphs(key, "dbg")
    for mode in ("pull", "push"):
        got = cachesim.flat_structure(g, mode)
        want = ref_cachesim.flat_structure(rg, mode)
        assert all(_same(a, b) for a, b in zip(got, want))
        prop = (g.in_csr if mode == "pull" else g.out_csr).indices
        t = cachesim.interleave_structure(prop, *got, max_len=20_000)
        assert _same(t, ref_cachesim.interleave_structure(prop, *want,
                                                          max_len=20_000))
    # the packed layout's structure stream, as the reference prices it
    adj, radj = pack_graph(g).in_adj, ref_pack_graph(rg).in_adj
    got, want = adj.structure_addresses(), radj.structure_addresses()
    assert all(_same(a, b) for a, b in zip(got, want))
    ids, rids = adj.decode_edges()[1], radj.decode_edges()[1]
    t = cachesim.interleave_structure(ids, *got, max_len=20_000)
    assert _same(t, ref_cachesim.interleave_structure(rids, *want,
                                                      max_len=20_000))
    hot = np.unique(np.concatenate([h.rows for h in adj.hot]) // 8)
    levels = cachesim.scaled_hierarchy(g.num_vertices)
    assert _same(cachesim.mpka_pinned(t, hot, levels),
                 ref_cachesim.mpka_pinned(
                     t, hot, ref_cachesim.scaled_hierarchy(g.num_vertices)))


@pytest.mark.parametrize("key", GRAPHS)
def test_stats_tables_are_bitwise(key):
    g, rg = _graphs(key)
    assert _same(stats.hot_vertex_stats(g), ref_stats.hot_vertex_stats(rg))
    for src in ("out", "in"):
        for bpv in (4, 8):
            assert _same(
                stats.hot_per_cache_block(g, bytes_per_vertex=bpv,
                                          degree_source=src),
                ref_stats.hot_per_cache_block(rg, bytes_per_vertex=bpv,
                                              degree_source=src))
            assert _same(
                stats.hot_footprint_mb(g, bytes_per_vertex=bpv,
                                       degree_source=src),
                ref_stats.hot_footprint_mb(rg, bytes_per_vertex=bpv,
                                           degree_source=src))
            assert _same(
                stats.degree_range_distribution(g, degree_source=src,
                                                bytes_per_vertex=bpv),
                ref_stats.degree_range_distribution(rg, degree_source=src,
                                                    bytes_per_vertex=bpv))


@pytest.mark.parametrize("key", GRAPHS)
def test_gorder_lite_mapping_is_bitwise(key):
    g, rg = _graphs(key)
    res, ref = gorder_lite.gorder_lite(g), ref_gorder.gorder_lite(rg)
    assert _same(res.mapping, ref.mapping)
    assert res.technique == ref.technique == "gorder_lite"
    assert isinstance(res, reorder.ReorderResult)
    assert np.array_equal(np.sort(res.mapping), np.arange(g.num_vertices))


def test_quickstart_runs_on_the_cpu(capsys):
    assert quickstart.main(["--scale", "test", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [ln.split() for ln in out.splitlines()
            if ln.split() and ln.split()[0] in quickstart.TECHNIQUES]
    assert [r[0] for r in rows] == list(quickstart.TECHNIQUES)
    assert all(r[-1] == "True" for r in rows)  # PageRank invariant
    assert all(int(r[5]) > 0 and float(r[6]) > 0 for r in rows)  # counters
    assert engine.get_edge_map_hook() is None


def test_quickstart_cache_model_matches_reference():
    """The quickstart's AMAT column is the reference's on the same graph."""
    g, rg = _graphs("mp")
    levels = cachesim.scaled_hierarchy(g.num_vertices)
    for tech in quickstart.TECHNIQUES:
        g2, res = quickstart.reordered(g, tech)
        if tech == "gorder_lite":
            rres = ref_gorder.gorder_lite(rg)
            rg2 = ref_csr.relabel(rg, rres.mapping)
        else:
            rg2, rres = ref_reorder.reorder_graph(rg, tech,
                                                  degree_source="out")
        assert _same(res.mapping, rres.mapping)
        d = cachesim.stack_distances(cachesim.to_blocks(
            cachesim.property_trace(g2, "pull")))
        rd = ref_cachesim.stack_distances(ref_cachesim.to_blocks(
            ref_cachesim.property_trace(rg2, "pull")))
        assert _same(cachesim.amat_cycles(d, levels),
                     ref_cachesim.amat_cycles(
                         rd, ref_cachesim.scaled_hierarchy(rg.num_vertices)))
