"""The port's streaming plane (``repro_torch.stream``) against
``repro.stream``.

Each test of tests/test_stream.py has a parity case here: the same graph
(``lj`` / ``kr`` at ``test`` scale), carried across through
``convert.graph_from_numpy``, and the same update batches go through both
packages; the reference runs its fused pushes with K5 in Pallas interpret
mode, the port on the CPU through K5's plain version.  Bands: ``DeltaGraph``
state, SSSP, min/max edge maps, ``IncrementalDBG`` and the cache model
bitwise; sum edge maps within 2e-6 · (1 + max|y|); incremental PageRank
1e-8 against the reference's same path and 1e-5 against a full recompute.
"""
import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import stream as ref_stream  # noqa: E402
from repro.apps import pagerank as ref_pagerank  # noqa: E402
from repro.apps import sssp as ref_sssp  # noqa: E402
from repro.apps import to_arrays as ref_to_arrays  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.kernels.edge_map import ops as ref_ops  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro.pack import layout as ref_layout  # noqa: E402
from repro.stream import incremental as ref_inc  # noqa: E402
from repro_torch import apps, stream  # noqa: E402
from repro_torch.convert import graph_from_numpy  # noqa: E402
from repro_torch.core import reorder  # noqa: E402
from repro_torch.core.reorder import _assign_groups  # noqa: E402
from repro_torch.graph import csr  # noqa: E402
from repro_torch.kernels.edge_map import ops  # noqa: E402
from repro_torch.obs import flight, metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.pack import layout  # noqa: E402
from repro_torch.stream import incremental  # noqa: E402

CPU = torch.device("cpu")


def _reset():
    for tr in (obs_trace, ref_trace):
        tr.disable()
    flight.uninstall()
    metrics.reset_registry()
    ref_metrics.reset_registry()


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """The tracer, flight sink and registry are process-global on both
    sides: each test starts and ends clean."""
    _reset()
    yield
    _reset()


def _port(g):
    return graph_from_numpy(g.in_csr.indptr, g.in_csr.indices,
                            g.in_csr.weights, g.out_csr.indptr,
                            g.out_csr.indices, g.out_csr.weights, g.name)


@pytest.fixture(scope="module")
def base_graph():
    g = ref_datasets.load("lj", "test", seed=1)
    return g, _port(g)


@pytest.fixture(scope="module")
def weighted_base():
    g = ref_datasets.load_weighted("lj", "test", seed=1)
    return g, _port(g)


def _chain(weights=None):
    g = ref_csr.from_edges(np.array([0]), np.array([1]), 3, weights=weights,
                           name="chain")
    return g, _port(g)


def _random_batch(dg, rng, n_add=120, n_del=40):
    v = dg.num_vertices
    add_src = rng.integers(0, v, n_add)
    add_dst = rng.integers(0, v, n_add)
    es, ed, _ = dg.alive_edges()
    idx = rng.choice(es.shape[0], size=n_del, replace=False)
    return add_src, add_dst, es[idx], ed[idx]


def _dgs(pair):
    """The reference's and the port's ``DeltaGraph`` over one graph."""
    return ref_stream.DeltaGraph(pair[0]), stream.DeltaGraph(pair[1])


def _services(pair, **cfg):
    """The reference's and the port's ``StreamService`` over one graph."""
    return (ref_stream.StreamService(pair[0], ref_stream.StreamConfig(**cfg)),
            stream.StreamService(pair[1], stream.StreamConfig(**cfg),
                                 device=CPU))


def _eq(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_graphs_equal(rg, pg):
    assert rg.num_vertices == pg.num_vertices
    for rc, pc in ((rg.in_csr, pg.in_csr), (rg.out_csr, pg.out_csr)):
        _eq(rc.indptr, pc.indptr)
        _eq(rc.indices, pc.indices)
        _eq(rc.weights, pc.weights)


DG_STATE = ("base_alive", "_base_src", "_base_dst", "_base_w", "_out2in",
            "_base_key_order", "_base_key_sorted", "_ex_src", "_ex_dst",
            "_ex_w", "_ex_alive", "out_deg", "in_deg")
DG_COUNTS = ("_n_extra", "_dead_base", "_dead_extra", "inserted_since_compact",
             "deleted_since_compact", "version", "num_edges", "churn")


def _assert_dg_equal(rdg, pdg):
    for f in DG_STATE:
        _eq(getattr(rdg, f), getattr(pdg, f))
    for f in DG_COUNTS:
        assert getattr(rdg, f) == getattr(pdg, f), f
    for r, p in zip(rdg.alive_edges(), pdg.alive_edges()):
        _eq(r, p)
    _eq(rdg.in_alive_mask(), pdg.in_alive_mask())


def _assert_results_equal(ra, pa):
    for f in dataclasses.fields(ra):
        if f.name != "seconds":
            _eq(getattr(ra, f.name), getattr(pa, f.name))


def _apply_both(rdg, pdg, **batch):
    ra, pa = rdg.apply(**batch), pdg.apply(**batch)
    _assert_results_equal(ra, pa)
    return ra, pa


# ---------------------------------------------------------------------------
# DeltaGraph substrate
# ---------------------------------------------------------------------------

def test_delta_graph_matches_reference_across_batches(base_graph):
    rdg, pdg = _dgs(base_graph)
    _assert_dg_equal(rdg, pdg)
    rng = np.random.default_rng(0)
    for _ in range(4):
        a_s, a_d, d_s, d_d = _random_batch(rdg, rng)
        _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d, del_src=d_s,
                    del_dst=d_d)
        _assert_dg_equal(rdg, pdg)
        snap = pdg.snapshot()
        csr.validate(snap)
        _assert_graphs_equal(rdg.snapshot(), snap)
        assert np.array_equal(pdg.out_deg, snap.out_degrees())
        assert np.array_equal(pdg.in_deg, snap.in_degrees())


def test_delta_graph_compact_matches_reference(base_graph):
    rdg, pdg = _dgs(base_graph)
    rng = np.random.default_rng(1)
    a_s, a_d, d_s, d_d = _random_batch(rdg, rng, n_add=300, n_del=100)
    _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
    assert pdg.churn == 400
    rg, pg = rdg.compact(), pdg.compact()
    assert pdg.churn == 0 and pdg.base is pg
    _assert_graphs_equal(rg, pg)
    _assert_dg_equal(rdg, pdg)


def test_delta_graph_delete_missing_edge_raises_like_reference(base_graph):
    rdg, pdg = _dgs(base_graph)
    es, ed, _ = pdg.alive_edges()
    pairs = set(zip(es.tolist(), ed.tolist()))
    v = pdg.num_vertices
    missing = next((a, b) for a in range(v) for b in range(v)
                   if (a, b) not in pairs)
    for dg in (rdg, pdg):
        with pytest.raises(KeyError):
            dg.apply(del_src=[missing[0]], del_dst=[missing[1]])
    _assert_dg_equal(rdg, pdg)


def test_delta_graph_weighted_deletion_matches_reference(weighted_base):
    rdg = ref_stream.DeltaGraph(weighted_base[0])
    pdg = stream.DeltaGraph(weighted_base[1])
    es, ed, ew = pdg.alive_edges()
    _, pa = _apply_both(rdg, pdg, del_src=es[:5], del_dst=ed[:5])
    np.testing.assert_array_equal(pa.del_w, ew[:5])
    _apply_both(rdg, pdg, add_src=[0, 1], add_dst=[2, 3], add_w=[7.5, 2.25])
    _, _, w2 = pdg.alive_edges()
    assert 7.5 in w2 and 2.25 in w2
    _assert_dg_equal(rdg, pdg)


def test_delta_graph_vectorized_deletion_staging_matches_reference():
    """Duplicate deletion requests of one key, weighted parallel edges and
    same-batch insert+delete: the same claims as the reference, and a batch
    that fails to stage leaves both untouched."""
    rng = np.random.default_rng(11)
    g = ref_datasets.load_weighted("kr", "test", seed=4)
    rdg, pdg = ref_stream.DeltaGraph(g), stream.DeltaGraph(_port(g))
    for _ in range(12):
        es, ed, _ = pdg.alive_edges()
        idx = rng.choice(es.shape[0], size=40, replace=True)
        n_add = int(rng.integers(1, 60))
        a_s = rng.integers(0, pdg.num_vertices, n_add)
        a_d = rng.integers(0, pdg.num_vertices, n_add)
        req = Counter(zip(es[idx].tolist(), ed[idx].tolist()))
        have = Counter(zip(es.tolist(), ed.tolist()))
        ds, dd = [], []
        for key, c in req.items():
            take = min(c, have[key])
            ds += [key[0]] * take
            dd += [key[1]] * take
        _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d,
                    add_w=rng.random(n_add), del_src=np.array(ds),
                    del_dst=np.array(dd))
    _assert_dg_equal(rdg, pdg)
    _assert_graphs_equal(rdg.compact(), pdg.compact())
    es, ed, _ = pdg.alive_edges()
    lone = next(p for p, c in Counter(zip(es.tolist(), ed.tolist())).items()
                if c == 1)
    for dg in (rdg, pdg):
        with pytest.raises(KeyError):
            dg.apply(del_src=[lone[0], lone[0]], del_dst=[lone[1], lone[1]])
    _assert_dg_equal(rdg, pdg)


def test_delta_graph_out_edges_of_matches_reference(base_graph):
    rdg, pdg = _dgs(base_graph)
    rng = np.random.default_rng(2)
    a_s, a_d, d_s, d_d = _random_batch(rdg, rng)
    _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
    probe = np.unique(rng.integers(0, pdg.num_vertices, 50))
    for r, p in zip(rdg.out_edges_of(probe), pdg.out_edges_of(probe)):
        _eq(r, p)
    snap = pdg.snapshot()
    s, d = pdg.out_edges_of(probe)
    want = [(int(u), int(w)) for u in probe for w in snap.out_csr.neighbors(u)]
    assert sorted(zip(s.tolist(), d.tolist())) == sorted(want)


@pytest.mark.parametrize("weighted", [False, True])
def test_match_directions_equals_the_reference_lexsorts(weighted):
    """The port pairs out- and in-edge positions by a stable integer sort
    plus a weight sort of the parallel-edge runs; on multigraphs full of
    parallel edges and tied weights, with each in-row reversed (so the two
    directions list parallel edges in different orders), the pairing is
    the reference's."""
    rng = np.random.default_rng(17)
    for _ in range(20):
        v = int(rng.integers(1, 40))
        e = int(rng.integers(0, 500))
        src, dst = rng.integers(0, v, e), rng.integers(0, v, e)
        w = rng.integers(1, 4, e).astype(np.float32) if weighted else None
        g = ref_csr.from_edges(src, dst, v, weights=w)
        ic = g.in_csr
        rev = np.concatenate([np.arange(ic.indptr[r + 1] - 1,
                                        ic.indptr[r] - 1, -1)
                              for r in range(v)]).astype(np.int64)
        g = ref_csr.Graph(
            in_csr=ref_csr.CSR(indptr=ic.indptr, indices=ic.indices[rev],
                               weights=None if w is None
                               else ic.weights[rev]),
            out_csr=g.out_csr, name="reversed")
        _eq(ref_stream.DeltaGraph._match_directions(g),
            stream.DeltaGraph._match_directions(_port(g)))


def test_occurrence_rank_matches_reference():
    inv = np.random.default_rng(3).integers(0, 17, 500)
    _eq(ref_stream.delta.occurrence_rank(inv),
        stream.delta.occurrence_rank(inv))


# ---------------------------------------------------------------------------
# coo_tiles and refresh_alive
# ---------------------------------------------------------------------------

def _assert_tile_equal(rt, pt):
    _eq(np.asarray(rt.rows).astype(np.int64), _np(pt.rows))
    for f in ("idx", "deg", "w", "alive"):
        r, p = getattr(rt, f), getattr(pt, f)
        _eq(None if r is None else np.asarray(r),
            None if p is None else _np(p))


@pytest.mark.parametrize("weighted", [False, True])
def test_coo_tiles_match_reference(weighted):
    rng = np.random.default_rng(4)
    n = 300
    src = rng.integers(0, 900, n)
    dst = rng.integers(0, 60, n)
    w = rng.random(n).astype(np.float32) if weighted else None
    alive = rng.random(n) < 0.8
    (rt,) = ref_ops.coo_tiles(src, dst, w=w, alive=alive)
    (pt,) = ops.coo_tiles(src, dst, w=w, alive=alive, device=CPU)
    _assert_tile_equal(rt, pt)
    rows = _np(pt.rows)
    assert np.array_equal(rows, np.unique(rows)), "a delta row repeats"
    assert pt.segments is None
    assert ops.coo_tiles(src[:0], dst[:0], device=CPU) == ()


def test_coo_tiles_split_a_row_wider_than_1024_lanes():
    """A delta row past 1,024 lanes carries K5's segment list, as
    ``ell_tiles`` builds it, and the fused combine still meets it once."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 5000, 3000)
    dst = np.concatenate([np.full(2500, 7), rng.integers(0, 5000, 500)])
    (rt,) = ref_ops.coo_tiles(src, dst)
    (pt,) = ops.coo_tiles(src, dst, device=CPU)
    _assert_tile_equal(rt, pt)
    assert pt.idx.shape[1] > 1024 and pt.segments is not None
    deg = _np(pt.deg)
    segs = _np(pt.segments)
    for r in range(deg.shape[0]):
        mine = segs[segs[:, 0] == r]
        assert mine[0, 1] == 0 and mine[-1, 2] == deg[r]
        assert np.array_equal(mine[1:, 1], mine[:-1, 2])
    x = torch.from_numpy(rng.random(5000).astype(np.float32))
    base = torch.from_numpy(rng.random(5000).astype(np.float32))
    got = ops.fused_edge_map((), x, 5000, init=base, extra_tiles=(pt,))
    want = base.numpy().astype(np.float64)
    np.add.at(want, dst, x.numpy()[src])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_refresh_alive_matches_reference(base_graph):
    rdg, pdg = _dgs(base_graph)
    rng = np.random.default_rng(6)
    a_s, a_d, d_s, d_d = _random_batch(rdg, rng, n_add=50, n_del=200)
    _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
    rb, rd = ref_inc.stream_push_tiles(rdg)
    pb, pd = incremental.stream_push_tiles(pdg, device=CPU)
    assert len(rb) == len(pb) and len(rd) == len(pd) == 1
    for rt, pt in zip(rb + rd, pb + pd):
        _assert_tile_equal(rt, pt)
    for t in pb:
        assert t.alive is not None
    tiles = ops.ell_tiles(base_graph[1].in_csr, [10, 3, 1, 0], device=CPU)
    dropped = ops.refresh_alive(base_graph[1].in_csr, tiles, None)
    assert all(t.alive is None for t in dropped)
    kept = ops.refresh_alive(base_graph[1].in_csr, tiles, pdg.in_alive_mask())
    for t, k in zip(tiles, kept):
        assert k.idx is t.idx and k.segments is t.segments


# ---------------------------------------------------------------------------
# The stream edge maps and StreamBackend
# ---------------------------------------------------------------------------

def _assert_agree(want, got, reduce):
    want, got = np.asarray(want), _np(got)
    assert want.shape == got.shape
    if reduce == "sum":
        fin = np.isfinite(want)
        scale = 1.0 + (np.abs(want[fin]).max() if fin.any() else 0.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def churned(weighted_base):
    """Both sides' DeltaGraph after two batches: tombstones in the base,
    live and dead edges in the delta buffer."""
    rdg = ref_stream.DeltaGraph(weighted_base[0])
    pdg = stream.DeltaGraph(weighted_base[1])
    rng = np.random.default_rng(7)
    for _ in range(2):
        a_s, a_d, d_s, d_d = _random_batch(rdg, rng)
        w = rng.uniform(1, 16, a_s.shape[0]).astype(np.float32)
        _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d, add_w=w, del_src=d_s,
                    del_dst=d_d)
    es, ed, _ = rdg.extras()[:3]
    _apply_both(rdg, pdg, del_src=es[:10], del_dst=ed[:10])
    return rdg, pdg


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("direction", ["pull", "push"])
@pytest.mark.parametrize("reduce", ["sum", "min", "max", "or"])
def test_stream_edge_maps_match_reference(churned, reduce, direction, k):
    """``StreamBackend`` pull / push over tombstones and the delta buffer,
    1-D and (V, K), weights and a frontier, against the reference's."""
    rdg, pdg = churned
    rng = np.random.default_rng(8)
    v = pdg.num_vertices
    shape = (v,) if k == 1 else (v, k)
    prop = rng.random(shape).astype(np.float32)
    front = rng.random(shape) < 0.6
    if reduce == "or":
        prop = (prop < 0.3).astype(np.float32)
    kw = dict(reduce=reduce, use_weights=reduce in ("min", "max"),
              src_frontier=front)
    rb = ref_stream.StreamBackend.from_delta(rdg)
    pb = stream.StreamBackend.from_delta(pdg, device=CPU)
    if direction == "push":
        init = rng.random(shape).astype(np.float32)
        want = rb.push(jnp.asarray(prop), init=jnp.asarray(init),
                       **dict(kw, src_frontier=jnp.asarray(front)))
        got = pb.push(torch.from_numpy(prop), init=torch.from_numpy(init),
                      **dict(kw, src_frontier=torch.from_numpy(front)))
    else:
        want = rb.pull(jnp.asarray(prop),
                       **dict(kw, src_frontier=jnp.asarray(front)))
        got = pb.pull(torch.from_numpy(prop),
                      **dict(kw, src_frontier=torch.from_numpy(front)))
    _assert_agree(want, got, "max" if reduce == "or" else reduce)


def test_stream_edge_maps_equal_engine_on_static_graph(base_graph):
    """With no updates applied, the port's stream edge maps reproduce the
    port's engine and the reference's stream edge maps."""
    rdg, pdg = _dgs(base_graph)
    sa = stream.stream_arrays(pdg, CPU)
    ga = apps.to_arrays(base_graph[1], device=CPU)
    prop = np.random.default_rng(0).random(pdg.num_vertices).astype(np.float32)
    pt = torch.from_numpy(prop)
    from repro_torch.apps import engine

    np.testing.assert_allclose(
        _np(stream.edge_map_pull_stream(sa, pt)),
        _np(engine.edge_map_pull(ga, pt)), rtol=1e-6)
    np.testing.assert_allclose(
        _np(stream.edge_map_push_stream(sa, pt)),
        _np(engine.edge_map_push(ga, pt)), rtol=1e-6)
    rsa = ref_stream.stream_arrays(rdg)
    _assert_agree(ref_stream.edge_map_pull_stream(rsa, jnp.asarray(prop)),
                  stream.edge_map_pull_stream(sa, pt), "sum")
    _assert_agree(ref_stream.edge_map_push_stream(rsa, jnp.asarray(prop)),
                  stream.edge_map_push_stream(sa, pt), "sum")


@pytest.mark.parametrize("fused", [False, True])
def test_stream_edge_map_min_ignores_padding_and_tombstones(fused):
    """Masked edges (tombstones, dead delta edges) contribute the
    reduction's identity, not 0.0 — the reference's regression case, on the
    edge-parallel and the fused path."""
    g = csr.from_edges(np.array([1, 2, 0]), np.array([0, 0, 2]), 3)
    dg = stream.DeltaGraph(g)
    prop = torch.tensor([5.0, 9.0, 7.0])

    def pull():
        if fused:
            bt, dt = stream.stream_push_tiles(dg, device=CPU)
            return incremental.edge_map_pull_stream_fused(bt, dt, prop, 3,
                                                          reduce="min")
        return stream.edge_map_pull_stream(stream.stream_arrays(dg, CPU),
                                           prop, reduce="min")

    def push():
        if fused:
            bt, dt = stream.stream_push_tiles(dg, device=CPU)
            return stream.edge_map_push_stream_fused(bt, dt, prop, 3,
                                                     reduce="min")
        return stream.edge_map_push_stream(stream.stream_arrays(dg, CPU),
                                           prop, reduce="min")

    np.testing.assert_array_equal(_np(pull()), [7.0, np.inf, 5.0])
    dg.apply(del_src=[2], del_dst=[0])  # tombstone 2->0; in(0) = {1}
    np.testing.assert_array_equal(_np(pull()), [9.0, np.inf, 5.0])
    np.testing.assert_array_equal(_np(push()), [9.0, np.inf, 5.0])
    dg.apply(add_src=[2], add_dst=[1])
    dg.apply(del_src=[2], del_dst=[1])  # a dead delta edge into 1
    np.testing.assert_array_equal(_np(pull()), [9.0, np.inf, 5.0])


def test_stream_backend_out_edge_sum_and_materialize_match_reference(churned):
    rdg, pdg = churned
    rb = ref_stream.StreamBackend.from_delta(rdg)
    pb = stream.StreamBackend.from_delta(pdg, device=CPU)
    rng = np.random.default_rng(9)
    a = rng.random(pdg.num_vertices).astype(np.float32)
    want = rb.out_edge_sum(lambda s, d: jnp.asarray(a)[d] * 2.0
                           + jnp.asarray(a)[s])
    ta = torch.from_numpy(a)
    got = pb.out_edge_sum(lambda s, d: ta[d] * 2.0 + ta[s])
    _assert_agree(want, got, "sum")
    _assert_graphs_equal(rb.materialize(), pb.materialize())
    got = ref_csr.to_edges(rdg.snapshot())
    want = csr.to_edges(pb.materialize())
    assert (sorted(zip(*(x.tolist() for x in got)))
            == sorted(zip(*(x.tolist() for x in want))))
    assert (pb.num_vertices, pb.weighted) == (rb.num_vertices, rb.weighted)
    _eq(np.asarray(rb.in_deg), _np(pb.in_deg))
    _eq(np.asarray(rb.out_deg), _np(pb.out_deg))


# ---------------------------------------------------------------------------
# Incremental PageRank (the acceptance bar)
# ---------------------------------------------------------------------------

def _full_pr(g):
    r, _ = apps.pagerank(apps.to_arrays(g, device=CPU), tol=1e-10,
                         max_iters=256)
    return r.numpy()


@pytest.mark.parametrize("fused", [False, True])
def test_incremental_pagerank_matches_reference_and_full_recompute(
        base_graph, fused):
    cfg = dict(compact_threshold=0.08, pr_fused_push=fused)
    rsvc, psvc = _services(base_graph, **cfg)
    rng = np.random.default_rng(3)
    saw_compaction = False
    for _ in range(6):
        a_s, a_d, d_s, d_d = _random_batch(rsvc.dg, rng)
        rs = rsvc.ingest(add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
        ps = psvc.ingest(add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
        assert ps.compacted == rs.compacted
        saw_compaction |= ps.compacted
        r_inc = psvc.pagerank()
        np.testing.assert_allclose(r_inc, rsvc.pagerank(), rtol=0, atol=1e-8)
        np.testing.assert_allclose(r_inc, _full_pr(psvc.snapshot()), atol=1e-5)
    assert saw_compaction, "compaction threshold never triggered"


def test_incremental_pagerank_fused_push_parity(base_graph):
    """The port's fused and unfused push loops agree with each other and
    with the reference's two loops to 1e-8 across insert+delete batches."""
    rdg = [ref_stream.DeltaGraph(base_graph[0]) for _ in range(2)]
    pdg = [stream.DeltaGraph(base_graph[1]) for _ in range(2)]
    rpr = [ref_stream.IncrementalPageRank(rdg[0]),
           ref_stream.IncrementalPageRank(rdg[1], use_fused_push=True)]
    ppr = [stream.IncrementalPageRank(pdg[0], device=CPU),
           stream.IncrementalPageRank(pdg[1], use_fused_push=True, device=CPU)]
    rng = np.random.default_rng(11)
    for _ in range(3):
        a_s, a_d, d_s, d_d = _random_batch(rdg[0], rng, n_add=60, n_del=15)
        batch = dict(add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
        for dgs, prs in ((rdg, rpr), (pdg, ppr)):
            for dg, pr in zip(dgs, prs):
                pr.ingest(dg.apply(**batch))
        got = [pr.query() for pr in ppr]
        np.testing.assert_allclose(got[0], got[1], rtol=0, atol=1e-8)
        for g, pr in zip(got, rpr):
            np.testing.assert_allclose(g, pr.query(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(ppr[1].query(), _full_pr(pdg[1].snapshot()),
                               atol=1e-5)


def test_pr_residual_fused_resync_parity(base_graph):
    """The full-residual resync on the fused tiles equals the edge-parallel
    one and the reference's to fp association; resync() then query stays on
    the true PageRank."""
    rdg, pdg = _dgs(base_graph)
    rng = np.random.default_rng(13)
    a_s, a_d, d_s, d_d = _random_batch(rdg, rng, n_add=80, n_del=25)
    _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
    rank = rng.random(pdg.num_vertices).astype(np.float32)
    rank /= rank.sum()
    rsa = ref_stream.stream_arrays(rdg)
    want = ref_inc._pr_residual(rsa, jnp.asarray(rank), jnp.float32(0.85))
    sa = stream.stream_arrays(pdg, CPU)
    plain = incremental._pr_residual(sa, torch.from_numpy(rank), 0.85)
    bt, dt = stream.stream_push_tiles(pdg, device=CPU)
    fused = incremental._pr_residual_fused(bt, dt, sa.out_deg,
                                           torch.from_numpy(rank), 0.85)
    np.testing.assert_allclose(_np(plain), np.asarray(want), rtol=0, atol=1e-7)
    np.testing.assert_allclose(_np(fused), np.asarray(want), rtol=0, atol=1e-7)
    ipr = stream.IncrementalPageRank(pdg, use_fused_push=True, device=CPU)
    ipr.resync()
    np.testing.assert_allclose(ipr.query(), _full_pr(pdg.snapshot()),
                               atol=1e-5)


def test_service_pr_fused_push_config(base_graph):
    cfg = dict(pr_fused_push=True)
    rsvc, psvc = _services(base_graph, **cfg)
    assert psvc.pr.use_fused_push
    rng = np.random.default_rng(12)
    a_s, a_d, d_s, d_d = _random_batch(rsvc.dg, rng)
    for svc in (rsvc, psvc):
        svc.ingest(add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
    got = psvc.pagerank()
    np.testing.assert_allclose(got, rsvc.pagerank(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got, _full_pr(psvc.snapshot()), atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_incremental_pagerank_converges_faster_than_cold_start(base_graph,
                                                               fused):
    pdg = stream.DeltaGraph(base_graph[1])
    ipr = stream.IncrementalPageRank(pdg, use_fused_push=fused, device=CPU)
    ipr.refresh()
    cold = ipr.last_iters
    rdg = ref_stream.DeltaGraph(base_graph[0])
    rpr = ref_stream.IncrementalPageRank(rdg, use_fused_push=fused)
    rpr.refresh()
    rng = np.random.default_rng(4)
    a_s, a_d, d_s, d_d = _random_batch(pdg, rng, n_add=20, n_del=5)
    ra, pa = _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d, del_src=d_s,
                         del_dst=d_d)
    ipr.ingest(pa)
    rpr.ingest(ra)
    warm = ipr.refresh()
    assert 0 < warm < cold
    # the push loops' iteration counts may move by one with fp association
    assert abs(cold - rpr.total_push_iters) <= 1
    assert abs(warm - rpr.refresh()) <= 1
    np.testing.assert_allclose(ipr.rank, rpr.rank, rtol=0, atol=1e-8)


def test_incremental_pagerank_weighted_graph_unaffected(weighted_base):
    rsvc, psvc = _services(weighted_base)
    rng = np.random.default_rng(5)
    a_s, a_d, d_s, d_d = _random_batch(rsvc.dg, rng, n_add=50, n_del=20)
    w = rng.uniform(1, 9, 50).astype(np.float32)
    for svc in (rsvc, psvc):
        svc.ingest(add_src=a_s, add_dst=a_d, add_w=w, del_src=d_s,
                   del_dst=d_d)
    got = psvc.pagerank()
    np.testing.assert_allclose(got, rsvc.pagerank(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got, _full_pr(psvc.snapshot()), atol=1e-5)


# ---------------------------------------------------------------------------
# Incremental SSSP
# ---------------------------------------------------------------------------

def _full_sssp(g, root=0):
    d, _ = apps.sssp(apps.to_arrays(g, device=CPU), root)
    return d.numpy()


def _ref_full_sssp(g, root=0):
    return np.asarray(ref_sssp(ref_to_arrays(g), jnp.int32(root))[0])


def test_incremental_sssp_insert_only_stays_incremental(weighted_base):
    rsvc, psvc = _services(weighted_base)
    rng = np.random.default_rng(6)
    np.testing.assert_array_equal(psvc.sssp(0), rsvc.sssp(0))
    v = psvc.dg.num_vertices
    for _ in range(3):
        k = 80
        batch = dict(add_src=rng.integers(0, v, k),
                     add_dst=rng.integers(0, v, k),
                     add_w=rng.uniform(1, 16, k).astype(np.float32))
        for svc in (rsvc, psvc):
            svc.ingest(**batch)
        got = psvc.sssp(0)
        np.testing.assert_array_equal(got, rsvc.sssp(0))
        np.testing.assert_array_equal(got, _full_sssp(psvc.snapshot()))
    assert psvc._sssp[0].full_recomputes == 0 == rsvc._sssp[0].full_recomputes


@pytest.mark.parametrize("fused", [False, True])
def test_incremental_sssp_deletion_of_used_edge_recomputes(weighted_base,
                                                          fused):
    rdg = ref_stream.DeltaGraph(weighted_base[0])
    pdg = stream.DeltaGraph(weighted_base[1])
    rs = ref_stream.IncrementalSSSP(rdg, 0, use_fused_push=fused)
    ps = stream.IncrementalSSSP(pdg, 0, use_fused_push=fused, device=CPU)
    dist = ps.query()
    np.testing.assert_array_equal(dist, rs.query())
    es, ed, ew = pdg.alive_edges()
    used = (np.isfinite(dist[es]) & np.isfinite(dist[ed])
            & np.isclose(dist[es] + ew, dist[ed], rtol=1e-5))
    assert used.any()
    i = int(np.argmax(used))
    ra, pa = _apply_both(rdg, pdg, del_src=[es[i]], del_dst=[ed[i]])
    rs.ingest(ra)
    ps.ingest(pa)
    got, want = ps.query(), rs.query()
    assert ps.full_recomputes == 1 == rs.full_recomputes
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _full_sssp(pdg.snapshot()))


def _chain_case(name):
    """(graph weights, batches, expected dist) of the reference's three
    pending-edge regression cases."""
    if name == "delete_of_pending_insert":
        return None, [dict(add_src=[1], add_dst=[2]),
                      dict(del_src=[1], del_dst=[2])]
    if name == "same_batch_insert_delete":
        return None, [dict(add_src=[1], add_dst=[2], del_src=[1],
                           del_dst=[2])]
    return np.array([1.0], np.float32), [
        dict(add_src=[0], add_dst=[1], add_w=[1.0]),
        dict(del_src=[0], del_dst=[1])]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["delete_of_pending_insert",
                                  "same_batch_insert_delete",
                                  "delete_with_surviving_pending_twin"])
def test_incremental_sssp_pending_scrub_stays_exact(case, fused):
    """The reference's scrub regressions: a deletion of an edge still in
    the pending-insert buffers never leaks a distance through it, and no
    recompute runs."""
    weights, batches = _chain_case(case)
    rg, pg = _chain(weights)
    rdg, pdg = ref_stream.DeltaGraph(rg), stream.DeltaGraph(pg)
    rs = ref_stream.IncrementalSSSP(rdg, 0, use_fused_push=fused)
    ps = stream.IncrementalSSSP(pdg, 0, use_fused_push=fused, device=CPU)
    np.testing.assert_array_equal(ps.query(), [0.0, 1.0, np.inf])
    rs.query()
    for batch in batches:
        ra, pa = _apply_both(rdg, pdg, **batch)
        rs.ingest(ra)
        ps.ingest(pa)
    got = ps.query()
    np.testing.assert_array_equal(got, [0.0, 1.0, np.inf])
    np.testing.assert_array_equal(got, rs.query())
    assert ps.full_recomputes == 0 == rs.full_recomputes
    es, ed, _ = pdg.alive_edges()
    assert list(zip(es.tolist(), ed.tolist())) == [(0, 1)]


@pytest.mark.parametrize("fused", [False, True])
def test_incremental_sssp_interleaved_insert_delete_matches_reference(
        weighted_base, fused):
    rdg = ref_stream.DeltaGraph(weighted_base[0])
    pdg = stream.DeltaGraph(weighted_base[1])
    rs = ref_stream.IncrementalSSSP(rdg, 0, use_fused_push=fused)
    ps = stream.IncrementalSSSP(pdg, 0, use_fused_push=fused, device=CPU)
    rs.query()
    ps.query()
    rng = np.random.default_rng(8)
    v = pdg.num_vertices
    for _ in range(3):
        k = 60
        a_s = rng.integers(0, v, k)
        a_d = rng.integers(0, v, k)
        a_w = rng.uniform(1, 16, k).astype(np.float32)
        idx = rng.choice(k, size=20, replace=False)
        for batch in (dict(add_src=a_s, add_dst=a_d, add_w=a_w),
                      dict(del_src=a_s[idx], del_dst=a_d[idx])):
            ra, pa = _apply_both(rdg, pdg, **batch)
            rs.ingest(ra)
            ps.ingest(pa)
        got = ps.query()
        np.testing.assert_array_equal(got, rs.query())
        np.testing.assert_array_equal(got, _full_sssp(pdg.snapshot()))
        assert (ps.full_recomputes, ps.last_iters) == (rs.full_recomputes,
                                                       rs.last_iters)


def test_sssp_root_cache_is_bounded_and_eviction_is_transparent(weighted_base):
    cfg = dict(max_sssp_roots=4, regroup_every=0)
    rsvc, psvc = _services(weighted_base, **cfg)
    refs = {r: psvc.sssp(r).copy() for r in range(10)}
    for r in range(10):
        np.testing.assert_array_equal(refs[r], rsvc.sssp(r))
    assert list(psvc._sssp) == list(rsvc._sssp) and len(psvc._sssp) == 4
    for r in (0, 9):
        np.testing.assert_array_equal(psvc.sssp(r), refs[r])


def test_incremental_sssp_noop_query_is_free(weighted_base):
    for fused in (False, True):
        ps = stream.IncrementalSSSP(stream.DeltaGraph(weighted_base[1]), 0,
                                    use_fused_push=fused, device=CPU)
        np.testing.assert_array_equal(ps.query(),
                                      _ref_full_sssp(weighted_base[0]))
        assert ps.refresh() == 0


# ---------------------------------------------------------------------------
# Incremental DBG (the reordering layer)
# ---------------------------------------------------------------------------

def _assert_remap_equal(rd, pd):
    for f in ("moved", "old_group", "new_group"):
        _eq(getattr(rd, f), getattr(pd, f))
    assert rd.spec_rebuilt == pd.spec_rebuilt


def _assert_idbg_equal(r, p):
    _eq(r.group_of, p.group_of)
    _eq(r.degrees, p.degrees)
    _eq(r.current_mapping(), p.current_mapping())
    assert r.spec.boundaries == p.spec.boundaries
    assert r.total_moved == p.total_moved


def test_incremental_dbg_initial_mapping_equals_batch_dbg(base_graph):
    degs = base_graph[1].out_degrees()
    p = stream.IncrementalDBG(degs)
    np.testing.assert_array_equal(p.current_mapping(),
                                  reorder.dbg(degs).mapping)
    _assert_idbg_equal(ref_stream.IncrementalDBG(degs), p)


def _drive_idbg(degs, kwargs, steps):
    """The same updates through both IncrementalDBGs; every RemapDelta and
    the state after each step equal."""
    r = ref_stream.IncrementalDBG(degs, **kwargs)
    p = stream.IncrementalDBG(degs, **kwargs)
    for vs, nd in steps:
        _assert_remap_equal(r.update(vs, nd), p.update(vs, nd))
        _assert_idbg_equal(r, p)
    return p


def test_incremental_dbg_zero_hysteresis_equals_batch_assignment(base_graph):
    degs = base_graph[1].out_degrees().copy()
    rng = np.random.default_rng(7)
    steps = []
    d = degs.copy()
    for _ in range(5):
        a = rng.choice(d.shape[0], 40, replace=False)
        b = rng.permutation(a)
        d[a], d[b] = d[b].copy(), d[a].copy()
        touched = np.unique(np.concatenate([a, b]))
        steps.append((touched, d[touched].copy()))
    p = _drive_idbg(degs, dict(hysteresis=0.0), steps)
    spec = reorder.dbg_spec(max(1.0, d.mean()))
    assert spec.boundaries == p.spec.boundaries
    np.testing.assert_array_equal(p.group_of,
                                  _assign_groups(d, spec.boundaries))


def test_incremental_dbg_hysteresis_band_matches_reference(base_graph):
    degs = base_graph[1].out_degrees().copy()
    rng = np.random.default_rng(8)
    d, steps = degs.copy(), []
    for _ in range(5):
        vs = rng.choice(d.shape[0], 60, replace=False)
        d[vs] = np.maximum(0, d[vs] + rng.integers(-6, 7, vs.shape[0]))
        steps.append((vs, d[vs].copy()))
    h = 0.5
    p = _drive_idbg(degs, dict(hysteresis=h, spec_drift_tol=10.0), steps)
    b = np.asarray(p.spec.boundaries, dtype=np.int64)
    pure = _assign_groups(d, p.spec.boundaries)
    for v in np.where(p.group_of != pure)[0]:
        if pure[v] < p.group_of[v]:
            assert d[v] < np.ceil(b[p.group_of[v] - 1] * (1 + h))
        else:
            assert d[v] >= b[p.group_of[v]] / (1 + h)


def test_incremental_dbg_oscillating_vertex_does_not_churn(base_graph):
    degs = base_graph[1].out_degrees().copy()
    b = stream.IncrementalDBG(degs).spec.boundaries[2]
    steps = [(np.array([0]), np.array([b if i % 2 == 0 else b - 1]))
             for i in range(20)]
    p = _drive_idbg(degs, dict(hysteresis=0.25, spec_drift_tol=10.0), steps)
    assert p.total_moved <= 1


def test_incremental_dbg_spec_drift_triggers_rebuild(base_graph):
    degs = base_graph[1].out_degrees().copy()
    vs = np.arange(degs.shape[0] // 2)
    p = _drive_idbg(degs, dict(spec_drift_tol=0.2),
                    [(vs, degs[vs] + 40)])
    d = degs.copy()
    d[vs] += 40
    np.testing.assert_array_equal(p.group_of,
                                  _assign_groups(d, p.spec.boundaries))
    assert p.spec.boundaries != stream.IncrementalDBG(degs).spec.boundaries


def test_remap_delta_merge_matches_reference(base_graph):
    degs = base_graph[1].out_degrees().copy()
    r = ref_stream.IncrementalDBG(degs, hysteresis=0.0)
    p = stream.IncrementalDBG(degs, hysteresis=0.0)
    rng = np.random.default_rng(10)
    rds, pds = [], []
    for _ in range(4):
        vs = rng.choice(degs.shape[0], 80, replace=False)
        nd = rng.integers(0, 60, vs.shape[0])
        rds.append(r.update(vs, nd))
        pds.append(p.update(vs, nd))
    _assert_remap_equal(ref_stream.RemapDelta.merge(rds),
                        stream.RemapDelta.merge(pds))
    _assert_remap_equal(ref_stream.RemapDelta.merge([]),
                        stream.RemapDelta.merge([]))
    _eq(r.hot_ids(2), p.hot_ids(2))
    _eq(r.pure_groups(), p.pure_groups())


# ---------------------------------------------------------------------------
# Service loop, health, locality, traces
# ---------------------------------------------------------------------------

def _stats(st):
    return {k: v for k, v in dataclasses.asdict(st).items()
            if not k.endswith("seconds")}


def _ingest_both(rsvc, psvc, batch):
    rs, ps = rsvc.ingest(**batch), psvc.ingest(**batch)
    assert _stats(rs) == _stats(ps)
    return rs, ps


def test_service_regroup_every_accumulates_touched(base_graph):
    kw = dict(regroup_every=2, hysteresis=0.0, spec_drift_tol=100.0)
    rsvc, psvc = _services(base_graph, **kw)
    rng = np.random.default_rng(10)
    for i in range(4):
        a_s, a_d, d_s, d_d = _random_batch(rsvc.dg, rng, n_add=80, n_del=20)
        _, st = _ingest_both(rsvc, psvc, dict(add_src=a_s, add_dst=a_d,
                                              del_src=d_s, del_dst=d_d))
        ran_regroup = (i % 2) == 1
        assert (st.regroup_seconds > 0) == ran_regroup
        if ran_regroup:
            np.testing.assert_array_equal(psvc.regrouper.degrees,
                                          psvc.dg.out_deg)
            _assert_idbg_equal(rsvc.regrouper, psvc.regrouper)
    assert len(psvc.remap_deltas) == len(rsvc.remap_deltas) == 2
    for rd, pd in zip(rsvc.remap_deltas, psvc.remap_deltas):
        _assert_remap_equal(rd, pd)


def _churn(rsvc, psvc, seed, n=3, **kw):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        a_s, a_d, d_s, d_d = _random_batch(rsvc.dg, rng, **kw)
        _ingest_both(rsvc, psvc, dict(add_src=a_s, add_dst=a_d, del_src=d_s,
                                      del_dst=d_d))


def test_service_history_and_locality_hook(base_graph):
    rsvc, psvc = _services(base_graph, regroup_every=1)
    _churn(rsvc, psvc, 9, n_add=60, n_del=20)
    assert len(psvc.history) == 3 and psvc.batches_applied == 3
    assert all(st.total_seconds > 0 for st in psvc.history)
    assert ([_stats(s) for s in psvc.history]
            == [_stats(s) for s in rsvc.history])
    assert psvc.compactions == rsvc.compactions
    _eq(rsvc.current_mapping(), psvc.current_mapping())
    for rd, pd in zip(rsvc.remap_deltas, psvc.remap_deltas):
        _assert_remap_equal(rd, pd)
    loc = psvc.locality(max_len=200_000)
    assert loc == rsvc.locality(max_len=200_000)
    assert set(loc) == {"identity", "incremental_dbg"}
    for layout_mpka in loc.values():
        assert set(layout_mpka) == {"l1_mpka", "l2_mpka", "l3_mpka"}
        assert all(np.isfinite(x) and x >= 0 for x in layout_mpka.values())
    gauges = {k: v for k, v in metrics.get_registry().snapshot().items()
              if k.startswith("cachesim.mpka.")}
    want = {k: v for k, v in ref_metrics.get_registry().snapshot().items()
            if k.startswith("cachesim.mpka.")}
    assert gauges == want and len(gauges) == 6
    m = psvc.current_mapping()
    assert sorted(m.tolist()) == list(range(base_graph[1].num_vertices))


def test_layout_and_packed_mpka_match_reference(base_graph):
    rg, pg = base_graph
    mapping = reorder.dbg(pg.out_degrees()).mapping
    for kw in (dict(), dict(include_structure=True), dict(mode="push")):
        assert (stream.layout_mpka(pg, mapping, max_len=100_000, **kw)
                == ref_stream.layout_mpka(rg, mapping, max_len=100_000, **kw))
    rp = ref_layout.pack_graph(rg)
    pp = layout.pack_graph(pg)
    for kw in (dict(), dict(pin_hot=True)):
        assert (stream.packed_mpka(pp, max_len=100_000, **kw)
                == ref_stream.packed_mpka(rp, max_len=100_000, **kw))


def test_health_matches_reference(base_graph):
    rsvc, psvc = _services(base_graph)
    _churn(rsvc, psvc, 14, n=2, n_add=30, n_del=10)
    rsvc.sssp(0)
    psvc.sssp(0)
    rh, ph = rsvc.health(), psvc.health()
    assert ph["ingest"] == rh["ingest"] == {
        "batches_applied": 2, "compactions": 0, "remap_deltas": 2,
        "sssp_roots": 1}
    assert set(ph) == set(rh)
    assert set(ph["objectives"]) == set(rh["objectives"])
    for name, o in ph["objectives"].items():
        assert set(o) == set(rh["objectives"][name])
        assert o["breached"] == rh["objectives"][name]["breached"]
    assert ph["status"] == rh["status"] == "ok"


def test_slo_breach_triggers_the_flight_recorder(base_graph, tmp_path):
    """A per-batch ingest time over its p99 target snapshots the flight
    ring, as the reference's does."""
    from repro.obs import flight as ref_flight

    rsvc, psvc = _services(base_graph, slo_ingest_p99_s=1e-9,
                           slo_windows=(30.0,))
    dumps = []
    for fl, svc in ((ref_flight, rsvc), (flight, psvc)):
        fr = fl.install(capacity=64, dump_dir=str(tmp_path / fl.__name__))
        try:
            svc.ingest(add_src=[1], add_dst=[2])
            svc.health()
            dumps.append([(d["reason"], d["context"]["objective"])
                          for d in fr.triggers])
        finally:
            fl.uninstall()
    assert dumps[0] == dumps[1] and dumps[1]
    assert dumps[1][0] == ("slo_breach", "stream.ingest_seconds")


def _strip(events):
    return [{k: v for k, v in e.items()
             if k not in ("ts", "dur", "pid", "tid")} for e in events]


def test_service_trace_events_match_reference(base_graph):
    """The service's spans (stream.ingest / .apply / .refresh / .regroup /
    .compact / .repack / .query.* / .locality) equal repro.obs's, clocks and
    ids aside."""
    cfg = dict(compact_threshold=0.02, repack_on_compact=True)
    rsvc, psvc = _services(base_graph, **cfg)
    rtr, ptr = ref_trace.enable(), obs_trace.enable()
    rng = np.random.default_rng(15)
    for _ in range(3):
        a_s, a_d, d_s, d_d = _random_batch(rsvc.dg, rng, n_add=90, n_del=30)
        batch = dict(add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
        _ingest_both(rsvc, psvc, batch)
        for svc in (rsvc, psvc):
            svc.pagerank()
            svc.sssp(3)
    for svc in (rsvc, psvc):
        svc.locality(max_len=50_000)
    assert psvc.compactions >= 1
    got = _strip(ptr.events)
    names = {e["name"] for e in got}
    assert {"stream.ingest", "stream.apply", "stream.refresh",
            "stream.regroup", "stream.compact", "stream.repack",
            "stream.query.pagerank", "stream.query.sssp",
            "stream.locality"} <= names
    assert got == _strip(rtr.events)


def test_packed_graph_from_delta_matches_reference(base_graph):
    rdg, pdg = _dgs(base_graph)
    rng = np.random.default_rng(16)
    a_s, a_d, d_s, d_d = _random_batch(rdg, rng)
    _apply_both(rdg, pdg, add_src=a_s, add_dst=a_d, del_src=d_s, del_dst=d_d)
    rp = ref_layout.PackedGraph.from_delta(rdg)
    pp = layout.PackedGraph.from_delta(pdg)
    for ra, pa in ((rp.in_adj, pp.in_adj), (rp.out_adj, pp.out_adj)):
        assert (ra.num_vertices, ra.num_edges, ra.boundaries,
                ra.hot_group_count) == (pa.num_vertices, pa.num_edges,
                                        pa.boundaries, pa.hot_group_count)
        for rh, ph in zip(ra.hot, pa.hot):
            for f in ("rows", "deg", "idx", "w"):
                _eq(getattr(rh, f), getattr(ph, f))
        for f in ("ctrl", "data", "vpb", "block_ctrl", "block_data"):
            _eq(getattr(ra.cold.lists, f), getattr(pa.cold.lists, f))
    _assert_graphs_equal(rp.unpack(), pp.unpack())


def test_apply_remaps_to_waits_for_the_sharded_layout(base_graph):
    psvc = stream.StreamService(base_graph[1], device=CPU)
    with pytest.raises(NotImplementedError, match="A11"):
        psvc.apply_remaps_to(None)


def test_stream_refresh_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                               base_graph):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream.StreamService(base_graph[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        stream.IncrementalSSSP(stream.DeltaGraph(base_graph[1]), 0)
