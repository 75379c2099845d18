"""The port's serving plane (``repro_torch.serve``) against ``repro.serve``.

Each test of tests/test_serve.py and tests/test_serve_incremental.py has a
parity case here: the same graphs (``kr`` / ``lj`` at ``test`` scale, or
seeded random ones, carried across through ``convert.graph_from_numpy``),
queries and update batches go through both packages; the reference runs
``ell`` / ``packed`` with K5 in Pallas interpret mode, the port on the CPU
through K5's plain version.  Bands: SSSP bitwise with equal iterations;
PageRank within the reference's own 1e-6 at test scale (ranks ~5e-4) with
iterations within 1; versions, epochs, queue behaviour, metrics, health and
trace events equal.  The port's batches also hold to the port's own
single-query apps, and run bitwise the same twice.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.apps.engine as ref_engine  # noqa: E402
from repro import serve as ref_serve  # noqa: E402
from repro.apps import to_arrays as ref_to_arrays  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.obs import counters as ref_counters  # noqa: E402
from repro.obs import flight as ref_flight  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro_torch import apps, serve  # noqa: E402
from repro_torch.apps import engine  # noqa: E402
from repro_torch.convert import graph_from_numpy  # noqa: E402
from repro_torch.obs import counters, flight, metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve import (GraphServeService, Query,  # noqa: E402
                               QueueFull, ServeConfig, ServeMetrics)
from repro_torch.stream import StreamBackend  # noqa: E402
from repro_torch.tune import plan as tune_plan  # noqa: E402

CPU = torch.device("cpu")
BACKENDS = ("flat", "ell", "packed")


def _reset():
    for tr in (obs_trace, ref_trace):
        tr.disable()
    for fl in (flight, ref_flight):
        fl.uninstall()
    engine.set_edge_map_hook(None)
    ref_engine.set_edge_map_hook(None)
    metrics.reset_registry()
    ref_metrics.reset_registry()


@pytest.fixture(autouse=True)
def _clean_state():
    """The port's active plan is off and its tracer, flight sink, registry
    and engine hook clean around each test (tests/conftest.py does the same
    for ``repro``)."""
    prev = tune_plan.set_active_plan(None)
    _reset()
    yield
    _reset()
    tune_plan.set_active_plan(prev)


def _port(g):
    return graph_from_numpy(g.in_csr.indptr, g.in_csr.indices,
                            g.in_csr.weights, g.out_csr.indptr,
                            g.out_csr.indices, g.out_csr.weights, g.name)


def _rand_pair(n, e, seed, weighted):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) + 0.01 if weighted else None
    g = ref_csr.from_edges(src, dst, n, weights=w)
    return g, _port(g)


@pytest.fixture(scope="module")
def small_pair():
    g = ref_datasets.load("kr", "test")
    return g, _port(g)


def _services(pair, clock=None, **cfg):
    """The reference's and the port's service over one graph, one config."""
    kw = {} if clock is None else {"clock": clock}
    return (ref_serve.GraphServeService(pair[0],
                                        ref_serve.ServeConfig(**cfg), **kw),
            GraphServeService(pair[1], ServeConfig(**cfg), device=CPU, **kw))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _assert_results(rres, pres, pr_atol=1e-6):
    """Two services' results for the same submissions: same qids, kinds,
    versions and epochs; SSSP bitwise with equal iterations, PageRank in
    the band with iterations within 1."""
    assert [(r.qid, r.kind, r.snapshot_version, r.submit_epoch)
            for r in rres] == [(r.qid, r.kind, r.snapshot_version,
                                r.submit_epoch) for r in pres]
    for r, p in zip(rres, pres):
        assert p.value.dtype == np.float32
        if r.kind == "sssp":
            np.testing.assert_array_equal(p.value, r.value)
            assert p.iters == r.iters
        else:
            np.testing.assert_allclose(p.value, r.value, atol=pr_atol)
            assert abs(p.iters - r.iters) <= 1


# ---------------------------------------------------------------------------
# batched == independent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,e,seed,weighted,backend,k", [
    (12, 12, 0, False, "flat", 1),
    (40, 200, 11, True, "flat", 5),
    (64, 384, 23, True, "ell", 4),
    (33, 66, 37, False, "ell", 3),
    (50, 150, 41, True, "packed", 5),
    (20, 120, 53, False, "packed", 2),
])
def test_batched_equals_independent(n, e, seed, weighted, backend, k):
    rg, pg = _rand_pair(n, e, seed, weighted)
    ga = apps.to_arrays(pg, backend=backend, device=CPU)
    rga = ref_to_arrays(rg, backend=backend)
    rng = np.random.default_rng(seed + 1)
    roots = rng.integers(0, n, k)

    dist, iters = serve.batched_sssp(ga, torch.from_numpy(roots))
    assert dist.shape == (n, k) and iters.dtype == torch.int32
    rdist, riters = ref_serve.batched_sssp(rga, jnp.asarray(roots, jnp.int32))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(rdist))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(riters))
    for i, r in enumerate(roots):
        d1, it1 = apps.sssp(ga, int(r))
        np.testing.assert_array_equal(dist[:, i].numpy(), d1.numpy())
        assert int(iters[i]) == it1

    p = np.zeros((n, k), np.float32)
    for i, r in enumerate(roots):
        if i % 2 == 0:
            p[:, i] = 1.0 / n
        else:
            p[r, i] = 1.0
    ranks, prit = serve.batched_pagerank(ga, torch.from_numpy(p),
                                         max_iters=32)
    rranks, rprit = ref_serve.batched_pagerank(rga, jnp.asarray(p),
                                               max_iters=32)
    np.testing.assert_allclose(ranks.numpy(), np.asarray(rranks), atol=1e-6)
    assert np.abs(prit.numpy() - np.asarray(rprit)).max() <= 1
    for i in range(k):
        r1, it1 = serve.batched_pagerank(ga, torch.from_numpy(p[:, i:i + 1]),
                                         max_iters=32)
        np.testing.assert_allclose(ranks[:, i].numpy(), r1[:, 0].numpy(),
                                   atol=1e-6)
        assert abs(int(prit[i]) - int(it1[0])) <= 1
    # no float atomics anywhere: a second run is bitwise the same
    again, _ = serve.batched_pagerank(ga, torch.from_numpy(p), max_iters=32)
    assert torch.equal(again, ranks)


def test_batched_sssp_duplicate_roots_and_frozen_lanes():
    rg, pg = _rand_pair(60, 300, 5, True)
    ga = apps.to_arrays(pg, backend="ell", device=CPU)
    roots = np.array([3, 3, 7, 3])
    dist, iters = serve.batched_sssp(ga, torch.from_numpy(roots))
    for i in (1, 3):
        assert torch.equal(dist[:, 0], dist[:, i])
    rdist, riters = ref_serve.batched_sssp(ref_to_arrays(rg),
                                           jnp.asarray(roots, jnp.int32))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(rdist))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(riters))
    # a lane that converged early holds bitwise while the batch runs on:
    # the batch stopped at the lane's last iteration leaves it as it ends
    p = np.zeros((60, 2), np.float32)
    p[:, 0] = 1.0 / 60
    p[5, 1] = 1.0
    plane = torch.from_numpy(p)
    ranks, it = serve.batched_pagerank(ga, plane, tol=1e-3)
    early, late = sorted((0, 1), key=lambda i: int(it[i]))
    assert int(it[early]) < int(it[late])
    stopped, _ = serve.batched_pagerank(ga, plane, tol=1e-3,
                                        max_iters=int(it[early]))
    assert torch.equal(ranks[:, early], stopped[:, early])
    assert not torch.equal(ranks[:, late], stopped[:, late])


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_uniform_lane_matches_global_pagerank(small_pair, backend):
    rg, pg = small_pair
    ga = apps.to_arrays(pg, backend=backend, device=CPU)
    v = pg.num_vertices
    p = np.full((v, 3), 1.0 / v, np.float32)
    p[:, 1] = 0.0
    p[7, 1] = 1.0
    ranks, _ = serve.batched_pagerank(ga, torch.from_numpy(p), max_iters=64)
    ref, _ = apps.pagerank(ga, max_iters=64)
    for lane in (0, 2):
        np.testing.assert_allclose(ranks[:, lane].numpy(), ref.numpy(),
                                   atol=1e-6)
    rranks, _ = ref_serve.batched_pagerank(ref_to_arrays(rg), jnp.asarray(p),
                                           max_iters=64)
    np.testing.assert_allclose(ranks.numpy(), np.asarray(rranks), atol=1e-6)


def test_batch_frontier_density_matches_reference(small_pair):
    rg, pg = small_pair
    f = np.random.default_rng(0).random((pg.num_vertices, 4)) < 0.1
    got = serve.batch_frontier_density(apps.to_arrays(pg, device=CPU),
                                       torch.from_numpy(f))
    want = ref_serve.batch_frontier_density(ref_to_arrays(rg),
                                            jnp.asarray(f))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


# ---------------------------------------------------------------------------
# admission queue (numpy copy: the same script, the same outcome)
# ---------------------------------------------------------------------------

def _both(fn):
    return fn(ref_serve), fn(serve)


def test_queue_backpressure_and_cancel():
    def script(m):
        q = m.QueryQueue(max_width=2, max_depth=2)
        a = q.submit(m.Query("pagerank"))
        q.submit(m.Query("pagerank"))
        with pytest.raises(m.QueueFull):
            q.submit(m.Query("pagerank"))
        out = [q.rejected, q.cancel(a), q.cancel(a)]
        q.submit(m.Query("sssp", root=0))
        return out + [len(q), q.submitted, q.cancelled]

    r, p = _both(script)
    assert p == r == [1, True, False, 2, 3, 1]
    assert QueueFull is serve.QueueFull


def test_queue_priority_then_fifo_one_kind_per_batch():
    def script(m):
        q = m.QueryQueue(max_width=3, max_depth=16)
        q.submit(m.Query("sssp", root=1))
        q.submit(m.Query("pagerank", priority=9))
        q.submit(m.Query("sssp", root=2, priority=5))
        q.submit(m.Query("sssp", root=3))
        b1 = q.next_batch(now=float("inf"))
        b2 = q.next_batch(now=float("inf"))
        return ([p.query.kind for p in b1], [p.query.root for p in b2])

    r, p = _both(script)
    assert p == r == (["pagerank"], [2, 1, 3])


def test_queue_deadline_dispatch():
    def script(m):
        clock = FakeClock()
        q = m.QueryQueue(max_width=4, max_depth=16, deadline=1.0, clock=clock)
        q.submit(m.Query("pagerank"))
        out = [len(q.next_batch())]
        clock.t = 2.0
        out.append(len(q.next_batch()))
        for _ in range(4):
            q.submit(m.Query("pagerank"))
        out.append(len(q.next_batch()))
        return out

    r, p = _both(script)
    assert p == r == [0, 1, 4]


def test_query_validation():
    for m in (ref_serve, serve):
        with pytest.raises(ValueError, match="needs a root"):
            m.Query("sssp")
        with pytest.raises(ValueError, match="unknown query kind"):
            m.Query("triangle_count")
        with pytest.raises(ValueError):
            m.QueryQueue(max_width=0)


def test_query_epochs_are_monotone():
    def script(m):
        q = m.QueryQueue(max_width=8, max_depth=8)
        epochs = [q.submit(m.Query("pagerank")) for _ in range(3)]
        return epochs, [p.submit_epoch for p in q.next_batch(now=float("inf"))]

    r, p = _both(script)
    assert p == r and p[0] == p[1] == sorted(p[0])


# ---------------------------------------------------------------------------
# snapshot store and metrics
# ---------------------------------------------------------------------------

def test_snapshot_store_refcount_and_epoch_reclaim():
    def script(m, csr):
        rng = np.random.default_rng(0)
        g = csr.from_edges(rng.integers(0, 16, 32), rng.integers(0, 16, 32),
                           16)
        g2 = csr.from_edges(rng.integers(0, 16, 40), rng.integers(0, 16, 40),
                            16)
        store = m.SnapshotStore(g)
        s0 = store.acquire()
        out = [s0.version, store.live_versions]
        store.publish(g2)
        out += [store.current_version, store.live_versions, s0.graph is g]
        s1 = store.acquire()
        out.append(s1.version)
        store.release(s0)
        out += [store.live_versions, store.reclaimed]
        store.release(s1)
        out.append(store.live_versions)
        with pytest.raises(RuntimeError):
            store.release(s1)
        out.append(dict(store.registry.snapshot()))
        return out

    from repro_torch.graph import csr

    r = script(ref_serve, ref_csr)
    p = script(serve, csr)
    rsnap, psnap = r.pop(), p.pop()
    assert p == r == [0, 1, 1, 2, True, 1, 1, 1, 1]
    for k in ("snapshot.live_versions", "snapshot.pinned_readers",
              "snapshot.published", "snapshot.reclaimed",
              "snapshot.publish_seconds_count"):
        assert psnap[k] == rsnap[k], k


def test_snapshot_cached_builds_once(small_pair):
    for m, g in zip((ref_serve, serve), small_pair):
        snap = m.SnapshotStore(g).acquire()
        calls = []
        b1 = snap.cached("k", lambda g: calls.append(1) or object())
        b2 = snap.cached("k", lambda g: calls.append(1) or object())
        assert b1 is b2 and len(calls) == 1


def test_snapshot_reclaim_stall_triggers_the_flight_recorder(small_pair,
                                                             tmp_path):
    dumps = []
    for m, fl, g in ((ref_serve, ref_flight, small_pair[0]),
                     (serve, flight, small_pair[1])):
        fr = fl.install(capacity=64, dump_dir=str(tmp_path / fl.__name__))
        try:
            store = m.SnapshotStore(g, stall_threshold=1)
            for _ in range(3):
                store.acquire()
                store.publish(g)
            dumps.append([(d["reason"], d["context"]["retired_pinned"])
                          for d in fr.triggers])
        finally:
            fl.uninstall()
    assert dumps[0] == dumps[1] == [("reclaim_stall", 2)]


def test_metrics_occupancy_and_quantiles():
    outs = []
    for m in (ref_serve.ServeMetrics, ServeMetrics):
        sm = m(max_width=4)
        sm.record_batch("pagerank", 4, 0.1, [0.1] * 4, [0.0] * 4)
        sm.record_batch("sssp", 2, 0.2, [0.2, 0.4], [0.0, 0.0])
        sm.record_cancelled()
        sm.record_rejected(2)
        outs.append((sm.summary(), sm.batches, sm.completed, sm.occupancy,
                     sm.by_kind))
    assert outs[0] == outs[1]
    s = outs[1][0]
    assert outs[1][3] == pytest.approx(6 / 8)
    assert s["queries_pagerank"] == 4 and s["queries_sssp"] == 2
    assert s["latency_p50_ms"] == pytest.approx(100.0)
    assert s["latency_p99_ms"] > s["latency_p50_ms"]
    assert (s["cancelled"], s["rejected"]) == (1, 2)


# ---------------------------------------------------------------------------
# the service end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["flat", "auto"])
def test_service_batch_matches_single_apps(small_pair, backend):
    rsvc, psvc = _services(small_pair, max_width=4, backend=backend)
    for svc in (rsvc, psvc):
        for _ in range(2):
            svc.submit(_query(svc, "pagerank"))
        svc.submit(_query(svc, "sssp", root=1))
        svc.submit(_query(svc, "sssp", root=7))
    rres, pres = rsvc.drain(), psvc.drain()
    assert len(pres) == 4
    _assert_results(rres, pres)
    ga = apps.to_arrays(small_pair[1], device=CPU)
    ref_pr, it_pr = apps.pagerank(ga, max_iters=64, tol=1e-7)
    ref_d1, it_d1 = apps.sssp(ga, 1)
    by_kind = {}
    for r in pres:
        by_kind.setdefault(r.kind, []).append(r)
    np.testing.assert_allclose(by_kind["pagerank"][0].value, ref_pr.numpy(),
                               atol=1e-6)
    assert abs(by_kind["pagerank"][0].iters - it_pr) <= 1
    d1 = next(r for r in by_kind["sssp"] if r.value[1] == 0.0)
    assert d1.iters == it_d1
    np.testing.assert_array_equal(d1.value, ref_d1.numpy())
    assert all(r.snapshot_version == 0 for r in pres)
    assert psvc.metrics.completed == 4 and psvc.metrics.batches == 2
    if backend == "auto":  # the default plan: ell, cached per app + device
        snap = psvc.store.acquire()
        assert set(snap._cache) == {"backend:auto:pr:cpu",
                                    "backend:auto:sssp:cpu",
                                    "tune:sssp_threshold"}
        assert all(isinstance(snap._cache[f"backend:auto:{a}:cpu"],
                              engine.EllBackend) for a in ("pr", "sssp"))
        assert snap._cache["tune:sssp_threshold"] == 0.05
        psvc.store.release(snap)


def _query(svc, kind, **kw):
    m = serve if isinstance(svc, GraphServeService) else ref_serve
    return m.Query(kind, **kw)


@pytest.mark.parametrize("incremental", [False, True])
def test_service_snapshot_isolation_under_churn(small_pair, incremental):
    """A batch pinned to version N equals the from-scratch answer on the
    version-N graph, however much ingest lands between submit and
    dispatch — and equals the reference's answer for that version."""
    rsvc, psvc = _services(small_pair, max_width=2, publish_every=1,
                           incremental_publish=incremental)
    v = small_pair[1].num_vertices
    pinned = {0: psvc.store.acquire()}
    rng = np.random.default_rng(0)
    rres, pres = [], []
    for step in range(4):
        root = int(rng.integers(0, v))
        batch = dict(add_src=rng.integers(0, v, 64),
                     add_dst=rng.integers(0, v, 64))
        for svc, out in ((rsvc, rres), (psvc, pres)):
            svc.submit(_query(svc, "sssp", root=root))
            svc.submit(_query(svc, "pagerank"))
            svc.ingest(**batch)
            out.extend(svc.drain())
        pinned[psvc.snapshot_version] = psvc.store.acquire()
    assert {r.snapshot_version for r in pres} == {1, 2, 3, 4}
    _assert_results(rres, pres)
    for version, snap in pinned.items():  # lazy until a reader forces it
        assert snap.materialized == (version == 0 or not incremental)
    for r in pres:
        snap = pinned[r.snapshot_version]
        ga = apps.to_arrays(snap.graph, device=CPU)
        if r.kind == "sssp":
            root = int(np.flatnonzero(r.value == 0.0)[0])
            ref, it = apps.sssp(ga, root)
            np.testing.assert_array_equal(r.value, ref.numpy())
            assert r.iters == it
        else:
            ref, _ = apps.pagerank(ga, max_iters=64, tol=1e-7)
            np.testing.assert_allclose(r.value, ref.numpy(), atol=1e-6)
    for snap in pinned.values():
        psvc.store.release(snap)
    assert psvc.store.live_versions == 1


def test_service_backpressure_and_cancellation(small_pair, tmp_path):
    out = []
    for svc, fl in zip(_services(small_pair, max_width=2, max_depth=2),
                       (ref_flight, flight)):
        fr = fl.install(capacity=64, dump_dir=str(tmp_path / fl.__name__))
        try:
            a = svc.submit(_query(svc, "pagerank"))
            svc.submit(_query(svc, "pagerank"))
            with pytest.raises(Exception) as e:
                svc.submit(_query(svc, "pagerank"))
            assert type(e.value).__name__ == "QueueFull"
            assert svc.cancel(a) and not svc.cancel(a)
            res = svc.drain()
            out.append(([r.qid for r in res], svc.metrics.summary()["rejected"],
                         svc.metrics.cancelled,
                         [(d["reason"], d["context"]["depth"])
                          for d in fr.triggers]))
        finally:
            fl.uninstall()
    # the rejection also breaches the rejection-rate SLO (1 of 3 > 5%)
    assert out[0] == out[1] == ([1], 1, 1, [("slo_breach", 2),
                                            ("queue_full", 2)])


def test_deadline_zero_dispatches_partial_batches(small_pair):
    occ = []
    for svc in _services(small_pair, max_width=8, deadline=0.0):
        svc.submit(_query(svc, "sssp", root=0))
        assert len(svc.pump()) == 1
        assert svc.pump() == []
        occ.append(svc.metrics.occupancy)
    assert occ[0] == occ[1] == pytest.approx(1 / 8)


def test_service_auto_backend_resolves_the_active_plan(small_pair):
    """``backend="auto"`` serves through the plan set in the port, and
    agrees with the reference serving through the same plan."""
    rg, pg = small_pair
    cells = [{"family": "kr", "features": tune_plan.graph_features(pg),
              "configs": {"pr": {"backend": "packed", "row_tile": 32},
                          "sssp": {"backend": "ell", "width_tile": 64,
                                   "density_threshold": 0.2}}}]
    from repro.tune import plan as ref_plan

    tune_plan.set_active_plan(tune_plan.build_plan(cells))
    ref_plan.set_active_plan(ref_plan.build_plan(cells))
    rsvc, psvc = _services(small_pair, max_width=2, backend="auto")
    for svc in (rsvc, psvc):
        svc.submit(_query(svc, "pagerank"))
        svc.submit(_query(svc, "pagerank", root=3))
        svc.submit(_query(svc, "sssp", root=2))
    _assert_results(rsvc.drain(), psvc.drain(), pr_atol=1e-6)
    snap = psvc.store.acquire()
    from repro_torch.pack.engine import PackedBackend

    assert isinstance(snap._cache["backend:auto:pr:cpu"], PackedBackend)
    assert snap._cache["backend:auto:sssp:cpu"].width_tile == 64
    assert psvc._sssp_threshold(snap) == 0.2
    psvc.store.release(snap)


def test_teleport_plane_equals_the_references(small_pair):
    rsvc, psvc = _services(small_pair, max_width=4)
    v = small_pair[1].num_vertices
    pers = np.random.default_rng(1).random(v).astype(np.float32)
    qs = [dict(), dict(root=11), dict(personalization=pers),
          dict(personalization=pers, root=4)]
    batches = [[serve.PendingQuery(m.Query("pagerank", **q), i, i, 0.0)
                for i, q in enumerate(qs)] for m in (ref_serve, serve)]
    want = rsvc._teleport_plane(v, batches[0])
    got = psvc._teleport_plane(v, batches[1])
    assert got.dtype == torch.float32 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), want)


def test_results_are_bitwise_the_same_twice(small_pair):
    out = []
    for _ in range(2):
        svc = GraphServeService(small_pair[1], ServeConfig(max_width=3,
                                                           backend="packed"),
                                device=CPU)
        for q in (Query("pagerank"), Query("pagerank", root=9),
                  Query("sssp", root=4), Query("sssp", root=5)):
            svc.submit(q)
        out.append(svc.drain())
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.value, b.value)
        assert a.iters == b.iters


# ---------------------------------------------------------------------------
# incremental (O(delta)) publishing
# ---------------------------------------------------------------------------

def _edges_sorted(g):
    src = np.repeat(np.arange(g.num_vertices, dtype=np.int64),
                    g.out_csr.degrees().astype(np.int64))
    dst = np.asarray(g.out_csr.indices, np.int64)
    w = g.out_csr.weights
    cols = [src, dst] if w is None else [src, dst, np.asarray(w)]
    order = np.lexsort(tuple(reversed(cols)))
    return [c[order] for c in cols]


def test_incremental_publish_reuses_base_and_stays_lazy(small_pair):
    rsvc, psvc = _services(small_pair, incremental_publish=True)
    v = small_pair[1].num_vertices
    rng = np.random.default_rng(1)
    b1 = dict(add_src=rng.integers(0, v, 40), add_dst=rng.integers(0, v, 40))
    b2 = dict(add_src=rng.integers(0, v, 40), add_dst=rng.integers(0, v, 40))
    svc = psvc
    svc.ingest(**b1)
    rsvc.ingest(**b1)
    s1 = svc.store.acquire()
    assert not s1.materialized and s1.num_vertices == v
    assert not s1.materialized
    k1 = s1._cache["backend:stream"]
    assert isinstance(k1, StreamBackend)
    svc.ingest(**b2)
    rsvc.ingest(**b2)
    s2 = svc.store.acquire()
    k2 = s2._cache["backend:stream"]
    assert k2.sa.in_src is k1.sa.in_src
    assert k2.sa.out_dst is k1.sa.out_dst
    assert k2.sa.in_w is k1.sa.in_w
    assert k2.sa.in_alive is k1.sa.in_alive
    assert k2.sa.ex_alive is not k1.sa.ex_alive
    assert svc.store.published == rsvc.store.published == 3
    hist = svc.metrics.registry.get("snapshot.publish_seconds")
    assert hist is not None and hist.count == 3
    svc.store.release(s1)
    svc.store.release(s2)


@pytest.mark.parametrize("weighted", [False, True])
def test_incremental_answers_match_eager(weighted):
    load = ref_datasets.load_weighted if weighted else ref_datasets.load
    rg = load("lj", "test")
    pair = (rg, _port(rg))
    rng = np.random.default_rng(2)
    v = rg.num_vertices
    es = np.repeat(np.arange(v, dtype=np.int64),
                   rg.out_csr.degrees().astype(np.int64))
    kill = rng.choice(es.shape[0], 16, replace=False)
    kw = dict(add_src=rng.integers(0, v, 64), add_dst=rng.integers(0, v, 64),
              del_src=es[kill], del_dst=np.asarray(rg.out_csr.indices)[kill])
    if weighted:
        kw["add_w"] = rng.random(64).astype(np.float32) + 0.01
    answers = []
    for inc in (False, True):
        rsvc, psvc = _services(pair, max_width=2, incremental_publish=inc)
        got = []
        for svc in (rsvc, psvc):
            svc.ingest(**kw)
            svc.submit(_query(svc, "sssp", root=3))
            svc.submit(_query(svc, "pagerank"))
            got.append(svc.drain())
        _assert_results(*got)
        answers.append({r.kind: r for r in got[1]})
    eager, inc = answers
    np.testing.assert_array_equal(eager["sssp"].value, inc["sssp"].value)
    np.testing.assert_allclose(eager["pagerank"].value,
                               inc["pagerank"].value, atol=1e-6)
    snap = psvc.store.acquire()
    assert not snap.materialized
    ga = apps.to_arrays(snap.graph, device=CPU)
    assert snap.materialized
    ref, _ = apps.sssp(ga, 3)
    np.testing.assert_array_equal(inc["sssp"].value, ref.numpy())
    ref, _ = apps.pagerank(ga, max_iters=64, tol=1e-7)
    np.testing.assert_allclose(inc["pagerank"].value, ref.numpy(), atol=1e-6)
    psvc.store.release(snap)


def test_lazy_snapshot_pins_version_exactly(small_pair):
    rsvc, psvc = _services(small_pair, incremental_publish=True)
    v = small_pair[1].num_vertices
    rng = np.random.default_rng(3)
    batch = dict(add_src=rng.integers(0, v, 32), add_dst=rng.integers(0, v, 32))
    rsvc.ingest(**batch)
    psvc.ingest(**batch)
    snaps = [s.store.acquire() for s in (rsvc, psvc)]
    expected = psvc.stream.snapshot()
    for _ in range(2):
        es, ed, _ = psvc.stream.dg.alive_edges()
        kill = rng.choice(es.shape[0], 8, replace=False)
        batch = dict(add_src=rng.integers(0, v, 32),
                     add_dst=rng.integers(0, v, 32),
                     del_src=es[kill], del_dst=ed[kill])
        rsvc.ingest(**batch)
        psvc.ingest(**batch)
    got, rgot = snaps[1].graph, snaps[0].graph
    for a, b, c in zip(_edges_sorted(got), _edges_sorted(expected),
                       _edges_sorted(rgot)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for s, snap in zip((rsvc, psvc), snaps):
        s.store.release(snap)


# ---------------------------------------------------------------------------
# observability: counters, trace events, health
# ---------------------------------------------------------------------------

def test_record_iters_after_a_served_batch(small_pair):
    rc = ref_counters.install(registry=ref_metrics.MetricsRegistry())
    pc = counters.install(registry=metrics.MetricsRegistry())
    rsvc, psvc = _services(small_pair, max_width=3)
    for svc in (rsvc, psvc):
        svc.submit(_query(svc, "sssp", root=1))
        svc.submit(_query(svc, "sssp", root=2))
        svc.submit(_query(svc, "pagerank"))
    rres, pres = rsvc.drain(), psvc.drain()
    _assert_results(rres, pres)
    rs, ps = rc.summary(), pc.summary()
    keys = [k for k in ps if k.startswith(("edge_map.iters.",
                                           "edge_map.queries."))]
    assert sorted(keys) == ["edge_map.iters.pagerank", "edge_map.iters.sssp",
                            "edge_map.queries.pagerank",
                            "edge_map.queries.sssp"]
    assert ps["edge_map.queries.sssp"] == rs["edge_map.queries.sssp"] == 2
    assert ps["edge_map.iters.sssp"] == rs["edge_map.iters.sssp"] == sum(
        r.iters for r in pres if r.kind == "sssp")
    assert abs(ps["edge_map.iters.pagerank"]
               - rs["edge_map.iters.pagerank"]) <= 1
    # the port's hook fires per pass that ran: one pass per iteration
    passes = sum(v for k, v in ps.items() if k.startswith("edge_map.passes."))
    assert passes == max(r.iters for r in pres if r.kind == "sssp") + \
        ps["edge_map.iters.pagerank"]
    counters.uninstall()
    ref_counters.uninstall()


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
            for e in events]


@pytest.mark.parametrize("incremental", [False, True])
def test_service_trace_events_match_reference(small_pair, incremental):
    """submit/dispatch/result flows and async spans, the serve.batch /
    serve.ingest / serve.publish / engine.solve.* / serve.snapshot_materialize
    spans and the reclaim instants equal repro.obs's, clocks and ids
    aside."""
    clock = FakeClock()
    # a fixed PageRank iteration count (tol 0): the span and flow arguments
    # carry iterations, which a converging sum may reach one apart
    rsvc, psvc = _services(small_pair, clock=clock, max_width=2,
                           incremental_publish=incremental, pr_tol=0.0,
                           pr_max_iters=6)
    rtr, ptr = ref_trace.enable(), obs_trace.enable()
    v = small_pair[1].num_vertices
    rng = np.random.default_rng(4)
    for step in range(2):
        batch = dict(add_src=rng.integers(0, v, 16),
                     add_dst=rng.integers(0, v, 16))
        for svc in (rsvc, psvc):
            svc.submit(_query(svc, "sssp", root=step + 1))
            a = svc.submit(_query(svc, "pagerank", root=5))
            svc.submit(_query(svc, "pagerank"))
            svc.cancel(a)
            svc.ingest(**batch)
            svc.drain()
    for svc in (rsvc, psvc):
        snap = svc.store.acquire()
        snap.graph  # the lazy materialization, when incremental
        svc.store.release(snap)
    got = _strip(ptr.events)
    names = {e["name"] for e in got}
    assert {"serve.query", "serve.batch", "serve.ingest", "serve.publish",
            "engine.solve.sssp", "engine.solve.pagerank",
            "serve.reclaim"} <= names
    if incremental:
        assert "serve.snapshot_materialize" in names
    assert got == _strip(rtr.events)


def test_health_and_slo_breach_match_reference(small_pair, tmp_path):
    clock = FakeClock()
    rsvc, psvc = _services(small_pair, clock=clock, max_width=2,
                           slo_latency_p99_s=1e-9, slo_windows=(30.0,))
    dumps, healths = [], []
    for svc, fl in ((rsvc, ref_flight), (psvc, flight)):
        fr = fl.install(capacity=64, dump_dir=str(tmp_path / fl.__name__))
        try:
            svc.submit(_query(svc, "sssp", root=0))
            clock.t += 0.5
            svc.drain()
            clock.t -= 0.5
            healths.append(svc.health())
            dumps.append([(d["reason"], d["context"]["objective"])
                          for d in fr.triggers])
        finally:
            fl.uninstall()
    assert dumps[0] == dumps[1] == [("slo_breach", "serve.latency")]
    rh, ph = healths
    assert ph["queue"] == rh["queue"]
    assert ph["snapshots"] == rh["snapshots"] == {
        "version": 0, "live_versions": 1, "batch_epoch": 1,
        "ingest_batches": 0}
    assert set(ph) == set(rh) and ph["status"] == rh["status"]
    for name, o in ph["objectives"].items():
        assert set(o) == set(rh["objectives"][name])
        assert o["breached"] == rh["objectives"][name]["breached"]


def test_service_builds_on_the_device_it_is_given(small_pair):
    svc = GraphServeService(small_pair[1], ServeConfig(backend="ell"),
                            device="cpu")
    assert svc.device == CPU and svc.stream.device == CPU
    svc.submit(Query("sssp", root=0))
    svc.drain()
    snap = svc.store.acquire()
    (ga,) = snap._cache.values()
    assert ga.in_tiles[0].idx.device == CPU
    svc.store.release(snap)
