"""The port's ``obs`` against ``repro.obs`` on the same calls.

Tracer, flight ring and SLO tracker: the same calls on both sides export
the same events (timestamps, durations and thread/process ids aside) and
the same health.  Metrics: the same exact aggregates (count, sum, min,
max, and the quantiles while no more than ``max_samples`` values were
seen).  Edge-map counters: direct ``edge_map_pull`` / ``edge_map_push`` /
``out_edge_sum`` calls on ``flat``, ``ell``, ``packed`` and raw arrays,
eager on the reference side, give the same passes, edges, lanes, modeled
bytes and frontier densities; and instrumented app runs are bitwise equal
to bare ones.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.apps.engine as ref_engine  # noqa: E402
from repro import apps as ref_apps  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.obs import counters as ref_counters  # noqa: E402
from repro.obs import flight as ref_flight  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import slo as ref_slo  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro_torch import apps  # noqa: E402
from repro_torch.apps import engine  # noqa: E402
from repro_torch.graph import csr  # noqa: E402
from repro_torch.obs import counters, flight, metrics, slo  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ("flat", "ell", "packed", "arrays")


def _reset():
    for tr in (obs_trace, ref_trace):
        tr.disable()
    for fl in (flight, ref_flight):
        fl.uninstall()
    engine.set_edge_map_hook(None)
    ref_engine.set_edge_map_hook(None)
    metrics.reset_registry()


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """The port's tracer, flight sink, registry and engine hook are
    process-global, like the reference's: each test starts and ends clean."""
    _reset()
    yield
    _reset()


def _strip(events):
    """Events without what differs run to run: clock, process, thread."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
            for e in events]


#: prefixes of the spans the port's graph path records and the reference
#: has no counterpart of (set-up phases, app calls and iterations, the
#: engine's dispatch, host reads; ``tests/test_torch_obs_graph.py``)
GRAPH_PATH = ("reorder.", "engine.build.", "engine.edge_map_",
              "engine.out_edge_sum", "apps.")


def _held_to_reference(events):
    """The events the reference also records: all but the graph path's."""
    return [e for e in events if not e["name"].startswith(GRAPH_PATH)]


def _script(mod, tr):
    """One fixed sequence of recording calls against a trace module ``mod``
    with the tracer ``tr`` enabled."""
    mod.enable(tr)

    @mod.traced("core.step", cat="t")
    def step(x):
        return x + 1

    with mod.span("outer", cat="t", n=3) as sp:
        with mod.span("inner", cat="t"):
            step(1)
        sp.add(result=np.float32(2.5), ok=True)
        mod.instant("mark", cat="t", at=1)
        mod.counter("bytes", cat="t", total=10, edges=4)
    mod.flow_start("q", 7, cat="serve", kind="pr")
    mod.flow_step("q", 7, cat="serve")
    mod.async_begin("q", 7, cat="serve")
    mod.async_instant("q", 7, cat="serve", step=1)
    mod.async_end("q", 7, cat="serve")
    mod.flow_end("q", 7, cat="serve")
    mod.disable()
    return tr


# ---------------------------------------------------------------- trace
def test_span_nesting_matches_reference():
    tr, ref = obs_trace.Tracer(), ref_trace.Tracer()
    for t in (tr, ref):
        with t.span("outer", cat="t") as outer:
            assert t.depth == 1 and outer.depth == 0
            with t.span("inner", cat="t") as inner:
                assert t.depth == 2 and inner.depth == 1
            with t.span("inner2", cat="t"):
                pass
        assert t.depth == 0
    evs = tr.export()["traceEvents"]
    assert _strip(evs) == _strip(ref.export()["traceEvents"])
    by = {e["name"]: e for e in evs}
    for child in ("inner", "inner2"):
        assert by["outer"]["ts"] <= by[child]["ts"]
        assert (by[child]["ts"] + by[child]["dur"]
                <= by["outer"]["ts"] + by["outer"]["dur"] + 1e-6)
    assert by["inner"]["ts"] + by["inner"]["dur"] <= by["inner2"]["ts"] + 1e-6


def test_chrome_json_round_trip_equals_reference(tmp_path):
    port = _script(obs_trace, obs_trace.Tracer())
    ref = _script(ref_trace, ref_trace.Tracer())
    a = obs_trace.load_trace(port.save(str(tmp_path / "port.json")))
    b = ref_trace.load_trace(ref.save(str(tmp_path / "ref.json")))
    assert len(a["traceEvents"]) == 11
    assert _strip(a["traceEvents"]) == _strip(b["traceEvents"])
    assert a["displayTimeUnit"] == b["displayTimeUnit"]
    # each side's loader accepts the other's file
    ref_trace.validate_trace(a)
    obs_trace.validate_trace(b)


_BAD_TRACES = {
    "no_list": {"traceEvents": None},
    "no_ph": {"traceEvents": [{"name": "a", "ts": 0}]},
    "no_ts": {"traceEvents": [{"ph": "i", "name": "a"}]},
    "negative_ts": {"traceEvents": [{"ph": "i", "name": "a", "ts": -1}]},
    "no_dur": {"traceEvents": [{"ph": "X", "name": "a", "ts": 0,
                                "pid": 1, "tid": 1}]},
    "no_tid": {"traceEvents": [{"ph": "X", "name": "a", "ts": 0, "dur": 1,
                                "pid": 1}]},
    "flow_without_id": {"traceEvents": [{"ph": "s", "name": "a", "ts": 0}]},
    "dangling_flow": {"traceEvents": [{"ph": "f", "name": "a", "ts": 0,
                                       "id": 3, "cat": "c"}]},
    "dangling_async": {"traceEvents": [{"ph": "e", "name": "a", "ts": 0,
                                        "id": 3, "cat": "c"}]},
    "wrong_cat": {"traceEvents": [
        {"ph": "b", "name": "a", "ts": 0, "id": 3, "cat": "c"},
        {"ph": "e", "name": "a", "ts": 1, "id": 3, "cat": "d"}]},
}


@pytest.mark.parametrize("case", sorted(_BAD_TRACES))
def test_validate_trace_rejects_what_the_reference_rejects(case):
    bad = _BAD_TRACES[case]
    with pytest.raises(ValueError):
        ref_trace.validate_trace(bad)
    with pytest.raises(ValueError):
        obs_trace.validate_trace(bad)


def test_disabled_mode_is_a_shared_noop():
    assert not obs_trace.enabled() and not obs_trace.recording()
    assert obs_trace.span("a") is obs_trace.span("b")
    assert obs_trace.get_tracer() is obs_trace.NULL_TRACER
    obs_trace.flow_start("q", 1)
    obs_trace.async_end("q", 1)
    assert obs_trace.NULL_TRACER.export()["traceEvents"] == []
    tr = obs_trace.enable()
    with obs_trace.span("x"):
        pass
    assert obs_trace.disable() is tr and len(tr.events) == 1


# ---------------------------------------------------------------- flight
def _ring_ops(mod, rec):
    mod.install(recorder=rec)
    tr_mod = obs_trace if mod is flight else ref_trace
    for i in range(6):
        with tr_mod.span(f"s{i}", cat="t"):
            pass
    tr_mod.flow_start("q", 1, cat="serve")
    tr_mod.flow_end("q", 1, cat="serve")
    tr_mod.async_end("lost", 2, cat="serve")  # its begin never recorded
    return rec


def test_flight_ring_matches_reference(tmp_path):
    port = _ring_ops(flight, flight.FlightRecorder(
        capacity=4, dump_dir=str(tmp_path / "p"), wall_clock=lambda: 0.0))
    ref = _ring_ops(ref_flight, ref_flight.FlightRecorder(
        capacity=4, dump_dir=str(tmp_path / "r"), wall_clock=lambda: 0.0))
    assert len(port) == len(ref) == 4
    assert port.total_events == ref.total_events == 9
    assert (_strip(port.export()["traceEvents"])
            == _strip(ref.export()["traceEvents"]))
    p = port.trigger("queue_full", depth=3)
    assert port.trigger("queue_full") is None  # inside the cooldown
    r = ref.trigger("queue_full", depth=3)
    a, b = obs_trace.load_trace(p), ref_trace.load_trace(r)
    assert _strip(a["traceEvents"]) == _strip(b["traceEvents"])
    assert port.triggers == ref.triggers
    assert flight.trigger("slo_breach") is not None
    assert flight.uninstall() is port and flight.trigger("x") is None


def test_flight_tees_from_an_enabled_tracer():
    fr = flight.install(capacity=8)
    tr = obs_trace.enable()
    with obs_trace.span("a"):
        pass
    obs_trace.counter("c", n=1)
    assert [e["name"] for e in tr.events] == ["a", "c"]
    assert [e["name"] for e in fr.snapshot_events()] == ["a", "c"]
    obs_trace.disable()
    assert obs_trace.recording()  # the ring stays on
    with obs_trace.span("b"):
        pass
    assert [e["name"] for e in fr.snapshot_events()] == ["a", "c", "b"]


# ---------------------------------------------------------------- slo
def _slo_run(mod):
    now = [0.0]
    fired = []
    t = mod.SLOTracker(
        [mod.Objective("latency", "quantile", 0.01, quantile=0.9,
                       windows=(5.0, 50.0)),
         mod.Objective("admit", "rate", 0.1, windows=(10.0,)),
         mod.Objective("lag", "value", 2.0, windows=(10.0, 100.0),
                       description="ingest lag")],
        clock=lambda: now[0],
        on_breach=lambda name, info: fired.append((name, info["breached"])))
    rng = np.random.default_rng(0)
    for i in range(60):
        now[0] = float(i)
        t.observe("latency", float(rng.random() * 0.02))
        t.observe_ok("admit", bool(i % 4))
        t.observe("lag", float(i % 7) / 2.0)
    return t.health(), fired


def test_slo_health_matches_reference():
    port, ref = _slo_run(slo), _slo_run(ref_slo)
    assert port == ref
    json.dumps(port[0])
    with pytest.raises(ValueError):
        slo.Objective("x", "nope", 1.0)
    with pytest.raises(TypeError):
        slo.SLOTracker([slo.Objective("r", "rate", 0.1)]).observe("r", 1.0)


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("n", [0, 5, 64, 10_000])
def test_histogram_exact_aggregates_match_reference(n):
    xs = np.random.default_rng(n).normal(size=n) * 100
    h, r = metrics.Histogram("lat", 64), ref_metrics.Histogram("lat", 64)
    h.observe_many(xs)
    r.observe_many(xs)
    assert (h.count, h.total, h.min, h.max) == (r.count, r.total, r.min,
                                                r.max)
    assert h.num_samples == r.num_samples == min(n, 64)
    if n == 0:
        assert np.isnan(h.mean) and np.isnan(h.quantile(0.5))
    elif n <= 64:  # every value kept: the quantiles are exact on both
        assert h.quantiles((0.5, 0.9, 0.99)) == r.quantiles((0.5, 0.9, 0.99))
        assert h.mean == r.mean


def test_histogram_reservoir_is_the_same_in_every_process():
    """Seeded from the name's CRC-32: another hash seed, the same samples
    (the reference seeds from ``hash(name)``, which varies per process)."""
    code = ("import sys; sys.path.insert(0, 'src')\n"
            "import numpy as np\n"
            "from repro_torch.obs.metrics import Histogram\n"
            "h = Histogram('h', max_samples=64)\n"
            "h.observe_many(np.arange(10_000, dtype=np.float64))\n"
            "print(h.quantile(0.5), sum(h._samples))\n")
    outs = {subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           env=dict(os.environ, PYTHONHASHSEED=seed),
                           capture_output=True, text=True,
                           check=True).stdout
            for seed in ("0", "1", "12345")}
    assert len(outs) == 1
    h = metrics.Histogram("h", max_samples=64)
    h.observe_many(np.arange(10_000, dtype=np.float64))
    assert outs == {f"{h.quantile(0.5)} {sum(h._samples)}\n"}
    assert h.quantile(0.5) == pytest.approx(5000, rel=0.35)


def test_registry_snapshot_matches_reference():
    port, ref = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    for reg in (port, ref):
        reg.counter("a").inc(3)
        reg.gauge("b").set(2.5)
        reg.gauge("b").dec(0.5)
        reg.histogram("c").observe_many([3.0, 1.0, 2.0])
        reg.histogram("d")
        with pytest.raises(TypeError):
            reg.gauge("a")
    assert port.snapshot() == ref.snapshot()
    assert port.names() == ref.names() == ["a", "b", "c", "d"]
    json.dumps(port.snapshot())


def test_registry_runs_its_flushes_before_a_snapshot():
    reg = metrics.MetricsRegistry()
    reg.add_flush(lambda: reg.counter("late").inc(2))
    assert reg.get("late") is None
    assert reg.snapshot()["late"] == 2
    r1 = metrics.get_registry()
    r2 = metrics.reset_registry()
    assert metrics.get_registry() is r2 and r2 is not r1


# ---------------------------------------------------------------- counters
def _graphs(n, e, seed, weighted):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) + 0.01 if weighted else None
    return (csr.from_edges(src, dst, n, weights=w),
            ref_csr.from_edges(src, dst, n, weights=w))


_CASES = {
    "pull": dict(direction="pull", kw={}),
    "pull_min_weighted_frontier": dict(
        direction="pull", kw=dict(reduce="min", use_weights=True,
                                  neutral=float("inf")), frontier=True),
    "push_sum_frontier": dict(direction="push", kw={}, frontier=True),
    "push_max_init": dict(direction="push", kw=dict(reduce="max"),
                          init=True),
    "plane_pull": dict(direction="pull", kw={}, k=4),
    "plane_pull_planar_frontier": dict(direction="pull", kw={}, k=3,
                                       frontier=True),
    "out_edge_sum": dict(direction="out_sum", kw={}),
}


def _one_pass(eng, ga, case, prop, frontier, init, to):
    kw = dict(case["kw"])
    if case.get("frontier"):
        kw["src_frontier"] = to(frontier)
    if case.get("init"):
        kw["init"] = to(init)
    if case["direction"] == "pull":
        return eng.edge_map_pull(ga, to(prop), **kw)
    if case["direction"] == "push":
        return eng.edge_map_push(ga, to(prop), **kw)
    return eng.out_edge_sum(ga, lambda s, d: (s + d) * 0 + 1.0)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(_CASES))
def test_counters_match_reference(backend, case):
    c = _CASES[case]
    n = 300  # > 256: the packed tables' ids are uint16 on both sides
    g, rg = _graphs(n, 8 * n, seed=len(case), weighted=True)
    ga = apps.to_arrays(g, backend=backend, device="cpu")
    rga = ref_apps.to_arrays(rg, backend=backend)
    rng = np.random.default_rng(1)
    k = c.get("k", 1)
    shape = (n,) if k == 1 else (n, k)
    prop = rng.random(shape).astype(np.float32)
    frontier = rng.random(shape) < 0.4
    init = rng.random(shape).astype(np.float32)

    port = counters.install(registry=metrics.MetricsRegistry())
    for _ in range(2):
        _one_pass(engine, ga, c, prop, frontier, init, torch.from_numpy)
    counters.uninstall()
    ref = ref_counters.install(registry=ref_metrics.MetricsRegistry())
    try:
        for _ in range(2):
            _one_pass(ref_engine, rga, c, prop, frontier, init, jnp.asarray)
    finally:
        ref_counters.uninstall()

    got, want = port.summary(), ref.summary()
    assert got == want
    name = counters.backend_name(ga)
    assert got[f"edge_map.passes.{name}.{c['direction']}"] == 2
    assert got["edge_map.lanes"] == 2 * k
    if c.get("frontier"):
        assert got["edge_map.frontier_density_count"] == 2
        hist = port.registry.histogram("edge_map.frontier_density")
        ref_hist = ref.registry.histogram("edge_map.frontier_density")
        assert hist._samples == ref_hist._samples


def test_counters_on_tiny_packed_graphs_price_the_ports_planes():
    """At V <= 256 the packed layout stores uint8 ids; the port's K5 reads
    them widened to uint16, and the byte model prices the planes K5 reads:
    the difference from the reference is one byte per padded idx slot of
    each such table, and nothing else."""
    g, rg = _graphs(200, 1600, seed=3, weighted=False)
    ga = apps.to_arrays(g, backend="packed", device="cpu")
    rga = ref_apps.to_arrays(rg, backend="packed")
    port = counters.install(registry=metrics.MetricsRegistry())
    engine.edge_map_pull(ga, torch.ones(200))
    counters.uninstall()
    ref = ref_counters.install(registry=ref_metrics.MetricsRegistry())
    try:
        ref_engine.edge_map_pull(rga, jnp.ones(200))
    finally:
        ref_counters.uninstall()
    got, want = port.summary(), ref.summary()
    narrow = sum(int(np.prod(t.idx.shape)) for t in rga.in_tiles
                 if t.idx.dtype.itemsize == 1)
    assert narrow > 0
    assert got.pop("edge_map.model_bytes") - want.pop(
        "edge_map.model_bytes") == narrow
    assert got == want


def test_frontier_density_waits_on_the_device_until_read():
    g, _ = _graphs(64, 400, seed=2, weighted=False)
    ga = apps.to_arrays(g, device="cpu")
    reg = metrics.MetricsRegistry()
    c = counters.install(registry=reg)
    frontier = torch.arange(64) < 32
    engine.edge_map_push(ga, torch.ones(64), src_frontier=frontier)
    engine.edge_map_pull(ga, torch.ones((64, 4)),
                         src_frontier=torch.ones((64, 4), dtype=torch.bool))
    assert reg.histogram("edge_map.frontier_density").count == 0
    assert len(c._pending) == 2
    s = c.summary()
    assert not c._pending
    out_deg = g.out_degrees()
    want = [out_deg[:32].sum() / out_deg.sum(), 1.0]
    assert reg.histogram("edge_map.frontier_density")._samples == want
    assert s["edge_map.frontier_density_count"] == 2
    assert s["edge_map.lanes"] == 1 + 4


def test_flat_edge_map_bytes_matches_reference():
    for kw in ({}, dict(weighted=True), dict(frontier=True),
               dict(push_init=True), dict(plane_k=4),
               dict(plane_k=3, frontier=True, frontier_planar=True),
               dict(weighted=True, frontier=True, push_init=True, plane_k=2)):
        assert (counters.flat_edge_map_bytes(1000, 100, **kw)
                == ref_counters.flat_edge_map_bytes(1000, 100, **kw))


def test_install_sets_and_clears_the_engine_hook():
    c = counters.install(registry=metrics.MetricsRegistry())
    assert engine.get_edge_map_hook() is c
    assert counters.install(c) is c
    counters.uninstall()
    assert engine.get_edge_map_hook() is None
    assert counters.EdgeMapCounters().registry is metrics.get_registry()


def test_counter_events_ride_the_trace_one_per_pass(tmp_path):
    g, _ = _graphs(128, 1024, seed=4, weighted=False)
    tr = obs_trace.enable()
    ga = apps.to_arrays(g, backend="ell", device="cpu")
    c = counters.install(registry=metrics.MetricsRegistry())
    _, iters = apps.pagerank(ga, max_iters=6)
    counters.uninstall()
    obs_trace.disable()
    events = obs_trace.load_trace(tr.save(str(tmp_path / "t.json")))[
        "traceEvents"]
    build = [e for e in events if e["name"] == "engine.build_backend"]
    samples = [e for e in events if e["ph"] == "C" and e["name"] == "edge_map"]
    assert len(build) == 1 and build[0]["ph"] == "X"
    assert build[0]["args"] == {"backend": "ell", "vertices": 128,
                                "edges": 1024}
    assert len(samples) == iters == c.summary()["edge_map.passes.ell.pull"]
    assert samples[-1]["args"]["edges"] == iters * 1024


@pytest.mark.parametrize("backend", ["flat", "ell", "packed"])
def test_build_backend_span_matches_reference(backend):
    g, rg = _graphs(100, 500, seed=5, weighted=False)
    tr, ref = obs_trace.enable(), ref_trace.enable()
    apps.to_arrays(g, backend=backend, device="cpu")
    ref_apps.to_arrays(rg, backend=backend)
    obs_trace.disable()
    ref_trace.disable()
    assert _strip(_held_to_reference(tr.events)) == _strip(ref.events)
    # the port's own phases: the host packing, then the upload, inside the
    # build's span
    (build,) = [e for e in tr.events if e["name"] == "engine.build_backend"]
    phases = [e for e in tr.events if e["name"].startswith("engine.build.")]
    assert [e["name"] for e in phases] == ["engine.build.pack",
                                           "engine.build.upload"]
    for e in phases:
        assert build["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= build["ts"] + build["dur"]


def _run_app(app, ga, n):
    if app == "pagerank":
        return apps.pagerank(ga, max_iters=8)
    if app == "pagerank_delta":
        return apps.pagerank_delta(ga, epsilon=0.01 / n, max_iters=8)
    if app == "sssp":
        return apps.sssp(ga, 0)
    if app == "bc":
        return apps.bc(ga, 0)
    return apps.radii(ga, torch.tensor([0, 5, 17, 40]))


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("backend", ["flat", "ell", "packed"])
@pytest.mark.parametrize("app", ["pagerank", "pagerank_delta", "sssp", "bc",
                                 "radii"])
def test_instrumented_runs_are_bitwise_equal(backend, app):
    n = 400
    g, _ = _graphs(n, 6 * n, seed=6, weighted=app == "sssp")
    ga = apps.to_arrays(g, backend=backend, device="cpu")
    bare = _run_app(app, ga, n)
    tr = obs_trace.enable()
    c = counters.install(registry=metrics.MetricsRegistry())
    try:
        instrumented = _run_app(app, ga, n)
    finally:
        counters.uninstall()
        obs_trace.disable()
    assert _same(bare, instrumented)
    s = c.summary()
    assert sum(v for k, v in s.items() if k.startswith("edge_map.passes.")) > 0
    assert len([e for e in tr.events if e["ph"] == "C"]) == sum(
        v for k, v in s.items() if k.startswith("edge_map.passes."))
    assert [e["name"] for e in tr.events
            if e["name"] == f"apps.{app}"] == [f"apps.{app}"]
