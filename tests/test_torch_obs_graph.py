"""The graph path's own spans and counts (``repro_torch.obs``), on the CPU.

Host reads: each app's count equals its loop's formula (PageRank ``it``,
PageRank-Delta ``it + 1``, SSSP and BC ``2 it + 1``, Radii ``it``).  BC's
backward sweep walks every edge once per level.  Set-up: ``reorder_graph``
and every backend build publish their phases once per call, and the
phases cover the call.  Spans: answers are bitwise the same with the
tracer on and off, spans nest as the code does, and a span's bounds on
``time.time_ns`` hold the ``torch.profiler`` events of what ran inside it.

This file imports only torch and the port: its card test runs with
``--noconftest`` on the card's machine.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import apps  # noqa: E402
from repro_torch.apps import engine  # noqa: E402
from repro_torch.core.reorder import reorder_graph  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.obs import counters, flight, metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

BACKENDS = ("flat", "ell", "packed")
APPS = ("pagerank", "pagerank_delta", "sssp", "bc", "radii")


def _reset():
    obs_trace.disable()
    flight.uninstall()
    engine.set_edge_map_hook(None)
    metrics.reset_registry()


@pytest.fixture(autouse=True)
def _clean_obs_state():
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def graph():
    """A small weighted R-MAT graph in DBG order, as the benchmark runs."""
    g = generators.with_weights(generators.rmat(1024, 8192, seed=11), seed=2)
    return reorder_graph(g, "dbg")[0]


@pytest.fixture(scope="module")
def backends(graph):
    return {b: apps.to_arrays(graph, backend=b, device="cpu")
            for b in BACKENDS}


def _run(app, ga):
    n = ga.num_vertices
    if app == "pagerank":
        return apps.pagerank(ga)
    if app == "pagerank_delta":
        return apps.pagerank_delta(ga, epsilon=0.01 / n)
    if app == "sssp":
        return apps.sssp(ga, 3)
    if app == "bc":
        return apps.bc(ga, 3)
    return apps.radii(ga, torch.tensor([3, 100, 517, 900]))


def _iters(app, out):
    return out[2] if app == "bc" else out[1]


#: host reads of one call, from its iterations
READS = {"pagerank": lambda it: it, "pagerank_delta": lambda it: it + 1,
         "sssp": lambda it: 2 * it + 1, "bc": lambda it: 2 * it + 1,
         "radii": lambda it: it}


def _counter(name):
    m = metrics.get_registry().get(name)
    return None if m is None else m.value


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("app", APPS)
def test_host_reads_follow_the_loop(backends, app, backend):
    reads0 = counters.HOST_READS
    it = _iters(app, _run(app, backends[backend]))
    assert it >= 2
    assert counters.HOST_READS - reads0 == READS[app](it)
    assert _counter(f"apps.host_reads.{app}") == READS[app](it)
    assert _counter(f"apps.jobs.{app}") == 1
    _run(app, backends[backend])  # one registry addition per call
    assert _counter(f"apps.host_reads.{app}") == 2 * READS[app](it)
    assert _counter(f"apps.jobs.{app}") == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_bc_sweep_walks_every_edge_once_per_level(backends, graph, backend):
    levels = _iters("bc", _run("bc", backends[backend]))
    assert _counter("engine.out_edge_sum.edges") == levels * graph.num_edges
    for app in ("pagerank", "sssp"):  # no sweep: the counter stays
        _run(app, backends[backend])
    assert _counter("engine.out_edge_sum.edges") == levels * graph.num_edges


def test_reorder_publishes_its_two_phases_once_per_call():
    g = generators.rmat(4096, 32768, seed=5)
    total = 0.0
    for calls in (1, 2):
        _, res = reorder_graph(g, "dbg")
        total += res.seconds
        assert _counter("reorder.calls") == calls
        got = _counter("reorder.mapping_s") + _counter("reorder.relabel_s")
        assert got == pytest.approx(total, abs=1e-8 * calls)
        assert _counter("reorder.mapping_s") > 0
        assert _counter("reorder.relabel_s") > 0


@pytest.mark.parametrize("backend", ("flat", "ell", "packed", "arrays"))
def test_build_phases_cover_the_call(backend):
    g = generators.rmat(1 << 14, 1 << 17, seed=6)
    t = time.perf_counter_ns()
    apps.to_arrays(g, backend=backend, device="cpu")
    whole = (time.perf_counter_ns() - t) / 1e9
    assert _counter("engine.build.calls") == 1
    pack, upload = (_counter("engine.build.pack_s"),
                    _counter("engine.build.upload_s"))
    assert pack > 0 and upload > 0
    assert 0.75 * whole <= pack + upload <= whole


def test_setup_spans_are_the_published_phases():
    """One timing path: each set-up span's duration is its registry
    seconds, the phases run back to back, inside the call's span."""
    g = generators.rmat(2048, 16384, seed=7)
    tr = obs_trace.enable()
    g2, _ = reorder_graph(g, "dbg")
    apps.to_arrays(g2, backend="ell", device="cpu")
    obs_trace.disable()
    ev = {e["name"]: e for e in tr.events}
    for prefix, names in (("reorder", ("mapping", "relabel")),
                          ("engine.build", ("pack", "upload"))):
        spans = [ev[f"{prefix}.{n}"] for n in names]
        for n, e in zip(names, spans):
            assert e["dur"] / 1e6 == pytest.approx(
                _counter(f"{prefix}.{n}_s"), rel=1e-9)
        assert spans[0]["ts"] + spans[0]["dur"] == pytest.approx(
            spans[1]["ts"], abs=1e-3)
    build = ev["engine.build_backend"]
    assert build["ts"] <= ev["engine.build.pack"]["ts"]
    assert (ev["engine.build.upload"]["ts"] + ev["engine.build.upload"]["dur"]
            <= build["ts"] + build["dur"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("app", APPS)
def test_answers_are_bitwise_the_same_with_the_tracer_on(backends, app,
                                                         backend):
    bare = _run(app, backends[backend])
    tr = obs_trace.enable()
    traced = _run(app, backends[backend])
    obs_trace.disable()
    assert tr.events
    for a, b in zip(bare, traced):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_pagerank_spans_nest_per_iteration(backends):
    tr = obs_trace.enable()
    _, it = apps.pagerank(backends["ell"])
    obs_trace.disable()
    names = [e["name"] for e in tr.events]
    for name in ("apps.pagerank.iter", "engine.edge_map_pull",
                 "apps.host_read"):
        assert names.count(name) == it
    (job,) = [e for e in tr.events if e["name"] == "apps.pagerank"]
    iters = [e for e in tr.events if e["name"] == "apps.pagerank.iter"]
    assert all(_inside(e, job) for e in tr.events)
    for name in ("engine.edge_map_pull", "apps.host_read"):
        inner = [e for e in tr.events if e["name"] == name]
        assert all(_inside(e, i) for e, i in zip(inner, iters))


def test_bc_spans_hold_the_sweep(backends):
    tr = obs_trace.enable()
    _, _, levels = apps.bc(backends["ell"], 3)
    obs_trace.disable()
    (sweep,) = [e for e in tr.events if e["name"] == "apps.bc.backward"]
    sums = [e for e in tr.events if e["name"] == "engine.out_edge_sum"]
    assert len(sums) == levels and all(_inside(e, sweep) for e in sums)
    names = [e["name"] for e in tr.events]
    assert names.count("apps.bc.iter") == levels
    assert names.count("apps.host_read") == 2 * levels + 1


def test_complete_records_a_timed_span_on_the_tracers_clock():
    ticks = iter(range(1000, 10**6, 1000))
    tr = obs_trace.enable(obs_trace.Tracer(clock=lambda: next(ticks)))
    a = obs_trace.now()
    b = obs_trace.now()
    obs_trace.complete("phase", a, b, cat="t", n=1)
    obs_trace.disable()
    obs_trace.complete("dropped", a, b)  # disabled: records nothing
    assert tr.events == [{"ph": "X", "name": "phase", "cat": "t",
                          "pid": tr.pid, "tid": tr.events[0]["tid"],
                          "ts": 1.0, "dur": 1.0, "args": {"n": 1}}]
    assert tr.spans_unix_ns() == [(tr.epoch_unix_ns + 1000,
                                   tr.epoch_unix_ns + 2000, "phase")]
    assert isinstance(obs_trace.now(), int)


def _bounds_ns(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def test_an_op_inside_a_span_lies_inside_it_on_the_profilers_clock():
    """``torch.profiler``'s events are on ``time.time_ns``: the span's
    bounds there hold the matrix product run 2 ms after it opens and 2 ms
    before it closes, with room to spare on both sides."""
    a = torch.randn(128, 128)
    tr = obs_trace.enable()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        with obs_trace.span("outer"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
    obs_trace.disable()
    ((start, end, _),) = tr.spans_unix_ns()
    mm = [_bounds_ns(e) for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    s, t = mm[0]
    assert start + 1_000_000 <= s and t + 1_000_000 <= end


def test_disabled_hot_sites_share_one_noop_span():
    assert obs_trace.span("apps.pagerank.iter") is obs_trace.span(
        "engine.edge_map_pull")
    assert not obs_trace.recording()


@pytest.mark.cuda
def test_k5_segment_fallback_is_a_counted_host_read():
    """A wide tile without its segment list: the wrapper reads ``deg`` to
    the host once, through ``host_read``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU mode")
    from repro_torch.kernels.edge_map import ell_edge_map

    dev = torch.device("cuda")
    r, width, v = 64, 2048, 4096
    rng = np.random.default_rng(3)
    deg = np.zeros(r, np.int32)
    deg[:3] = (1500, 2048, 7)
    idx = rng.integers(0, v, (r, width)).astype(np.int32)
    x = torch.rand(v, device=dev)
    reads0 = counters.HOST_READS
    ell_edge_map(x, torch.from_numpy(idx).to(dev),
                 torch.from_numpy(deg).to(dev), width_tile=width)
    torch.cuda.synchronize()
    assert counters.HOST_READS - reads0 == 1
