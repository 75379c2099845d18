"""A run end to end on the CPU at a small size: the result line, the
trace reading, and ``correct`` coming out false when the timed path is
broken underneath."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench.lib import harness, trace as tracing

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["kron-s21.pagerank", "uni-s21.pagerank", "kron-s21.traverse"]


@pytest.fixture(autouse=True)
def steady_clock(monkeypatch):
    """A window of a fixed number of jobs, whatever the load on this
    machine: the harness's clock advances 10 ms at each reading, two
    readings a job."""
    import itertools
    import time
    import types

    ticks = itertools.count()
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * 0.01, time_ns=time.time_ns))


def _run(spec, seed=2**31 + 99, seconds=0.3, trace=False):
    return harness.run_cell(spec, seed, seconds, trace, torch.device("cpu"),
                            0.0, {"hbm_bytes_per_s": 3.35e12})


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(small_spec, cell, capsys):
    spec = small_spec(cell)
    result, compared = _run(spec)
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(compared) == set(spec.check["limits"])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert harness.finish(result, compared) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    tail = err.strip().splitlines()[-len(compared):]
    assert all(t.startswith("compared ") for t in tail)


def test_a_traced_run_gives_the_layer_metrics_it_can_read(small_spec,
                                                         capsys):
    spec = small_spec("kron-s21.pagerank")
    result, _ = _run(spec, trace=True)
    assert result["correct"]
    # the CPU has no device trace: only the set-up spans and the host-clock
    # share are readable
    assert set(result["metrics"]) == {"reorder_s", "backend_build_s",
                                      "pagerank_roofline"}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the profiled window follows the measured one, and both count
    untraced, _ = _run(spec)
    assert result["attempted"] > untraced["attempted"]
    assert "jobs/s traced against" in capsys.readouterr().err


def test_layer_shares_read_the_unprofiled_pace():
    """Host-clock shares read the measured window; device shares put the
    traced window's device time per job over the measured window's pace;
    counts per job and K5's roofline read the traced window alone."""
    trace = tracing.Trace(
        window_s=2.0, busy_s=0.8, kernels=400,
        ops={"edge_map_kernel<0, int>": (0.5, 200),
             "fold_kernel": (0.1, 100), "index_copy": (0.2, 100)},
        idle={}, device_events=400)
    pr = [("pagerank", 0.01)] * 100
    run = harness.Run(
        spec=None, setup_s=1.0,
        window=harness.Window(pr, 1.0, {"pagerank.pulls": 1800}, 0),
        traced=harness.Window(pr, 2.0, {"pagerank.pulls": 1800}, 0, trace),
        spans={}, sizes={"pull_work_bytes": 1e6},
        peak={"hbm_bytes_per_s": 1e12})

    def read(name):
        return harness._reader(name)(run)

    # 8 ms of device time a job, 6 of it K5's, at 100 jobs/s unprofiled
    assert read("device_idle_share") == pytest.approx(20.0)
    assert read("k5_device_share") == pytest.approx(60.0)
    assert read("launches_per_job") == pytest.approx(4.0)
    # 1,800 pulls of 1 MB at 1 TB/s are 1.8 ms: 0.18% of the measured 1 s
    # window, 0.3% of K5's 0.6 s
    assert read("pagerank_roofline") == pytest.approx(0.18)
    assert read("k5_roofline") == pytest.approx(0.3)
    run.traced = None
    assert read("k5_device_share") is None
    assert read("pagerank_roofline") == pytest.approx(0.18)


def _state_unchanged(monkeypatch):
    """Every edge map hands back its input: the step leaves the state."""
    from repro_torch.apps import engine

    def pull(self, prop, **kw):
        return prop.clone()

    def push(self, prop, *, init=None, **kw):
        return prop.clone() if init is None else init.clone()

    monkeypatch.setattr(engine.EllBackend, "pull", pull)
    monkeypatch.setattr(engine.EllBackend, "push", push)


def _half_the_lanes(monkeypatch):
    """K5 walks half of each row and scales a sum up to the whole."""
    from repro_torch.kernels.edge_map import ops

    real = ops.ell_edge_map

    def half(x, idx, deg, **kw):
        kept = (deg + 1) // 2
        y = real(x, idx, kept, **kw)
        if kw.get("reduce") == "sum" and kw.get("init_rows") is None:
            scale = (deg.float() / kept.clamp(min=1).float())
            y = y * (scale[:, None] if y.dim() == 2 else scale)
        return y

    monkeypatch.setattr(ops, "ell_edge_map", half)


def _answer_altered(monkeypatch):
    """One vertex's answer changed where each app produces it."""
    from repro_torch import apps

    def altered(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            first = out[0].clone()
            v = int(torch.argmax(first.float()))
            first[v] = first[v] + (1 if not first.is_floating_point()
                                   else max(1.0, float(first[v])) * 0.01)
            return (first,) + tuple(out[1:])
        return wrapped

    for name in ("pagerank", "pagerank_delta", "sssp", "bc", "radii"):
        monkeypatch.setattr(apps, name, altered(getattr(apps, name)))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_lanes,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(small_spec, cell, fault,
                                            monkeypatch):
    fault(monkeypatch)
    result, compared = _run(small_spec(cell))
    assert not result["correct"], compared


def test_a_wrong_mapping_is_not_correct(small_spec, monkeypatch):
    from bench.systems import graph_jobs

    real = graph_jobs.Cell.__init__

    def swapped(self, *args, **kw):
        real(self, *args, **kw)
        self.mapping = self.mapping.copy()
        self.mapping[[0, 1]] = self.mapping[[1, 0]]

    monkeypatch.setattr(graph_jobs.Cell, "__init__", swapped)
    result, compared = _run(small_spec("kron-s21.pagerank"))
    assert not result["correct"]
    assert compared["mapping_mismatch"][0] == 2


def test_a_failing_job_is_counted_and_not_correct(small_spec, monkeypatch):
    from repro_torch import apps

    real, calls = apps.pagerank, []

    def boom(*args, **kw):
        calls.append(1)
        if len(calls) > 2:  # past the warm-up's two calls
            raise RuntimeError("planted")
        return real(*args, **kw)

    monkeypatch.setattr(apps, "pagerank", boom)
    result, _ = _run(small_spec("kron-s21.pagerank"), seconds=0.2)
    assert result["failed"] == result["attempted"] > 0
    assert not result["correct"]


class _Event:
    """A profiler event as ``summarize`` reads it; ``kind`` names what
    its device type, annotation flag and name make it."""

    def __init__(self, name, kind, start, dur):
        self._n, self._k, self._s, self._d = name, kind, start, dur

    def name(self):
        return self._n

    def is_user_annotation(self):
        return self._k.endswith("annotation")

    def device_type(self):
        cuda = self._k in ("kernel", "gpu_memcpy", "gpu_user_annotation")
        return torch.autograd.DeviceType.CUDA if cuda else (
            torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": lambda _self: events})()})()


def test_trace_summary_busy_union_and_idle_labels():
    ev = [_Event("cudaStreamSynchronize", "cuda_runtime", 3000, 1000),
          _Event("k1", "kernel", 1500, 1000),
          _Event("k2", "kernel", 2000, 1000),  # overlaps k1
          _Event("Memcpy DtoH", "gpu_memcpy", 4500, 500),
          _Event("k1", "kernel", 9500, 1000),  # runs past the window
          _Event("k0", "kernel", 100, 200),  # before the window
          _Event("gpu annotation", "gpu_user_annotation", 1000, 9000)]
    t = tracing.summarize(_Prof(ev), (1000, 10000), [(1000, 6000, "job.bc")])
    assert t.window_s == 9e-6
    assert t.busy_s == pytest.approx((1500 + 500 + 500) * 1e-9)
    assert t.kernels == 3 and t.device_events == 4
    assert t.ops["k1"] == (pytest.approx(1.5e-6), 2)
    assert "k0" not in t.ops
    assert t.idle == {
        "job.bc: python": pytest.approx(500e-9),
        "job.bc: cudaStreamSynchronize": pytest.approx(1500e-9),
        "no job: python": pytest.approx(4500e-9)}
    assert t.seconds_matching(("k1",)) == pytest.approx(1.5e-6)


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kron-s21.pagerank",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_run_without_the_program_exits_non_zero(tmp_path):
    """A directory that holds only BENCHMARK.json and bench/."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kron-s21.pagerank",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
