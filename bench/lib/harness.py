"""The harness: one run of one cell, driven by ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
harness finds everything by those names:

* ``bench/configs/<config>.json``: the configuration's sizes, and the
  ``system`` that serves it, ``bench/systems/<system>.py``;
* ``bench/traffic/<mix>.json``: the mix, read by ``bench.lib.traffic``;
* ``bench/workloads/<cell>.json``: the cell's check (the limit of every
  compared number, and how many answers of each app it samples);
* ``bench/metrics/<metric>.py``: one reader per metric, ``read(run)``,
  which returns the number or ``None`` where it finds nothing to read.

A run builds the system (set-up: ``setup_s`` runs from the start of the
process to the window), runs the closed loop for ``seconds``, reads the
memory peak, frees the program's state, runs the check, and returns the
result line.  With ``trace`` a second window of ``seconds`` follows the
first under the profiler: the profiler slows the host between launches,
so every host-clock number reads the first window, and the trace's
device time is put over the first window's pace (``Run.untraced_share``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Spec", "Window", "Run", "Spans", "FORBIDDEN", "load_spec",
           "run_cell", "forbidden_modules", "finish"]

BENCH = Path(__file__).resolve().parents[1]
#: top-level module names no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Spec:
    """Everything a run of one cell reads from files."""

    name: str
    chips: int
    config: dict
    mix: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclasses.dataclass
class Window:
    """The jobs of one measured window."""

    jobs: List[Tuple[str, float]]  # (app, seconds) of every job
    seconds: float
    counters: Dict[str, float]  # what the window's jobs counted
    failed: int
    trace: object = None  # bench.lib.trace.Trace, where it was profiled


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    spec: Spec
    setup_s: float
    window: Window  # the measured window, never profiled
    traced: Optional[Window]  # the profiled window after it (--trace 1)
    spans: Dict[str, float]
    sizes: Dict[str, float]  # the cell's fixed work counts
    peak: dict

    def untraced_share(self, device_s: float) -> float:
        """``device_s`` of the traced window's device time as a share (%)
        of the unprofiled pace: device time per traced job over the
        measured window's time per job."""
        per_job = device_s / len(self.traced.jobs)
        return 100.0 * per_job * len(self.window.jobs) / self.window.seconds


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_spec(root: Path, workload: str) -> Spec:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"known: {', '.join(sorted(cells))}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    from . import traffic

    mix = traffic.load(BENCH / "traffic" / f"{cell['traffic']}.json")
    check = _json(BENCH / "workloads" / f"{workload}.json")

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return Spec(workload, int(cell["chips"]), config, mix, check,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


class Spans(dict):
    """Seconds of the benchmark's own spans of set-up, by name."""

    def __init__(self, sync: Callable[[], None]):
        super().__init__()
        self._sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        t = time.perf_counter()
        yield
        if sync:
            self._sync()
        self[name] = time.perf_counter() - t


def _reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _p(*args):
    print(*args, file=sys.stderr, flush=True)


def _window(cell, stream, seconds: float, sync, prof=None):
    """Jobs back to back until the first to end past ``seconds`` ends.
    Returns the window's start on the host clock, and the window."""
    from . import trace as tracing

    jobs: List[Tuple[str, float]] = []
    spans_ns: List[Tuple[int, int, str]] = []
    failed = 0
    before = dict(cell.counters)
    with prof if prof is not None else contextlib.nullcontext():
        sync()
        start = time.perf_counter()
        start_ns = time.time_ns()
        deadline = start + seconds
        while True:
            app, p = next(stream)
            t, t_ns = time.perf_counter(), time.time_ns()
            try:
                out = cell.run(app, p)
                sync()
            except Exception:  # a job that fails is counted, not fatal
                failed += 1
                _p(f"job {app} {p} failed:\n{traceback.format_exc()}")
                out = None
            end = time.perf_counter()
            spans_ns.append((t_ns, time.time_ns(), f"job.{app}"))
            jobs.append((app, end - t))
            if out is not None:
                cell.done(app, p, out, end - t)
            if end >= deadline:
                break
        end_ns = time.time_ns()
    summary = (tracing.summarize(prof, (start_ns, end_ns), spans_ns)
               if prof is not None else None)
    counted = {k: v - before.get(k, 0) for k, v in cell.counters.items()}
    return start, Window(jobs, end - start, counted, failed, summary)


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device,
             t0: float, peak: dict) -> Tuple[dict, Dict[str, Tuple[float,
                                                                   float]]]:
    """One run.  Returns the result line (without its ``compared`` key)
    and each compared number with its limit."""
    import torch

    from . import trace as tracing

    if device.type == "cuda":
        def sync():
            torch.cuda.synchronize(device)
    else:
        def sync():
            pass
    system = importlib.import_module(f"bench.systems.{spec.config['system']}")
    spans = Spans(sync)
    cell = system.Cell(spec.config, spec.mix, spec.check, seed, device, spans)
    with spans("warm_up", sync=True):
        cell.warm_up()
    gc.collect()
    _p(f"set-up spans (s): {json.dumps(spans)}")

    stream = cell.jobs()
    start, window = _window(cell, stream, seconds, sync)
    setup_s = start - t0
    traced = None
    if trace:
        _, traced = _window(cell, stream, seconds, sync,
                            tracing.profile(device))
        _p(f"profiler: {len(traced.jobs) / traced.seconds:.4f} jobs/s "
           f"traced against {len(window.jobs) / window.seconds:.4f} "
           "unprofiled")
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    cell.release()

    t = time.perf_counter()
    found = cell.check()
    limits = spec.check["limits"]
    unknown = sorted(set(found) - set(limits))
    if unknown:
        raise KeyError(f"{spec.name}: no limit for {unknown} in "
                       f"bench/workloads/{spec.name}.json")
    compared = {k: (found.get(k, math.nan), float(limits[k]))
                for k in limits}
    _p(f"check: {time.perf_counter() - t:.3f} s over "
       f"{len(cell.samples())} sampled answers")
    for app, times in sorted(cell.per_app.items()):
        times = sorted(times)
        _p(f"jobs {app}: {len(times)}, median {times[len(times) // 2]:.6f} s,"
           f" max {times[-1]:.6f} s")

    run = Run(spec, setup_s, window, traced, dict(spans), dict(cell.sizes),
              peak)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = _reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": spec.chips, "memory_peak_bytes": int(memory_peak)}
    windows = [window] + ([traced] if traced is not None else [])
    failed = sum(w.failed for w in windows)
    correct = failed == 0 and all(v <= lim for v, lim in compared.values())
    result = {"correct": correct,
              "attempted": sum(len(w.jobs) for w in windows),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        summary = traced.trace
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": tracing.top({k: s for k, (s, _) in
                                       summary.ops.items()}),
            "idle_gaps": tracing.top(summary.idle)}
        _p(f"trace: {summary.device_events} device operations, "
           f"{summary.kernels} kernels, busy {summary.busy_s:.6f} s of "
           f"{summary.window_s:.6f} s")
    return result, compared


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def finish(result: dict, compared: Dict[str, Tuple[float, float]]) -> int:
    """Print the compared numbers (the last lines of standard error) and
    the result line (the last line of standard output).  Exits non-zero,
    printing no result, when a forbidden module is loaded."""
    bad = forbidden_modules()
    if bad:
        _p(f"forbidden modules loaded in this process: {bad}")
        return 5
    # a number that was not read (no job of its app finished) is null
    result["compared"] = {k: {"value": None if math.isnan(v) else v,
                              "limit": lim}
                          for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        ok = "ok" if v <= lim else "FAIL"
        _p(f"compared {k}: {v!r} limit {lim!r} {ok}")
    print(json.dumps(result), flush=True)
    return 0
