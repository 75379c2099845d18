"""The device trace of a run's window, from ``torch.profiler``.

The harness runs the window inside ``profile(device)``, which on a card
records the device's operations and the host's CUDA runtime calls only
(recording every host operation as well doubled a PageRank job's time).
The benchmark's own spans, the window and each job (``job.<app>``), are
taken with ``time.time_ns``, the clock of the profiler's events.
``summarize`` reduces the raw events to what the per-layer readers take:
the window's length, the union of device activity in it, each device
operation's seconds and count by name, the kernels launched, and the idle
time of the device grouped by what the host was doing (the open job span
and the innermost host call at the middle of each gap).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

import torch

__all__ = ["Trace", "profile", "summarize", "top"]

DEVICE_OPS = {"kernel", "gpu_memcpy", "gpu_memset"}


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    ops: Dict[str, Tuple[float, int]]  # device op name -> (seconds, count)
    idle: Dict[str, float]  # what the host was doing -> device idle seconds
    device_events: int

    def seconds_matching(self, names) -> float:
        """Device seconds of the operations whose name holds one of
        ``names``."""
        return sum(s for op, (s, _) in self.ops.items()
                   if any(n in op for n in names))


def profile(device: torch.device):
    """The device's operations on a card; the host's operations on the
    CPU, where there is no device."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if device.type == "cuda" else act.CPU])


def _span_ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        start, dur = e.start_ns(), e.duration_ns()
    else:
        start, dur = e.start_us() * 1000, e.duration_us() * 1000
    return int(start), int(start + dur)


def _kind(e) -> str:
    """``kernel``, ``gpu_memcpy``, ``gpu_memset``, ``annotation`` or
    ``host`` (a host operation or CUDA runtime call).  Read from the
    device type and the name: not every torch's events carry their
    activity type."""
    if e.is_user_annotation():
        return "annotation"
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        name = e.name()
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "host"


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int):
    """Merged ``[start, end)`` intervals, clipped to ``[lo, hi)``."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(starts, ends, names, t: int, reach: int = 64) -> str:
    """Name of the latest-starting interval that holds ``t`` (intervals
    sorted by start; nested ones start later)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if ends[j] > t:
            return names[j]
    return ""


def summarize(prof, window: Tuple[int, int],
              jobs: List[Tuple[int, int, str]]) -> Trace:
    """``window`` and ``jobs`` (start, end, name) in ``time.time_ns``."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in DEVICE_OPS:
            device.append((_span_ns(e), e.name(), kind))
        elif kind == "host":
            host.append((_span_ns(e), e.name()))
    lo, hi = window
    ops: Dict[str, List[float]] = {}
    kernels = 0
    inside = []
    for (s, t), name, kind in device:
        if t <= lo or s >= hi:
            continue
        inside.append((s, t))
        entry = ops.setdefault(name, [0.0, 0])
        entry[0] += (min(t, hi) - max(s, lo)) / 1e9
        entry[1] += 1
        kernels += kind == "kernel"
    busy = _union(inside, lo, hi)
    busy_s = sum(t - s for s, t in busy) / 1e9
    idle: Dict[str, float] = {}
    if busy:
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        jobs = sorted(jobs)
        host.sort()
        jstart = [s for s, _, _ in jobs]
        jend = [t for _, t, _ in jobs]
        jname = [n for _, _, n in jobs]
        hstart = [s for (s, _), _ in host]
        hend = [t for (_, t), _ in host]
        hname = [n for _, n in host]
        for s, t in gaps:
            mid = (s + t) // 2
            span = _innermost(jstart, jend, jname, mid, reach=1) or "no job"
            op = _innermost(hstart, hend, hname, mid) or "python"
            label = f"{span}: {op}"
            idle[label] = idle.get(label, 0.0) + (t - s) / 1e9
    return Trace(window_s=(hi - lo) / 1e9, busy_s=busy_s, kernels=kernels,
                 ops={k: (v[0], int(v[1])) for k, v in ops.items()},
                 idle=idle, device_events=len(inside))


def top(d: Dict[str, float], n: int = 10, width: int = 160):
    """The ``n`` largest entries as ``[[name, value], ...]``."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:width], v] for k, v in items]

