"""Always-on flight recorder: a bounded ring of the most recent trace events.

The port's copy of ``repro.obs.flight``.

The full :class:`~repro_torch.obs.trace.Tracer` grows without bound — fine for a
benchmark run, wrong for a long-lived service.  The flight recorder is the
production counterpart: a FIXED-CAPACITY ring buffer of finished span /
instant / counter / flow events (O(1) append, O(capacity) memory, works even
when the full tracer is disabled) that can be snapshotted into a valid
Chrome trace at any moment.  Like an aircraft FDR, its value is what it
holds when something goes wrong: the events *leading up to* an incident.

``install()`` registers the recorder as :mod:`repro_torch.obs.trace`'s flight
sink: with the full tracer off, the module-level ``trace.span(...)`` call
sites record into the ring directly; with the full tracer on, every event it
records is teed into the ring too — instrumented code never has to know
which mode the process is in.

**Anomaly triggers.**  ``trigger(reason, **context)`` snapshots the ring to
``dump_dir`` (rate-limited per reason by ``cooldown_s`` so a breach storm
produces one dump, not thousands).  In ``repro`` the serving stack wires
four incident classes through the module-level :func:`trigger` — a no-op
unless a recorder is installed — ``slo_breach``, ``queue_full``,
``remap_overflow`` and ``reclaim_stall``; the port's streaming and serving
services, which will do the same, are not ported yet (ROADMAP A7, A8).

``dump()`` output is always ``load_trace``-valid: a ring that evicted the
start of a long-lived flow would otherwise hold dangling flow steps, so the
snapshot drops id-tagged events whose start/begin fell off the ring (the
incident's own chain is recent by construction and survives intact).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import trace as obs_trace
from .trace import Tracer

__all__ = [
    "FlightRecorder",
    "install",
    "uninstall",
    "get_flight",
    "trigger",
]


class FlightRecorder(Tracer):
    """A :class:`Tracer` whose event store is a fixed-capacity ring.

    Inherits the whole recording surface (spans, instants, counters, flow
    and async events) and overrides only the emission path, so it can serve
    as the process-global tracer on its own or as the tee target of a full
    tracer.  ``export()`` / ``dump(path)`` return the ring contents, oldest
    first, as a Chrome trace.
    """

    def __init__(self, capacity: int = 4096, clock=time.perf_counter_ns,
                 dump_dir: Optional[str] = None, cooldown_s: float = 1.0,
                 wall_clock=time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        super().__init__(clock)
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.cooldown_s = float(cooldown_s)
        self._wall = wall_clock
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._total = 0
        self._dump_seq = 0
        self._last_trigger: Dict[str, float] = {}
        self.triggers: List[Dict[str, Any]] = []  # bounded trigger history

    # -- the O(1) append path ------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._ring[self._total % self.capacity] = ev
            self._total += 1

    @property
    def total_events(self) -> int:
        """Events ever recorded (>= len(ring) once the ring has wrapped)."""
        return self._total

    def __len__(self) -> int:
        return min(self._total, self.capacity)

    # -- snapshotting --------------------------------------------------------
    def snapshot_events(self) -> List[Dict[str, Any]]:
        """The ring contents, oldest first (a consistent copy)."""
        with self._lock:
            n, head = self._total, self._total % self.capacity
            if n <= self.capacity:
                return [e for e in self._ring[:n]]
            return [e for e in self._ring[head:] + self._ring[:head]]

    @staticmethod
    def _drop_orphans(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Drop flow steps/finishes and async instants/ends whose start/begin
        was evicted — the ring must always dump to a valid Chrome trace."""
        starts = {(e.get("cat", ""), e["name"], e["id"])
                  for e in events if e["ph"] == "s"}
        begins = {(e.get("cat", ""), e["name"], e["id"])
                  for e in events if e["ph"] == "b"}
        out = []
        for e in events:
            ph = e["ph"]
            if ph in ("t", "f") and \
                    (e.get("cat", ""), e["name"], e["id"]) not in starts:
                continue
            if ph in ("n", "e") and \
                    (e.get("cat", ""), e["name"], e["id"]) not in begins:
                continue
            out.append(e)
        return out

    def export(self) -> Dict[str, Any]:
        return {"traceEvents": self._drop_orphans(self.snapshot_events()),
                "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        """Write the ring as a Chrome trace JSON (Perfetto-loadable)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.export(), f)
        return path

    # alias: a FlightRecorder used as a plain Tracer still saves correctly
    save = dump

    # -- anomaly triggers ----------------------------------------------------
    def trigger(self, reason: str, path: Optional[str] = None,
                **context) -> Optional[str]:
        """Record an anomaly marker and snapshot the ring.

        The marker (``flight.anomaly`` instant) always lands in the ring; the
        DUMP is rate-limited per ``reason`` by ``cooldown_s`` (an SLO breach
        evaluated per batch must not write one file per batch).  Dumps go to
        ``path`` if given, else to ``dump_dir/flight_<seq>_<reason>.json``;
        with neither configured, the marker alone is recorded.  Returns the
        dump path, or None when no file was written.
        """
        self.instant("flight.anomaly", cat="flight", reason=reason, **context)
        now = self._wall()
        with self._lock:
            last = self._last_trigger.get(reason)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_trigger[reason] = now
            self._dump_seq += 1
            seq = self._dump_seq
            self.triggers.append({"seq": seq, "reason": reason,
                                  "context": dict(context)})
            del self.triggers[:-256]
        if path is None and self.dump_dir is not None:
            path = os.path.join(self.dump_dir,
                                f"flight_{seq:04d}_{reason}.json")
        if path is None:
            return None
        return self.dump(path)


# ---------------------------------------------------------------------------
# process-global recorder — what the serving stack's trigger sites dispatch to
# ---------------------------------------------------------------------------

_INSTALLED: Optional[FlightRecorder] = None
_LOCK = threading.Lock()


def install(capacity: int = 4096, dump_dir: Optional[str] = None,
            cooldown_s: float = 1.0,
            recorder: Optional[FlightRecorder] = None) -> FlightRecorder:
    """Install ``recorder`` (or a fresh ring) as the process-global flight
    recorder AND as the trace module's flight sink."""
    global _INSTALLED
    with _LOCK:
        fr = recorder if recorder is not None else FlightRecorder(
            capacity=capacity, dump_dir=dump_dir, cooldown_s=cooldown_s)
        _INSTALLED = fr
        obs_trace.set_flight_sink(fr)
    return fr


def uninstall() -> Optional[FlightRecorder]:
    """Remove the flight recorder; returns it (so a caller can still
    ``dump()`` what it holds)."""
    global _INSTALLED
    with _LOCK:
        prev, _INSTALLED = _INSTALLED, None
        obs_trace.set_flight_sink(None)
    return prev


def get_flight() -> Optional[FlightRecorder]:
    return _INSTALLED


def trigger(reason: str, **context) -> Optional[str]:
    """Module-level anomaly trigger: one ``is None`` check when no recorder
    is installed — safe to leave on every incident path."""
    fr = _INSTALLED
    if fr is None:
        return None
    return fr.trigger(reason, **context)
