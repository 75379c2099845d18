"""Near-zero-overhead span tracer with Chrome-trace-event export.

The port's copy of ``repro.obs.trace``.  Spans read host clocks only: a span
never synchronizes the device, so a span around a call that launches
kernels times the host's side of the call, not the kernels.

The measurement plane's clock: ``Tracer.span`` opens a nested, thread-safe
span (context manager or decorator) on a monotone clock
(``time.perf_counter_ns``); finished spans accumulate as Chrome trace
events — the ``{"traceEvents": [...]}`` JSON that chrome://tracing and
Perfetto load directly — with complete events (``ph == "X"``), microsecond
timestamps, one track per thread.  Nesting is per-thread (a thread-local
span stack tracks depth; Chrome infers the tree from timestamp containment
within a ``tid``), so concurrent recorders never interleave each other's
stacks.

Each tracer anchors its epoch on ``time.time_ns``, the clock of
``torch.profiler``'s events: ``Tracer.spans_unix_ns`` gives every complete
event as ``(start, end, name)`` there, so a profiled window's device
events line up with the spans that launched them.  A phase the caller
times anyway (a set-up step whose seconds it also publishes) takes two
readings of :func:`now` and records them with :func:`complete`: one timing
path for the span and the number.

Tracing is OFF by default and costs one ``is``-check per call site when off:
the module-level :func:`span` / :func:`instant` / :func:`counter` helpers
dispatch to a process-global tracer that defaults to the :data:`NULL_TRACER`
singleton, whose ``span()`` returns one shared no-op context manager — no
allocation, no clock read, no lock.  ``enable()`` swaps in a live
:class:`Tracer`; ``disable()`` swaps the null one back and returns the live
tracer so the caller can still ``save()`` it.  Instrumented code paths are
therefore safe to leave in hot loops: disabled-mode behavior is bitwise
identical to uninstrumented code (the tracer never touches operand values).

Beyond nested spans, the tracer speaks Chrome's CAUSAL vocabulary:

  * **flow events** (``ph`` ``s``/``t``/``f`` + an ``id``) stitch a logical
    operation across spans, threads, and batches — a serving layer tags
    each query's submit → batch-dispatch → result with its qid, so
    selecting one query in Perfetto highlights its whole causal chain;
  * **async spans** (``ph`` ``b``/``n``/``e`` + an ``id``) bracket an
    operation whose start and end live in different stack frames (a query's
    queue wait), drawn as their own track.

There is also a second, always-on sink: :mod:`repro_torch.obs.flight` installs a
bounded ring recorder via :func:`set_flight_sink`.  When only the flight
sink is installed, the module-level helpers record into the ring (bounded
memory, O(1) append); when a full tracer is ALSO enabled, every event it
records is teed into the ring as well — so the recent-history ring is always
current, whichever mode the process runs in.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "enable",
    "disable",
    "enabled",
    "recording",
    "get_tracer",
    "set_flight_sink",
    "get_flight_sink",
    "span",
    "now",
    "complete",
    "instant",
    "counter",
    "flow_start",
    "flow_step",
    "flow_end",
    "async_begin",
    "async_instant",
    "async_end",
    "traced",
    "save",
    "load_trace",
    "validate_trace",
]

#: flow phases (start / step / finish) and async phases (begin / instant /
#: end) — the id-tagged causal event vocabulary ``validate_trace`` checks
FLOW_PHASES = ("s", "t", "f")
ASYNC_PHASES = ("b", "n", "e")


class _NullSpan:
    """Shared do-nothing context manager — the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **args) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One open span; closing it appends a Chrome complete event."""

    __slots__ = ("_tracer", "name", "cat", "args", "_start", "_tid", "depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._start = 0
        self._tid = 0
        self.depth = 0

    def add(self, **args) -> "_Span":
        """Attach result args discovered mid-span (shown in the trace UI)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)
        return self

    def __enter__(self):
        tr = self._tracer
        self._tid = threading.get_ident()
        stack = tr._stack()
        self.depth = len(stack)
        stack.append(self)
        self._start = tr._clock()
        return self

    def __exit__(self, *exc):
        end = self._tracer._clock()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        ev = {
            "ph": "X",
            "name": self.name,
            "cat": self.cat or "repro",
            "pid": tr.pid,
            "tid": self._tid,
            "ts": (self._start - tr.epoch) / 1e3,  # µs, trace-relative
            "dur": (end - self._start) / 1e3,
        }
        if self.args:
            ev["args"] = _jsonable(self.args)
        tr._emit(ev)
        return False


def _jsonable(args: Dict[str, Any]) -> Dict[str, Any]:
    """Chrome trace args must be JSON — stringify anything exotic."""
    out = {}
    for k, v in args.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


class Tracer:
    """Thread-safe span recorder on a monotone clock.

    All spans of all threads accumulate into one event list (appends are
    locked; open-span stacks are thread-local).  ``export()`` returns the
    Chrome trace dict; ``save(path)`` writes it as JSON.
    """

    def __init__(self, clock=time.perf_counter_ns):
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self.pid = os.getpid()
        before = time.time_ns()
        self.epoch = clock()  # ts 0 == tracer construction
        #: ``time.time_ns()`` at ``epoch`` (the mean of two readings around
        #: it): where ts 0 lies on the profiler's clock
        self.epoch_unix_ns = (before + time.time_ns()) // 2
        self.events: List[Dict[str, Any]] = []

    # -- internals -----------------------------------------------------------
    def _stack(self) -> List[_Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _emit(self, ev: Dict[str, Any]) -> None:
        """Record one finished event; tees into the flight ring if one is
        installed (the always-on recent-history sink)."""
        with self._lock:
            self.events.append(ev)
        flight = _FLIGHT
        if flight is not None and flight is not self:
            flight._emit(ev)

    def _stamp(self, ph: str, name: str, cat: str,
               args: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        ev = {
            "ph": ph, "name": name, "cat": cat or "repro",
            "pid": self.pid, "tid": threading.get_ident(),
            "ts": (self._clock() - self.epoch) / 1e3,
        }
        if args:
            ev["args"] = _jsonable(args)
        return ev

    # -- recording -----------------------------------------------------------
    def span(self, name: str, cat: str = "", **args) -> _Span:
        """Open a span: ``with tracer.span("serve.batch", kind="sssp"): ...``"""
        return _Span(self, name, cat, args or None)

    def now(self) -> int:
        """One reading of this tracer's clock (what :meth:`complete` takes)."""
        return self._clock()

    def complete(self, name: str, start: int, end: int, cat: str = "",
                 **args) -> None:
        """Record a span already timed by two readings of this tracer's
        clock (``now()`` before and after): the complete event ``span``
        would have made."""
        ev = {"ph": "X", "name": name, "cat": cat or "repro", "pid": self.pid,
              "tid": threading.get_ident(), "ts": (start - self.epoch) / 1e3,
              "dur": (end - start) / 1e3}
        if args:
            ev["args"] = _jsonable(args)
        self._emit(ev)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """A zero-duration marker event (``ph == "i"``)."""
        ev = self._stamp("i", name, cat, args)
        ev["s"] = "t"
        self._emit(ev)

    def counter(self, name: str, cat: str = "", **values) -> None:
        """A Chrome counter sample (``ph == "C"`` — plotted as a track)."""
        ev = self._stamp("C", name, cat, None)
        ev["args"] = _jsonable(values)
        self._emit(ev)

    # -- causal events (flows + async spans) ---------------------------------
    def _id_event(self, ph: str, name: str, event_id, cat: str,
                  args: Dict[str, Any]) -> None:
        ev = self._stamp(ph, name, cat or "flow", args or None)
        ev["id"] = int(event_id)
        if ph == "f":
            ev["bp"] = "e"  # bind the finish to the enclosing slice
        self._emit(ev)

    def flow_start(self, name: str, flow_id, cat: str = "", **args) -> None:
        """Begin a flow (``ph == "s"``): the arrow's tail.  ``flow_id`` links
        all events of one logical operation (e.g. a query's qid)."""
        self._id_event("s", name, flow_id, cat, args)

    def flow_step(self, name: str, flow_id, cat: str = "", **args) -> None:
        """An intermediate flow binding point (``ph == "t"``)."""
        self._id_event("t", name, flow_id, cat, args)

    def flow_end(self, name: str, flow_id, cat: str = "", **args) -> None:
        """Finish a flow (``ph == "f"``): the arrow's head."""
        self._id_event("f", name, flow_id, cat, args)

    def async_begin(self, name: str, async_id, cat: str = "", **args) -> None:
        """Open an id-tagged async span (``ph == "b"``) — an operation whose
        begin and end live in different stack frames / threads."""
        self._id_event("b", name, async_id, cat, args)

    def async_instant(self, name: str, async_id, cat: str = "",
                      **args) -> None:
        """A marker inside an async span (``ph == "n"``)."""
        self._id_event("n", name, async_id, cat, args)

    def async_end(self, name: str, async_id, cat: str = "", **args) -> None:
        """Close an async span (``ph == "e"``)."""
        self._id_event("e", name, async_id, cat, args)

    @property
    def depth(self) -> int:
        """Open-span depth of the CALLING thread (0 at top level)."""
        return len(self._stack())

    # -- the profiler's clock -----------------------------------------------
    def spans_unix_ns(self) -> List[Tuple[int, int, str]]:
        """Every complete event as ``(start, end, name)`` on ``time.time_ns``,
        the clock of ``torch.profiler``'s events, in the order recorded.
        Holds for a clock that counts real nanoseconds (the default,
        ``time.perf_counter_ns``)."""
        with self._lock:
            events = [e for e in self.events if e["ph"] == "X"]
        at = self.epoch_unix_ns
        return [(at + round(e["ts"] * 1e3),
                 at + round((e["ts"] + e["dur"]) * 1e3), e["name"])
                for e in events]

    # -- export --------------------------------------------------------------
    def export(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export(), f)
        return path


class NullTracer:
    """Disabled-mode tracer: every operation is a no-op.

    ``span()`` hands back ONE shared context manager — identity-equal across
    calls, so disabled-mode instrumentation allocates nothing and reads no
    clock (the no-measurable-overhead contract).
    """

    def span(self, name: str, cat: str = "", **args) -> _NullSpan:
        return _NULL_SPAN

    def now(self) -> int:
        return time.perf_counter_ns()

    def complete(self, name: str, start: int, end: int, cat: str = "",
                 **args) -> None:
        return None

    def instant(self, name: str, cat: str = "", **args) -> None:
        return None

    def counter(self, name: str, cat: str = "", **values) -> None:
        return None

    def flow_start(self, name: str, flow_id, cat: str = "", **args) -> None:
        return None

    def flow_step(self, name: str, flow_id, cat: str = "", **args) -> None:
        return None

    def flow_end(self, name: str, flow_id, cat: str = "", **args) -> None:
        return None

    def async_begin(self, name: str, async_id, cat: str = "", **args) -> None:
        return None

    def async_instant(self, name: str, async_id, cat: str = "",
                      **args) -> None:
        return None

    def async_end(self, name: str, async_id, cat: str = "", **args) -> None:
        return None

    @property
    def depth(self) -> int:
        return 0

    def export(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export(), f)
        return path


NULL_TRACER = NullTracer()
_TRACER: Any = NULL_TRACER
_FLIGHT: Any = None     # the always-on bounded ring (obs.flight)
_ACTIVE: Any = NULL_TRACER  # what the module-level helpers dispatch to


# ---------------------------------------------------------------------------
# process-global switch — what the instrumented call sites dispatch through
# ---------------------------------------------------------------------------

def _recompute_active() -> None:
    """The effective dispatch target: the full tracer when enabled (it tees
    into the flight ring itself), else the flight ring alone, else NULL."""
    global _ACTIVE
    if _TRACER is not NULL_TRACER:
        _ACTIVE = _TRACER
    elif _FLIGHT is not None:
        _ACTIVE = _FLIGHT
    else:
        _ACTIVE = NULL_TRACER


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Install ``tracer`` (or a fresh one) as the process-global tracer."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    _recompute_active()
    return _TRACER


def disable() -> Any:
    """Restore the no-op tracer; returns the previously active tracer (so a
    caller can still ``save()`` what it recorded).  An installed flight ring
    keeps recording — it is the ALWAYS-ON sink (``flight.uninstall()``
    removes it)."""
    global _TRACER
    prev, _TRACER = _TRACER, NULL_TRACER
    _recompute_active()
    return prev


def enabled() -> bool:
    """True when the FULL (unbounded) tracer is on."""
    return _TRACER is not NULL_TRACER


def recording() -> bool:
    """True when events are recorded anywhere — full tracer OR flight ring."""
    return _ACTIVE is not NULL_TRACER


def get_tracer() -> Any:
    return _TRACER


def set_flight_sink(flight: Any) -> None:
    """Install (or, with None, remove) the bounded flight-ring sink.  Called
    by :func:`repro_torch.obs.flight.install` — not usually directly."""
    global _FLIGHT
    _FLIGHT = flight
    _recompute_active()


def get_flight_sink() -> Any:
    return _FLIGHT


def span(name: str, cat: str = "", **args):
    """Module-level span against the global tracer (no-op when disabled)."""
    return _ACTIVE.span(name, cat, **args)


def now() -> int:
    """One reading of the active recorder's clock (``time.perf_counter_ns``
    when nothing records): what :func:`complete` takes."""
    return _ACTIVE.now()


def complete(name: str, start: int, end: int, cat: str = "", **args) -> None:
    """Record a span timed by two readings of :func:`now` (no-op when
    disabled)."""
    _ACTIVE.complete(name, start, end, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    _ACTIVE.instant(name, cat, **args)


def counter(name: str, cat: str = "", **values) -> None:
    _ACTIVE.counter(name, cat, **values)


def flow_start(name: str, flow_id, cat: str = "", **args) -> None:
    _ACTIVE.flow_start(name, flow_id, cat, **args)


def flow_step(name: str, flow_id, cat: str = "", **args) -> None:
    _ACTIVE.flow_step(name, flow_id, cat, **args)


def flow_end(name: str, flow_id, cat: str = "", **args) -> None:
    _ACTIVE.flow_end(name, flow_id, cat, **args)


def async_begin(name: str, async_id, cat: str = "", **args) -> None:
    _ACTIVE.async_begin(name, async_id, cat, **args)


def async_instant(name: str, async_id, cat: str = "", **args) -> None:
    _ACTIVE.async_instant(name, async_id, cat, **args)


def async_end(name: str, async_id, cat: str = "", **args) -> None:
    _ACTIVE.async_end(name, async_id, cat, **args)


def save(path: str) -> str:
    """Save the global tracer's events (works disabled too: empty trace)."""
    return _TRACER.save(path)


def traced(name: Optional[str] = None, cat: str = ""):
    """Decorator form: ``@traced("core.dbg")`` spans every call of ``fn``."""

    def deco(fn):
        span_name = name or f"{fn.__module__.split('.')[-1]}.{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with _ACTIVE.span(span_name, cat):
                return fn(*a, **kw)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# schema helpers (tests + the CI trace-validation step)
# ---------------------------------------------------------------------------

def load_trace(path: str) -> Dict[str, Any]:
    """Load + schema-check a Chrome trace JSON; returns the trace dict."""
    with open(path) as f:
        trace = json.load(f)
    validate_trace(trace)
    return trace


def validate_trace(trace: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``trace`` is a loadable Chrome trace:
    a ``traceEvents`` list whose complete events carry name/ts/dur/pid/tid
    with numeric, non-negative timing — the shape Perfetto ingests.

    Flow events (``ph`` s/t/f) and async events (``ph`` b/n/e) must carry an
    ``id``, and the chains must be well-formed: every flow step/finish and
    every async instant/end needs a matching start/begin with the same
    (cat, name, id) — Perfetto silently drops dangling arrows, so a dangling
    chain is a bug in the emitter, not a rendering choice."""
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace has no traceEvents list")
    flow_starts, flow_refs = set(), []
    async_begins, async_refs = set(), []
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            raise ValueError(f"malformed event: {ev!r}")
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event without numeric ts: {ev!r}")
        ph = ev["ph"]
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"complete event without dur: {ev!r}")
            if "pid" not in ev or "tid" not in ev:
                raise ValueError(f"complete event without pid/tid: {ev!r}")
        if ph in FLOW_PHASES or ph in ASYNC_PHASES:
            if "id" not in ev:
                raise ValueError(f"id-tagged event without id: {ev!r}")
            key = (ev.get("cat", ""), ev["name"], ev["id"])
            if ph == "s":
                flow_starts.add(key)
            elif ph in ("t", "f"):
                flow_refs.append((key, ev))
            elif ph == "b":
                async_begins.add(key)
            elif ph in ("n", "e"):
                async_refs.append((key, ev))
        if "args" in ev:
            json.dumps(ev["args"])  # must round-trip
    for key, ev in flow_refs:
        if key not in flow_starts:
            raise ValueError(f"flow {ev['ph']!r} without matching start "
                             f"(cat={key[0]!r} name={key[1]!r} id={key[2]!r})")
    for key, ev in async_refs:
        if key not in async_begins:
            raise ValueError(f"async {ev['ph']!r} without matching begin "
                             f"(cat={key[0]!r} name={key[1]!r} id={key[2]!r})")
