"""Declarative SLOs evaluated over rolling windows with multi-window burn
rates — the health plane of the serving stack.  The port's copy of
``repro.obs.slo``.

The cumulative metrics in :mod:`repro_torch.obs.metrics` answer "what happened
since the process started"; an operator needs "is it healthy NOW".  An
:class:`Objective` declares a target; an :class:`SLOTracker` keeps a bounded
event window per objective and evaluates each over several rolling windows
(classically one short and one long) as a **burn rate** — the rate the error
budget is being consumed, normalized so 1.0 means "exactly exhausting the
budget":

  * ``kind="quantile"`` — events are measurements (latencies); an event is
    *bad* when it exceeds ``target``; the budget is ``1 - quantile`` (a p99
    objective tolerates 1% bad), so ``burn = bad_fraction / (1-quantile)``;
  * ``kind="rate"``     — events are good/bad outcomes (admissions vs
    ``QueueFull`` rejections); ``target`` IS the budget:
    ``burn = bad_fraction / target``;
  * ``kind="value"``    — events are gauge samples (snapshot staleness,
    ingest lag); ``burn = max(value in window) / target``.

An objective is **breached** when its burn rate is >= 1 in EVERY window that
has data — the standard multi-window rule: the long window proves the
problem is real (not one blip), the short window proves it is still
happening.  Breaches are edge-triggered into ``on_breach`` (the serving
stack wires this to :func:`repro_torch.obs.flight.trigger`, so the flight ring is
snapshotted with the events leading UP TO the first breach, and again only
after the objective recovers).

``health()`` flattens everything into one JSON-able dict — the shape a
service's ``health()`` returns.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Objective", "SLOTracker"]

KINDS = ("quantile", "rate", "value")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative service-level objective (see module doc for kinds)."""

    name: str
    kind: str
    target: float
    quantile: float = 0.99          # kind="quantile" only
    windows: Tuple[float, ...] = (30.0, 300.0)   # seconds, short -> long
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown objective kind {self.kind!r}; "
                             f"known: {', '.join(KINDS)}")
        if self.target <= 0:
            raise ValueError(f"objective {self.name!r} needs target > 0")
        if self.kind == "quantile" and not 0.0 < self.quantile < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError("windows must be positive")


class _Series:
    """Bounded (timestamp, value, bad) event window for one objective."""

    __slots__ = ("events", "max_events")

    def __init__(self, max_events: int):
        self.events: Deque[Tuple[float, float, bool]] = deque(
            maxlen=max_events)
        self.max_events = max_events

    def append(self, t: float, value: float, bad: bool) -> None:
        self.events.append((t, value, bad))

    def window(self, now: float, w: float) -> List[Tuple[float, float, bool]]:
        lo = now - w
        return [e for e in self.events if e[0] >= lo]


class SLOTracker:
    """Evaluate a set of :class:`Objective`\\ s over rolling windows.

    Thread-safe; all recording paths are O(1) appends into bounded deques,
    so a tracker can sit on the serving hot path.  ``on_breach(name, info)``
    fires at record time, edge-triggered per objective (breached only after
    having been healthy).
    """

    def __init__(self, objectives: Sequence[Objective],
                 clock=time.monotonic, max_events: int = 8192,
                 on_breach: Optional[Callable[[str, Dict[str, Any]],
                                              None]] = None):
        self.objectives: Dict[str, Objective] = {}
        for o in objectives:
            if o.name in self.objectives:
                raise ValueError(f"duplicate objective {o.name!r}")
            self.objectives[o.name] = o
        self._series = {name: _Series(max_events) for name in self.objectives}
        self._breached = {name: False for name in self.objectives}
        self._clock = clock
        self._on_breach = on_breach
        self._lock = threading.Lock()

    def _objective(self, name: str) -> Objective:
        try:
            return self.objectives[name]
        except KeyError:
            raise KeyError(f"unknown objective {name!r}; declared: "
                           f"{', '.join(sorted(self.objectives))}") from None

    # -- recording -----------------------------------------------------------
    def observe(self, name: str, value: float,
                context: Optional[Dict[str, Any]] = None) -> None:
        """Record one measurement (kind="quantile") or gauge sample
        (kind="value")."""
        obj = self._objective(name)
        if obj.kind == "rate":
            raise TypeError(f"objective {name!r} is rate-kind; use "
                            "observe_ok(name, ok)")
        value = float(value)
        bad = value > obj.target
        with self._lock:
            self._series[name].append(self._clock(), value, bad)
        self._check_breach(name, context)

    def observe_ok(self, name: str, ok: bool,
                   context: Optional[Dict[str, Any]] = None) -> None:
        """Record one good/bad outcome (kind="rate")."""
        obj = self._objective(name)
        if obj.kind != "rate":
            raise TypeError(f"objective {name!r} is {obj.kind}-kind; use "
                            "observe(name, value)")
        with self._lock:
            self._series[name].append(self._clock(), 0.0 if ok else 1.0,
                                      not ok)
        self._check_breach(name, context)

    # -- evaluation ----------------------------------------------------------
    def _eval_window(self, obj: Objective, events) -> Dict[str, float]:
        n = len(events)
        out: Dict[str, float] = {"events": n}
        if n == 0:
            out["burn_rate"] = 0.0
            return out
        bad = sum(1 for e in events if e[2])
        if obj.kind == "quantile":
            vals = np.asarray([e[1] for e in events])
            q = float(np.quantile(vals, obj.quantile))
            out[f"p{int(obj.quantile * 100)}"] = q
            out["bad_fraction"] = bad / n
            out["burn_rate"] = (bad / n) / (1.0 - obj.quantile)
        elif obj.kind == "rate":
            out["bad_fraction"] = bad / n
            out["burn_rate"] = (bad / n) / obj.target
        else:  # value
            worst = max(e[1] for e in events)
            out["value"] = worst
            out["burn_rate"] = worst / obj.target
        return out

    def evaluate(self, name: str,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """One objective's windows, burn rates, and breach verdict."""
        obj = self._objective(name)
        now = self._clock() if now is None else now
        with self._lock:
            series = self._series[name]
            windows = {w: series.window(now, w) for w in obj.windows}
        evals = {f"{w:g}s": self._eval_window(obj, evs)
                 for w, evs in windows.items()}
        with_data = [e for e in evals.values() if e["events"]]
        breached = bool(with_data) and all(e["burn_rate"] >= 1.0
                                           for e in with_data)
        info: Dict[str, Any] = {
            "kind": obj.kind,
            "target": obj.target,
            "windows": evals,
            "worst_burn": max((e["burn_rate"] for e in with_data),
                              default=0.0),
            "breached": breached,
        }
        if obj.kind == "quantile":
            info["quantile"] = obj.quantile
        if obj.description:
            info["description"] = obj.description
        return info

    def _check_breach(self, name: str,
                      context: Optional[Dict[str, Any]]) -> None:
        """Edge-triggered breach detection on the record path."""
        info = self.evaluate(name)
        was = self._breached[name]
        self._breached[name] = info["breached"]
        if info["breached"] and not was and self._on_breach is not None:
            if context:
                info = dict(info, context=dict(context))
            self._on_breach(name, info)

    def breached(self, name: str) -> bool:
        return self.evaluate(name)["breached"]

    def health(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The JSON-able health snapshot: every objective evaluated, plus an
        overall status (``ok`` / ``breached``)."""
        now = self._clock() if now is None else now
        objectives = {name: self.evaluate(name, now)
                      for name in sorted(self.objectives)}
        return {
            "status": ("breached"
                       if any(o["breached"] for o in objectives.values())
                       else "ok"),
            "objectives": objectives,
        }
