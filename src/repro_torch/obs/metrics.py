"""Counter / gauge / histogram registry with bounded reservoir quantiles.

The port's copy of ``repro.obs.metrics`` (numpy only): three metric kinds
behind one thread-safe registry —

  * :class:`Counter` — monotone ``inc``;
  * :class:`Gauge`   — last-write-wins ``set`` (plus inc/dec);
  * :class:`Histogram` — ``observe`` into a BOUNDED uniform reservoir
    (Vitter's algorithm R with a per-histogram RNG seeded from a stable
    hash of its name): count /
    sum / min / max are tracked exactly, quantiles are estimated from at
    most ``max_samples`` retained samples, so a service that records one
    latency per query holds O(max_samples) memory after a billion queries
    instead of O(queries).

``MetricsRegistry.snapshot()`` flattens everything into one JSON-able dict
(histograms expand to ``*_count`` / ``*_mean`` / ``*_p50`` / ``*_p99`` …).
A producer that keeps values on the device until they are read (the
edge-map counters' frontier densities) registers a flush with
``MetricsRegistry.add_flush``; ``snapshot()`` runs every flush first.  A
process-global default registry (:func:`get_registry`) collects the
stack-wide metrics unless a caller injects its own.

One change from the reference: the reservoir's RNG is seeded from
``zlib.crc32`` of the name, not ``hash(name)``, which ``PYTHONHASHSEED``
randomises per process.  Count, sum, min and max are exact either way, and
so are the quantiles while no more than ``max_samples`` values were seen.
"""
from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "reset_registry",
]


class Counter:
    """Monotone event counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded-memory distribution: exact count/sum/min/max + reservoir
    quantiles.

    Algorithm R: the first ``max_samples`` observations are kept verbatim
    (small-N quantiles are exact — the common test/benchmark case); after
    that, observation ``i`` replaces a random retained sample with
    probability ``max_samples / i`` — a uniform sample of the full stream in
    O(max_samples) memory.  The RNG is seeded from the CRC-32 of the metric
    name, so runs are deterministic in every process.
    """

    __slots__ = ("name", "max_samples", "count", "total", "min", "max",
                 "_samples", "_rng", "_lock")

    def __init__(self, name: str, max_samples: int = 2048):
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self.name = name
        self.max_samples = int(max_samples)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: List[float] = []
        self._rng = np.random.default_rng(zlib.crc32(name.encode()))
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self.count += 1
            self.total += x
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            if len(self._samples) < self.max_samples:
                self._samples.append(x)
            else:
                j = int(self._rng.integers(0, self.count))
                if j < self.max_samples:
                    self._samples[j] = x

    def observe_many(self, xs: Sequence[float]) -> None:
        for x in xs:
            self.observe(x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    @property
    def num_samples(self) -> int:
        return len(self._samples)

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                return float("nan")
            return float(np.quantile(np.asarray(self._samples), q))

    def quantiles(self, qs: Sequence[float] = (0.5, 0.99)) -> Dict[str, float]:
        with self._lock:
            if not self._samples:
                return {f"p{int(q * 100)}": float("nan") for q in qs}
            arr = np.asarray(self._samples)
        return {f"p{int(q * 100)}": float(np.quantile(arr, q)) for q in qs}


class MetricsRegistry:
    """Name → metric table; get-or-create, kind-checked, thread-safe."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._flushes: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def add_flush(self, fn: Callable[[], None]) -> None:
        """Run ``fn()`` at the start of every ``snapshot()``: it folds values
        a producer has held back (on the device) into its metrics."""
        with self._lock:
            self._flushes.append(fn)

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, max_samples: int = 2048) -> Histogram:
        return self._get(name, Histogram, max_samples=max_samples)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, float]:
        """Flatten every metric into one JSON-able dict (after every flush)."""
        with self._lock:
            flushes = list(self._flushes)
        for fn in flushes:
            fn()
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, float] = {}
        for name in sorted(metrics):
            m = metrics[name]
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
            else:
                h: Histogram = m  # type: ignore[assignment]
                out[f"{name}_count"] = h.count
                if h.count:
                    out[f"{name}_mean"] = h.mean
                    out[f"{name}_min"] = h.min
                    out[f"{name}_max"] = h.max
                    q = h.quantiles((0.5, 0.99))
                    out[f"{name}_p50"] = q["p50"]
                    out[f"{name}_p99"] = q["p99"]
        return out


_REGISTRY = MetricsRegistry()
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (stack-wide metrics land here)."""
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh global registry (test isolation); returns the new one."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()
    return _REGISTRY
