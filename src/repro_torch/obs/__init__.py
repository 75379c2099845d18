"""repro_torch.obs — tracing, metrics and edge-map counters of the port.

The port's copy of ``repro.obs``, the measurement plane:

  * :mod:`repro_torch.obs.trace`    — near-zero-overhead span tracer (host
    clocks only: a span never synchronizes the device) exporting
    Chrome-trace-event JSON that loads into Perfetto / chrome://tracing;
  * :mod:`repro_torch.obs.metrics`  — counter / gauge / histogram registry
    with bounded reservoir quantiles;
  * :mod:`repro_torch.obs.counters` — per-edge-map-pass telemetry (edges
    traversed, modeled HBM bytes, frontier density, per-backend pass
    counts) hooked into the engine's dispatch, so every app on every
    backend reports;
  * :mod:`repro_torch.obs.flight`   — always-on fixed-capacity flight
    recorder with anomaly triggers;
  * :mod:`repro_torch.obs.slo`      — declarative objectives over rolling
    windows with multi-window burn rates.

Everything is off by default and bitwise-invisible to the computation when
off; ``trace.enable()`` + ``counters.install()`` turn the lights on, and
``flight.install()`` arms the bounded always-on recorder.  The sharded
engine's counters wait for its port (ROADMAP A11).
"""
from . import counters, flight, metrics, slo, trace
from .counters import EdgeMapCounters, flat_edge_map_bytes
from .flight import FlightRecorder
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, reset_registry)
from .slo import Objective, SLOTracker
from .trace import (NULL_TRACER, NullTracer, Tracer, load_trace,
                    validate_trace)

__all__ = [
    "trace",
    "metrics",
    "counters",
    "flight",
    "slo",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "load_trace",
    "validate_trace",
    "FlightRecorder",
    "Objective",
    "SLOTracker",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "reset_registry",
    "EdgeMapCounters",
    "flat_edge_map_bytes",
]
