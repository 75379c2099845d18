"""Persisted execution plans: what ``backend="auto"`` actually loads.

Port of ``repro.tune.plan``.  A plan is a small, schema-versioned JSON
document mapping **graph families** to tuned configurations.  Families are
keyed by features computed from the graph itself — vertex/edge counts,
degree skew (coefficient of variation), hub mass (edge fraction owned by
the top-1% degree vertices), max-degree ratio — so a graph the tuner never
saw still resolves to the nearest family instead of falling off a
name-keyed cliff.  This is the paper's own finding operationalized: the
best technique depends on skew and structure, so the plan key IS skew and
structure.

Resolution order for the active plan: an explicit :func:`set_active_plan`
override, else the ``REPRO_TORCH_TUNE_PLAN`` env path.  Unlike the
reference, the port discovers no committed plan: the repo-root
``PLAN_tuned.json`` was tuned for the reference's Pallas interpreter, not
for the port's device, so it is read only when a caller passes it.  With
no plan, ``backend="auto"`` takes the hand-tuned
:data:`~repro_torch.tune.space.DEFAULT_CONFIG`, so "auto" is always safe
to request.

Per-family configs are per-app (``configs["pr"]`` …) with a ``"default"``
entry for apps the tuner did not sweep; every stored config is canonical
(:func:`repro_torch.tune.space.canonical`) and JSON round-trips bit-equal.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from .space import DEFAULT_CONFIG, canonical, split_config

__all__ = [
    "PLAN_SCHEMA",
    "PlanError",
    "PlanEntry",
    "ExecutionPlan",
    "graph_features",
    "feature_distance",
    "PLAN_ENV",
    "set_active_plan",
    "get_active_plan",
    "auto_config",
    "resolve_auto",
    "build_plan",
]

PLAN_SCHEMA = 1

#: feature keys used for nearest-family matching, with their distance
#: weights.  Counts compare on log scale (a 2x size gap matters the same at
#: 1e4 and 1e7 vertices); skew features compare directly.
_MATCH_FEATURES: Tuple[Tuple[str, float, bool], ...] = (
    ("vertices", 1.0, True),
    ("edges", 1.0, True),
    ("avg_degree", 1.0, True),
    ("deg_cv", 2.0, False),
    ("hub_mass", 2.0, False),
)


class PlanError(ValueError):
    """Malformed / wrong-schema plan document."""


def graph_features(g) -> Dict[str, float]:
    """Family signature of a graph, computed from its degree vectors alone.

    ``deg_cv`` (std/mean of out-degree) is the skew axis, ``hub_mass`` the
    fraction of edges owned by the top-1% highest-out-degree vertices (the
    paper's hot-vertex concentration), ``max_deg_ratio`` the max/mean
    degree.  All plain floats — the dict JSON round-trips exactly.
    """
    deg = np.asarray(g.out_degrees(), np.float64)
    v = int(deg.shape[0])
    e = int(deg.sum())
    mean = deg.mean() if v else 0.0
    std = deg.std() if v else 0.0
    n_hub = max(1, v // 100)
    hub = float(np.sort(deg)[-n_hub:].sum() / max(1.0, float(e)))
    return {
        "vertices": float(v),
        "edges": float(e),
        "avg_degree": round(float(mean), 6),
        "deg_cv": round(float(std / mean) if mean else 0.0, 6),
        "hub_mass": round(hub, 6),
        "max_deg_ratio": round(float(deg.max() / mean) if mean else 0.0, 6),
    }


def feature_distance(a: Dict[str, float], b: Dict[str, float]) -> float:
    """Weighted distance between two family signatures (see module doc)."""
    d = 0.0
    for key, weight, log in _MATCH_FEATURES:
        x, y = float(a.get(key, 0.0)), float(b.get(key, 0.0))
        if log:
            x, y = math.log1p(max(0.0, x)), math.log1p(max(0.0, y))
        d += weight * (x - y) ** 2
    return math.sqrt(d)


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One graph family: its feature signature + per-app tuned configs."""

    family: str
    features: Dict[str, float]
    configs: Dict[str, Dict]  # app name (or "default") -> canonical config

    def config_for(self, app: Optional[str]) -> Dict:
        if app is not None and app in self.configs:
            return dict(self.configs[app])
        if "default" in self.configs:
            return dict(self.configs["default"])
        # any app entry beats nothing; deterministic pick
        key = sorted(self.configs)[0]
        return dict(self.configs[key])


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A schema-versioned set of :class:`PlanEntry` rows + provenance."""

    entries: Tuple[PlanEntry, ...]
    created: str = ""
    meta: Dict = dataclasses.field(default_factory=dict)
    schema: int = PLAN_SCHEMA

    # -- persistence --------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "schema": self.schema,
            "created": self.created,
            "meta": dict(self.meta),
            "entries": [
                {"family": e.family, "features": dict(e.features),
                 "configs": {k: dict(v) for k, v in sorted(e.configs.items())}}
                for e in self.entries
            ],
        }

    @classmethod
    def from_json(cls, doc: Dict) -> "ExecutionPlan":
        if not isinstance(doc, dict) or "entries" not in doc:
            raise PlanError("not a plan document (no 'entries')")
        got = doc.get("schema")
        if got != PLAN_SCHEMA:
            raise PlanError(
                f"plan schema {got!r} != expected {PLAN_SCHEMA} — re-run "
                "the tuner (tune.search.sweep, tune.plan.build_plan) to "
                "regenerate the plan")
        entries = []
        for row in doc["entries"]:
            configs = {k: canonical(v) for k, v in row["configs"].items()}
            if not configs:
                raise PlanError(f"family {row.get('family')!r} has no configs")
            entries.append(PlanEntry(
                family=str(row["family"]),
                features={k: float(v) for k, v in row["features"].items()},
                configs=configs))
        return cls(entries=tuple(entries), created=str(doc.get("created", "")),
                   meta=dict(doc.get("meta", {})))

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "ExecutionPlan":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    # -- resolution ---------------------------------------------------------
    def lookup(self, features: Dict[str, float],
               app: Optional[str] = None) -> Tuple[Dict, str]:
        """Nearest-family config for a feature signature: ``(config,
        family_name)``.  Raises on an empty plan."""
        if not self.entries:
            raise PlanError("empty plan")
        best = min(self.entries,
                   key=lambda e: (feature_distance(features, e.features),
                                  e.family))
        return best.config_for(app), best.family


# ---------------------------------------------------------------------------
# active-plan state (what backend="auto" resolves through)
# ---------------------------------------------------------------------------

_UNSET = object()
_ACTIVE: Union[object, None, ExecutionPlan] = _UNSET
_ENV_CACHE: Dict[str, ExecutionPlan] = {}

#: the environment variable naming the port's plan file
PLAN_ENV = "REPRO_TORCH_TUNE_PLAN"


def set_active_plan(
        plan: Union[None, str, ExecutionPlan, object] = _UNSET):
    """Override the active plan for this process.

    ``ExecutionPlan`` or a path sets it; ``None`` disables plans entirely
    (``"auto"`` → hand-tuned defaults, bypassing the env discovery);
    calling with no argument clears the override and restores discovery.
    Returns the previous override state.
    """
    global _ACTIVE
    prev = _ACTIVE
    if isinstance(plan, str):
        plan = ExecutionPlan.load(plan)
    _ACTIVE = plan
    return prev


def get_active_plan() -> Optional[ExecutionPlan]:
    """The plan ``backend="auto"`` resolves through right now (see module
    doc for the resolution order); ``None`` when no plan is available."""
    if _ACTIVE is not _UNSET:
        return _ACTIVE  # type: ignore[return-value]
    path = os.environ.get(PLAN_ENV)
    if not path:
        return None
    if path not in _ENV_CACHE:
        _ENV_CACHE[path] = ExecutionPlan.load(path)
    return _ENV_CACHE[path]


def auto_config(g, *, app: Optional[str] = None,
                plan: Union[None, str, ExecutionPlan] = None) -> Dict:
    """The full (engine + app scope) config ``backend="auto"`` picks for
    ``g``: the nearest family's per-app config layered over the hand-tuned
    defaults, or the defaults alone when no plan is available."""
    if isinstance(plan, str):
        plan = ExecutionPlan.load(plan)
    if plan is None:
        plan = get_active_plan()
    if plan is None:
        return canonical(dict(DEFAULT_CONFIG))
    cfg, _family = plan.lookup(graph_features(g), app)
    return canonical({**DEFAULT_CONFIG, **cfg})


def resolve_auto(g, *, app: Optional[str] = None,
                 plan: Union[None, str, ExecutionPlan] = None,
                 ) -> Tuple[str, Dict]:
    """``(backend_name, engine_kwargs)`` for ``to_arrays(backend="auto")``.
    The resolved name is always a concrete ``BACKENDS`` entry."""
    engine_cfg, _app_cfg, _ = split_config(auto_config(g, app=app, plan=plan))
    name = engine_cfg.pop("backend")
    if name == "auto":  # a plan must resolve, not recurse
        raise PlanError("plan config resolves backend to 'auto'")
    return name, engine_cfg


def build_plan(cells: Sequence[Dict], *, created: str = "",
               meta: Optional[Dict] = None) -> ExecutionPlan:
    """Assemble a plan from autotune result cells: each cell supplies
    ``family`` / ``features`` / ``configs``."""
    entries = tuple(PlanEntry(
        family=str(c["family"]), features=dict(c["features"]),
        configs={k: canonical(v) for k, v in c["configs"].items()})
        for c in cells)
    return ExecutionPlan(entries=entries, created=created,
                         meta=dict(meta or {}))
