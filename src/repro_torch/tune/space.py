"""Declarative configuration space for the autotuner (repro_torch.tune).

Port of ``repro.tune.space``.  The system's knobs — engine backend, ELL
tile geometry, packed-layout slot alignment / hot-group count, the apps'
frontier-density direction switch, the stream regrouper's hysteresis
band — are declared ONCE as typed dimensions with per-backend validity, so
the cost ranker (``tune.cost``), the measured sweep (``tune.search``), the
persisted plans (``tune.plan``) and the engine's own kwarg validation
(``apps.engine.to_arrays``) all agree on what a configuration *is*.

A **config** is a plain JSON-able dict: ``{"backend": "ell", "row_tile": 64,
"width_tile": 128, ...}``.  :data:`BACKEND_KNOBS`, the constraint table
mapping each engine backend to the construction knobs it consumes,
:data:`KNOB_SCOPES` and :func:`validate_knobs` are the engine's own
(``apps.engine``), re-exported here: the port keeps one knob table.  :func:`canonical` drops inapplicable
knobs so two configs that build the same backend compare equal.

``interpret`` (the reference's Pallas interpreter switch) is not a knob of
the port: the device is the caller's ``device`` argument.  A config that
carries it (a reference plan) loads, and :func:`canonical` drops it;
``validate_knobs`` raises on it as an unknown knob.

Scopes: ``engine`` knobs feed ``to_arrays``; ``app`` knobs
(``density_threshold``) thread into the direction-optimizing loops
(``apps.sssp`` / ``apps.bc`` / ``serve.batched``); ``stream`` knobs
(``hysteresis``) feed ``stream.StreamConfig``.  :func:`split_config`
separates a mixed config by scope.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Dict, Iterable, List, Sequence, Tuple

from ..apps.engine import BACKEND_KNOBS, KNOB_SCOPES, validate_knobs

__all__ = [
    "Choice",
    "IntRange",
    "FloatRange",
    "ParamSpace",
    "BACKEND_KNOBS",
    "KNOB_SCOPES",
    "DEFAULT_CONFIG",
    "backend_knobs",
    "canonical",
    "split_config",
    "validate_knobs",
    "engine_space",
    "full_space",
]


# ---------------------------------------------------------------------------
# typed dimensions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Choice:
    """Categorical dimension: grid == values, random == uniform pick."""

    name: str
    values: Tuple

    def grid_points(self) -> Tuple:
        return tuple(self.values)

    def sample(self, rng: random.Random):
        return rng.choice(self.values)


@dataclasses.dataclass(frozen=True)
class IntRange:
    """Integer dimension.  ``log=True`` grids/samples powers-of-two style
    (geometric steps), which is what tile shapes want."""

    name: str
    lo: int
    hi: int
    log: bool = True
    grid_n: int = 4

    def grid_points(self) -> Tuple:
        if self.log:
            pts, v = [], self.lo
            while v <= self.hi:
                pts.append(v)
                v *= 2
            return tuple(pts)
        step = max(1, (self.hi - self.lo) // max(1, self.grid_n - 1))
        return tuple(range(self.lo, self.hi + 1, step))

    def sample(self, rng: random.Random) -> int:
        if self.log:
            return int(rng.choice(self.grid_points()))
        return rng.randint(self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class FloatRange:
    """Float dimension; ``log=True`` samples log-uniform (thresholds)."""

    name: str
    lo: float
    hi: float
    log: bool = True
    grid_n: int = 3

    def grid_points(self) -> Tuple:
        n = max(2, self.grid_n)
        if self.log:
            la, lb = math.log(self.lo), math.log(self.hi)
            return tuple(round(math.exp(la + (lb - la) * i / (n - 1)), 10)
                         for i in range(n))
        return tuple(round(self.lo + (self.hi - self.lo) * i / (n - 1), 10)
                     for i in range(n))

    def sample(self, rng: random.Random) -> float:
        if self.log:
            la, lb = math.log(self.lo), math.log(self.hi)
            return round(math.exp(rng.uniform(la, lb)), 10)
        return round(rng.uniform(self.lo, self.hi), 10)


# ---------------------------------------------------------------------------
# the hand-tuned default (the knob tables, BACKEND_KNOBS and KNOB_SCOPES,
# live in apps.engine)
# ---------------------------------------------------------------------------

#: The hand-tuned configuration every benchmark used before repro.tune: the
#: fused DBG-ELL backend with the PR-4 tile geometry and Ligra's E/20
#: direction switch.  ``backend="auto"`` falls back to this when no plan
#: matches, and the measured sweep uses its modeled bytes as the
#: never-spend-more budget.
DEFAULT_CONFIG: Dict = {
    "backend": "ell",
    "row_tile": 64,
    "width_tile": 128,
    "density_threshold": 0.05,
}


def backend_knobs(backend: str) -> frozenset:
    """Construction knobs valid for ``backend`` (KeyError-free)."""
    try:
        return BACKEND_KNOBS[backend]
    except KeyError:
        raise ValueError(
            f"unknown edge-map backend {backend!r}; known backends: "
            f"{', '.join(sorted(BACKEND_KNOBS))}") from None


def canonical(config: Dict) -> Dict:
    """Drop knobs the config's backend does not consume (keeping non-engine
    scopes), so configs that build identical backends compare equal.

    ``{"backend": "flat", "row_tile": 32}`` and ``{"backend": "flat"}``
    are the same execution plan; the sweep must not price them twice.
    """
    backend = config.get("backend", DEFAULT_CONFIG["backend"])
    allowed = backend_knobs(backend)
    out = {"backend": backend}
    for k in sorted(config):
        if k in ("backend", "interpret"):
            continue
        scope = KNOB_SCOPES.get(k)
        if scope == "engine" and k not in allowed:
            continue
        out[k] = config[k]
    return out


def split_config(config: Dict) -> Tuple[Dict, Dict, Dict]:
    """``(engine_kwargs, app_kwargs, stream_kwargs)`` of a mixed config.

    ``engine_kwargs`` includes ``backend`` and is safe to splat into
    ``to_arrays``; the others go to the app loops / StreamConfig."""
    cfg = canonical(config)
    engine: Dict = {}
    app: Dict = {}
    stream: Dict = {}
    for k, v in cfg.items():
        scope = KNOB_SCOPES.get(k, "engine")
        (engine if scope == "engine" else
         app if scope == "app" else stream)[k] = v
    return engine, app, stream


# ---------------------------------------------------------------------------
# the space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """A declared set of dimensions + the constraint table.

    ``grid()`` enumerates the full cartesian product, canonicalizes each
    point (dropping knobs invalid for its backend) and dedupes — so the
    flat backend contributes ONE candidate however many tile-geometry
    values are declared.  ``sample(n, seed)`` draws canonical random
    configs (deduped, so it may return fewer than ``n``).
    """

    dims: Tuple = ()

    def dim(self, name: str):
        for d in self.dims:
            if d.name == name:
                return d
        raise KeyError(name)

    def _dedupe(self, configs: Iterable[Dict]) -> List[Dict]:
        seen, out = set(), []
        for cfg in configs:
            c = canonical(cfg)
            key = tuple(sorted(c.items()))
            if key in seen:
                continue
            seen.add(key)
            out.append(c)
        return out

    def grid(self) -> List[Dict]:
        names = [d.name for d in self.dims]
        axes = [d.grid_points() for d in self.dims]
        return self._dedupe(dict(zip(names, vals))
                            for vals in itertools.product(*axes))

    def sample(self, n: int, seed: int = 0) -> List[Dict]:
        rng = random.Random(seed)
        return self._dedupe(
            {d.name: d.sample(rng) for d in self.dims} for _ in range(n))

    def contains(self, config: Dict) -> bool:
        """Every knob of the canonical config is a declared dim value (grid
        membership for Choice/log dims, range membership otherwise)."""
        cfg = canonical(config)
        declared = {d.name: d for d in self.dims}
        for k, v in cfg.items():
            d = declared.get(k)
            if d is None:
                return False
            if isinstance(d, Choice):
                if v not in d.values:
                    return False
            elif not (d.lo <= v <= d.hi):
                return False
        return True


def engine_space(*, backends: Sequence[str] = ("flat", "ell", "packed"),
                 ) -> ParamSpace:
    """The backend-construction space the analytic ranker prices: backend
    choice × ELL tile geometry × packed slot alignment / hot-group count.
    ~160 canonical candidates — cheap to price, far too many to measure,
    which is exactly the pre-ranker's job."""
    return ParamSpace(dims=(
        Choice("backend", tuple(backends)),
        IntRange("row_tile", 16, 128),     # 16, 32, 64, 128
        IntRange("width_tile", 32, 256),   # 32, 64, 128, 256
        Choice("slot_align", (8, 16, 32)),
        # 0 = the layout's own hot threshold (groups with lower bound >= mean)
        Choice("hot_groups", (0, 2, 4)),
    ))


def full_space(*, backends: Sequence[str] = ("flat", "ell", "packed"),
               ) -> ParamSpace:
    """Engine space + the app/stream knobs (frontier-density switch,
    regroup hysteresis) for sweeps that run whole app loops."""
    es = engine_space(backends=backends)
    return ParamSpace(dims=es.dims + (
        FloatRange("density_threshold", 0.01, 0.2, log=True, grid_n=3),
        Choice("hysteresis", (0.0, 0.25, 0.5)),
    ))
