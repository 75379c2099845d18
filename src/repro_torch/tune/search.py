"""Measured refinement sweep: run the analytic shortlist, keep the winner.

Port of ``repro.tune.search`` on the port's apps: each measured repetition
ends in ``torch.cuda.synchronize`` (the reference's
``jax.block_until_ready``) on a CUDA device, and the backends are built on
the caller's ``device`` (``None``: the CUDA card).

``tune.cost`` prunes the configuration space to a handful of candidates;
this module actually builds each one (``apps.engine.to_arrays``), runs the
target app on it, and selects by wall clock under **successive halving**:
every live candidate gets a cheap first round, the slower half is
eliminated, survivors get more repetitions — so measurement budget
concentrates on the contenders instead of being spread evenly over losers.

Selection is budget-constrained: only candidates whose modeled bytes do not
exceed the hand-tuned default's (``cost.default_budget``) may be chosen, so
a plan can win wall clock but never regress the modeled-traffic objective.
The incumbent default is always measured, so the sweep degrades to "keep
the default" when nothing beats it.

Every candidate — shortlisted, deliberately-sampled extras (the honesty
probes), and the incumbent — leaves a full audit trail: analytic price,
per-round timings, which round eliminated it; the honesty verdict (did the
analytic shortlist contain the measured winner?) is read straight from it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..device import resolve_device
from .cost import (GraphCost, Scored, config_key, default_budget, rank,
                   shortlist)
from .space import DEFAULT_CONFIG, ParamSpace, canonical, engine_space, \
    split_config

__all__ = ["Trial", "SweepResult", "measure", "sweep",
           "refine_density_threshold"]


# ---------------------------------------------------------------------------
# app runners — what one measured repetition executes
# ---------------------------------------------------------------------------

def _run_pr(ga, app_cfg: Dict):
    from ..apps.pagerank import pagerank

    rank_, _ = pagerank(ga, max_iters=16, tol=0.0)  # fixed-iteration body
    return rank_


def _run_sssp(ga, app_cfg: Dict):
    from ..apps.sssp import sssp

    # iteration-capped: the sweep ranks configs by per-round traffic, it
    # does not need convergence (road-network diameters would make it pay
    # for hundreds of rounds per repetition)
    dist, _ = sssp(ga, 0, max_iters=32,
                   density_threshold=app_cfg.get("density_threshold"))
    return dist


_RUNNERS: Dict[str, Callable] = {"pr": _run_pr, "sssp": _run_sssp}


# ---------------------------------------------------------------------------
# audit-trail records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trial:
    """One candidate's complete history through the sweep."""

    config: Dict               # canonical engine(+app) config
    model_bytes: int           # analytic price (tune.cost)
    cost_s: float
    source: str                # "shortlist" | "extra" | "default"
    feasible: bool             # model_bytes <= default budget
    steps: int = 0             # modeled Pallas grid steps per iteration
    rounds: List[Dict] = dataclasses.field(default_factory=list)
    eliminated_round: Optional[int] = None  # None = survived to the end
    error: Optional[str] = None

    @property
    def best_s(self) -> float:
        if not self.rounds:
            return math.inf
        return min(r["best_s"] for r in self.rounds)

    def to_json(self) -> Dict:
        return {
            "config": dict(self.config),
            "model_bytes": int(self.model_bytes),
            "cost_s": float(self.cost_s),
            "steps": int(self.steps),
            "source": self.source,
            "feasible": bool(self.feasible),
            "rounds": [dict(r) for r in self.rounds],
            "eliminated_round": self.eliminated_round,
            "best_ms": (round(self.best_s * 1e3, 3)
                        if self.rounds else None),
            "error": self.error,
        }


@dataclasses.dataclass
class SweepResult:
    """Outcome of one graph x app sweep + the full audit trail."""

    app: str
    chosen: Dict               # what the plan should store for this app
    chosen_s: float
    default_s: float
    winner: Dict               # measured-fastest config over ALL trials
    winner_s: float
    honest: bool               # shortlist held the winner OR a ~tie of it
    honest_strict: bool        # the winner itself came from the shortlist
    num_candidates: int        # full space size before pruning
    num_measured: int
    trials: List[Trial]

    @property
    def speedup_vs_default(self) -> float:
        if not self.chosen_s or not math.isfinite(self.default_s):
            return 1.0
        return self.default_s / self.chosen_s

    def to_json(self) -> Dict:
        return {
            "app": self.app,
            "chosen": dict(self.chosen),
            "chosen_ms": round(self.chosen_s * 1e3, 3),
            "default_ms": round(self.default_s * 1e3, 3),
            "speedup_vs_default": round(self.speedup_vs_default, 4),
            "winner": dict(self.winner),
            "winner_ms": round(self.winner_s * 1e3, 3),
            "honest": bool(self.honest),
            "honest_strict": bool(self.honest_strict),
            "num_candidates": int(self.num_candidates),
            "num_measured": int(self.num_measured),
            "trials": [t.to_json() for t in self.trials],
        }


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _block(device: torch.device) -> None:
    """Wait for the device's queued work (the host clock then times it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(g, config: Dict, *, app: str = "pr", reps: int = 1,
            warmup: bool = True, runner: Optional[Callable] = None,
            device: Union[None, str, torch.device] = None) -> float:
    """Best-of-``reps`` wall-clock seconds of one app run under ``config``
    (backend built fresh on ``device``; the first run, which bears the
    kernels' first use, is discarded when ``warmup``)."""
    dev = resolve_device(device)
    run = runner or _RUNNERS[app]
    engine_cfg, app_cfg, _ = split_config(config)
    backend = engine_cfg.pop("backend")
    from ..apps.engine import to_arrays

    ga = to_arrays(g, backend=backend, device=dev, **engine_cfg)
    if warmup:
        run(ga, app_cfg)
        _block(dev)
    best = math.inf
    for _ in range(max(1, reps)):
        _block(dev)
        t0 = time.perf_counter()
        run(ga, app_cfg)
        _block(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _halve(live: List[Trial], keep_frac: float) -> List[Trial]:
    live = sorted(live, key=lambda t: (t.best_s, config_key(t.config)))
    keep = max(1, math.ceil(len(live) * keep_frac))
    return live[:keep]


def sweep(
    g,
    *,
    app: str = "pr",
    space: Optional[ParamSpace] = None,
    top_k: int = 5,
    extras: int = 4,
    seed: int = 0,
    hw=None,
    reps_schedule: Sequence[int] = (1, 3),
    keep_frac: float = 0.5,
    select: str = "measured",
    runner: Optional[Callable] = None,
    device: Union[None, str, torch.device] = None,
) -> SweepResult:
    """Cost-rank the space, measure the shortlist, successive-halve, select.

    ``extras`` deliberately-sampled NON-shortlist candidates are measured
    alongside (honesty probes: if one of them wins, the analytic ranker
    missed the winner).  Two honesty verdicts are recorded:
    ``honest_strict`` — the measured winner itself was shortlisted (or is
    the incumbent) — and ``honest``, which additionally accepts a
    shortlisted candidate measuring within 5% of the winner (tile-geometry
    tie classes measure identically up to timer noise; a probe "winning"
    such a tie by luck says nothing about ranker quality).  ``select``:
    ``"measured"`` picks the fastest byte-feasible candidate by wall clock;
    ``"bytes"`` picks by modeled bytes alone (deterministic — the CI smoke
    mode, immune to machine-load noise).  ``hw`` defaults to
    ``HW.profile()`` (the port's ``"h100"``); ``device`` is where the
    candidates are built and run.  A candidate that raises is audited
    (``Trial.error``) and the sweep goes on, as the reference's does, except
    on a CUDA device: there the error propagates, so a kernel that fails
    to build or launch never hands the plan to the plain ``flat`` path.
    """
    if select not in ("measured", "bytes"):
        raise ValueError(f"select must be 'measured' or 'bytes': {select!r}")
    dev = resolve_device(device)
    space = space or engine_space()
    gc = GraphCost.from_graph(g)
    candidates = space.grid()
    ranked = rank(gc, candidates, app=app, hw=hw)
    sl = shortlist(ranked, top_k, must_include=DEFAULT_CONFIG)
    sl_keys = {config_key(s.config) for s in sl}
    budget = default_budget(gc, app)

    import random as _random
    rng = _random.Random(seed)
    slk = {config_key(t.config) for t in sl}
    pool = [s for s in ranked if config_key(s.config) not in slk]
    probe = rng.sample(pool, min(extras, len(pool))) if pool else []

    default_key = config_key(split_config(DEFAULT_CONFIG)[0])

    def _source(s: Scored) -> str:
        k = config_key(s.config)
        if k == default_key:
            return "default"
        return "shortlist" if k in sl_keys else "extra"

    trials = [Trial(config=s.config, model_bytes=s.model_bytes,
                    cost_s=s.cost_s, steps=s.steps, source=_source(s),
                    feasible=s.model_bytes <= budget)
              for s in list(sl) + list(probe)]

    # -- successive halving over the measured rounds ------------------------
    live = list(trials)
    for rnd, reps in enumerate(reps_schedule):
        for t in live:
            try:
                best = measure(g, t.config, app=app, reps=reps,
                               warmup=(rnd == 0), runner=runner,
                               device=dev)
                t.rounds.append({"round": rnd, "reps": reps,
                                 "best_s": best})
            except Exception as exc:
                if dev.type == "cuda":
                    # a kernel that fails to build or launch on the card
                    # must not leave the plain path to win by default
                    raise
                t.error = f"{type(exc).__name__}: {exc}"  # audit, go on
                t.eliminated_round = rnd
        live = [t for t in live if t.error is None]
        if rnd + 1 < len(reps_schedule):
            survivors = _halve(live, keep_frac)
            for t in live:
                if t not in survivors:
                    t.eliminated_round = rnd
            live = survivors

    measured = [t for t in trials if t.rounds]
    if not measured:
        raise RuntimeError(f"sweep measured nothing for app={app!r}")
    winner = min(measured, key=lambda t: (t.best_s, config_key(t.config)))

    default_t = next((t for t in measured
                      if config_key(t.config) == default_key), None)
    default_s = default_t.best_s if default_t else math.inf

    feasible = [t for t in measured if t.feasible]
    if select == "bytes":
        chosen_t = min(feasible or measured,
                       key=lambda t: (t.model_bytes, config_key(t.config)))
    else:
        chosen_t = min(feasible or measured,
                       key=lambda t: (t.best_s, config_key(t.config)))

    honest_strict = (config_key(winner.config) in sl_keys
                     or config_key(winner.config) == default_key)
    listed = [t for t in measured
              if t.source in ("shortlist", "default")]
    best_listed_s = min((t.best_s for t in listed), default=math.inf)
    honest = honest_strict or best_listed_s <= winner.best_s * 1.05

    return SweepResult(
        app=app,
        chosen=canonical(chosen_t.config),
        chosen_s=chosen_t.best_s,
        default_s=default_s,
        winner=canonical(winner.config),
        winner_s=winner.best_s,
        honest=honest,
        honest_strict=honest_strict,
        num_candidates=len(candidates),
        num_measured=len(measured),
        trials=trials,
    )


def refine_density_threshold(
    g, config: Dict, *, app: str = "sssp", reps: int = 2,
    grid: Sequence[float] = (0.01, 0.05, 0.2),
    device: Union[None, str, torch.device] = None,
):
    """Second-phase knob sweep: measure ``config`` under each pull/push
    switch point and return ``(config_with_fastest_attached, timings)``
    where ``timings`` maps each threshold to its best wall-clock seconds —
    the audit evidence that a non-default threshold actually won.  Results
    are bitwise invariant to the threshold (it is a traffic choice), so this
    needs no correctness cross-check."""
    timings: Dict[float, float] = {}
    for dt in grid:
        cfg = dict(config)
        cfg["density_threshold"] = float(dt)
        timings[float(dt)] = measure(g, cfg, app=app, reps=reps,
                                     device=device)
    out = dict(config)
    if timings:
        out["density_threshold"] = min(timings, key=lambda d: (timings[d], d))
    return canonical(out), timings
