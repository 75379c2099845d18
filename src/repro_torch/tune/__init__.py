"""repro_torch.tune — cost-ranked, sweep-driven autotuned execution plans.

Port of ``repro.tune``.  Which layout/geometry wins is a property of the
graph (skew, hub mass, scale), not of the code.  Four pieces:

  * :mod:`~repro_torch.tune.space`  — the declarative knob space; the
    per-backend constraint table is ``apps.engine``'s, re-exported;
  * :mod:`~repro_torch.tune.cost`   — analytic pre-ranker (the port's byte
    models through :class:`repro_torch.roofline.HW`), prunes the space to
    a shortlist without running anything;
  * :mod:`~repro_torch.tune.search` — measured successive-halving sweep
    over the shortlist, full audit trail, honesty probes;
  * :mod:`~repro_torch.tune.plan`   — the persisted, schema-versioned
    ``ExecutionPlan`` that ``to_arrays(backend="auto")`` resolves, keyed by
    graph-family features with a hand-tuned-default fallback.

``chip_smoke.py`` (the serving phase) runs the loop on the card: a sweep
per app on a registry graph, ``build_plan``, ``set_active_plan``.
"""
from .cost import (APP_PROFILES, GraphCost, PassProfile, Scored,  # noqa: F401
                   app_bytes, app_seconds, config_key, default_budget,
                   pass_bytes, rank, shortlist)
from .plan import (PLAN_ENV, PLAN_SCHEMA, ExecutionPlan,  # noqa: F401
                   PlanEntry, PlanError, auto_config, build_plan,
                   feature_distance, get_active_plan, graph_features,
                   resolve_auto, set_active_plan)
from .search import (SweepResult, Trial, measure,  # noqa: F401
                     refine_density_threshold, sweep)
from .space import (BACKEND_KNOBS, DEFAULT_CONFIG, KNOB_SCOPES,  # noqa: F401
                    Choice, FloatRange, IntRange, ParamSpace, backend_knobs,
                    canonical, engine_space, full_space, split_config,
                    validate_knobs)
