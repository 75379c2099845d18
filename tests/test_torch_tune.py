"""The port's tuner (``repro_torch.tune``, ``repro_torch.roofline``) against
``repro.tune`` on the same inputs.

Each A10 test of tests/test_tune.py has a parity case here: the same knob
dicts, graphs (numpy, carried across through ``convert.graph_from_numpy``)
and plans go through both packages.  Space, canonical forms, splits, knob
validation, grids and samples are equal; the cost model's bytes are equal,
and equal to ``fused_edge_map_bytes`` over the tiles the port builds;
rankings, shortlists, plan documents and resolutions are equal under one
``HW`` (built with the same fields on both sides); the sweep's
``select="bytes"`` choice is equal.  Apps on the resolved backends: SSSP
bitwise, PageRank within the reference's band.  The reference's committed
plans are read only as explicit inputs: the port discovers none.
"""
import dataclasses
import json
import math
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.apps.engine as ref_engine  # noqa: E402
from repro import apps as ref_apps  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro.roofline import HW as RefHW  # noqa: E402
from repro.serve import batched as ref_batched  # noqa: E402
from repro.tune import cost as ref_cost  # noqa: E402
from repro.tune import plan as ref_plan  # noqa: E402
from repro.tune import search as ref_search  # noqa: E402
from repro.tune import space as ref_space  # noqa: E402
from repro_torch import apps  # noqa: E402
from repro_torch.apps import engine  # noqa: E402
from repro_torch.convert import graph_from_numpy  # noqa: E402
from repro_torch.core.reorder import dbg_spec  # noqa: E402
from repro_torch.kernels.edge_map.ops import (ell_tiles,  # noqa: E402
                                              fused_edge_map_bytes)
from repro_torch.obs import flight, metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.counters import flat_edge_map_bytes  # noqa: E402
from repro_torch.pack.engine import PackedBackend  # noqa: E402
from repro_torch.roofline import HW, HW_PROFILES  # noqa: E402
from repro_torch.serve import batched  # noqa: E402
from repro_torch.tune import cost, plan, search, space  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _reset():
    obs_trace.disable()
    ref_trace.disable()
    flight.uninstall()
    engine.set_edge_map_hook(None)
    ref_engine.set_edge_map_hook(None)
    metrics.reset_registry()


@pytest.fixture(autouse=True)
def _clean_state():
    """The port's active plan is off (``None``: no discovery) and its
    tracer, flight sink, registry and engine hook clean around each test;
    tests/conftest.py does the same for ``repro``."""
    prev = plan.set_active_plan(None)
    _reset()
    yield
    _reset()
    plan.set_active_plan(prev)


def _pair(n, e, seed, weighted=False):
    """One random graph in both packages (the reference's, then the port's
    copy of its arrays)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) + 0.01 if weighted else None
    g = ref_csr.from_edges(src, dst, n, weights=w)
    return g, _port(g)


def _port(g):
    return graph_from_numpy(g.in_csr.indptr, g.in_csr.indices,
                            g.in_csr.weights, g.out_csr.indptr,
                            g.out_csr.indices, g.out_csr.weights, g.name)


@pytest.fixture(scope="module")
def gp():
    return _pair(300, 3600, seed=7)


@pytest.fixture(scope="module")
def gwp():
    return _pair(300, 3600, seed=7, weighted=True)


def _hws(**fields):
    """The same roofline profile in both packages."""
    kw = dict(peak_flops=math.inf, hbm_bw=2e12, link_bw=math.inf,
              dispatch_overhead=0.0, name="test")
    kw.update(fields)
    return RefHW(**kw), HW(**kw)


def _scored(ranked):
    return [(s.config, s.model_bytes, s.cost_s, s.steps) for s in ranked]


# ---------------------------------------------------------------------------
# space
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["engine_space", "full_space"])
def test_grid_configs_canonical_valid_and_equal_to_reference(which):
    grid = getattr(space, which)().grid()
    assert grid == getattr(ref_space, which)().grid()
    assert len(grid) > 50
    seen = set()
    for cfg in grid:
        assert cfg == space.canonical(cfg)
        assert cfg["backend"] in engine.BACKENDS and cfg["backend"] != "auto"
        assert set(cfg) - {"backend"} - set(("density_threshold",
                                             "hysteresis")) <= \
            space.backend_knobs(cfg["backend"])
        key = cost.config_key(cfg)
        assert key not in seen
        seen.add(key)
    # the knob-free flat backend collapses to one candidate per app/stream
    # knob combination
    flats = sum(1 for c in grid if c["backend"] == "flat")
    assert flats == (1 if which == "engine_space" else 9)


def test_sampled_configs_are_contained_and_equal_to_reference():
    sp, rsp = space.full_space(), ref_space.full_space()
    drawn = sp.sample(40, seed=3)
    assert drawn == rsp.sample(40, seed=3)
    for cfg in drawn:
        assert sp.contains(cfg) and rsp.contains(cfg)
    assert sp.sample(10, seed=5) == sp.sample(10, seed=5)


def test_default_config_is_a_grid_point():
    assert space.DEFAULT_CONFIG == ref_space.DEFAULT_CONFIG
    keys = {cost.config_key(c) for c in space.engine_space().grid()}
    assert cost.config_key(space.split_config(space.DEFAULT_CONFIG)[0]) in keys


@pytest.mark.parametrize("cfg", [
    {"backend": "flat", "row_tile": 32},
    {"backend": "flat", "density_threshold": 0.1, "hysteresis": 0.5},
    {"backend": "packed", "row_tile": 32, "slot_align": 8, "hot_groups": 2},
    {"backend": "ell", "slot_align": 8, "width_tile": 64},
    {"row_tile": 16},
])
def test_canonical_and_split_match_reference(cfg):
    assert space.canonical(cfg) == ref_space.canonical(cfg)
    assert space.split_config(cfg) == ref_space.split_config(cfg)


def test_canonical_drops_interpret_and_split_scopes():
    assert space.canonical({"backend": "flat", "row_tile": 32}) == \
        {"backend": "flat"}
    b = space.canonical({"backend": "flat", "density_threshold": 0.1,
                         "hysteresis": 0.5})
    assert b["density_threshold"] == 0.1 and b["hysteresis"] == 0.5
    # the reference's interpreter switch: loads, and is dropped
    cfg = {"backend": "ell", "row_tile": 32, "interpret": True}
    assert space.canonical(cfg) == {"backend": "ell", "row_tile": 32}
    eng, app, stream = space.split_config(
        {"backend": "ell", "row_tile": 32, "density_threshold": 0.02,
         "hysteresis": 0.25, "interpret": False})
    assert eng == {"backend": "ell", "row_tile": 32}
    assert app == {"density_threshold": 0.02}
    assert stream == {"hysteresis": 0.25}


def test_one_knob_table():
    """The tuner's constraint table, scopes and validation are the
    engine's."""
    assert space.BACKEND_KNOBS is engine.BACKEND_KNOBS
    assert space.KNOB_SCOPES is engine.KNOB_SCOPES
    assert space.validate_knobs is engine.validate_knobs
    for name, knobs in ref_space.BACKEND_KNOBS.items():
        assert space.BACKEND_KNOBS[name] == knobs - {"interpret"}
    assert space.KNOB_SCOPES == {k: v for k, v in ref_space.KNOB_SCOPES.items()
                                 if k != "interpret"}


@pytest.mark.parametrize("backend,knobs,strict", [
    ("ell", {"row_tile": 32, "slot_align": 8}, False),
    ("flat", {"row_tile": 32, "density_threshold": 0.1}, False),
    ("auto", {"app": "sssp", "plan": None, "hot_groups": 2}, False),
    ("packed", {"hysteresis": 0.5, "width_tile": 64}, False),
    ("ell", {"bogus": 1}, False),
    ("flat", {"row_tile": 32}, True),
    ("nope", {}, False),
])
def test_validate_knobs_matches_reference(backend, knobs, strict):
    try:
        want = ref_space.validate_knobs(backend, knobs, strict=strict)
    except ValueError as e:
        msg = str(e).split(";")[0].split("(")[0].split(" — ")[0]
        with pytest.raises(ValueError, match=msg[:20]):
            space.validate_knobs(backend, knobs, strict=strict)
        return
    assert space.validate_knobs(backend, knobs, strict=strict) == want


def test_interpret_is_no_knob_of_the_port():
    with pytest.raises(ValueError, match="unknown backend knob"):
        space.validate_knobs("ell", {"interpret": True})


# ---------------------------------------------------------------------------
# roofline HW profiles
# ---------------------------------------------------------------------------

def test_hw_profiles():
    h = HW.profile()
    assert h.name == "h100" and set(HW_PROFILES) == {"h100"}
    assert h.dispatch_overhead == 0.0
    assert h.hbm_bw > 1e12 and h.peak_flops > 1e13  # measured on the card
    assert HW.profile("h100") is h
    with pytest.raises(ValueError, match="unknown hardware profile"):
        HW.profile("v5e")
    assert [f.name for f in dataclasses.fields(HW)] == \
        [f.name for f in dataclasses.fields(RefHW)]


def test_hw_profile_reads_no_environment(monkeypatch):
    """The one profile is the default: the reference's variable, or one
    named like it for the port, chooses nothing."""
    for var in ("REPRO_HW_PROFILE", "REPRO_TORCH_HW_PROFILE"):
        monkeypatch.setenv(var, "cpu-interpret")
    assert HW.profile() is HW_PROFILES["h100"]


def test_dispatch_free_ranking_is_pure_bytes(gp):
    """The H100 profile has no dispatch term, so its ranking is by modeled
    bytes — as the reference's dispatch-free ranking is."""
    rg, pg = gp
    gc = cost.GraphCost.from_graph(pg)
    cfgs = space.engine_space().grid()
    ranked = cost.rank(gc, cfgs, app="pr")
    order = [s.model_bytes for s in ranked]
    assert order == sorted(order)
    rhw, hw = _hws()
    want = ref_cost.rank(ref_cost.GraphCost.from_graph(rg), cfgs, app="pr",
                         hw=rhw)
    assert _scored(cost.rank(gc, cfgs, app="pr", hw=hw)) == _scored(want)
    assert [s.config for s in ranked] == [s.config for s in want]


def test_dispatch_priced_like_the_reference(gp):
    rg, pg = gp
    rhw, hw = _hws(hbm_bw=20e9, dispatch_overhead=5e-5)
    gc, rgc = cost.GraphCost.from_graph(pg), ref_cost.GraphCost.from_graph(rg)
    coarse = {"backend": "ell", "row_tile": 128, "width_tile": 256}
    fine = {"backend": "ell", "row_tile": 16, "width_tile": 32}
    for c in (coarse, fine, {"backend": "flat"}, {"backend": "packed"}):
        assert cost.config_steps(gc, c, app="pr") == \
            ref_cost.config_steps(rgc, c, app="pr")
        assert cost.app_seconds(gc, c, "pr", hw=hw) == \
            ref_cost.app_seconds(rgc, c, "pr", hw=rhw)
    assert cost.config_steps(gc, coarse) < cost.config_steps(gc, fine)
    ranked = cost.rank(gc, [coarse, fine], app="pr", hw=hw)
    assert ranked[0].config["row_tile"] == 128
    assert _scored(ranked) == _scored(ref_cost.rank(rgc, [coarse, fine],
                                                    app="pr", hw=rhw))


# ---------------------------------------------------------------------------
# cost-model parity with the built backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_tile,width_tile,seed", [
    (16, 32, 0), (32, 64, 11), (64, 128, 123), (128, 32, 999)])
def test_ell_cost_parity(row_tile, width_tile, seed):
    """The degree-vector mirror prices exactly the tiles the port's
    ``ell_tiles`` builds, for every pass shape, and equals the reference's
    price."""
    rg, pg = _pair(200, 2400, seed)
    deg = pg.in_degrees()
    spec = dbg_spec(max(1.0, float(deg.mean()) if deg.size else 1.0))
    tiles = ell_tiles(pg.in_csr, spec.boundaries, row_tile=row_tile,
                      width_tile=width_tile, device=CPU)
    gc, rgc = cost.GraphCost.from_graph(pg), ref_cost.GraphCost.from_graph(rg)
    cfg = {"backend": "ell", "row_tile": row_tile, "width_tile": width_tile}
    for (name, profiles) in cost.APP_PROFILES.items():
        for p, rp in zip(profiles, ref_cost.APP_PROFILES[name]):
            assert dataclasses.asdict(p) == dataclasses.asdict(rp)
            actual = fused_edge_map_bytes(
                tiles, pg.num_vertices,
                use_weights=p.use_weights and gc.weighted,
                frontier=p.frontier, push_init=p.direction == "push",
                plane_k=p.plane_k, frontier_planar=p.frontier_planar)
            assert cost.pass_bytes(gc, cfg, p) == actual
            assert ref_cost.pass_bytes(rgc, cfg, rp) == actual


@pytest.mark.parametrize("knobs", [
    {"row_tile": 64, "width_tile": 128},
    {"row_tile": 32, "width_tile": 64, "slot_align": 8},
    {"row_tile": 64, "width_tile": 128, "slot_align": 32, "hot_groups": 2},
])
def test_packed_cost_parity(gp, knobs):
    rg, pg = gp
    pb = apps.to_arrays(pg, backend="packed", device=CPU, **knobs)
    actual = fused_edge_map_bytes(pb.in_tiles, pg.num_vertices)
    cfg = {"backend": "packed", **knobs}
    p, rp = cost.APP_PROFILES["pr"][0], ref_cost.APP_PROFILES["pr"][0]
    assert cost.pass_bytes(cost.GraphCost.from_graph(pg), cfg, p) == actual
    assert ref_cost.pass_bytes(ref_cost.GraphCost.from_graph(rg), cfg,
                               rp) == actual


def test_flat_cost_is_the_counters_model(gp):
    from repro.obs.counters import flat_edge_map_bytes as ref_flat

    rg, pg = gp
    gc = cost.GraphCost.from_graph(pg)
    p = cost.PassProfile("push", use_weights=True, frontier=True)
    want = flat_edge_map_bytes(pg.num_edges, pg.num_vertices, weighted=False,
                               frontier=True, push_init=True)
    assert cost.pass_bytes(gc, {"backend": "flat"}, p) == want
    assert ref_flat(rg.num_edges, rg.num_vertices, weighted=False,
                    frontier=True, push_init=True) == want


@pytest.mark.parametrize("app", ["pr", "sssp", "bc", "radii"])
def test_rank_and_shortlist_match_reference(gwp, app):
    rg, pg = gwp
    rhw, hw = _hws()
    gc, rgc = cost.GraphCost.from_graph(pg), ref_cost.GraphCost.from_graph(rg)
    grid = space.engine_space().grid()
    ranked = cost.rank(gc, grid, app=app, hw=hw)
    rranked = ref_cost.rank(rgc, grid, app=app, hw=rhw)
    assert _scored(ranked) == _scored(rranked)
    assert ranked == cost.rank(gc, grid, app=app, hw=hw)
    sl = cost.shortlist(ranked, 3, must_include=space.DEFAULT_CONFIG)
    rsl = ref_cost.shortlist(rranked, 3, must_include=ref_space.DEFAULT_CONFIG)
    assert _scored(sl) == _scored(rsl)
    want = cost.config_key(space.split_config(space.DEFAULT_CONFIG)[0])
    assert any(cost.config_key(s.config) == want for s in sl)
    assert len(sl) <= 4
    assert cost.default_budget(gc, app) == ref_cost.default_budget(rgc, app)


@pytest.mark.parametrize("key", ["kr", "lj", "road", "uni"])
def test_pricing_from_group_stats_equals_the_reference_replay(key):
    """The port prices every candidate from one pass over the degrees
    (``GraphCost.dbg_groups``); the reference replays the binning per
    candidate.  Every app's full-grid ranking agrees, bytes and steps."""
    rg = ref_datasets.load_weighted(key, "test")
    pg = _port(rg)
    gc, rgc = cost.GraphCost.from_graph(pg), ref_cost.GraphCost.from_graph(rg)
    boundaries, mean, stats = gc.dbg_groups
    assert stats.shape == (len(boundaries), 3)
    assert int(stats[:, 0].sum()) == pg.num_vertices
    assert int(stats[:, 1].sum()) == int((pg.in_degrees() > 0).sum())
    rhw, hw = _hws()
    grid = space.engine_space().grid()
    for app in cost.APP_PROFILES:
        assert _scored(cost.rank(gc, grid, app=app, hw=hw)) == \
            _scored(ref_cost.rank(rgc, grid, app=app, hw=rhw))


# ---------------------------------------------------------------------------
# plans: persistence, lookup, auto resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plan_roundtrip_bit_equal_to_reference_and_resolves(seed, tmp_path):
    rng = np.random.default_rng(seed)
    grid = space.engine_space().grid()
    cells = []
    for i in range(1 + seed % 4):
        cfg = dict(grid[int(rng.integers(0, len(grid)))])
        if rng.integers(0, 2):
            cfg["density_threshold"] = float(rng.choice([0.01, 0.05, 0.2]))
        rg_i, pg_i = _pair(50 + 10 * i, 500, seed + i)
        feats = plan.graph_features(pg_i)
        assert feats == ref_plan.graph_features(rg_i)
        cells.append({"family": f"fam{i}", "features": feats,
                      "configs": {"default": cfg}})
    p, rp = plan.build_plan(cells), ref_plan.build_plan(cells)
    assert p.to_json() == rp.to_json()
    path, rpath = str(tmp_path / "p.json"), str(tmp_path / "r.json")
    p.save(path)
    rp.save(rpath)
    with open(path) as a, open(rpath) as b:
        first = a.read()
        assert first == b.read()
    loaded = plan.ExecutionPlan.load(path)
    assert loaded.to_json() == p.to_json()
    loaded.save(path)
    with open(path) as fh:
        assert fh.read() == first
    rg, pg = _pair(120, 1200, seed)
    name, kw = plan.resolve_auto(pg, plan=loaded)
    assert (name, kw) == ref_plan.resolve_auto(rg, plan=rp)
    assert name in engine.BACKENDS and name != "auto"
    assert not space.validate_knobs(name, kw)[1]


def test_plan_schema_mismatch_raises(tmp_path):
    p = str(tmp_path / "bad.json")
    with open(p, "w") as fh:
        json.dump({"schema": 99, "entries": []}, fh)
    for mod in (plan, ref_plan):
        with pytest.raises(mod.PlanError, match="schema"):
            mod.ExecutionPlan.load(p)
    with pytest.raises(plan.PlanError, match="no 'entries'"):
        plan.ExecutionPlan.from_json({"schema": 1})


def test_nearest_family_lookup(gp):
    rg, pg = gp
    far_r, far_p = _pair(5000, 10000, 1)
    cells = [
        {"family": "far", "features": plan.graph_features(far_p),
         "configs": {"default": {"backend": "flat"}}},
        {"family": "near", "features": plan.graph_features(pg),
         "configs": {"default": {"backend": "packed"},
                     "sssp": {"backend": "ell", "row_tile": 32}}},
    ]
    p, rp = plan.build_plan(cells), ref_plan.build_plan(cells)
    for app in (None, "sssp", "pr"):
        got = p.lookup(plan.graph_features(pg), app=app)
        assert got == rp.lookup(ref_plan.graph_features(rg), app=app)
    assert p.lookup(plan.graph_features(pg)) == ({"backend": "packed"},
                                                 "near")
    assert p.lookup(plan.graph_features(pg), app="sssp")[0] == \
        {"backend": "ell", "row_tile": 32}
    assert p.lookup(plan.graph_features(far_p))[1] == "far"


def test_auto_without_plan_is_the_default(gp, monkeypatch):
    """No plan set and no ``REPRO_TORCH_TUNE_PLAN``: ``"auto"`` is the
    hand-tuned default, though the repo root holds ``PLAN_tuned.json`` and
    the reference's ``REPRO_TUNE_PLAN`` names it."""
    rg, pg = gp
    assert os.path.exists(os.path.join(ROOT, "PLAN_tuned.json"))
    monkeypatch.delenv("REPRO_TORCH_TUNE_PLAN", raising=False)
    monkeypatch.setenv("REPRO_TUNE_PLAN",
                       os.path.join(ROOT, "PLAN_tuned.json"))
    plan.set_active_plan()  # discovery on: still nothing to find
    assert plan.get_active_plan() is None
    assert plan.auto_config(pg) == space.canonical(dict(space.DEFAULT_CONFIG))
    assert plan.auto_config(pg) == ref_plan.auto_config(rg, plan=None)
    assert isinstance(apps.to_arrays(pg, backend="auto", device=CPU),
                      engine.EllBackend)


def test_auto_resolves_active_plan(gp):
    rg, pg = gp
    cells = [{
        "family": "f", "features": plan.graph_features(pg),
        "configs": {"default": {"backend": "flat"},
                    "sssp": {"backend": "ell", "row_tile": 32,
                             "density_threshold": 0.2}}}]
    plan.set_active_plan(plan.build_plan(cells))
    ref_plan.set_active_plan(ref_plan.build_plan(cells))
    assert isinstance(apps.to_arrays(pg, backend="auto", device=CPU),
                      engine.FlatBackend)
    eb = apps.to_arrays(pg, backend="auto", app="sssp", device=CPU)
    assert isinstance(eb, engine.EllBackend) and eb.row_tile == 32
    for app in (None, "sssp"):
        assert plan.auto_config(pg, app=app) == \
            ref_plan.auto_config(rg, app=app)
    assert plan.auto_config(pg, app="sssp")["density_threshold"] == 0.2
    eb = apps.to_arrays(pg, backend="auto", app="sssp", row_tile=16,
                        device=CPU)
    assert eb.row_tile == 16  # explicit kwargs override the plan


def test_env_plan_discovery(tmp_path, monkeypatch, gp):
    rg, pg = gp
    p = plan.build_plan([{
        "family": "f", "features": plan.graph_features(pg),
        "configs": {"default": {"backend": "packed", "row_tile": 32}}}])
    path = str(tmp_path / "env_plan.json")
    p.save(path)
    monkeypatch.setenv("REPRO_TORCH_TUNE_PLAN", path)
    plan.set_active_plan()  # restore discovery
    got = plan.get_active_plan()
    assert got is not None and got.entries[0].family == "f"
    assert plan.auto_config(pg)["backend"] == "packed"
    assert isinstance(apps.to_arrays(pg, backend="auto", device=CPU),
                      PackedBackend)


@pytest.mark.parametrize("name", ["PLAN_tuned.json",
                                  "benchmarks/baselines/PLAN_smoke.json"])
def test_reference_plans_load_when_passed(name):
    """The reference's committed plans, passed explicitly, load into the
    port and resolve as they do in the reference on the registry graphs."""
    path = os.path.join(ROOT, name)
    p, rp = plan.ExecutionPlan.load(path), ref_plan.ExecutionPlan.load(path)
    assert p.to_json() == rp.to_json()
    for entry in p.entries:
        for cfg in entry.configs.values():
            eng = space.split_config(cfg)[0]
            assert eng["backend"] in engine.BACKENDS and eng["backend"] != "auto"
    for key in ("kr", "lj", "road"):
        rg = ref_datasets.load(key, "test")
        pg = _port(rg)
        for app in (None, "pr", "sssp"):
            assert plan.resolve_auto(pg, app=app, plan=p) == \
                ref_plan.resolve_auto(rg, app=app, plan=rp)
        name_, kw = plan.resolve_auto(pg, plan=p)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            apps.to_arrays(pg, backend=name_, device=CPU, **kw)


def test_auto_app_results_match_flat_oracle_and_reference(gp, gwp):
    (rg, pg), (rgw, pgw) = gp, gwp
    cells = [{
        "family": "f", "features": plan.graph_features(pg),
        "configs": {"default": {"backend": "packed", "row_tile": 32,
                                "width_tile": 64},
                    "sssp": {"backend": "ell", "row_tile": 16,
                             "density_threshold": 0.1}}}]
    plan.set_active_plan(plan.build_plan(cells))
    ref_plan.set_active_plan(ref_plan.build_plan(cells))
    fa, faw = (apps.to_arrays(x, device=CPU) for x in (pg, pgw))
    aa = apps.to_arrays(pg, backend="auto", device=CPU)
    aaw = apps.to_arrays(pgw, backend="auto", app="sssp", device=CPU)
    assert isinstance(aa, PackedBackend)
    assert isinstance(aaw, engine.EllBackend)
    r_flat, _ = apps.pagerank(fa)
    r_auto, _ = apps.pagerank(aa)
    np.testing.assert_allclose(r_flat.numpy(), r_auto.numpy(), atol=2e-6)
    r_ref, _ = ref_apps.pagerank(ref_apps.to_arrays(rg, backend="auto"))
    np.testing.assert_allclose(r_auto.numpy(), np.asarray(r_ref), atol=2e-6)
    dt = plan.auto_config(pgw, app="sssp").get("density_threshold")
    assert dt == 0.1
    d_flat, _ = apps.sssp(faw, 0)
    d_auto, _ = apps.sssp(aaw, 0, density_threshold=dt)
    np.testing.assert_array_equal(d_flat.numpy(), d_auto.numpy())
    d_ref, _ = ref_apps.sssp(ref_apps.to_arrays(rgw, backend="auto",
                                                app="sssp"), jnp.int32(0),
                             density_threshold=dt)
    np.testing.assert_array_equal(d_auto.numpy(), np.asarray(d_ref))


# ---------------------------------------------------------------------------
# to_arrays knob validation
# ---------------------------------------------------------------------------

def test_to_arrays_warns_and_drops_ignored_knobs(gp):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ga = apps.to_arrays(gp[1], backend="flat", row_tile=32, device=CPU)
    assert isinstance(ga, engine.FlatBackend)
    assert any("ignoring knob" in str(x.message) for x in w)


def test_to_arrays_strict_and_unknown(gp):
    pg = gp[1]
    with pytest.raises(ValueError, match="no-ops on backend"):
        apps.to_arrays(pg, backend="flat", row_tile=32, strict=True,
                       device=CPU)
    with pytest.raises(ValueError, match="unknown backend knob"):
        apps.to_arrays(pg, backend="ell", bogus=1, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        apps.to_arrays(pg, backend="packed", slot_align=8, hot_groups=2,
                       device=CPU)
        apps.to_arrays(pg, backend="auto", app="pr", device=CPU)


# ---------------------------------------------------------------------------
# density threshold: a pure traffic choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [0.01, 0.5])
def test_density_threshold_bitwise_invariance(gp, gwp, dt):
    (rg, pg), (rgw, pgw) = gp, gwp
    gaw = apps.to_arrays(pgw, device=CPU)
    d0, _ = apps.sssp(gaw, 0)
    d1, _ = apps.sssp(gaw, 0, density_threshold=dt)
    np.testing.assert_array_equal(d0.numpy(), d1.numpy())
    rd, _ = ref_apps.sssp(ref_apps.to_arrays(rgw), jnp.int32(0),
                          density_threshold=dt)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(rd))
    ga = apps.to_arrays(pg, device=CPU)
    c0, dist0, _ = apps.bc(ga, 0)
    c1, dist1, _ = apps.bc(ga, 0, density_threshold=dt)
    np.testing.assert_array_equal(dist0.numpy(), dist1.numpy())
    np.testing.assert_allclose(c0.numpy(), c1.numpy(), atol=1e-5)


@pytest.mark.parametrize("backend", ["flat", "ell", "packed"])
def test_batched_sssp_density_threshold(gwp, backend):
    rgw, pgw = gwp
    ga = apps.to_arrays(pgw, backend=backend, device=CPU)
    roots = torch.tensor([0, 5, 9])
    d0, i0 = batched.batched_sssp(ga, roots)
    d1, i1 = batched.batched_sssp(ga, roots, density_threshold=0.5)
    np.testing.assert_array_equal(d0.numpy(), d1.numpy())
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    rd, ri = ref_batched.batched_sssp(ref_apps.to_arrays(rgw),
                                      jnp.asarray([0, 5, 9], jnp.int32),
                                      density_threshold=0.5)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ri))


# ---------------------------------------------------------------------------
# the measured sweep
# ---------------------------------------------------------------------------

def test_sweep_audit_trail_and_select_bytes_matches_reference(gp):
    rg, pg = gp
    rhw, hw = _hws()
    res = search.sweep(pg, app="pr", top_k=3, extras=2, hw=hw,
                       reps_schedule=(1, 1), select="bytes", device=CPU)
    ref = ref_search.sweep(rg, app="pr", top_k=3, extras=2, hw=rhw,
                           reps_schedule=(1, 1), select="bytes")
    assert res.chosen == ref.chosen
    assert [(t.config, t.model_bytes, t.source, t.feasible, t.steps)
            for t in res.trials] == \
        [(t.config, t.model_bytes, t.source, t.feasible, t.steps)
         for t in ref.trials]
    assert (res.num_candidates, res.num_measured) == \
        (ref.num_candidates, ref.num_measured)
    gc = cost.GraphCost.from_graph(pg)
    budget = cost.default_budget(gc, "pr")
    assert cost.app_bytes(gc, space.split_config(res.chosen)[0], "pr") \
        <= budget
    assert res.num_measured >= 4
    sources = {t.source for t in res.trials}
    assert "extra" in sources and ("default" in sources
                                   or "shortlist" in sources)
    for t in res.trials:
        assert t.rounds or t.error
        assert t.error is None
    assert any(t.eliminated_round == 0 for t in res.trials)
    json.dumps(res.to_json())


def test_refine_density_threshold_attaches_a_measured_winner(gwp):
    cfg, timings = search.refine_density_threshold(
        gwp[1], {"backend": "ell"}, reps=1, grid=(0.01, 0.2), device=CPU)
    assert set(timings) == {0.01, 0.2}
    assert cfg["density_threshold"] in timings
    assert cfg == space.canonical(cfg)


def test_sweep_audits_a_failing_candidate_on_the_cpu(gp):
    """On the CPU a candidate that raises is audited and the sweep picks
    among the others, as the reference's sweep does (on the card it raises:
    ``tests/test_torch_cuda.py``)."""
    from repro_torch.apps.engine import EllBackend

    def runner(ga, app_cfg):
        if isinstance(ga, EllBackend):
            raise RuntimeError("nvcc failed")
        return search._run_pr(ga, app_cfg)

    res = search.sweep(gp[1], app="pr", top_k=3, extras=2,
                       reps_schedule=(1,), runner=runner, device=CPU)
    failed = [t for t in res.trials if t.error]
    assert failed and all(t.config["backend"] == "ell" for t in failed)
    assert all(t.error == "RuntimeError: nvcc failed"
               and t.eliminated_round == 0 and not t.rounds for t in failed)
    assert res.chosen["backend"] != "ell"


def test_sweep_rejects_unknown_select(gp):
    with pytest.raises(ValueError, match="select"):
        search.sweep(gp[1], select="fastest", device=CPU)
