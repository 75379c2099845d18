"""The port's sharded streaming plane (``repro_torch.dist.stream`` and
``repro_torch.stream.sharded``) against ``repro.dist.stream`` and the
single-device service.

In-process, on a one-rank gloo group: the ``ShardedStreamService`` against
the reference's on the same churn (SSSP bitwise, PageRank within 1e-8: the
same solver), its routed layouts (delta buffers, tombstones, folds) bitwise
equal to the reference's at D = 2, per-shard compaction and the halo
overflow at D = 2 on the host, the counters' per-shard attribution, and
``StreamService.apply_remaps_to``.  Across ranks (``tests/dist_workers.py``,
gloo groups of 2 and 4 subprocesses, started with this module): the sharded
service against the port's single-device service after every batch (SSSP
bitwise, PageRank within the reference's 2e-7: two solvers, each within
epsilon of the fixed point), and the halo overflow's flight anomaly and
re-shard.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as tdist  # noqa: E402

from repro.apps import engine as ref_engine  # noqa: E402
from repro.dist import graph as ref_dg  # noqa: E402
from repro.dist import stream as ref_ds  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.obs import counters as ref_counters  # noqa: E402
from repro.obs.metrics import MetricsRegistry as RefRegistry  # noqa: E402
from repro.stream import StreamConfig as RefConfig  # noqa: E402
from repro.stream import StreamService as RefService  # noqa: E402
from repro.stream.delta import DeltaGraph as RefDeltaGraph  # noqa: E402
from repro.stream.sharded import ShardedStreamService as RefSharded  # noqa: E402
from repro_torch.apps import engine  # noqa: E402
from repro_torch.convert import graph_from_numpy  # noqa: E402
from repro_torch.dist import graph as dg  # noqa: E402
from repro_torch.dist import stream as ds  # noqa: E402
from repro_torch.graph import csr  # noqa: E402
from repro_torch.obs import counters, flight, metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.stream import StreamConfig, StreamService  # noqa: E402
from repro_torch.stream.delta import DeltaGraph  # noqa: E402
from repro_torch.stream.sharded import ShardedStreamService  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import dist_workers as workers  # noqa: E402

PR_ATOL = 2e-7     # the reference's band: sharded vs single-device service
SOLVER_ATOL = 1e-8  # the port's sharded solver vs the reference's
RANK_TIMEOUT = 300
WORLDS = (2, 4)


class _Ranks:
    def __init__(self, out_dir):
        self.out_dir = str(out_dir)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        script = os.path.join(ROOT, "tests", "dist_workers.py")
        self.procs = [
            subprocess.Popen(
                [sys.executable, script, "torch-stream", self.out_dir,
                 str(r), str(d), os.path.join(self.out_dir, f"init_{d}")],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            for d in WORLDS for r in range(d)]
        self._results = None

    def results(self):
        if self._results is None:
            deadline = time.monotonic() + RANK_TIMEOUT
            for p in self.procs:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                assert p.returncode == 0 and "OK" in out, out[-4000:]
            self._results = {d: [dict(np.load(os.path.join(
                self.out_dir, f"torch_stream_{d}_{r}.npz")))
                for r in range(d)] for d in WORLDS}
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("dist_stream_ranks"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    init = tmp_path_factory.mktemp("dist_stream_init") / "init"
    tdist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                             world_size=1)
    yield dg.make_graph_mesh(1, device="cpu")
    tdist.destroy_process_group()


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """The port's tracer, flight sink, registry and engine hook are
    process-global: each test starts and ends clean."""
    def reset():
        obs_trace.disable()
        flight.uninstall()
        counters.uninstall()
        metrics.reset_registry()

    reset()
    yield
    reset()


def _port(g):
    return graph_from_numpy(g.in_csr.indptr, g.in_csr.indices,
                            g.in_csr.weights, g.out_csr.indptr,
                            g.out_csr.indices, g.out_csr.weights, g.name)


@pytest.fixture(scope="module")
def kr():
    g = ref_datasets.load("kr", "test")
    return g, _port(g)


def _churn(dg_, rng, size, weighted):
    v = dg_.num_vertices
    es, ed, _ = dg_.alive_edges()
    idx = rng.choice(es.shape[0], size=size // 4, replace=False)
    kw = dict(add_src=rng.integers(0, v, size),
              add_dst=rng.integers(0, v, size),
              del_src=es[idx], del_dst=ed[idx])
    if weighted:
        kw["add_w"] = rng.random(size).astype(np.float32) + 0.01
    return kw


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_layouts_equal(rs, ps):
    """Planes, tiles, delta segment and stream bookkeeping, bitwise."""
    for f in ("in_slot", "in_dst_local", "in_w", "in_mask", "send_idx",
              "hot_ids", "out_src_local", "out_dst", "out_w", "out_mask",
              "in_deg", "out_deg"):
        _eq(getattr(rs, f), getattr(ps, f), f)
    for side in ("pull_tiles", "push_tiles"):
        rt, pt = getattr(rs, side), getattr(ps, side)
        assert (rt is None) == (pt is None)
        for a, b in zip(rt or (), pt or ()):
            for f in ("rows", "idx", "deg", "w", "alive"):
                assert (getattr(a, f) is None) == (getattr(b, f) is None)
                if getattr(a, f) is not None:
                    _eq(getattr(a, f), getattr(b, f), f"{side}.{f}")
    for f in ref_dg.ShardDeltaSegment._fields[:8]:
        _eq(getattr(rs.delta, f), getattr(ps.delta, f), f"delta.{f}")
    for side in ("pull_tiles", "push_tiles"):
        for a, b in zip(getattr(rs.delta, side) or (),
                        getattr(ps.delta, side) or ()):
            for f in ("rows", "idx", "deg", "w"):
                if getattr(a, f) is not None:
                    _eq(getattr(a, f), getattr(b, f), f"delta.{side}.{f}")
    rst, pst = rs.host["stream"], ps.host["stream"]
    for i in range(rs.n_shards):
        for f in ("in_alive", "out_alive", "in_dst", "out_dst", "in_wv"):
            _eq(rst[f][i], pst[f][i], f)
        for side in ("d", "p"):
            assert rst[side][i]["n"] == pst[side][i]["n"]
    _eq(rst["in_dead"], pst["in_dead"])
    assert rs.stats == ps.stats


# ---------------------------------------------------------------------------
# in-process: the service against the reference's, on one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("backend", ["flat", "ell"])
def test_sharded_service_matches_reference_one_shard(mesh1, backend,
                                                     weighted):
    """The sharded ingest parity on one rank (two batches, one on the
    weighted graph): after every batch, the port's
    sharded SSSP equals the reference's and the port's single-device
    service's bitwise; its PageRank is within 1e-8 of the reference's
    sharded solve (the same solver) and within 2e-7 of the single-device
    service (the reference's own band)."""
    g = (ref_datasets.load_weighted if weighted else ref_datasets.load)(
        "kr", "test")
    gp = _port(g)
    cfg = dict(regroup_every=1, hysteresis=0.0)
    rsh = RefSharded(g, RefConfig(**cfg), n_shards=1, backend=backend)
    single = StreamService(gp, StreamConfig(**cfg), device="cpu")
    psh = ShardedStreamService(gp, StreamConfig(**cfg), mesh=mesh1,
                               backend=backend)
    rng = np.random.default_rng(3)
    for _ in range(1 if weighted else 2):
        kw = _churn(single.dg, rng, 160, weighted)
        rsh.ingest(**kw)
        single.ingest(**kw)
        psh.ingest(**kw)
        root = int(rng.integers(0, g.num_vertices))
        got = psh.sssp(root)
        np.testing.assert_array_equal(got, rsh.sssp(root))
        np.testing.assert_array_equal(got, single.sssp(root))
        pr = psh.pagerank()
        np.testing.assert_allclose(pr, rsh.pagerank(), rtol=0,
                                   atol=SOLVER_ATOL)
        np.testing.assert_allclose(pr, single.pagerank(), rtol=0,
                                   atol=PR_ATOL)
    assert psh.full_rebuilds == rsh.full_rebuilds == 0
    assert [h["compacted"] for h in psh.shard_history] == [
        h["compacted"] for h in rsh.shard_history]
    _assert_layouts_equal(rsh.sg, psh.sg)


@pytest.mark.parametrize("backend", ["flat", "ell"])
def test_routed_layouts_match_reference_two_shards(kr, backend):
    """Two batches routed into a 2-shard layout, then folded: every plane,
    the delta segment and the stream bookkeeping equal the reference's
    (the routers need no mesh)."""
    g, gp = kr
    rga = ref_engine.to_arrays(g, backend="arrays")
    pga = engine.to_arrays(gp, backend="arrays", device="cpu")
    kw = dict(backend=backend, stream=True, remap_headroom=1.0)
    rs = ref_ds.sync_delta(ref_dg.shard_graph(rga, 2, **kw))
    ps = ds.sync_delta(dg.shard_graph(pga, 2, **kw))
    rdg = RefDeltaGraph(g)
    rng = np.random.default_rng(4)
    for b in range(2):
        res = rdg.apply(**_churn(rdg, rng, 120, False))
        rs, rstats = ref_ds.apply_edge_delta(
            rs, res, out_deg=rdg.out_deg, in_deg=rdg.in_deg, batch_index=b)
        ps, pstats = ds.apply_edge_delta(
            ps, res, out_deg=rdg.out_deg, in_deg=rdg.in_deg, batch_index=b)
        assert rstats == pstats
        _assert_layouts_equal(rs, ps)
    rs, rf = ref_ds.compact_shards(rs, threshold=0.002)
    ps, pf = ds.compact_shards(ps, threshold=0.002)
    assert rf == pf and pf
    _assert_layouts_equal(rs, ps)
    for i in range(2):
        _eq(rs.host["tile_pos"][i] if rs.host["tile_pos"] else 0,
            ps.host["tile_pos"][i] if ps.host["tile_pos"] else 0)


def test_batch_path_is_o_delta(mesh1, kr):
    """No O(E) work per batch: the base planes — on the host and the
    rank's device copies — keep their identity; only masks, the delta
    segment and degree rows change."""
    _, gp = kr
    sh = ShardedStreamService(gp, StreamConfig(regroup_every=0), mesh=mesh1)
    sh.sssp(0)  # the rank's device copy exists
    view = next(iter(sh.sg.views.values()))
    before = sh.sg
    dev_slot = view.planes["in_slot"]
    rng = np.random.default_rng(0)
    v = gp.num_vertices
    sh.ingest(add_src=rng.integers(0, v, 50), add_dst=rng.integers(0, v, 50))
    after = sh.sg
    assert sh.full_rebuilds == 0
    assert not sh.shard_history[-1]["compacted"]
    for f in ("in_slot", "in_dst_local", "out_src_local", "in_w"):
        assert getattr(after, f) is getattr(before, f), f
    assert view.planes["in_slot"] is dev_slot
    assert sum(int(b["n"]) for b in after.host["stream"]["d"]) == 50


@pytest.mark.parametrize("backend", ["flat", "ell"])
def test_one_shard_skew_compacts_only_that_shard(mesh1, kr, backend,
                                                 tmp_path):
    """All deltas on shard 0 of two: only shard 0 folds (the local
    threshold), and the overshooting batch files shard_compact_stall with
    its context, as the reference does; then on one rank the folded layout's
    min-pull equals the flat oracle of the churned graph."""
    g, gp = kr
    pga = engine.to_arrays(gp, backend="arrays", device="cpu")
    for shards in (2, 1):
        delta_g = DeltaGraph(gp)
        sg = ds.sync_delta(dg.shard_graph(pga, shards, backend=backend,
                                          stream=True))
        v_blk = sg.v_blk
        rng = np.random.default_rng(3)
        k = int(0.6 * sg.host["stream"]["in_alive"][0].shape[0])
        res = delta_g.apply(add_src=rng.integers(0, v_blk, k),
                            add_dst=rng.integers(0, v_blk, k))
        fr = flight.install(dump_dir=str(tmp_path))
        try:
            sg, _ = ds.apply_edge_delta(sg, res, out_deg=delta_g.out_deg,
                                        in_deg=delta_g.in_deg, batch_index=7)
            sg, folded = ds.compact_shards(sg, threshold=0.25, batch_index=7)
        finally:
            flight.uninstall()
        assert folded and all(i == 0 for _, i in folded)
        assert sg.host["stream"]["d"][0]["n"] == 0
        stalls = [t for t in fr.triggers
                  if t["reason"] == "shard_compact_stall"]
        assert stalls and stalls[0]["context"]["shard"] == 0
        assert stalls[0]["context"]["batch_index"] == 7
    ga2 = engine.to_arrays(delta_g.snapshot(), backend="arrays",
                           device="cpu")
    prop = torch.from_numpy(rng.random(g.num_vertices).astype(np.float32))
    ref = engine.edge_map_pull(engine.FlatBackend(ga2), prop, reduce="min")
    got = dg.edge_map_pull_sharded(sg, prop, mesh1, reduce="min")
    np.testing.assert_array_equal(ref.numpy(), got.numpy())


def test_halo_overflow_raises(kr):
    """Distinct cold sources of shard 1 into shard 0 need more halo slots
    than the (1 -> 0) pair reserved: the router raises, as the
    reference's does."""
    g = workers.two_block_graph(csr)
    ga = engine.to_arrays(g, backend="arrays", device="cpu")
    delta_g = DeltaGraph(g)
    sg = ds.sync_delta(dg.shard_graph(ga, 2, stream=True, remap_headroom=0.0))
    cold = [s for s in range(17, 30)
            if sg.host["hot_pos"][s] < 0][: sg.halo_max + 4]
    assert len(cold) > sg.halo_max
    res = delta_g.apply(add_src=np.array(cold),
                        add_dst=np.arange(1, 1 + len(cold)))
    with pytest.raises(dg.HaloOverflow):
        ds.apply_edge_delta(sg, res, out_deg=delta_g.out_deg,
                            in_deg=delta_g.in_deg)


def test_counters_per_shard_attribution(mesh1, kr):
    """``edge_map.shard_edges.{i}`` sum to ``edge_map.edges`` (degrees
    include the streamed delta edges) and every ``shard_bytes.{i}`` is
    ``edge_map_bytes_sharded``: the same summary as the reference's
    counters on the same routed layout."""
    g, gp = kr
    cfg = dict(regroup_every=0)
    rsh = RefSharded(g, RefConfig(**cfg), n_shards=1)
    psh = ShardedStreamService(gp, StreamConfig(**cfg), mesh=mesh1)
    rng = np.random.default_rng(9)
    v = g.num_vertices
    kw = dict(add_src=rng.integers(0, v, 40), add_dst=rng.integers(0, v, 40))
    rsh.ingest(**kw)
    psh.ingest(**kw)
    c = counters.install(registry=metrics.MetricsRegistry())
    try:
        dg.edge_map_pull_sharded(psh.sg, torch.ones(v), mesh1)
        dg.edge_map_push_sharded(psh.sg, torch.ones(v), mesh1,
                                 use_weights=True)
    finally:
        counters.uninstall()
    rc = ref_counters.install(registry=RefRegistry())
    try:
        import jax.numpy as jnp

        ref_dg.edge_map_pull_sharded(rsh.sg, jnp.ones(v, jnp.float32),
                                     rsh.mesh)
        ref_dg.edge_map_push_sharded(rsh.sg, jnp.ones(v, jnp.float32),
                                     rsh.mesh, use_weights=True)
    finally:
        ref_counters.uninstall()
    s = c.summary()
    assert s == rc.summary()
    assert s["edge_map.shard_edges.0"] == 2 * psh.dg.num_edges
    assert s["edge_map.shard_bytes.0"] == s["edge_map.model_bytes"] == (
        dg.edge_map_bytes_sharded(psh.sg, mode="pull")
        + dg.edge_map_bytes_sharded(psh.sg, mode="push", use_weights=True))
    assert s["edge_map.passes.sharded_flat.pull"] == 1


def test_remap_and_edge_deltas_land_in_one_patch(mesh1, kr):
    """A regroup moving vertices whose streamed edges still sit in delta
    buffers: their slots are retargeted inside apply_remap, so queries see
    one consistent layout."""
    _, gp = kr
    cfg = dict(regroup_every=1, hysteresis=0.0)
    ref = StreamService(gp, StreamConfig(**cfg), device="cpu")
    sh = ShardedStreamService(gp, StreamConfig(**cfg), mesh=mesh1,
                              backend="ell", shard_compact_threshold=10.0)
    rng = np.random.default_rng(5)
    v = gp.num_vertices
    hubs = rng.choice(v, size=8, replace=False)
    for _ in range(4):
        add_s = np.concatenate([np.repeat(hubs, 12), rng.integers(0, v, 40)])
        add_d = rng.integers(0, v, add_s.shape[0])
        ref.ingest(add_src=add_s, add_dst=add_d)
        sh.ingest(add_src=add_s, add_dst=add_d)
    assert sum(d.num_moved for d in sh.remap_deltas) > 0
    assert sum(int(b["n"]) for b in sh.sg.host["stream"]["d"]) > 0
    np.testing.assert_allclose(ref.pagerank(), sh.pagerank(), rtol=0,
                               atol=PR_ATOL)
    np.testing.assert_array_equal(ref.sssp(int(hubs[0])),
                                  sh.sssp(int(hubs[0])))


def test_apply_remaps_to_patches_as_the_reference(mesh1, kr):
    """``StreamService.apply_remaps_to`` routes the regroups into a sharded
    layout as the reference's does (bitwise), consumes each delta once,
    and the patched layout still pulls right on its snapshot."""
    g, gp = kr
    cfg = dict(regroup_every=1, hysteresis=0.0)
    rsvc = RefService(g, RefConfig(**cfg))
    psvc = StreamService(gp, StreamConfig(**cfg), device="cpu")
    rs = ref_dg.shard_graph(ref_engine.to_arrays(g, backend="arrays"), 4)
    ps = dg.shard_graph(engine.to_arrays(gp, backend="arrays", device="cpu"),
                        4)
    rng = np.random.default_rng(0)
    v = g.num_vertices
    for _ in range(3):
        kw = dict(add_src=rng.integers(0, v, 400),
                  add_dst=rng.integers(0, v, 400))
        rsvc.ingest(**kw)
        psvc.ingest(**kw)
    assert sum(d.num_moved for d in psvc.remap_deltas) > 0
    rs2 = rsvc.apply_remaps_to(rs)
    ps2 = psvc.apply_remaps_to(ps)
    assert rs2.stats == ps2.stats
    for f in ("in_slot", "send_idx", "hot_ids"):
        _eq(getattr(rs2, f), getattr(ps2, f), f)
    assert psvc.apply_remaps_to(ps2) is ps2  # nothing new to route
    # the same regroups into a one-shard layout, which keeps its snapshot's
    # topology: its pull still equals the flat oracle of that snapshot
    psvc._remaps_consumed = 0
    one = psvc.apply_remaps_to(dg.shard_graph(
        engine.to_arrays(gp, backend="arrays", device="cpu"), 1))
    assert one.stats["n_hot"] == ps2.stats["n_hot"]
    prop = torch.from_numpy(rng.random(v).astype(np.float32))
    ref = engine.edge_map_pull(
        engine.FlatBackend(engine.to_arrays(gp, backend="arrays",
                                            device="cpu")), prop,
        reduce="min")
    np.testing.assert_array_equal(
        ref.numpy(), dg.edge_map_pull_sharded(one, prop, mesh1,
                                              reduce="min").numpy())


# ---------------------------------------------------------------------------
# across ranks: the sharded service against the single-device one
# ---------------------------------------------------------------------------

def _rank_outputs(ranks, world):
    outs = ranks.results()[world]
    for other in outs[1:]:  # every rank answers the same queries
        for k, v in outs[0].items():
            if not k.startswith("halo/dumps"):
                np.testing.assert_array_equal(other[k], v, err_msg=k)
    return outs[0]


@pytest.mark.parametrize("world,name,backend", [
    (w, n, b) for w in WORLDS for n, b in workers.stream_cases(w)])
def test_sharded_ingest_parity_across_ranks(ranks, world, name, backend):
    got = _rank_outputs(ranks, world)
    pre = f"{name}/{backend}"
    worst = 0.0
    for b in range(3):
        np.testing.assert_array_equal(got[f"{pre}/{b}/sssp"],
                                      got[f"{pre}/{b}/sssp_ref"])
        gap = float(np.abs(got[f"{pre}/{b}/pr"]
                           - got[f"{pre}/{b}/pr_ref"]).max())
        worst = max(worst, gap)
    print(f"D={world} {pre}: PageRank gap to the single-device service "
          f"{worst:.3g}, folds {int(got[pre + '/folds'])}, moved "
          f"{int(got[pre + '/moved'])}")
    assert worst <= PR_ATOL
    assert int(got[pre + "/full_rebuilds"]) == 0
    assert int(got[pre + "/folds"]) > 0  # the per-shard compaction ran


def test_halo_overflow_rebuilds_the_service_across_ranks(ranks):
    """A batch past the halo headroom: on every rank one ``halo_overflow``
    anomaly with the batch's context, a dump, one full re-shard, and SSSP
    still bitwise equal to the single-device service's."""
    for got in ranks.results()[2]:
        assert int(got["halo/full_rebuilds"]) == 1
        assert int(got["halo/triggers"]) == 1
        assert int(got["halo/batch_index"]) == 1
        assert int(got["halo/inserted"]) == 13
        assert int(got["halo/dumps"]) >= 1
        np.testing.assert_array_equal(got["halo/sssp"], got["halo/sssp_ref"])
