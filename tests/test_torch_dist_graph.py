"""The port's sharded graph engine (``repro_torch.dist.graph``) against
``repro.dist.graph``.

In-process, on a one-rank gloo group: every layout plane of ``shard_graph``
and of both sharded packers bitwise equal to the reference's at D = 1, 2, 4
and 8 (each wide class's segment lists checked too); the halo claim at
D = 8; the edge maps, PageRank and ``apply_remap`` at D = 1 against the
reference (its maps under one ``jax.jit``, its Pallas kernels in interpret
mode).  Across ranks: ``tests/dist_workers.py`` runs the reference at D = 2
and 4 on host devices and the port's ranks as subprocesses in gloo groups
(``file://`` rendezvous), all started when this module starts; the tests
compare their npz outputs.  Bands: min/max/or bitwise, sums within
2e-6 · (1 + max|y|), PageRank within 1.1e-7.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as tdist  # noqa: E402

from repro.apps import engine as ref_engine  # noqa: E402
from repro.apps.pagerank_dist import pagerank_dist as ref_pagerank_dist  # noqa: E402
from repro.dist import graph as ref_dg  # noqa: E402
from repro.dist import stream as ref_ds  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.kernels.edge_map import ops as ref_ops  # noqa: E402
from repro.stream.delta import DeltaGraph as RefDeltaGraph  # noqa: E402
from repro.stream.regroup import RemapDelta as RefRemapDelta  # noqa: E402
from repro_torch.apps import engine  # noqa: E402
from repro_torch.apps.pagerank_dist import pagerank_dist  # noqa: E402
from repro_torch.convert import (graph_from_numpy,  # noqa: E402
                                 sharded_graph_from_numpy)
from repro_torch.dist import graph as dg  # noqa: E402
from repro_torch.dist import stream as ds  # noqa: E402
from repro_torch.kernels import _wrap  # noqa: E402
from repro_torch.kernels.edge_map import ops  # noqa: E402
from repro_torch.stream.regroup import IncrementalDBG, RemapDelta  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import dist_workers as workers  # noqa: E402

PLANES = ("in_slot", "in_dst_local", "in_w", "in_mask", "send_idx",
          "hot_ids", "out_src_local", "out_dst", "out_w", "out_mask",
          "in_deg", "out_deg")
TILE_PLANES = ("rows", "idx", "deg", "w", "alive")
RANK_TIMEOUT = 300


# ---------------------------------------------------------------------------
# the subprocess ranks: started with the module, read by the D > 1 tests
# ---------------------------------------------------------------------------

class _Ranks:
    def __init__(self, out_dir):
        self.out_dir = str(out_dir)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu")
        script = os.path.join(ROOT, "tests", "dist_workers.py")
        self.procs = []
        for d in (2, 4):
            self.procs.append(subprocess.Popen(
                [sys.executable, script, "jax",
                 os.path.join(self.out_dir, f"ref_{d}.npz"), str(d)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
            init = os.path.join(self.out_dir, f"init_{d}")
            for r in range(d):
                self.procs.append(subprocess.Popen(
                    [sys.executable, script, "torch-graph", self.out_dir,
                     str(r), str(d), init],
                    env=env, cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        self._results = None

    def results(self):
        if self._results is None:
            deadline = time.monotonic() + RANK_TIMEOUT
            for p in self.procs:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                assert p.returncode == 0 and "OK" in out, out[-4000:]
            res = {}
            for d in (2, 4):
                res[d] = {
                    "ref": dict(np.load(os.path.join(self.out_dir,
                                                     f"ref_{d}.npz"))),
                    "ranks": [dict(np.load(os.path.join(
                        self.out_dir, f"torch_graph_{d}_{r}.npz")))
                        for r in range(d)]}
            self._results = res
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("dist_graph_ranks"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank gloo group in this process (``file://`` rendezvous)."""
    init = tmp_path_factory.mktemp("dist_graph_init") / "init"
    tdist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                             world_size=1)
    yield dg.make_graph_mesh(1, device="cpu")
    tdist.destroy_process_group()


def _port(g):
    return graph_from_numpy(g.in_csr.indptr, g.in_csr.indices,
                            g.in_csr.weights, g.out_csr.indptr,
                            g.out_csr.indices, g.out_csr.weights, g.name)


@pytest.fixture(scope="module")
def kr():
    g = ref_datasets.load("kr", "test")
    gp = _port(g)
    return (g, ref_engine.to_arrays(g, backend="arrays"), gp,
            engine.to_arrays(gp, backend="arrays", device="cpu"))


@pytest.fixture(scope="module")
def small():
    """The workers' weighted kr-signature RMAT graph (400 vertices)."""
    from repro.graph import generators

    g = workers.edge_map_graph(generators)
    gp = _port(g)
    return (g, ref_engine.to_arrays(g, backend="arrays"), gp,
            engine.to_arrays(gp, backend="arrays", device="cpu"))


def _eq(a, b, what=""):
    assert (a is None) == (b is None), what
    if a is not None:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_tiles_equal(rtiles, ptiles, what):
    assert (rtiles is None) == (ptiles is None), what
    if rtiles is None:
        return
    assert len(rtiles) == len(ptiles), what
    for c, (rt, pt) in enumerate(zip(rtiles, ptiles)):
        for f in TILE_PLANES:
            _eq(getattr(rt, f, None), getattr(pt, f), f"{what}[{c}].{f}")
        _assert_segments(pt)


def _assert_segments(t):
    """A wide class carries, per shard, a list covering each row's
    ``[0, deg)`` once, in order; a narrow class carries none."""
    w_pad = t.idx.shape[2]
    if _wrap.lanes_per_row(w_pad) < 256:
        assert t.segments is None
        return
    assert len(t.segments) == t.deg.shape[0]
    for deg, seg in zip(t.deg, t.segments):
        assert seg.dtype == np.int32 and seg.shape[1] == 3
        for r in range(deg.shape[0]):
            mine = seg[seg[:, 0] == r]
            assert mine[0, 1] == 0 and mine[-1, 2] == deg[r]
            np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
            assert np.all(mine[:, 2] - mine[:, 1] <= _wrap.SEGMENT_LANES)


def _assert_band(ref, got, reduce, what=""):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, what
    if reduce == "sum":
        scale = 1.0 + np.abs(ref[np.isfinite(ref)]).max(initial=0.0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=what)


# ---------------------------------------------------------------------------
# layouts, bitwise, in-process (shard_graph needs no mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True], ids=["static", "stream"])
@pytest.mark.parametrize("backend", ["flat", "ell"])
@pytest.mark.parametrize("policy", ["replicate_hot", "partition"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_shard_graph_is_bitwise_the_references(kr, shards, policy, backend,
                                               stream):
    _, rga, _, pga = kr
    kw = dict(policy=policy, backend=backend, stream=stream)
    rs = ref_dg.shard_graph(rga, shards, **kw)
    ps = dg.shard_graph(pga, shards, **kw)
    for f in PLANES:
        _eq(getattr(rs, f), getattr(ps, f), f)
    for f in ("n_shards", "num_vertices", "v_blk", "halo_max", "policy",
              "backend", "hot_cap", "hot_group_count", "weighted",
              "table_len", "v_pad"):
        assert getattr(rs, f) == getattr(ps, f), f
    assert rs.stats == ps.stats
    _assert_tiles_equal(rs.pull_tiles, ps.pull_tiles, "pull_tiles")
    _assert_tiles_equal(rs.push_tiles, ps.push_tiles, "push_tiles")
    assert (rs.host is None) == (ps.host is None)
    if rs.host is not None:
        for f in ("need_len", "hot_pos", "hot_ids", "send_idx"):
            _eq(rs.host[f], ps.host[f], f)
        assert rs.host["hot_free"] == ps.host["hot_free"]
        for i in range(shards):
            _eq(rs.host["slot"][i], ps.host["slot"][i], "slot")
            if rs.host["tile_pos"] is not None:
                _eq(rs.host["tile_pos"][i], ps.host["tile_pos"][i],
                    "tile_pos")
        if stream:
            rst, pst = rs.host["stream"], ps.host["stream"]
            for i in range(shards):
                for f in ("in_key", "out_key"):
                    for a, b in zip(rst[f][i], pst[f][i]):
                        _eq(a, b, f)
                if rst["push_tile_pos"] is not None:
                    _eq(rst["push_tile_pos"][i], pst["push_tile_pos"][i],
                        "push_tile_pos")
    for mode in ("pull", "push"):
        for uw in (False, True):
            assert (ref_dg.edge_map_bytes_sharded(rs, mode=mode,
                                                  use_weights=uw)
                    == dg.edge_map_bytes_sharded(ps, mode=mode,
                                                 use_weights=uw))


def _shard_lists(shards, weighted, seed):
    """Per-shard (rows, cols, w) lists with a hub row of 3,000 lanes on
    shard 0 (a class wider than 1,024 lanes) and an empty shard last."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(shards):
        if i == shards - 1 and shards > 1:
            rows = np.zeros(0, np.int64)
        else:
            rows = rng.integers(0, 300, 900)
            if i == 0:
                rows = np.concatenate([rows, np.full(3000, 17)])
            rng.shuffle(rows)
        cols = rng.integers(0, 5000, rows.shape[0])
        w = rng.random(rows.shape[0]).astype(np.float32) if weighted else None
        out.append((rows, cols, w))
    return out


@pytest.mark.parametrize("extras", [(False, False), (True, True)],
                         ids=["plain", "positions_alive"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_ell_tiles_sharded_is_bitwise_the_references(shards, weighted,
                                                     extras):
    positions, alive = extras
    lists = _shard_lists(shards, weighted, shards)
    kw = dict(id_upper=5000, with_positions=positions, with_alive=alive)
    rt = ref_ops.ell_tiles_sharded(lists, **kw)
    pt = ops.ell_tiles_sharded(lists, **kw)
    if positions:
        (rt, rpos), (pt, ppos) = rt, pt
        for a, b in zip(rpos, ppos):
            _eq(a, b, "positions")
    _assert_tiles_equal(rt, pt, "tiles")
    assert any(t.segments is not None for t in pt)  # the hub's class
    # shard i's device view: its planes and its own list
    i = 0
    view = pt[0].shard(i, "cpu")
    _eq(view.idx.numpy(), pt[0].idx[i], "shard idx")
    assert view.rows.dtype == torch.int64
    np.testing.assert_array_equal(view.segments.numpy(), pt[0].segments[i])


@pytest.mark.parametrize("caps", [(0, 0), (130, 1200)], ids=["fit", "caps"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_coo_tiles_sharded_is_bitwise_the_references(shards, weighted, caps):
    lists = _shard_lists(shards, weighted, 100 + shards)
    kw = dict(id_upper=70000, row_cap=caps[0], width_cap=caps[1])
    rt = ref_ops.coo_tiles_sharded(lists, **kw)
    pt = ops.coo_tiles_sharded(lists, **kw)
    _assert_tiles_equal(rt, pt, "coo tiles")
    assert pt[0].idx.dtype == np.int32  # ids past uint16's range


def test_hot_replication_shrinks_halo(kr):
    """The tentpole claim at D = 8: the DBG hot groups account for most
    remote references, so replicating them cuts the halo exchange."""
    _, _, _, pga = kr
    rep = dg.shard_graph(pga, 8, policy="replicate_hot")
    part = dg.shard_graph(pga, 8, policy="partition")
    assert rep.stats["n_hot"] > 0
    assert rep.stats["halo_slots"] < 0.7 * part.stats["halo_slots"], (
        rep.stats, part.stats)
    assert rep.stats["hot_frac"] < 0.5


@pytest.mark.parametrize("policy", ["replicate_hot", "partition"])
def test_exchange_table_feeds_each_shards_tiles(kr, policy):
    """At D = 4, each shard's tiles over the table the exchange delivers
    (``exchange_table``, built from the global vector) give that shard's
    block of the single-device pull and push: the table, the slots and the
    tiles agree without a process group."""
    _, _, gp, pga = kr
    sg = dg.shard_graph(pga, 4, policy=policy, backend="ell")
    x = torch.from_numpy(workers.prop_of(gp.num_vertices))
    flat = engine.FlatBackend(pga)
    for red in ("sum", "min", "max"):
        ident = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[red]
        pull = engine.edge_map_pull(flat, x, reduce=red)
        push = engine.edge_map_push(flat, x, reduce=red)
        parts = torch.full((sg.v_pad,), ident)
        for i in range(4):
            table = dg.exchange_table(sg, x, i)
            out = torch.full((sg.v_blk,), ident)
            for t in sg.pull_tiles:
                out = dg._class_fold(out, (t.shard(i, "cpu"),), table, red,
                                     False, ident, ident, sg)
            lo = i * sg.v_blk
            _assert_band(pull[lo: lo + sg.v_blk].numpy(),
                         out[: pull[lo: lo + sg.v_blk].shape[0]].numpy(),
                         red, f"pull shard {i}")
            local = table[: sg.v_blk]
            for t in sg.push_tiles:
                parts = dg._class_fold(parts, (t.shard(i, "cpu"),), local,
                                       red, False, ident, ident, sg)
        _assert_band(push.numpy(), parts[: gp.num_vertices].numpy(), red,
                     "push")


# ---------------------------------------------------------------------------
# edge maps at D = 1, in-process
# ---------------------------------------------------------------------------

def _ref_maps(sg, prop, cases):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), (ref_dg.AXIS,))

    def fn(p):
        return [(ref_dg.edge_map_pull_sharded if d == "pull"
                 else ref_dg.edge_map_push_sharded)(
            sg, p, mesh, reduce=red, use_weights=uw)
            for _, d, red, uw in cases]

    return [np.asarray(y) for y in jax.jit(fn)(jnp.asarray(prop))]


def _port_maps(sg, prop, mesh, cases):
    return [(dg.edge_map_pull_sharded if d == "pull"
             else dg.edge_map_push_sharded)(
        sg, torch.from_numpy(prop), mesh, reduce=red, use_weights=uw).numpy()
        for _, d, red, uw in cases]


@pytest.mark.parametrize("backend", ["flat", "ell"])
@pytest.mark.parametrize("policy", ["replicate_hot", "partition"])
def test_edge_maps_match_reference_one_shard(mesh1, small, policy, backend):
    _, rga, _, pga = small
    prop = workers.prop_of(rga.in_deg.shape[0])
    cases = list(workers.graph_cases(backend))
    rs = ref_dg.shard_graph(rga, 1, policy=policy, backend=backend)
    ps = dg.shard_graph(pga, 1, policy=policy, backend=backend)
    for (key, _, red, _), a, b in zip(cases, _ref_maps(rs, prop, cases),
                                      _port_maps(ps, prop, mesh1, cases)):
        _assert_band(a, b, red, key)


@pytest.mark.parametrize("backend", ["flat", "ell"])
def test_delta_segment_matches_reference_one_shard(mesh1, small, backend):
    """A churned streaming layout (inserts in the delta segment, deletions
    as tombstones) through the reference's routing and the port's, then
    its maps; the port's layout is built after its first map (so the
    router patches a live device copy)."""
    rg, rga, pgr, pga = small
    prop = workers.prop_of(rga.in_deg.shape[0])
    rdg = RefDeltaGraph(rg)
    res = rdg.apply(**workers.churn(rdg, 1))
    kw = dict(backend=backend, stream=True, remap_headroom=1.0)
    rs = ref_ds.sync_delta(ref_dg.shard_graph(rga, 1, **kw))
    rs, rstats = ref_ds.apply_edge_delta(rs, res, out_deg=rdg.out_deg,
                                         in_deg=rdg.in_deg)
    ps = ds.sync_delta(dg.shard_graph(pga, 1, **kw))
    dg.edge_map_push_sharded(ps, torch.from_numpy(prop), mesh1)
    ps, pstats = ds.apply_edge_delta(ps, res, out_deg=rdg.out_deg,
                                     in_deg=rdg.in_deg)
    assert rstats == pstats
    for f in ref_dg.ShardDeltaSegment._fields[:8]:
        _eq(getattr(rs.delta, f), getattr(ps.delta, f), f)
    for f in ("pull_tiles", "push_tiles"):
        _assert_tiles_equal(getattr(rs.delta, f), getattr(ps.delta, f), f)
    cases = list(workers.delta_cases()) + [
        ("pull/max/0", "pull", "max", False), ("push/or/1", "push", "or",
                                               True)]
    for (key, _, red, _), a, b in zip(cases, _ref_maps(rs, prop, cases),
                                      _port_maps(ps, prop, mesh1, cases)):
        _assert_band(a, b, red, key)
    # the same layout carried across from the reference's planes
    pc = sharded_graph_from_numpy(rs)
    for (key, _, red, _), a, b in zip(cases, _ref_maps(rs, prop, cases),
                                      _port_maps(pc, prop, mesh1, cases)):
        _assert_band(a, b, red, key)


def test_or_isolated_vertex_parity(mesh1):
    """reduce="or": an empty row takes the max identity (-inf) on both
    sharded backends, as the flat engine's empty segment max does."""
    g = ref_csr.from_edges(np.array([0, 1, 2, 0]), np.array([1, 2, 0, 2]), 4)
    gp = _port(g)
    ga = engine.to_arrays(gp, backend="arrays", device="cpu")
    prop = torch.tensor([1.0, -2.0, 0.5, -1.0])
    ref = engine.edge_map_pull(engine.FlatBackend(ga), prop, reduce="or")
    assert ref[3] == -np.inf
    for backend in ("flat", "ell"):
        sg = dg.shard_graph(ga, 1, backend=backend)
        got = dg.edge_map_pull_sharded(sg, prop, mesh1, reduce="or")
        np.testing.assert_array_equal(ref.numpy(), got.numpy())


@pytest.mark.parametrize("backend", ["flat", "ell"])
def test_pagerank_dist_one_shard_matches_reference(mesh1, kr, backend):
    rg, _, pgr, _ = kr
    rmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), (ref_dg.AXIS,))
    r_ranks, r_iters, _ = ref_pagerank_dist(rg, mesh=rmesh, backend=backend,
                                            max_iters=workers.PR_ITERS)
    p_ranks, p_iters, sg = pagerank_dist(pgr, mesh=mesh1, backend=backend,
                                         max_iters=workers.PR_ITERS)
    np.testing.assert_allclose(p_ranks.numpy(), np.asarray(r_ranks),
                               rtol=0, atol=1.1e-7)
    assert abs(p_iters - int(r_iters)) <= 1, (p_iters, int(r_iters))
    assert sg.backend == backend


# ---------------------------------------------------------------------------
# D = 2 and 4: the port's gloo ranks against the reference's host devices
# ---------------------------------------------------------------------------

def _rank_outputs(ranks, shards):
    res = ranks.results()[shards]
    for other in res["ranks"][1:]:  # every rank holds the global result
        assert other.keys() == res["ranks"][0].keys()
        for k, v in res["ranks"][0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    return res["ref"], res["ranks"][0]


@pytest.mark.parametrize("backend", ["flat", "ell"])
@pytest.mark.parametrize("policy", ["replicate_hot", "partition"])
@pytest.mark.parametrize("shards", [2, 4])
def test_edge_maps_match_reference_across_ranks(ranks, shards, policy,
                                                backend):
    ref, got = _rank_outputs(ranks, shards)
    pre = f"{shards}/{backend}/{policy}/"
    keys = [k for k in ref if k.startswith(pre)]
    assert len(keys) == len(list(workers.graph_cases(backend)))
    for k in keys:
        _assert_band(ref[k], got[k], k.split("/")[4], k)
    # flat against ell on the port's own layouts: every case
    for key, _, red, _ in workers.graph_cases():
        _assert_band(got[f"{shards}/flat/{policy}/{key}"],
                     got[f"{shards}/ell/{policy}/{key}"], red, key)


@pytest.mark.parametrize("backend", ["flat", "ell"])
@pytest.mark.parametrize("shards", [2, 4])
def test_delta_segment_matches_reference_across_ranks(ranks, shards,
                                                      backend):
    ref, got = _rank_outputs(ranks, shards)
    for key, _, red, _ in workers.delta_cases():
        k = f"{shards}/{backend}/{key}"
        _assert_band(ref[k], got[k], red, k)


@pytest.mark.parametrize("backend", ["flat", "ell"])
@pytest.mark.parametrize("shards", [2, 4])
def test_pagerank_dist_matches_reference_across_ranks(ranks, shards,
                                                      backend):
    ref, got = _rank_outputs(ranks, shards)
    k = f"{shards}/{backend}/pagerank"
    np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1.1e-7)
    it_ref, it = int(ref[k + "_iters"]), int(got[k + "_iters"])
    print(f"D={shards} {backend}: iterations {it} (reference {it_ref})")
    assert abs(it - it_ref) <= 1


@pytest.mark.parametrize("shards", [2, 4])
def test_apply_remap_equals_full_reshard_across_ranks(ranks, shards):
    _, got = _rank_outputs(ranks, shards)
    for backend in ("flat", "ell"):
        pre = f"{shards}/{backend}/remap/"
        assert int(got[pre + "moved"]) > 0
        _assert_band(got[pre + "reshard/sum"], got[pre + "patched/sum"],
                     "sum", pre)
        np.testing.assert_array_equal(got[pre + "patched/min"],
                                      got[pre + "reshard/min"])


# ---------------------------------------------------------------------------
# remaps, names and the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["flat", "ell"])
def test_apply_remap_equals_full_reshard(mesh1, kr, backend):
    """Patching only the group-crossers computes what a from-scratch
    shard_graph with the same hot set computes, and what the reference's
    patch computes; the port's device copy is patched in place."""
    _, rga, gp, pga = kr
    kw = dict(policy="replicate_hot", backend=backend, remap_headroom=3.0)
    rs = ref_dg.shard_graph(rga, 1, **kw)
    ps = dg.shard_graph(pga, 1, **kw)
    prop = torch.from_numpy(np.random.default_rng(0).random(
        gp.num_vertices).astype(np.float32))
    dg.edge_map_pull_sharded(ps, prop, mesh1)  # a live device copy
    deg = ps.out_deg.astype(np.int64)
    inc = IncrementalDBG(deg, hysteresis=0.0)
    rng = np.random.default_rng(2)
    touched = rng.choice(gp.num_vertices, size=150, replace=False)
    delta = inc.update(touched, np.maximum(0, deg[touched]
                                           + rng.integers(-10, 60, 150)))
    assert delta.num_moved > 0
    rdelta = RefRemapDelta(moved=delta.moved, old_group=delta.old_group,
                           new_group=delta.new_group, spec_rebuilt=False,
                           seconds=0.0)
    rs2 = ref_dg.apply_remap(rs, rdelta)
    ps2 = dg.apply_remap(ps, delta)
    assert rs2.stats == ps2.stats
    for f in ("in_slot", "send_idx", "hot_ids"):
        _eq(getattr(rs2, f), getattr(ps2, f), f)
    _assert_tiles_equal(rs2.pull_tiles, ps2.pull_tiles, "patched tiles")
    hot = set(ps.host["hot_ids"][: ps.stats["n_hot"]].tolist())
    for vid, ng in zip(delta.moved.tolist(), delta.new_group.tolist()):
        (hot.add if ng < ps.hot_group_count else hot.discard)(vid)
    ref = dg.shard_graph(pga, 1, hot_override=np.array(sorted(hot)), **kw)
    assert ps2.stats["n_hot"] == ref.stats["n_hot"]
    for red in ("sum", "min"):
        _assert_band(
            dg.edge_map_pull_sharded(ref, prop, mesh1, reduce=red).numpy(),
            dg.edge_map_pull_sharded(ps2, prop, mesh1, reduce=red).numpy(),
            red)


def test_apply_remap_overflow_and_spec_rebuild_raise(kr):
    _, _, _, pga = kr
    sg = dg.shard_graph(pga, 4, policy="replicate_hot", remap_headroom=0.0)
    cold = np.flatnonzero(sg.host["hot_pos"] < 0)[:100]
    delta = RemapDelta(moved=cold, old_group=np.full(100, 5),
                       new_group=np.zeros(100, np.int64),
                       spec_rebuilt=False, seconds=0.0)
    with pytest.raises(dg.RemapOverflow):
        dg.apply_remap(sg, delta)
    sg = dg.shard_graph(pga, 1, policy="replicate_hot")
    delta = RemapDelta(moved=np.array([0]), old_group=np.array([5]),
                       new_group=np.array([0]), spec_rebuilt=True,
                       seconds=0.0)
    with pytest.raises(dg.RemapOverflow, match="spec was rebuilt"):
        dg.apply_remap(sg, delta)
    assert issubclass(dg.HaloOverflow, dg.RemapOverflow)


def test_sharded_backend_names_resolve_through_registry(mesh1, kr):
    _, _, gp, pga = kr
    with pytest.raises(ValueError, match="unknown edge-map backend"):
        dg.shard_graph(pga, 1, backend="nope")
    with pytest.raises(ValueError, match="not supported by the sharded"):
        dg.shard_graph(pga, 1, backend="packed")  # known, but not sharded
    sg = dg.shard_graph(pga, 1)  # a flat layout carries no tiles
    with pytest.raises(ValueError, match="requires shard_graph"):
        dg.edge_map_pull_sharded(sg, torch.zeros(gp.num_vertices), mesh1,
                                 backend="ell")


def test_make_graph_mesh_needs_one_initialised_rank_per_shard(mesh1, kr,
                                                              monkeypatch):
    _, _, gp, pga = kr
    with pytest.raises(ValueError, match="one rank per shard"):
        dg.make_graph_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="2-shard layout on a mesh of 1"):
        dg.edge_map_pull_sharded(dg.shard_graph(pga, 2),
                                 torch.zeros(gp.num_vertices), mesh1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="needs a nccl process group"):
        dg.make_graph_mesh(1, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dg.make_graph_mesh(1)  # the card by default, and there is none
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="initialised"):
        dg.make_graph_mesh(1, device="cpu")
    assert (mesh1.rank, mesh1.size, mesh1.device.type) == (0, 1, "cpu")
