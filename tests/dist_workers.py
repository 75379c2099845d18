"""Subprocess workers of the sharded-engine parity tests.

    python tests/dist_workers.py jax OUT.npz D
    python tests/dist_workers.py torch-graph OUT_DIR RANK WORLD INIT_FILE
    python tests/dist_workers.py torch-stream OUT_DIR RANK WORLD INIT_FILE
    python tests/dist_workers.py jax-compress OUT.npz D
    python tests/dist_workers.py torch-compress OUT_DIR RANK WORLD INIT_FILE
    python tests/dist_workers.py torch-lm OUT_DIR RANK WORLD INIT_FILE
    python tests/dist_workers.py torch-pipeline OUT_DIR RANK WORLD INIT_FILE
    python tests/dist_workers.py jax-pipeline OUT.npz D
    python tests/dist_workers.py torch-dryrun OUT_DIR

``jax`` computes the reference's sharded edge maps, delta-segment maps and
PageRank at D host devices (every layout's outputs under one ``jax.jit``,
its Pallas kernels in interpret mode: on ``ell`` one weighting per
reduction, as each interpreted kernel costs seconds to trace).  ``torch-graph`` and
``torch-stream`` are one rank of the port's engine in a gloo group (a
``file://`` rendezvous): the same cases, and the sharded stream against
the single-device service.  ``jax-compress`` and ``torch-compress`` are
the int8 compressed mean over D participants: the reference's
``compressed_psum`` under ``shard_map``, and one rank of the port's
``compressed_all_reduce`` in a gloo group.  ``torch-lm`` is one rank of
the sharded LM (train steps on three meshes, a MoE step, decode) from the
reference's weights in ``OUT_DIR/data.npz``; ``torch-pipeline`` one stage
of ``pipeline_apply``, ``jax-pipeline`` the reference's on D host devices;
``torch-dryrun`` the port's dry run on fake process groups.
Each writes its outputs to an npz file that the tests compare.  Not collected by pytest (no ``test_`` prefix).
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

BACKENDS = ("flat", "ell")
POLICIES = ("replicate_hot", "partition")
REDUCES = ("sum", "min", "max", "or")
PR_ITERS = 50


def edge_map_graph(generators):
    """A ``kr``-signature RMAT graph with weights, small enough for the
    reference's interpret-mode kernels: 400 vertices, ~4,000 edges."""
    return generators.with_weights(generators.rmat(400, 4000, seed=5), seed=5)


def prop_of(v):
    return np.random.default_rng(0).normal(size=v).astype(np.float32)


def graph_cases(backend="flat"):
    """(key, direction, reduce, use_weights) of the base-layout outputs:
    all of them, or on the reference's ``ell`` one weighting per
    reduction."""
    for direction in ("pull", "push"):
        for red in REDUCES:
            for uw in (False, True):
                if backend == "ell" and uw != (red in ("sum", "max")):
                    continue
                yield f"{direction}/{red}/{int(uw)}", direction, red, uw


def delta_cases():
    for direction in ("pull", "push"):
        for red in ("sum", "min"):
            yield f"delta/{direction}/{red}", direction, red, True


def churn(dg, seed):
    """One insert + delete batch over ``dg``'s alive edges (numpy only, so
    both packages' DeltaGraphs take the same batch)."""
    rng = np.random.default_rng(seed)
    v = dg.num_vertices
    es, ed, _ = dg.alive_edges()
    idx = rng.choice(es.shape[0], size=60, replace=False)
    return dict(add_src=rng.integers(0, v, 200),
                add_dst=rng.integers(0, v, 200),
                add_w=rng.random(200).astype(np.float32) + 0.01,
                del_src=es[idx], del_dst=ed[idx])


# ---------------------------------------------------------------------------
# the reference, on D host devices
# ---------------------------------------------------------------------------

def run_jax(out_path, d):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={d}"
    import jax
    import jax.numpy as jnp

    from repro.apps import engine
    from repro.apps.pagerank_dist import pagerank_dist
    from repro.dist import graph as dg
    from repro.dist import stream as ds
    from repro.graph import datasets, generators
    from repro.stream.delta import DeltaGraph

    gw = edge_map_graph(generators)
    g = datasets.load("kr", "test")
    ga = engine.to_arrays(gw, backend="arrays")
    prop = jnp.asarray(prop_of(gw.num_vertices))
    dgw = DeltaGraph(gw)
    res = dgw.apply(**churn(dgw, 1))
    out = {}

    def run_all(sg, mesh, cases, prefix):
        def fn(p):
            return [(dg.edge_map_pull_sharded if d == "pull"
                     else dg.edge_map_push_sharded)(
                sg, p, mesh, reduce=red, use_weights=uw)
                for _, d, red, uw in cases]
        for (key, *_), y in zip(cases, jax.jit(fn)(prop)):
            out[f"{prefix}/{key}"] = np.asarray(y)

    mesh = jax.sharding.Mesh(np.array(jax.devices()), (dg.AXIS,))
    for backend in BACKENDS:
        for policy in POLICIES:
            pre = f"{d}/{backend}/{policy}"
            sg = dg.shard_graph(ga, d, policy=policy, backend=backend)
            run_all(sg, mesh, list(graph_cases(backend)), pre)
        sg = ds.sync_delta(dg.shard_graph(
            ga, d, backend=backend, stream=True, remap_headroom=1.0))
        sg, _ = ds.apply_edge_delta(sg, res, out_deg=dgw.out_deg,
                                    in_deg=dgw.in_deg)
        run_all(sg, mesh, list(delta_cases()), f"{d}/{backend}")
        ranks, iters, _ = pagerank_dist(g, mesh=mesh, backend=backend,
                                        max_iters=PR_ITERS)
        out[f"{d}/{backend}/pagerank"] = np.asarray(ranks)
        out[f"{d}/{backend}/pagerank_iters"] = np.asarray(int(iters))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port: one rank of a gloo group
# ---------------------------------------------------------------------------

def _mesh(rank, world, init_file):
    import torch.distributed as tdist

    from repro_torch.dist.graph import make_graph_mesh

    tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                             rank=rank, world_size=world)
    return make_graph_mesh(world, device="cpu")


def run_torch_graph(out_dir, rank, world, init_file):
    import torch
    import torch.distributed as tdist

    from repro_torch.apps import engine
    from repro_torch.apps.pagerank_dist import pagerank_dist
    from repro_torch.dist import graph as dg
    from repro_torch.dist import stream as ds
    from repro_torch.graph import datasets, generators
    from repro_torch.stream.delta import DeltaGraph
    from repro_torch.stream.regroup import IncrementalDBG

    mesh = _mesh(rank, world, init_file)
    gw = edge_map_graph(generators)
    g = datasets.load("kr", "test")
    ga = engine.to_arrays(gw, backend="arrays", device="cpu")
    prop = torch.from_numpy(prop_of(gw.num_vertices))
    dgw = DeltaGraph(gw)
    res = dgw.apply(**churn(dgw, 1))
    out = {}

    def run_all(sg, cases, prefix):
        for key, d, red, uw in cases:
            fn = (dg.edge_map_pull_sharded if d == "pull"
                  else dg.edge_map_push_sharded)
            out[f"{prefix}/{key}"] = fn(sg, prop, mesh, reduce=red,
                                        use_weights=uw).numpy()

    d = world
    for backend in BACKENDS:
        for policy in POLICIES:
            pre = f"{d}/{backend}/{policy}"
            sg = dg.shard_graph(ga, d, policy=policy, backend=backend)
            run_all(sg, list(graph_cases()), pre)
        # the delta segment, on a streaming layout with room for the
        # batch's new halo entries
        sg = ds.sync_delta(dg.shard_graph(
            ga, d, backend=backend, stream=True, remap_headroom=1.0))
        sg, _ = ds.apply_edge_delta(sg, res, out_deg=dgw.out_deg,
                                    in_deg=dgw.in_deg)
        run_all(sg, list(delta_cases()), f"{d}/{backend}")
        ranks, iters, _ = pagerank_dist(g, mesh=mesh, backend=backend,
                                        max_iters=PR_ITERS)
        out[f"{d}/{backend}/pagerank"] = ranks.numpy()
        out[f"{d}/{backend}/pagerank_iters"] = np.asarray(iters)

    # apply_remap against a full re-shard with the same hot set, both
    # backends: the patched layout's exchange (hot panel, halo) must agree
    ga_u = engine.to_arrays(g, backend="arrays", device="cpu")
    prop = torch.from_numpy(prop_of(g.num_vertices))
    for backend in BACKENDS:
        sg = dg.shard_graph(ga_u, d, backend=backend, remap_headroom=3.0)
        deg = sg.out_deg.astype(np.int64)
        inc = IncrementalDBG(deg, hysteresis=0.0)
        rng = np.random.default_rng(2)
        touched = rng.choice(g.num_vertices, size=150, replace=False)
        delta = inc.update(touched, np.maximum(
            0, deg[touched] + rng.integers(-10, 60, 150)))
        dg.edge_map_pull_sharded(sg, prop, mesh)  # views exist: patched
        sg2 = dg.apply_remap(sg, delta)
        hot = set(sg.host["hot_ids"][: sg.stats["n_hot"]].tolist())
        for vid, ng in zip(delta.moved.tolist(), delta.new_group.tolist()):
            (hot.add if ng < sg.hot_group_count else hot.discard)(vid)
        ref = dg.shard_graph(ga_u, d, backend=backend, remap_headroom=3.0,
                             hot_override=np.array(sorted(hot)))
        for red in ("sum", "min"):
            for name, lay in (("patched", sg2), ("reshard", ref)):
                out[f"{d}/{backend}/remap/{name}/{red}"] = (
                    dg.edge_map_pull_sharded(lay, prop, mesh,
                                             reduce=red).numpy())
        out[f"{d}/{backend}/remap/moved"] = np.asarray(delta.num_moved)
    np.savez(os.path.join(out_dir, f"torch_graph_{d}_{rank}.npz"), **out)
    tdist.destroy_process_group()


def stream_cases(world):
    """(graph, backend) pairs the stream ranks run at ``world`` shards."""
    if world == 2:
        return [(g, b) for g in ("kr", "rand_w") for b in BACKENDS]
    return [("kr", "ell")]


def two_block_graph(csr):
    """32 vertices, 2 shards of 16; one hot hub, cold tails, and NO
    cross-shard cold edges at build time -> a minimal halo segment."""
    src = [0] * 12 + list(range(1, 14))
    dst = list(range(1, 13)) + [14] * 13
    src += [16 + s for s in src]
    dst += [16 + d for d in dst]
    return csr.from_edges(np.array(src), np.array(dst), 32)


def run_torch_stream(out_dir, rank, world, init_file):
    """The sharded stream service beside the single-device one, both the
    port's, on the same churn: SSSP and PageRank after every batch; at two
    shards also a halo overflow, with the flight recorder on."""
    import torch.distributed as tdist

    from repro_torch.graph import csr, datasets
    from repro_torch.obs import flight as obs_flight
    from repro_torch.stream import StreamConfig, StreamService
    from repro_torch.stream.sharded import ShardedStreamService

    mesh = _mesh(rank, world, init_file)
    out = {}
    rng0 = np.random.default_rng(7)
    n = 40
    graphs = {"kr": datasets.load("kr", "test")}
    src, dst = rng0.integers(0, n, 160), rng0.integers(0, n, 160)
    graphs["rand_w"] = csr.from_edges(
        src, dst, n, weights=rng0.random(160).astype(np.float32) + 0.01)
    for name, backend in stream_cases(world):
        g = graphs[name]
        weighted = g.in_csr.weights is not None
        cfg = StreamConfig(regroup_every=1, hysteresis=0.0)
        ref = StreamService(g, cfg, device="cpu")
        sh = ShardedStreamService(g, cfg, mesh=mesh, backend=backend,
                                  shard_compact_threshold=0.05)
        rng = np.random.default_rng(11)
        v = g.num_vertices
        for b in range(3):
            es, ed, _ = ref.dg.alive_edges()
            size = max(8, g.num_edges // 40)
            idx = rng.choice(es.shape[0], size=size // 4, replace=False)
            kw = dict(add_src=rng.integers(0, v, size),
                      add_dst=rng.integers(0, v, size),
                      del_src=es[idx], del_dst=ed[idx])
            if weighted:
                kw["add_w"] = rng.random(size).astype(np.float32) + 0.01
            ref.ingest(**kw)
            sh.ingest(**kw)
            root = int(rng.integers(0, v))
            pre = f"{name}/{backend}/{b}"
            out[f"{pre}/pr_ref"] = ref.pagerank()
            out[f"{pre}/pr"] = sh.pagerank()
            out[f"{pre}/sssp_ref"] = ref.sssp(root)
            out[f"{pre}/sssp"] = sh.sssp(root)
        out[f"{name}/{backend}/folds"] = np.asarray(sum(
            len(h["compacted"]) for h in sh.shard_history))
        out[f"{name}/{backend}/moved"] = np.asarray(sum(
            d.num_moved for d in sh.remap_deltas))
        out[f"{name}/{backend}/full_rebuilds"] = np.asarray(
            sh.full_rebuilds)
    if world == 2:
        # distinct cold sources of shard 1, all into shard 0: each needs a
        # fresh halo slot on the (1 -> 0) pair, past the reserved headroom
        g = two_block_graph(csr)
        cold = list(range(17, 30))
        kw = dict(add_src=np.array(cold), add_dst=np.arange(1, 1 + len(cold)))
        cfg = StreamConfig(regroup_every=0)
        fr = obs_flight.install(dump_dir=os.path.join(out_dir, f"fr{rank}"))
        try:
            ref = StreamService(g, cfg, device="cpu")
            sh = ShardedStreamService(g, cfg, mesh=mesh, remap_headroom=0.0)
            ref.ingest(**kw)
            sh.ingest(**kw)
        finally:
            obs_flight.uninstall()
        trig = [t for t in fr.triggers if t["reason"] == "halo_overflow"]
        out["halo/full_rebuilds"] = np.asarray(sh.full_rebuilds)
        out["halo/triggers"] = np.asarray(len(trig))
        out["halo/batch_index"] = np.asarray(
            trig[0]["context"]["batch_index"])
        out["halo/inserted"] = np.asarray(trig[0]["context"]["inserted"])
        out["halo/dumps"] = np.asarray(len(os.listdir(
            os.path.join(out_dir, f"fr{rank}"))))
        out["halo/sssp_ref"] = ref.sssp(0)
        out["halo/sssp"] = sh.sssp(0)
    np.savez(os.path.join(out_dir, f"torch_stream_{world}_{rank}.npz"), **out)
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the int8 compressed mean (train.compress)
# ---------------------------------------------------------------------------

def compress_inputs(d):
    """Each participant's rows: a normal draw, one with a wide dynamic range
    and one whose largest entry lies on a single participant."""
    rng = np.random.default_rng(11)
    wide = rng.normal(size=(d, 1000)) * np.logspace(-4, 2, 1000)
    spike = rng.normal(size=(d, 257)) * 1e-3
    spike[d - 1, 5] = 40.0
    return {"normal": rng.normal(size=(d, 4096)).astype(np.float32),
            "wide": wide.astype(np.float32), "spike": spike.astype(np.float32)}


def run_jax_compress(out_path, d):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={d}"
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.train.compress import compressed_psum

    mesh = jax.make_mesh((d,), ("pod",))
    f = jax.jit(shard_map(lambda a: compressed_psum(a[0], "pod")[None],
                          mesh=mesh, in_specs=P("pod"), out_specs=P("pod")))
    np.savez(out_path, **{k: np.asarray(f(x))
                          for k, x in compress_inputs(d).items()})


def run_torch_compress(out_dir, rank, world, init_file):
    import torch
    import torch.distributed as tdist

    from repro_torch.train.compress import compressed_all_reduce

    tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                             rank=rank, world_size=world)
    out = {k: compressed_all_reduce(torch.from_numpy(x[rank])).numpy()
           for k, x in compress_inputs(world).items()}
    np.savez(os.path.join(out_dir, f"torch_compress_{world}_{rank}.npz"),
             **out)
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the sharded LM and the pipeline (A12.7)
# ---------------------------------------------------------------------------

LM_MESHES = ((2, 2), (4, 1), (1, 4))


def _lm_case(arch):
    from repro_torch import configs

    return configs.reduced(configs.get_config(arch), remat=False, n_layers=2)


def run_torch_lm(out_dir, rank, world, init_file):
    """One rank of the sharded LM on a 4-rank gloo group: from the
    reference's weights in ``data.npz``, 3 train steps of reduced Yi-9B on
    every mesh of LM_MESHES; one step of reduced DeepSeek with ``experts`` on ``model``; a few
    ``decode_step``s of Yi-9B with its cache placed by ``cache_specs``."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import sharding as shd
    from repro_torch.dist.constrain import activation_sharding
    from repro_torch.lm import model
    from repro_torch.train import step

    torch.set_num_threads(1)  # four ranks share the host's cores
    data = dict(np.load(os.path.join(out_dir, "data.npz")))
    tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                             rank=rank, world_size=world)
    out = {}

    def load(arch):
        cfg = _lm_case(arch)
        state = {k[len(arch) + 3:]: torch.from_numpy(v) for k, v in data.items()
                 if k.startswith(f"{arch}/p/")}
        m = model.LM(cfg, device="cpu")
        m.load_state_dict(state, strict=True)
        return cfg, m

    def batch(arch, i, mesh=None):
        b = {k: torch.from_numpy(data[f"{arch}/b{i}/{k}"])
             for k in ("tokens", "labels")}
        if mesh is None:
            return b
        spec = (shd.batch_spec(mesh)[0], None)
        return {k: distribute_tensor(v, mesh, shd.placements(
            shd.enforce_divisibility(v.shape, spec, mesh), mesh))
            for k, v in b.items()}

    def full(m):
        return {n: p.full_tensor().detach().numpy()
                for n, p in m.named_parameters()}

    oc = step.OptConfig(compute_dtype="float32", lr=1e-3, warmup=2,
                        total_steps=10)
    cases = [("yi_9b", shape, 3) for shape in LM_MESHES]
    cases.append(("deepseek_v2_lite_16b", (2, 2), 1))
    for arch, shape, n_steps in cases:
        tag = f"{arch}/{shape[0]}x{shape[1]}"
        cfg, m = load(arch)
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=("data", "model"))
        specs = shd.shard_model(m, mesh)
        opt = step.init_opt(m)
        ts = step.make_train_step(cfg, oc)
        for i in range(n_steps):
            with activation_sharding(mesh):
                got = ts(m, opt, batch(arch, i, mesh))
            out[f"{tag}/loss{i}"] = np.float64(got["loss"])
            out[f"{tag}/gnorm{i}"] = np.float64(got["grad_norm"])
        for n, p in m.named_parameters():
            out[f"{tag}/local/{n}"] = np.array(p.to_local().shape)
            out[f"{tag}/spec/{n}"] = np.array(repr(specs[n]))
            assert all(type(q) is type(r) for q, r in zip(
                opt["m"][n].placements, p.placements))
        params = full(m)
        if rank == 0:
            for n, a in params.items():
                out[f"{tag}/p/{n}"] = a
    # decode on (2, 2): the cache's batch over data
    cfg, m = load("yi_9b")
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    shd.shard_model(m, mesh)
    toks = torch.from_numpy(data["yi_9b/decode_tokens"])
    cache = shd.shard_cache(model.init_cache(
        cfg, toks.shape[0], toks.shape[1] + 1, device="cpu",
        dtype=torch.float32), mesh)
    for t in range(toks.shape[1]):
        tok = distribute_tensor(toks[:, t:t + 1], mesh, shd.placements(
            (shd.batch_spec(mesh)[0], None), mesh))
        with activation_sharding(mesh):
            logits, cache = model.decode_step(m, cache, tok)
        out[f"decode/logits{t}"] = logits.full_tensor().numpy()
    out["decode/cache_local"] = np.array(
        cache["layers"][0]["k"].to_local().shape)
    np.savez(os.path.join(out_dir, f"lm_rank{rank}.npz"), **out)
    tdist.destroy_process_group()


PIPE_CASES = ((4, 6), (4, 2))   # (S, M): M > S and M < S


def pipe_inputs(s, m, mb=3, d=16):
    """The reference test's stage weights and microbatches, from numpy."""
    rng = np.random.default_rng(s * 10 + m)
    w = (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(m, mb, d)).astype(np.float32)
    return w, x


def run_torch_pipeline(out_dir, rank, world, init_file):
    import torch
    import torch.distributed as tdist

    from repro_torch.dist.pipeline import pipeline_apply

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                             rank=rank, world_size=world)
    out = {}
    for s, m in PIPE_CASES:
        w, x = pipe_inputs(s, m)
        got = pipeline_apply(lambda p, h: torch.tanh(h @ p),
                             torch.from_numpy(w[rank]), torch.from_numpy(x))
        out[f"{s}x{m}"] = got.numpy()
    np.savez(os.path.join(out_dir, f"pipe_rank{rank}.npz"), **out)
    tdist.destroy_process_group()


def run_jax_pipeline(out_path, d):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={d}"
    import jax
    import jax.numpy as jnp

    from repro.dist.pipeline import pipeline_apply

    mesh = jax.make_mesh((d,), ("pipe",))
    out = {}
    for s, m in PIPE_CASES:
        w, x = pipe_inputs(s, m)
        got = pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"]),
                             {"w": jnp.asarray(w)}, jnp.asarray(x), mesh)
        out[f"{s}x{m}"] = np.asarray(got)
    np.savez(out_path, **out)


def run_torch_dryrun(out_dir):
    """The port's dry run on fake process groups (one process): the
    reference test's cell, its argument bytes counted apart from the dry
    run's own sum, the (1, 1) FLOP identity, a product split on both axes
    of (16, 16), resume and the ``long_500k`` skip; a summary JSON."""
    import json

    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.lm import model
    from repro_torch.train import step

    summary = {}
    path = os.path.join(out_dir, "dr.json")
    summary["failures"] = dryrun.run(["olmo_1b"], ["train_4k", "long_500k"],
                                     ["single"], path, reduced_for_test=True)
    # the argument bytes apart: each parameter's and moment's local shard
    # from its spec, and the batch's rows over data
    cfg = reduced(get_config("olmo_1b"))
    sizes = {"data": 16, "model": 16}
    m = model.LM(cfg, device="meta")
    specs = shd.param_specs(m, mesh=sizes)
    per = 0
    for n, p in m.named_parameters():
        parts = int(np.prod([sizes[a] for e in specs[n]
                             for a in shd._axes_tuple(e)] or [1]))
        per += p.numel() // parts * 4
    # parameters and two moments, the int32 step, tokens and labels
    summary["argument_bytes_apart"] = (3 * per + 4
                                       + 2 * (256 // 16) * 4096 * 4)
    # resume: a second run re-runs no ok cell
    real = dryrun.lower_cell

    def refuse(*a, **k):
        raise AssertionError("an ok cell was run again")

    dryrun.lower_cell = refuse
    try:
        summary["resume_failures"] = dryrun.run(
            ["olmo_1b"], ["train_4k"], ["single"], path,
            reduced_for_test=True)
    finally:
        dryrun.lower_cell = real
    # the (1, 1) identity on a small train cell
    cell = ShapeCell("tiny", 64, 2, "train")
    dryrun.fake_world(1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    summary["flops_1x1"] = dryrun.lower_cell(
        cfg, cell, mesh)["per_device"]["flops"]
    plain = model.LM(cfg, device="meta")
    batch = {k: torch.empty((2, 64), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    counts = dryrun.Counters()
    with counts:
        step.make_train_step(cfg, step.OptConfig())(
            plain, step.init_opt(plain), batch)
    summary["flops_plain"] = counts.flops
    # a product split on both axes of (16, 16)
    dryrun.fake_world(256)
    mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"))
    a = distribute_tensor(torch.empty(4096, 512, device="meta"), mesh,
                          [Shard(0), Shard(1)])
    a = a.redistribute(mesh, [Shard(0), shd.placements((None,), mesh)[1]])
    b = distribute_tensor(torch.empty(512, 2048, device="meta"), mesh,
                          shd.placements((None, "model"), mesh))
    counts = dryrun.Counters()
    with counts:
        a @ b
    summary["matmul_flops_16x16"] = counts.flops
    summary["matmul_flops_whole"] = 2 * 4096 * 512 * 2048
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f)


if __name__ == "__main__":
    job = sys.argv[1]
    if job == "torch-dryrun":
        run_torch_dryrun(sys.argv[2])
    elif job in ("jax", "jax-compress", "jax-pipeline"):
        {"jax": run_jax, "jax-compress": run_jax_compress,
         "jax-pipeline": run_jax_pipeline}[job](sys.argv[2], int(sys.argv[3]))
    else:
        fn = {"torch-graph": run_torch_graph,
              "torch-stream": run_torch_stream,
              "torch-compress": run_torch_compress,
              "torch-lm": run_torch_lm,
              "torch-pipeline": run_torch_pipeline}[job]
        fn(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    print("OK")
