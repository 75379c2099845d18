"""Subprocess workers of the sharded-engine parity tests.

    python tests/dist_workers.py jax OUT.npz D
    python tests/dist_workers.py torch-graph OUT_DIR RANK WORLD INIT_FILE
    python tests/dist_workers.py torch-stream OUT_DIR RANK WORLD INIT_FILE
    python tests/dist_workers.py jax-compress OUT.npz D
    python tests/dist_workers.py torch-compress OUT_DIR RANK WORLD INIT_FILE

``jax`` computes the reference's sharded edge maps, delta-segment maps and
PageRank at D host devices (every layout's outputs under one ``jax.jit``,
its Pallas kernels in interpret mode: on ``ell`` one weighting per
reduction, as each interpreted kernel costs seconds to trace).  ``torch-graph`` and
``torch-stream`` are one rank of the port's engine in a gloo group (a
``file://`` rendezvous): the same cases, and the sharded stream against
the single-device service.  ``jax-compress`` and ``torch-compress`` are
the int8 compressed mean over D participants: the reference's
``compressed_psum`` under ``shard_map``, and one rank of the port's
``compressed_all_reduce`` in a gloo group.  Each writes its outputs to an npz file that the
tests compare.  Not collected by pytest (no ``test_`` prefix).
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


if __name__ == "__main__":
    job = sys.argv[1]
    if job in ("jax", "jax-compress"):
        {"jax": run_jax, "jax-compress": run_jax_compress}[job](
            sys.argv[2], int(sys.argv[3]))
    else:
        fn = {"torch-graph": run_torch_graph,
              "torch-stream": run_torch_stream,
              "torch-compress": run_torch_compress}[job]
        fn(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    print("OK")
