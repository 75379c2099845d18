"""The port's packed storage (``repro_torch.pack``) against ``repro.pack``.

The codec and the layout are numpy copies: their arrays must be bitwise
equal to the reference's.  ``PackedBackend`` and the five apps on it run on
the reference's own packed arrays, carried across by
``convert.packed_adjacency_from_numpy``, and are held to ``repro``'s packed
backend (K5 in Pallas interpret mode) in the bands of
tests/test_engine_backends.py: min/max bitwise, sums 2e-6 · (1 + max|y|),
PageRank / PR-delta 1e-7, BC centrality rtol/atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import apps as ref_apps  # noqa: E402
from repro.apps.engine import edge_map_pull as ref_pull  # noqa: E402
from repro.apps.engine import edge_map_push as ref_push  # noqa: E402
from repro.apps.engine import out_edge_sum as ref_out_edge_sum  # noqa: E402
from repro.core import reorder as ref_reorder  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.pack import codec as ref_codec  # noqa: E402
from repro.pack import engine as ref_engine  # noqa: E402
from repro.pack import layout as ref_layout  # noqa: E402
from repro_torch import apps  # noqa: E402
from repro_torch.apps.engine import (edge_map_pull, edge_map_push,  # noqa: E402
                                     out_edge_sum)
from repro_torch.convert import (graph_from_numpy,  # noqa: E402
                                 packed_adjacency_from_numpy)
from repro_torch.pack import codec, engine, layout  # noqa: E402

KEYS = ("kr", "lj", "road", "uni")
BOUNDARY_VALUES = [0, 1, 127, 128, 255, 256, 2 ** 14, 2 ** 16 - 1, 2 ** 16,
                   2 ** 24 - 1, 2 ** 24, 2 ** 31 - 1, 2 ** 32 - 1]


def _port_graph(g):
    return graph_from_numpy(g.in_csr.indptr, g.in_csr.indices,
                            g.in_csr.weights, g.out_csr.indptr,
                            g.out_csr.indices, g.out_csr.weights, g.name)


def _port_adj(a):
    """The reference's ``PackedAdjacency`` carried across as numpy arrays."""
    lists = a.cold.lists
    return packed_adjacency_from_numpy(
        num_vertices=a.num_vertices, num_edges=a.num_edges,
        boundaries=a.boundaries, hot_group_count=a.hot_group_count,
        hot=[dict(group=h.group, rows=h.rows, deg=h.deg, idx=h.idx, w=h.w)
             for h in a.hot],
        cold=dict(rows=a.cold.rows, deg=a.cold.deg, w=a.cold.w,
                  ctrl=lists.ctrl, data=lists.data, vpb=lists.vpb,
                  block_ctrl=lists.block_ctrl, block_data=lists.block_data),
        rows_per_block=lists.rows_per_block, weighted=a.weighted)


def _port_pg(pg):
    return layout.PackedGraph(in_adj=_port_adj(pg.in_adj),
                              out_adj=_port_adj(pg.out_adj), name=pg.name)


@functools.lru_cache(maxsize=None)
def _graph(key, technique, weighted=False):
    g = (ref_datasets.load_weighted if weighted else ref_datasets.load)(
        key, "test")
    if technique != "original":
        g, _ = ref_reorder.reorder_graph(g, technique)
    return g


def _eq(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _assert_lists_equal(ra, pa):
    for f in ("ctrl", "data", "vpb", "block_ctrl", "block_data"):
        _eq(getattr(ra, f), getattr(pa, f))
    assert (ra.rows_per_block, ra.num_rows) == (pa.rows_per_block, pa.num_rows)


def _assert_adj_equal(ra, pa):
    assert (ra.num_vertices, ra.num_edges, ra.boundaries, ra.hot_group_count,
            ra.weighted) == (pa.num_vertices, pa.num_edges, pa.boundaries,
                             pa.hot_group_count, pa.weighted)
    assert len(ra.hot) == len(pa.hot)
    for rh, ph in zip(ra.hot, pa.hot):
        assert rh.group == ph.group
        for f in ("rows", "deg", "idx", "w"):
            _eq(getattr(rh, f), getattr(ph, f))
    for f in ("rows", "deg", "w"):
        _eq(getattr(ra.cold, f), getattr(pa.cold, f))
    _assert_lists_equal(ra.cold.lists, pa.cold.lists)


# ------------------------------------------------------------------- codec
def test_codec_bitwise():
    for v in (0, 255, 256, 65_535, 65_536, 2 ** 32 - 1, 2 ** 32):
        assert codec.min_uint_dtype(v) == ref_codec.min_uint_dtype(v)
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 9, 40).astype(np.int64)
    vals = rng.integers(0, 2 ** 31, int(counts.sum())).astype(np.int64)
    vals[: len(BOUNDARY_VALUES)] = BOUNDARY_VALUES
    for rpb in (1, 4, 64):
        r = ref_codec.encode_values(vals, counts, rows_per_block=rpb)
        p = codec.encode_values(vals, counts, rows_per_block=rpb)
        _assert_lists_equal(r, p)
        _eq(ref_codec.decode_all(r), codec.decode_all(p))
        _eq(ref_codec.value_data_offsets(r), codec.value_data_offsets(p))
        for b in range(p.num_blocks):
            (rv, rf), (pv, pf) = (ref_codec.decode_block(r, b),
                                  codec.decode_block(p, b))
            _eq(rv, pv)
            assert rf == pf
    nb = np.concatenate([np.sort(rng.integers(0, 5000, c)) for c in counts])
    d = codec.delta_encode_rows(nb, counts)
    _eq(ref_codec.delta_encode_rows(nb, counts), d)
    _eq(ref_codec.delta_decode_values(d, counts),
        codec.delta_decode_values(d, counts))
    with pytest.raises(ValueError):
        codec.encode_values(np.array([2 ** 32]), np.array([1]))


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("technique", ["original", "dbg"])
@pytest.mark.parametrize("key", KEYS + ("kr_w",))
def test_pack_graph_bitwise(key, technique):
    weighted = key.endswith("_w")
    g = _graph(key.removesuffix("_w"), technique, weighted)
    ref = ref_layout.pack_graph(g)
    port = layout.pack_graph(_port_graph(g))
    assert port.name == ref.name
    for ra, pa in ((ref.in_adj, port.in_adj), (ref.out_adj, port.out_adj)):
        _assert_adj_equal(ra, pa)
        _eq(ra.degrees(), pa.degrees())
        assert ra.packing_factor == pa.packing_factor
        assert ra.nbytes() == pa.nbytes()
        for x, y in zip(ra.decode_edges(), pa.decode_edges()):
            _eq(x, y)
        for x, y in zip(ra.structure_addresses(), pa.structure_addresses()):
            _eq(x, y)
        rc, pc = ra.cold_csr(), pa.cold_csr()
        for f in ("indptr", "indices", "weights"):
            _eq(getattr(rc, f), getattr(pc, f))
    ru, pu = ref.unpack(), port.unpack()
    for rc, pc in ((ru.in_csr, pu.in_csr), (ru.out_csr, pu.out_csr)):
        for f in ("indptr", "indices", "weights"):
            _eq(getattr(rc, f), getattr(pc, f))
    assert ref.nbytes() == port.nbytes()
    assert layout.flat_csr_nbytes(_port_graph(g)) == ref_layout.flat_csr_nbytes(g)


def test_pack_knobs_and_id_widths_bitwise():
    """Non-default hot groups / stride / blocks, and the three id widths."""
    g = _graph("lj", "dbg")
    for kw in (dict(hot_groups=1, slot_align=4, rows_per_block=5),
               dict(hot_groups=3, slot_align=32, rows_per_block=16)):
        ref = ref_layout.pack_graph(g, **kw)
        port = layout.pack_graph(_port_graph(g), **kw)
        _assert_adj_equal(ref.in_adj, port.in_adj)
        _assert_adj_equal(ref.out_adj, port.out_adj)
    rng = np.random.default_rng(2)
    for v, want in ((200, np.uint8), (3_000, np.uint16), (70_000, np.uint32)):
        src = rng.integers(0, v, 4 * v)
        dst = np.minimum(rng.zipf(1.6, 4 * v) - 1, v - 1)
        # parallel edges with distinct weights: ties keep their CSR order
        rg = ref_csr.from_edges(src, dst, v, weights=rng.random(4 * v)
                                .astype(np.float32))
        ref = ref_layout.pack_adjacency(rg.in_csr)
        port = layout.pack_adjacency(_port_graph(rg).in_csr)
        _assert_adj_equal(ref, port)
        assert all(h.idx.dtype == want for h in port.hot)


# ------------------------------------------------------------------ engine
def _backends(key, technique, weighted):
    g = _graph(key, technique, weighted)
    ref_pg = ref_layout.pack_graph(g)
    return (ref_engine.packed_backend(ref_pg),
            engine.packed_backend(_port_pg(ref_pg), device="cpu"))


_BACKENDS = functools.lru_cache(maxsize=None)(_backends)


def _assert_agree(want, got, reduce):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    if reduce in ("min", "max"):
        np.testing.assert_array_equal(want, got)
    else:
        scale = 1.0 + np.abs(want[np.isfinite(want)]).max(initial=0.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


# (reduce, mode, graph, use_weights) — every reduction pulls and pushes once
EDGE_MAP_CASES = [
    ("sum", "pull", "kr", False),  # PageRank
    ("sum", "push", "lj", False),  # PR-delta / BC forward
    ("min", "pull", "kr", True),  # SSSP pull
    ("min", "push", "lj", True),  # SSSP push
    ("max", "pull", "lj", False),  # Radii / BFS levels
    ("max", "push", "kr", True),
]


@pytest.mark.parametrize("case", EDGE_MAP_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_packed_backend_edge_maps_match_reference(case):
    reduce, mode, key, use_w = case
    ref, port = _BACKENDS(key, "dbg", True)
    assert isinstance(port, engine.PackedBackend)
    for rt, pt in zip(ref.in_tiles, port.in_tiles):
        np.testing.assert_array_equal(np.asarray(rt.idx), pt.idx.numpy())
        np.testing.assert_array_equal(np.asarray(rt.deg), pt.deg.numpy())
    v = port.num_vertices
    rng = np.random.default_rng(EDGE_MAP_CASES.index(case))
    x = rng.random(v).astype(np.float32)
    neutral = {"sum": 0.0, "min": np.inf, "max": -np.inf}[reduce]
    kw = dict(reduce=reduce, use_weights=use_w, neutral=neutral)
    if mode == "pull":
        want = ref_pull(ref, jnp.asarray(x), **kw)
        got = edge_map_pull(port, torch.from_numpy(x), **kw)
    else:
        fr = rng.random(v) < 0.4
        init = rng.random(v).astype(np.float32)
        want = ref_push(ref, jnp.asarray(x), src_frontier=jnp.asarray(fr),
                        init=jnp.asarray(init), **kw)
        got = edge_map_push(port, torch.from_numpy(x),
                            src_frontier=torch.from_numpy(fr),
                            init=torch.from_numpy(init), **kw)
    _assert_agree(want, got, reduce)


@pytest.mark.parametrize("key", ["kr", "road"])
def test_out_edge_sum_matches_reference(key):
    ref, port = _BACKENDS(key, "dbg", False)
    rng = np.random.default_rng(3)
    v = port.num_vertices
    a = rng.random(v).astype(np.float32)
    b = rng.integers(0, 4, v).astype(np.int32)

    def ref_val(src, child):
        return jnp.where(b[child] == b[src] + 1, a[child] + 1.0, 0.0)

    def port_val(src, child):
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        return torch.where(bt[child] == bt[src] + 1, at[child] + 1.0, 0.0)

    want = np.asarray(ref_out_edge_sum(ref, ref_val))
    got = out_edge_sum(port, port_val).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * (1 + np.abs(want).max()))
    # flat storage takes the sorted-segment sum over the same edges
    flat = apps.to_arrays(_port_graph(port.packed.unpack()), device="cpu")
    np.testing.assert_allclose(out_edge_sum(flat, port_val).numpy(), want,
                               rtol=0, atol=2e-6 * (1 + np.abs(want).max()))


APPS = ("pr", "prd", "sssp", "bc", "radii")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("key", ["kr", "lj"])
def test_app_on_packed_matches_reference(key, app):
    ref, port = _BACKENDS(key, "dbg", app == "sssp")
    if app == "pr":
        r1, _ = ref_apps.pagerank(ref, max_iters=20, tol=0.0)
        r2, _ = apps.pagerank(port, max_iters=20, tol=0.0)
        np.testing.assert_allclose(_np(r2), _np(r1), rtol=0, atol=1e-7)
    elif app == "prd":
        r1, i1 = ref_apps.pagerank_delta(ref)
        r2, i2 = apps.pagerank_delta(port)
        np.testing.assert_allclose(_np(r2), _np(r1), rtol=0, atol=1e-7)
        assert abs(int(i1) - i2) <= 1
    elif app == "sssp":
        d1, i1 = ref_apps.sssp(ref, jnp.int32(0))
        d2, i2 = apps.sssp(port, 0)
        np.testing.assert_array_equal(_np(d2), _np(d1))
        assert int(i1) == i2
    elif app == "bc":
        c1, dist1, l1 = ref_apps.bc(ref, jnp.int32(0))
        c2, dist2, l2 = apps.bc(port, 0)
        assert int(l1) == l2
        np.testing.assert_array_equal(_np(dist2), _np(dist1))
        np.testing.assert_allclose(_np(c2), _np(c1), rtol=1e-5, atol=1e-5)
    else:
        sources = jax.random.choice(jax.random.PRNGKey(0), port.num_vertices,
                                    shape=(8,), replace=False)
        r1, i1 = ref_apps.radii(ref, jnp.int32(0), num_samples=8)
        r2, i2 = apps.radii(port, torch.from_numpy(np.array(sources)))
        assert int(i1) == i2
        np.testing.assert_array_equal(_np(r2), _np(r1))


def test_uint32_tables_through_the_int32_view():
    """V > 65,536: the hot slot tables are uint32, K5 takes them as an int32
    view, and ``packed`` agrees with the port's own ``flat``."""
    rng = np.random.default_rng(11)
    v, e = 70_000, 140_000
    src = rng.integers(0, v, e)
    dst = rng.integers(0, v, e)
    dst[::20] = rng.integers(0, 10, e // 20)  # ten hub rows of ~700 edges
    w = rng.integers(1, 16, e).astype(np.float32)
    g = _port_graph(ref_csr.from_edges(src, dst, v, weights=w, name="wide"))
    pb = apps.to_arrays(g, backend="packed", device="cpu")
    assert any(h.idx.dtype == np.uint32 for h in pb.packed.in_adj.hot)
    hot_tiles = pb.in_tiles[:len(pb.packed.in_adj.hot)]
    assert hot_tiles and all(t.idx.dtype == torch.int32 for t in hot_tiles)
    fb = apps.to_arrays(g, device="cpu")
    x = torch.from_numpy(rng.random(v).astype(np.float32))
    _assert_agree(fb.pull(x, reduce="sum"), pb.pull(x, reduce="sum"), "sum")
    for red in ("min", "max"):
        _assert_agree(fb.pull(x, reduce=red, use_weights=True),
                      pb.pull(x, reduce=red, use_weights=True), red)
    np.testing.assert_array_equal(_np(apps.sssp(pb, 1)[0]),
                                  _np(apps.sssp(fb, 1)[0]))
    c1, d1, l1 = apps.bc(fb, 1)
    c2, d2, l2 = apps.bc(pb, 1)
    assert l1 == l2
    np.testing.assert_array_equal(_np(d1), _np(d2))
    np.testing.assert_allclose(_np(c2), _np(c1), rtol=1e-5, atol=1e-5)


def test_uint8_tables_widen_for_k5():
    g = _port_graph(ref_csr.from_edges(*np.random.default_rng(4).integers(
        0, 200, (2, 2_000)), 200, name="tiny"))
    pb = apps.to_arrays(g, backend="packed", device="cpu")
    assert all(h.idx.dtype == np.uint8 for h in pb.packed.in_adj.hot)
    assert all(t.idx.dtype in (torch.uint16,) for t in pb.in_tiles)
    fb = apps.to_arrays(g, device="cpu")
    r1, _ = apps.pagerank(fb, max_iters=20, tol=0.0)
    r2, _ = apps.pagerank(pb, max_iters=20, tol=0.0)
    np.testing.assert_allclose(_np(r2), _np(r1), rtol=0, atol=1e-7)


def test_to_arrays_packed_knobs():
    g = _port_graph(_graph("road", "original"))
    pb = apps.to_arrays(g, backend="packed", device="cpu", row_tile=32,
                        width_tile=64, slot_align=8, hot_groups=2)
    assert isinstance(pb, engine.PackedBackend)
    assert (pb.row_tile, pb.width_tile) == (32, 64)
    assert pb.packed.in_adj.hot_group_count == 2
    assert pb.packed.in_adj.cold.lists.rows_per_block == 32
    assert pb.num_edges == g.num_edges and pb.device.type == "cpu"
    with pytest.raises(ValueError, match="no-ops"):
        apps.to_arrays(g, backend="ell", device="cpu", strict=True,
                       slot_align=8)
    with pytest.raises(ValueError, match="unknown backend knob"):
        apps.to_arrays(g, backend="packed", device="cpu", interpret=True)
