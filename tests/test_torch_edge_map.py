"""The port's ELL packer and fused edge-map driver against ``repro``'s.

Tile planes must be bitwise equal (geometry, id width, degrees, weights);
``fused_edge_map`` must agree on identical tiles — min/max bitwise, sums in
the reference's band ``2e-6 · (1 + max|y|)`` (tests/test_engine_backends.py).
The JAX side runs K5 in interpret mode, as its own tests do.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.reorder import dbg_spec as ref_dbg_spec  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.kernels.edge_map import ops as ref_ops  # noqa: E402
from repro_torch.convert import graph_from_numpy, tiles_from_numpy  # noqa: E402
from repro_torch.core.reorder import dbg_spec  # noqa: E402
from repro_torch.kernels.edge_map import ops  # noqa: E402
from repro_torch.kernels.edge_map import edge_map_tile_bytes  # noqa: E402


def _port_graph(g):
    return graph_from_numpy(g.in_csr.indptr, g.in_csr.indices,
                            g.in_csr.weights, g.out_csr.indptr,
                            g.out_csr.indices, g.out_csr.weights, g.name)


def _wide_graph():
    """V > 65535, so the packer must store int32 ids."""
    rng = np.random.default_rng(11)
    v = 70_000
    src = rng.integers(0, v, 60_000)
    dst = np.minimum(rng.zipf(1.6, 60_000) - 1, v - 1)  # a few hub rows
    return ref_csr.from_edges(src, dst, v, weights=rng.random(60_000)
                              .astype(np.float32) + 0.5, name="wide")


@functools.lru_cache(maxsize=None)
def _graph(name):
    if name == "wide":
        return _wide_graph()
    if name == "lj_w":
        return ref_datasets.load_weighted("lj", "test")
    return ref_datasets.load(name, "test")


def _assert_tiles_equal(ref_tiles, port_tiles):
    assert len(ref_tiles) == len(port_tiles)
    for rt, pt in zip(ref_tiles, port_tiles):
        np.testing.assert_array_equal(np.asarray(rt.rows), pt.rows.numpy())
        ridx = np.asarray(rt.idx)
        assert pt.idx.numpy().dtype == ridx.dtype
        np.testing.assert_array_equal(ridx, pt.idx.numpy())
        np.testing.assert_array_equal(np.asarray(rt.deg), pt.deg.numpy())
        for a, b in ((rt.w, pt.w), (rt.alive, pt.alive)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.asarray(a).dtype == b.numpy().dtype
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("geometry", [(64, 128), (8, 16)])
@pytest.mark.parametrize("name", ["kr", "lj_w", "road", "wide"])
def test_ell_tiles_bitwise(name, geometry):
    row_tile, width_tile = geometry
    g = _graph(name)
    deg = g.in_csr.degrees()
    bounds = ref_dbg_spec(max(1.0, float(deg.mean()))).boundaries
    assert dbg_spec(max(1.0, float(deg.mean()))).boundaries == bounds
    alive = np.random.default_rng(1).random(g.num_edges) < 0.9
    for alive_edges in (None, alive):
        ref_tiles = ref_ops.ell_tiles(g.in_csr, bounds, row_tile=row_tile,
                                      width_tile=width_tile,
                                      alive_edges=alive_edges)
        port_tiles = ops.ell_tiles(_port_graph(g).in_csr, bounds,
                                   row_tile=row_tile, width_tile=width_tile,
                                   alive_edges=alive_edges, device="cpu")
        _assert_tiles_equal(ref_tiles, port_tiles)
        want = np.uint16 if name != "wide" else np.int32
        assert all(t.idx.numpy().dtype == want for t in port_tiles)
        for kw in (dict(use_weights=True, frontier=True, push_init=True),
                   dict(plane_k=8, frontier=True, frontier_planar=True)):
            assert (ops.fused_edge_map_bytes(port_tiles, g.num_vertices, **kw)
                    == ref_ops.fused_edge_map_bytes(ref_tiles, g.num_vertices,
                                                    **kw))
    assert edge_map_tile_bytes(64, 128, 1000, weighted=True, frontier=True,
                               alive=True, init=True, idx_itemsize=2,
                               plane_k=8, frontier_planar=True) == (
        ref_ops.edge_map_tile_bytes(64, 128, 1000, weighted=True,
                                    frontier=True, alive=True, init=True,
                                    idx_itemsize=2, plane_k=8,
                                    frontier_planar=True))


@pytest.mark.parametrize("geometry", [(64, 128), (8, 16)])
@pytest.mark.parametrize("name", ["kr", "road", "wide"])
def test_ell_tiles_segment_lists_cover_each_row_once(name, geometry):
    """A class wider than 1,024 lanes carries K5's segment list: every row's
    lanes [0, deg) (padding rows included) exactly once, rows in order, each
    row's pieces in lane order from lane 0, none longer than SEGMENT_LANES;
    narrower classes carry none."""
    from repro_torch.kernels.edge_map import SEGMENT_LANES

    row_tile, width_tile = geometry
    g = _graph(name)
    bounds = dbg_spec(max(1.0, float(g.in_csr.degrees().mean()))).boundaries
    tiles = ops.ell_tiles(_port_graph(g).in_csr, bounds, row_tile=row_tile,
                          width_tile=width_tile, device="cpu")
    wide = 0
    for t in tiles:
        r_pad, w_pad = t.idx.shape
        if w_pad <= 1024:
            assert t.segments is None
            continue
        wide += 1
        seg = t.segments.numpy()
        assert seg.dtype == np.int32 and seg.shape[1] == 3
        row, lo, hi = seg.T.astype(np.int64)
        np.testing.assert_array_equal(np.unique(row), np.arange(r_pad))
        assert np.all(np.diff(row) >= 0)
        first = np.r_[True, row[1:] != row[:-1]]
        np.testing.assert_array_equal(lo[first], 0)
        np.testing.assert_array_equal(lo[~first], hi[np.flatnonzero(~first) - 1])
        last = np.r_[row[1:] != row[:-1], True]
        np.testing.assert_array_equal(hi[last], t.deg.numpy()[row[last]])
        assert np.all(hi - lo <= SEGMENT_LANES) and np.all(hi >= lo)
        assert np.any(hi - lo == 0) == np.any(t.deg.numpy() == 0)
    assert wide == (name == "wide")


def test_tiles_from_numpy_carry_the_segment_lists_of_ell_tiles():
    """The reference's tiles brought across by ``tiles_from_numpy`` carry the
    segment lists the port's own ``ell_tiles`` builds: none at 1,024 lanes or
    fewer, bitwise equal above."""
    g = _graph("wide")
    bounds = ref_dbg_spec(max(1.0, float(g.in_csr.degrees().mean()))).boundaries
    copied = tiles_from_numpy(
        [(np.asarray(t.rows), np.asarray(t.idx), np.asarray(t.deg), None, None)
         for t in ref_ops.ell_tiles(g.in_csr, bounds)], device="cpu")
    own = ops.ell_tiles(_port_graph(g).in_csr, bounds, device="cpu")
    assert len(copied) == len(own)
    wide = 0
    for a, b in zip(copied, own):
        assert (a.segments is None) == (b.segments is None)
        if b.segments is not None:
            wide += 1
            assert torch.equal(a.segments, b.segments)
    assert wide > 0


def test_pad_and_id_width_rules():
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 127, 128, 129, 1000):
        for tile in (8, 64, 128):
            assert ops._pad_dim(n, tile) == ref_ops._pad_dim(n, tile)
            assert ops._tile_of(n, tile) == ref_ops._tile_of(n, tile)
    for v in (1, 65_535, 65_536, 1 << 21):
        assert ops._id_dtype(v) == ref_ops._id_dtype(v)


def _assert_agree(want, got, reduce):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    if reduce in ("min", "max"):
        np.testing.assert_array_equal(want, got)
    else:
        scale = 1.0 + np.abs(want[np.isfinite(want)]).max(initial=0.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


# (reduce, mode, graph, use_weights, frontier, plane_k, identity, alive)
FUSED_CASES = [
    ("sum", "pull", "lj", False, None, 1, None, False),  # PageRank
    ("sum", "push", "lj", False, "shared", 1, None, False),  # PR-delta / BC
    ("min", "pull", "lj_w", True, "shared", 1, None, False),  # SSSP pull
    ("min", "push", "lj_w", True, "shared", 1, None, False),  # SSSP push
    ("max", "pull", "lj", False, None, 8, -128.0, False),  # Radii's plane
    ("max", "push", "lj", False, "planar", 4, None, False),
    ("sum", "pull", "kr", True, "planar", 4, None, False),
    ("min", "pull", "lj_w", True, None, 1, None, True),  # alive bitplane
]


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_edge_map_matches_reference(case):
    reduce, mode, name, use_weights, frontier, k, identity, with_alive = case
    g = _graph(name)
    v = g.num_vertices
    bounds = ref_dbg_spec(max(1.0, float(g.in_csr.degrees().mean()))).boundaries
    alive = (np.random.default_rng(5).random(g.num_edges) < 0.8
             if with_alive else None)
    ref_tiles = ref_ops.ell_tiles(g.in_csr, bounds, alive_edges=alive)
    port_tiles = tiles_from_numpy(
        [(np.asarray(t.rows), np.asarray(t.idx), np.asarray(t.deg),
          None if t.w is None else np.asarray(t.w),
          None if t.alive is None else np.asarray(t.alive))
         for t in ref_tiles], device="cpu")
    rng = np.random.default_rng(FUSED_CASES.index(case))
    shape = (v,) if k == 1 else (v, k)
    x = rng.random(shape).astype(np.float32)
    if identity is not None:  # int8-sourced reachability plane
        x = (rng.random(shape) < 0.3).astype(np.float32)
    fr = None
    if frontier is not None:
        fr = rng.random((v,) if frontier == "shared" else shape) < 0.4
    init = rng.random(shape).astype(np.float32) if mode == "push" else None
    neutral = {"sum": 0.0, "min": np.inf, "max": -np.inf}[reduce]
    kw = dict(reduce=reduce, use_weights=use_weights, neutral=neutral,
              identity=identity)
    want = ref_ops.fused_edge_map(
        ref_tiles, jnp.asarray(x), v,
        src_frontier=None if fr is None else jnp.asarray(fr),
        init=None if init is None else jnp.asarray(init), **kw)
    init_t = None if init is None else torch.from_numpy(init)
    got = ops.fused_edge_map(
        port_tiles, torch.from_numpy(x), v,
        src_frontier=None if fr is None else torch.from_numpy(fr),
        init=init_t, **kw)
    _assert_agree(want, got.numpy(), reduce)
    if init is not None:  # the caller's init is left as it was
        np.testing.assert_array_equal(init_t.numpy(), init)
