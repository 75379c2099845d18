"""The five apps of the port against ``repro``'s, on identical inputs.

Graphs and ELL tiles go in through ``repro_torch.convert``, so both sides
compute on the same arrays.  Each app runs on ``flat`` and on ``ell`` (the
plain K5 on the CPU) and is held to ``repro``'s result on the same backend
with the bands of tests/test_engine_backends.py: SSSP distances, BC levels
and Radii bitwise; PageRank and PR-delta within 1e-7; BC centrality within
rtol 1e-5, atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import apps as ref_apps  # noqa: E402
from repro.core import reorder as ref_reorder  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro_torch import apps  # noqa: E402
from repro_torch.apps.engine import EllBackend  # noqa: E402
from repro_torch.convert import graph_from_numpy, tiles_from_numpy  # noqa: E402

GRAPHS = ("kr", "lj", "road")
ORDERINGS = ("original", "dbg")
APPS = ("pr", "prd", "sssp", "bc", "radii")
PR_ITERS = 20  # PageRank is compared at tol=0 over a fixed count (see below)
RADII_SEED, RADII_SAMPLES = 0, 8


@functools.lru_cache(maxsize=None)
def _graph(key, ordering, weighted):
    g = (ref_datasets.load_weighted if weighted else ref_datasets.load)(
        key, "test")
    if ordering != "original":
        g, _ = ref_reorder.reorder_graph(g, ordering)
    return g


@functools.lru_cache(maxsize=None)
def _backends(key, ordering, weighted, backend):
    """(repro backend, port backend) over the same graph and tiles."""
    g = _graph(key, ordering, weighted)
    ref = ref_apps.to_arrays(g, backend=backend)
    pg = graph_from_numpy(g.in_csr.indptr, g.in_csr.indices, g.in_csr.weights,
                          g.out_csr.indptr, g.out_csr.indices,
                          g.out_csr.weights, g.name)
    if backend == "flat":
        return ref, apps.to_arrays(pg, device="cpu")
    tiles = tiles_from_numpy(
        [(np.asarray(t.rows), np.asarray(t.idx), np.asarray(t.deg),
          None if t.w is None else np.asarray(t.w), None)
         for t in ref.in_tiles], device="cpu")
    port = EllBackend(apps.to_arrays(pg, backend="arrays", device="cpu"), tiles)
    return ref, port


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("backend", ("flat", "ell"))
@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("key", GRAPHS)
def test_app_matches_reference(key, ordering, backend, app):
    ref, port = _backends(key, ordering, app == "sssp", backend)
    if app == "pr":
        # A float32 sum in another order can move the stop by one iteration,
        # so ranks are compared over a fixed count and the counts below.
        r1, _ = ref_apps.pagerank(ref, max_iters=PR_ITERS, tol=0.0)
        r2, it2 = apps.pagerank(port, max_iters=PR_ITERS, tol=0.0)
        assert it2 == PR_ITERS
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
        v = port.num_vertices
        # the reference's own draw (repro/apps/radii.py), handed to the port
        sources = jax.random.choice(jax.random.PRNGKey(RADII_SEED), v,
                                    shape=(RADII_SAMPLES,), replace=False)
        r1, i1 = ref_apps.radii(ref, jnp.int32(RADII_SEED),
                                num_samples=RADII_SAMPLES)
        r2, i2 = apps.radii(port, torch.from_numpy(np.array(sources)))
        assert int(i1) == i2
        np.testing.assert_array_equal(_np(r2), _np(r1))
        assert r2.dtype == torch.int32


@pytest.mark.parametrize("key", GRAPHS)
def test_pagerank_converges_in_the_same_iteration_count(key):
    ref, port = _backends(key, "dbg", False, "flat")
    r1, i1 = ref_apps.pagerank(ref)
    r2, i2 = apps.pagerank(port)
    assert int(i1) == i2
    np.testing.assert_allclose(_np(r2), _np(r1), rtol=0, atol=1e-7)


def test_port_builds_its_own_ell_tiles_and_agrees_with_flat():
    """``to_arrays(backend="ell")`` packs the tiles itself; the five apps on
    it agree with the port's flat oracle (the contract of the engine)."""
    g = _graph("lj", "dbg", True)
    pg = graph_from_numpy(g.in_csr.indptr, g.in_csr.indices, g.in_csr.weights,
                          g.out_csr.indptr, g.out_csr.indices,
                          g.out_csr.weights, g.name)
    fb = apps.to_arrays(pg, device="cpu")
    eb = apps.to_arrays(pg, backend="ell", device="cpu")
    assert isinstance(eb, EllBackend)
    np.testing.assert_allclose(_np(apps.pagerank(eb)[0]),
                               _np(apps.pagerank(fb)[0]), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(_np(apps.sssp(eb, 3)[0]),
                                  _np(apps.sssp(fb, 3)[0]))
    src = apps.radii_sources(pg.num_vertices, 8,
                             generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_np(apps.radii(eb, src)[0]),
                                  _np(apps.radii(fb, src)[0]))
    c1, d1, l1 = apps.bc(fb, 1)
    c2, d2, l2 = apps.bc(eb, 1)
    assert l1 == l2
    np.testing.assert_array_equal(_np(d1), _np(d2))
    np.testing.assert_allclose(_np(c2), _np(c1), rtol=1e-5, atol=1e-5)


def test_to_arrays_knobs_and_backends():
    pg = graph_from_numpy(*(a for c in (_graph("road", "original", False).in_csr,
                                        _graph("road", "original", False).out_csr)
                            for a in (c.indptr, c.indices, c.weights)))
    assert isinstance(apps.to_arrays(pg, device="cpu"), apps.FlatBackend)
    assert isinstance(apps.to_arrays(pg, backend="arrays", device="cpu"),
                      apps.GraphArrays)
    with pytest.raises(ValueError, match="unknown edge-map backend"):
        apps.to_arrays(pg, backend="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown backend knob"):
        apps.to_arrays(pg, backend="ell", device="cpu", interpret=True)
    with pytest.warns(UserWarning, match="row_tile"):
        apps.to_arrays(pg, device="cpu", row_tile=32)
    with pytest.raises(ValueError, match="no-ops"):
        apps.to_arrays(pg, device="cpu", strict=True, row_tile=32)
    eb = apps.to_arrays(pg, backend="ell", device="cpu", row_tile=32,
                        width_tile=64)
    assert (eb.row_tile, eb.width_tile) == (32, 64)
    ga = apps.to_arrays(pg, backend="arrays", device="cpu")
    assert ga.in_w is ga.out_w  # one ones plane for an unweighted graph


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_vertex_map_matches_the_reference(dtype):
    rng = np.random.default_rng(9)
    frontier = rng.random(257) < 0.4
    vals = (rng.normal(size=257) * 10).astype(dtype)
    want = np.asarray(ref_apps.engine.vertex_map(jnp.asarray(frontier),
                                                 lambda: jnp.asarray(vals)))
    got = apps.vertex_map(torch.from_numpy(frontier),
                          lambda: torch.from_numpy(vals)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_engine_exports_match_the_reference():
    """``vertex_map`` and the ``EdgeMapBackend`` protocol are exported as
    the reference exports them; every backend the port builds satisfies
    the protocol, a bare object does not."""
    from repro_torch.apps import engine

    assert apps.EdgeMapBackend is engine.EdgeMapBackend
    assert apps.vertex_map is engine.vertex_map
    assert {"EdgeMapBackend", "vertex_map"} <= set(engine.__all__)
    assert set(ref_apps.engine.__all__) <= set(engine.__all__)
    g = _graph("lj", "dbg", False)
    pg = graph_from_numpy(g.in_csr.indptr, g.in_csr.indices, g.in_csr.weights,
                          g.out_csr.indptr, g.out_csr.indices,
                          g.out_csr.weights, g.name)
    for backend in ("flat", "ell", "packed"):
        b = apps.to_arrays(pg, backend=backend, device="cpu")
        assert isinstance(b, apps.EdgeMapBackend), backend
    assert not isinstance(object(), apps.EdgeMapBackend)
