"""The port's copies of the graph and reordering modules give arrays bitwise
equal to ``repro``'s: every registry graph, every technique."""
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import reorder as ref_reorder  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.graph import generators as ref_generators  # noqa: E402
from repro_torch.core import reorder  # noqa: E402
from repro_torch.graph import csr, datasets, generators  # noqa: E402

KEYS = sorted(ref_datasets.REGISTRY)


def _assert_graph_equal(a, b):
    assert a.name == b.name
    for ca, cb in ((a.in_csr, b.in_csr), (a.out_csr, b.out_csr)):
        for fa, fb in ((ca.indptr, cb.indptr), (ca.indices, cb.indices)):
            assert fa.dtype == fb.dtype
            np.testing.assert_array_equal(fa, fb)
        assert (ca.weights is None) == (cb.weights is None)
        if ca.weights is not None:
            assert ca.weights.dtype == cb.weights.dtype
            np.testing.assert_array_equal(ca.weights, cb.weights)


@functools.lru_cache(maxsize=None)
def _pair(key):
    return ref_datasets.load(key, "test"), datasets.load(key, "test")


def _spec_tuple(spec):
    return (spec.key, spec.kind, spec.structured, spec.avg_degree,
            spec.synthetic, spec.size_mult, tuple(sorted(spec.extra.items())))


def test_registry_and_scales_unchanged():
    assert datasets.SCALES == ref_datasets.SCALES
    assert set(datasets.REGISTRY) == set(ref_datasets.REGISTRY)
    for k, spec in ref_datasets.REGISTRY.items():
        assert _spec_tuple(datasets.REGISTRY[k]) == _spec_tuple(spec)


@pytest.mark.parametrize("key", KEYS)
def test_registry_graph_bitwise(key):
    ref, port = _pair(key)
    _assert_graph_equal(ref, port)
    _assert_graph_equal(ref_datasets.load_weighted(key, "test"),
                        datasets.load_weighted(key, "test"))


@pytest.mark.parametrize("technique", sorted(ref_reorder.TECHNIQUES))
@pytest.mark.parametrize("key", KEYS)
def test_reorder_graph_bitwise(key, technique):
    ref, port = _pair(key)
    for source in ("out", "in"):
        g_ref, r_ref = ref_reorder.reorder_graph(ref, technique, seed=3,
                                                 degree_source=source)
        g_port, r_port = reorder.reorder_graph(port, technique, seed=3,
                                               degree_source=source)
        np.testing.assert_array_equal(r_ref.mapping, r_port.mapping)
        assert r_ref.mapping.dtype == r_port.mapping.dtype
        assert (r_ref.technique, r_ref.num_groups) == (r_port.technique,
                                                       r_port.num_groups)
        _assert_graph_equal(g_ref, g_port)


@pytest.mark.parametrize("avg", [0.3, 1.0, 2.4, 20.0, 137.5])
def test_dbg_spec_and_binning(avg):
    spec = reorder.dbg_spec(avg)
    assert spec.boundaries == ref_reorder.dbg_spec(avg).boundaries
    deg = np.random.default_rng(int(avg * 10)).integers(0, 4000, 5000)
    np.testing.assert_array_equal(
        reorder._assign_groups(deg, spec.boundaries),
        ref_reorder._assign_groups(deg, spec.boundaries))


def test_csr_primitives_bitwise():
    rng = np.random.default_rng(7)
    starts = rng.integers(0, 100, 50)
    counts = rng.integers(0, 6, 50)
    np.testing.assert_array_equal(csr.ragged_offsets(starts, counts),
                                  ref_csr.ragged_offsets(starts, counts))
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    w = rng.random(2000).astype(np.float32)
    a = ref_csr.from_edges(src, dst, 300, weights=w)
    b = csr.from_edges(src, dst, 300, weights=w)
    _assert_graph_equal(a, b)
    mapping = rng.permutation(300)
    _assert_graph_equal(ref_csr.relabel(a, mapping), csr.relabel(b, mapping))
    _assert_graph_equal(ref_generators.uniform_random(500, 4.0, seed=2),
                        generators.uniform_random(500, 4.0, seed=2))
