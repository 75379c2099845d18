"""The device-side input builder gives the program's own arrays."""
import numpy as np
import pytest
import torch

from bench.lib import inputs


def _random_edges(v, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, m, dtype=np.int64),
            rng.integers(0, v, m, dtype=np.int64))


@pytest.mark.parametrize("v,m,seed", [(16, 200, 0), (300, 2000, 1),
                                      (1000, 500, 2)])
def test_dedup_matches_the_program_generator(v, m, seed):
    from repro_torch.graph.generators import _dedup

    src, dst = _random_edges(v, m, seed)
    want = _dedup(src, dst)
    got = inputs.dedup_first(torch.from_numpy(src), torch.from_numpy(dst), v)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("v,m,seed", [(1, 0, 0), (50, 400, 3),
                                      (777, 5000, 4)])
def test_graph_arrays_equal_from_edges(v, m, seed, weighted):
    from repro_torch.graph import csr

    src, dst = _random_edges(v, m, seed)
    w = (np.random.default_rng(seed).integers(1, 17, m).astype(np.float32)
         if weighted else None)
    want = csr.from_edges(src, dst, v, weights=w)
    got = inputs.make_graph(
        inputs.EdgeList(torch.from_numpy(src), torch.from_numpy(dst), v),
        None if w is None else torch.from_numpy(w))
    for a, b in ((got.in_csr, want.in_csr), (got.out_csr, want.out_csr)):
        for name in ("indptr", "indices", "weights"):
            x, y = getattr(a, name), getattr(b, name)
            if y is None:
                assert x is None
                continue
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y)


def _rmat(seed, device="cpu", log2=10, e=4096):
    return inputs.rmat_edges(log2, e, a=0.57, b=0.19, c=0.19, oversample=2.0,
                             gen=inputs.generator(seed, "graph", device),
                             device=device)


def test_rmat_has_exactly_the_edges_asked_for_and_no_repeats():
    g = _rmat(2**31 + 17)
    assert g.src.numel() == g.dst.numel() == 4096
    assert bool((g.src != g.dst).all())
    code = g.src * g.num_vertices + g.dst
    assert torch.unique(code).numel() == 4096
    assert int(g.src.min()) >= 0 and int(g.dst.max()) < 1024


def test_rmat_follows_the_seed():
    a, b, c = _rmat(5), _rmat(5), _rmat(6)
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert not torch.equal(a.src, c.src)


def test_rmat_raises_when_the_draw_falls_short():
    with pytest.raises(ValueError, match="oversampling"):
        inputs.rmat_edges(6, 60 * 63, a=0.57, b=0.19, c=0.19,
                          oversample=1.0,
                          gen=inputs.generator(0, "graph", "cpu"),
                          device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31 + 5, 2**40, -3])
def test_derived_seeds_fit_a_generator(seed):
    s = inputs.derive_seed(seed, "graph")
    assert 0 <= s < 2**63
    assert s != inputs.derive_seed(seed, "jobs")
    torch.Generator().manual_seed(s)


def test_integer_weights_are_whole_and_in_range():
    w = inputs.integer_weights(10000, 1, 16, inputs.generator(3, "w", "cpu"),
                               "cpu")
    assert w.dtype == torch.float32
    assert float(w.min()) == 1.0 and float(w.max()) == 16.0
    assert torch.equal(w, w.round())


@pytest.mark.cuda
def test_card_builder_gives_from_edges_arrays(cuda):
    from repro_torch.graph import csr

    g = _rmat(9, device=cuda, log2=12, e=30000)
    w = inputs.integer_weights(30000, 1, 16, inputs.generator(9, "w", cuda),
                               cuda)
    got = inputs.make_graph(g, w)
    want = csr.from_edges(g.src.cpu().numpy(), g.dst.cpu().numpy(),
                          g.num_vertices, weights=w.cpu().numpy())
    for a, b in ((got.in_csr, want.in_csr), (got.out_csr, want.out_csr)):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.weights, b.weights)
