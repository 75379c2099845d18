"""K4 (the packed hot-segment SpMV) and ``pack_spmv`` against ``repro``'s.

The port's plain ``hot_spmv_ref`` — what ``hot_spmv`` runs for CPU tensors —
is held to the TPU kernel ``hot_spmv_pallas`` in interpret mode on every id
width the packed storage uses (uint8, uint16, uint32), weighted and not;
``pack_spmv`` runs on the reference's own packed arrays (carried across by
``convert.packed_adjacency_from_numpy``) and is held to ``repro``'s and to
the CSR oracle.  Sums agree within 2e-6 · (1 + max|y|), the reference's band
for a sum in another association (tests/test_engine_backends.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import reorder as ref_reorder  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.kernels.pack_spmv import ops as ref_ops  # noqa: E402
from repro.kernels.pack_spmv.pack_spmv import hot_spmv_pallas  # noqa: E402
from repro.pack import layout as ref_layout  # noqa: E402
from repro_torch.convert import packed_adjacency_from_numpy  # noqa: E402
from repro_torch.kernels.csr_spmv import csr_spmv_ref  # noqa: E402
from repro_torch.device import to_device  # noqa: E402
from repro_torch.kernels.pack_spmv import (decode_cold_tiles,  # noqa: E402
                                           hot_spmv, hot_spmv_ref,
                                           ids_as_int64, pack_spmv)


def _close(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    scale = 1.0 + np.abs(want).max(initial=0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


# (V, id dtype): the three widths min_uint_dtype gives the packed storage
ID_CASES = [(200, np.uint8), (777, np.uint16), (70_000, np.uint32)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("r,w,rt,wt", [(128, 128, 64, 128), (64, 256, 64, 128),
                                       (8, 24, 8, 8)])
@pytest.mark.parametrize("v,dtype", ID_CASES, ids=lambda c: str(c))
def test_hot_spmv_plain_matches_pallas(v, dtype, r, w, rt, wt, weighted):
    rng = np.random.default_rng(r + w + weighted + v)
    x = rng.normal(size=v).astype(np.float32)
    idx = rng.integers(0, v, (r, w)).astype(dtype)
    deg = rng.integers(0, w + 1, r).astype(np.int32)
    wgt = rng.random((r, w)).astype(np.float32) if weighted else None
    want = hot_spmv_pallas(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(deg),
                           None if wgt is None else jnp.asarray(wgt),
                           row_tile=rt, width_tile=wt)
    t_idx = to_device(idx, "cpu")
    assert t_idx.dtype == {np.uint8: torch.uint8, np.uint16: torch.uint16,
                           np.uint32: torch.uint32}[dtype]
    got = hot_spmv(torch.from_numpy(x), t_idx, torch.from_numpy(deg),
                   None if wgt is None else torch.from_numpy(wgt),
                   row_tile=rt, width_tile=wt)
    _close(want, got)
    np.testing.assert_array_equal(
        got.numpy(), hot_spmv_ref(torch.from_numpy(x), t_idx,
                                  torch.from_numpy(deg),
                                  None if wgt is None
                                  else torch.from_numpy(wgt)).numpy())


def test_ids_are_indices_not_masks():
    """A uint8 plane indexes x; torch alone would read it as a mask."""
    idx = torch.tensor([[1, 0, 2]], dtype=torch.uint8)
    np.testing.assert_array_equal(ids_as_int64(idx).numpy(), [[1, 0, 2]])
    big = torch.from_numpy(np.array([[0, 2 ** 31 - 1]], np.uint32))
    np.testing.assert_array_equal(ids_as_int64(big).numpy(),
                                  [[0, 2 ** 31 - 1]])
    x = torch.tensor([10.0, 20.0, 30.0])
    y = hot_spmv(x, idx, torch.tensor([3], dtype=torch.int32), row_tile=1,
                 width_tile=3)
    assert float(y[0]) == 60.0


def test_hot_spmv_wrapper_checks():
    x = torch.ones(4)
    idx = torch.zeros((8, 8), dtype=torch.uint16)
    deg = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        hot_spmv(x, idx, deg, row_tile=16, width_tile=8)
    before = hot_spmv.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        hot_spmv(x.to("meta"), idx.to("meta"), deg.to("meta"), row_tile=8,
                 width_tile=8)
    assert hot_spmv.launches == before


def _port_adj(a):
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


@functools.lru_cache(maxsize=None)
def _packed(key, weighted):
    g = (ref_datasets.load_weighted if weighted else ref_datasets.load)(
        key, "test")
    g, _ = ref_reorder.reorder_graph(g, "dbg", degree_source="in")
    return g, ref_layout.pack_graph(g)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("key", ["wl", "kr", "road"])
def test_pack_spmv_matches_reference_and_csr_oracle(key, weighted):
    g, pg = _packed(key, weighted)
    adj = _port_adj(pg.in_adj)
    for a, b in zip(ref_ops.decode_cold_tiles(pg.in_adj),
                    decode_cold_tiles(adj)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(5).normal(size=g.num_vertices).astype(np.float32)
    want = ref_ops.pack_spmv(jnp.asarray(x), pg.in_adj)
    got = pack_spmv(torch.from_numpy(x), adj)
    _close(want, got)
    c = g.in_csr
    w = (torch.from_numpy(c.weights) if c.weights is not None
         else torch.ones(c.num_edges))
    oracle = csr_spmv_ref(torch.from_numpy(x), torch.from_numpy(c.indices),
                          torch.from_numpy(c.indptr), w)
    _close(oracle, got)


def test_pack_spmv_over_uint8_and_uint32_tables():
    """The port's own packing at the smallest and the widest id width."""
    from repro_torch.graph import csr
    from repro_torch.pack import pack_graph

    rng = np.random.default_rng(7)
    for v, dtype in ((150, np.uint8), (70_000, np.uint32)):
        e = 12 * v
        src, dst = rng.integers(0, v, e), rng.integers(0, v, e)
        dst[::10] = rng.integers(0, 50, e // 10)  # hub rows
        g = csr.from_edges(src, dst, v,
                           weights=rng.random(e).astype(np.float32))
        adj = pack_graph(g).in_adj
        assert all(h.idx.dtype == dtype for h in adj.hot) and adj.hot
        x = torch.from_numpy(rng.random(v).astype(np.float32))
        c = g.in_csr
        _close(csr_spmv_ref(x, torch.from_numpy(c.indices),
                            torch.from_numpy(c.indptr),
                            torch.from_numpy(c.weights)),
               pack_spmv(x, adj))
