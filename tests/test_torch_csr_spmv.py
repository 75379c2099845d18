"""K1 (the degree-binned ELL SpMV), its packer and ``dbg_spmv`` against
``repro``'s.

The port's plain ``ell_spmv_ref`` — what ``ell_spmv`` runs for CPU tensors —
is held to the TPU kernel ``ell_spmv_pallas`` in interpret mode; the
vectorised ``ell_pack_groups`` must give the reference loop's arrays
bitwise, plus each row's true degree; ``dbg_spmv`` runs on the reference's
own groups (carried across by ``convert.ell_groups_from_numpy``, no degrees:
every lane is read) and on the port's (with degrees: only the real lanes).  Sums agree within 2e-6 · (1 + max|y|),
the reference's band for a sum in another association.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps import to_arrays as ref_to_arrays  # noqa: E402
from repro.core.reorder import dbg_spec, reorder_graph  # noqa: E402
from repro.graph import csr as ref_csr  # noqa: E402
from repro.graph import datasets as ref_datasets  # noqa: E402
from repro.kernels.csr_spmv import ops as ref_ops  # noqa: E402
from repro.kernels.csr_spmv.csr_spmv import ell_spmv_pallas  # noqa: E402
from repro.kernels.csr_spmv.ref import csr_spmv_ref as ref_csr_spmv  # noqa: E402
from repro_torch.convert import (ell_groups_from_numpy,  # noqa: E402
                                 graph_from_numpy)
from repro_torch.kernels.csr_spmv import (csr_spmv_ref, dbg_spmv,  # noqa: E402
                                          ell_pack_groups, ell_spmv,
                                          ell_spmv_ref)


def _close(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    fin = np.isfinite(want)
    scale = 1.0 + np.abs(want[fin]).max(initial=0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("r,w,rt,wt", [(128, 128, 64, 128), (256, 512, 64, 128),
                                       (64, 256, 64, 256), (8, 16, 8, 8)])
def test_ell_spmv_plain_matches_pallas(r, w, rt, wt):
    rng = np.random.default_rng(r * w)
    x = rng.normal(size=4096).astype(np.float32)
    idx = rng.integers(0, 4096, (r, w)).astype(np.int32)
    wgt = (rng.random((r, w)) > 0.5).astype(np.float32)
    want = ell_spmv_pallas(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(wgt),
                           row_tile=rt, width_tile=wt)
    got = ell_spmv(torch.from_numpy(x), torch.from_numpy(idx),
                   torch.from_numpy(wgt), row_tile=rt, width_tile=wt)
    _close(want, got)
    np.testing.assert_array_equal(
        got.numpy(), ell_spmv_ref(torch.from_numpy(x), torch.from_numpy(idx),
                                  torch.from_numpy(wgt)).numpy())


def test_padding_is_read_so_a_non_finite_x0_propagates():
    """K1 has no degree mask: padding (id 0, weight 0) reads x[0], and
    0 · inf is NaN on both sides, as on the TPU."""
    x = np.array([np.inf, 1.0, 2.0, 3.0], np.float32)
    idx = np.array([[1, 2, 0, 0], [3, 1, 2, 3]], np.int32)
    wgt = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
    want = np.asarray(ell_spmv_pallas(jnp.asarray(x), jnp.asarray(idx),
                                      jnp.asarray(wgt), row_tile=2,
                                      width_tile=4))
    got = ell_spmv(torch.from_numpy(x), torch.from_numpy(idx),
                   torch.from_numpy(wgt), row_tile=2, width_tile=4).numpy()
    assert np.isnan(want[0]) and np.isnan(got[0])
    assert want[1] == got[1] == 9.0
    # With the degrees, the padded row's one x[0] * 0 term keeps it NaN; the
    # full row reads no padding and stays finite.
    deg = torch.tensor([2, 4], dtype=torch.int32)
    for y in (ell_spmv(torch.from_numpy(x), torch.from_numpy(idx),
                       torch.from_numpy(wgt), deg=deg, row_tile=2,
                       width_tile=4).numpy(),
              ell_spmv_ref(torch.from_numpy(x), torch.from_numpy(idx),
                           torch.from_numpy(wgt), deg=deg).numpy()):
        assert np.isnan(y[0]) and y[1] == 9.0


def test_ell_spmv_wrapper_checks():
    x = torch.ones(4)
    idx = torch.zeros((8, 8), dtype=torch.int32)
    w = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="multiple"):
        ell_spmv(x, idx, w, row_tile=8, width_tile=16)
    before = ell_spmv.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        ell_spmv(x.to("meta"), idx.to("meta"), w.to("meta"), row_tile=8,
                 width_tile=8)
    assert ell_spmv.launches == before


@functools.lru_cache(maxsize=None)
def _graph(key, weighted):
    if key == "hub":  # in-degrees up to ~10^4: a group wider than 1,024 lanes
        rng = np.random.default_rng(11)
        src = rng.integers(0, 20_000, 40_000)
        dst = np.minimum(rng.zipf(1.6, 40_000) - 1, 19_999)
        g = ref_csr.from_edges(src, dst, 20_000, name="hub")
    else:
        g = (ref_datasets.load_weighted if weighted else ref_datasets.load)(
            key, "test")
    g2, _ = reorder_graph(g, "dbg", degree_source="in")
    return g2


def _port_graph(g):
    return graph_from_numpy(g.in_csr.indptr, g.in_csr.indices,
                            g.in_csr.weights, g.out_csr.indptr,
                            g.out_csr.indices, g.out_csr.weights, g.name)


@pytest.mark.parametrize("geometry", [(64, 128), (8, 16)])
@pytest.mark.parametrize("key", ["wl", "kr", "road", "kr_w", "hub"])
def test_ell_pack_groups_bitwise(key, geometry):
    rt, wt = geometry
    g = _graph(key.removesuffix("_w"), key.endswith("_w"))
    bounds = dbg_spec(max(1.0, g.in_degrees().mean())).boundaries
    ref = ref_ops.ell_pack_groups(g, bounds, row_tile=rt, width_tile=wt)
    port = ell_pack_groups(_port_graph(g), bounds, row_tile=rt, width_tile=wt,
                           device="cpu")
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert a.num_rows == b.num_rows
        np.testing.assert_array_equal(a.rows, b.rows.numpy())
        for ra, pb in ((a.idx, b.idx), (a.w, b.w)):
            assert ra.dtype == pb.numpy().dtype
            np.testing.assert_array_equal(ra, pb.numpy())


@pytest.mark.parametrize("geometry", [(64, 128), (8, 16)])
@pytest.mark.parametrize("key", ["kr", "lj", "road", "kr_w", "hub"])
def test_ell_pack_groups_keep_true_degrees(key, geometry):
    """``deg`` is each row's in-CSR degree, 0 on padding rows, and every
    lane at or past it is (0, 0.0): what K1's degree walk relies on.  A
    group whose longest row passes 1,024 lanes carries its segment list:
    each row's [0, deg) once, in order, in pieces of SEGMENT_LANES at
    most."""
    from repro_torch.kernels.edge_map import SEGMENT_LANES, row_segments

    rt, wt = geometry
    g = _graph(key.removesuffix("_w"), key.endswith("_w"))
    bounds = dbg_spec(max(1.0, g.in_degrees().mean())).boundaries
    in_deg = g.in_csr.degrees()
    wide = 0
    for gr in ell_pack_groups(_port_graph(g), bounds, row_tile=rt,
                              width_tile=wt, device="cpu"):
        r_pad, w_pad = gr.idx.shape
        assert gr.deg.dtype == torch.int32 and gr.deg.shape == (r_pad,)
        d = gr.deg.numpy()
        np.testing.assert_array_equal(d[: gr.num_rows],
                                      in_deg[gr.rows.numpy()])
        np.testing.assert_array_equal(d[gr.num_rows:], 0)
        pad = np.arange(w_pad)[None, :] >= d[:, None]
        assert not gr.idx.numpy()[pad].any() and not gr.w.numpy()[pad].any()
        assert gr.max_deg == d.max()
        if gr.max_deg <= 1024:
            assert gr.segments is None
            continue
        wide += 1
        seg = gr.segments.numpy()
        np.testing.assert_array_equal(seg, row_segments(d))
        row, lo, hi = seg.T.astype(np.int64)
        np.testing.assert_array_equal(np.bincount(row, hi - lo, r_pad), d)
        assert np.all(np.diff(row) >= 0) and np.all(hi - lo <= SEGMENT_LANES)
        assert np.all(lo[1:][row[1:] == row[:-1]]
                      == hi[:-1][row[1:] == row[:-1]])
    assert (wide > 0) == (key == "hub")


@pytest.mark.parametrize("key", ["kr", "lj", "road"])
def test_ell_spmv_with_degrees_matches_every_lane_and_pallas(key):
    """The degree walk's plain version against the every-lane path and the
    TPU kernel (interpret mode) on the same DBG groups."""
    g = _graph(key, False)
    bounds = dbg_spec(max(1.0, g.in_degrees().mean())).boundaries
    x = np.random.default_rng(7).normal(size=g.num_vertices).astype(np.float32)
    xt = torch.from_numpy(x)
    for gr in ell_pack_groups(_port_graph(g), bounds, row_tile=64,
                              width_tile=128, device="cpu"):
        got = ell_spmv(xt, gr.idx, gr.w, deg=gr.deg, row_tile=64,
                       width_tile=128)
        np.testing.assert_array_equal(
            got.numpy(), ell_spmv_ref(xt, gr.idx, gr.w, deg=gr.deg).numpy())
        _close(ell_spmv_ref(xt, gr.idx, gr.w).numpy(), got)
        want = ell_spmv_pallas(jnp.asarray(x), jnp.asarray(gr.idx.numpy()),
                               jnp.asarray(gr.w.numpy()), row_tile=64,
                               width_tile=128)
        _close(want, got)


@pytest.mark.parametrize("key", ["wl", "kr", "kr_w"])
def test_dbg_spmv_matches_reference_and_csr_oracle(key):
    g = _graph(key.removesuffix("_w"), key.endswith("_w"))
    bounds = dbg_spec(max(1.0, g.in_degrees().mean())).boundaries
    ref_groups = ref_ops.ell_pack_groups(g, bounds, row_tile=64, width_tile=128)
    groups = ell_groups_from_numpy(
        [(gr.rows, gr.idx, gr.w, gr.num_rows) for gr in ref_groups], "cpu")
    x = np.random.default_rng(1).normal(size=g.num_vertices).astype(np.float32)
    want = ref_ops.dbg_spmv(jnp.asarray(x), ref_groups, g.num_vertices,
                            row_tile=64, width_tile=128)
    got = dbg_spmv(torch.from_numpy(x), groups, g.num_vertices, row_tile=64,
                   width_tile=128)
    _close(want, got)
    ga = ref_to_arrays(g)
    oracle = ref_csr_spmv(jnp.asarray(x), ga.in_src, ga.in_dst, ga.in_w,
                          g.num_vertices)
    c = g.in_csr
    w = (torch.from_numpy(c.weights) if c.weights is not None
         else torch.ones(c.num_edges))
    port_oracle = csr_spmv_ref(torch.from_numpy(x), torch.from_numpy(c.indices),
                               torch.from_numpy(c.indptr), w)
    _close(oracle, port_oracle)
    _close(port_oracle, got)


@pytest.mark.parametrize("key", ["wl", "kr", "kr_w"])
def test_dbg_spmv_with_degrees_matches_reference_and_csr_oracle(key):
    """``dbg_spmv`` on the port's own groups, which keep their degrees."""
    g = _graph(key.removesuffix("_w"), key.endswith("_w"))
    bounds = dbg_spec(max(1.0, g.in_degrees().mean())).boundaries
    ref_groups = ref_ops.ell_pack_groups(g, bounds, row_tile=64, width_tile=128)
    groups = ell_pack_groups(_port_graph(g), bounds, row_tile=64,
                             width_tile=128, device="cpu")
    assert all(gr.deg is not None for gr in groups)
    x = np.random.default_rng(2).normal(size=g.num_vertices).astype(np.float32)
    want = ref_ops.dbg_spmv(jnp.asarray(x), ref_groups, g.num_vertices,
                            row_tile=64, width_tile=128)
    got = dbg_spmv(torch.from_numpy(x), groups, g.num_vertices, row_tile=64,
                   width_tile=128)
    _close(want, got)
    c = g.in_csr
    w = (torch.from_numpy(c.weights) if c.weights is not None
         else torch.ones(c.num_edges))
    _close(csr_spmv_ref(torch.from_numpy(x), torch.from_numpy(c.indices),
                        torch.from_numpy(c.indptr), w), got)
