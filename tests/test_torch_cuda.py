"""The port's CUDA kernels on the card (marked ``cuda``; skips without a card):
K5 (narrow classes, and rows wider than 1,024 lanes by block and split
across blocks), K4, K1 (every lane, and only the real ones), hist_bin and
K2 against their plain versions, the apps on
``ell`` and ``packed`` against ``flat``, the LM's greedy decode on the card
against the CPU, and the wrappers raising rather than falling back.

Run on a machine with an NVIDIA card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports the JAX package, which
the card's machine need not have.)  This file imports only torch and the
port.  ``chip_smoke.py`` drives the same checks at the main path's size.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _graph():
    from repro_torch.graph import datasets

    return datasets.load_weighted("kr", "test")


def test_kernel_matches_plain_version_on_every_variant(cuda):
    from repro_torch.core.reorder import dbg_spec
    from repro_torch.kernels.edge_map import (ell_edge_map, ell_edge_map_ref,
                                              ell_tiles)

    g = _graph()
    tiles = ell_tiles(g.in_csr, dbg_spec(g.in_csr.degrees().mean()).boundaries,
                      device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    v = g.num_vertices
    xs = {1: torch.rand(v, generator=gen, device=cuda),
          8: torch.rand(v, 8, generator=gen, device=cuda)}
    frs = {"shared": (torch.rand(v, generator=gen, device=cuda) < .5).to(torch.int8),
           "planar": (torch.rand(v, 8, generator=gen, device=cuda) < .5).to(torch.int8)}
    before = ell_edge_map.launches
    for reduce, unit, fr, alive, init, k in itertools.product(
            ("sum", "min", "max"), (False, True), ("none", "shared", "planar"),
            (False, True), (False, True), (1, 8)):
        if fr == "planar" and k == 1:
            continue
        for t in tiles:
            r, w = t.idx.shape
            kw = dict(reduce=reduce, w=None if unit else t.w, unit_weights=unit,
                      frontier=None if fr == "none" else frs[fr],
                      alive=((torch.rand(r, w, generator=gen, device=cuda) < .8)
                             .to(torch.int8) if alive else None),
                      init_rows=(torch.rand((r, k) if k > 1 else (r,),
                                            generator=gen, device=cuda)
                                 if init else None),
                      neutral={"sum": 0.0, "min": float("inf"),
                               "max": float("-inf")}[reduce])
            got = ell_edge_map(xs[k], t.idx, t.deg, row_tile=r, width_tile=w,
                               **kw)
            want = ell_edge_map_ref(xs[k], t.idx, t.deg, **kw)
            if reduce == "sum":
                scale = 1.0 + float(want.abs().max())
                assert float((got - want).abs().max()) <= 2e-6 * scale
            else:
                assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert ell_edge_map.launches > before


def test_apps_on_ell_match_flat_on_the_card(cuda):
    from repro_torch import apps

    g = _graph()
    fb = apps.to_arrays(g, device=cuda)
    eb = apps.to_arrays(g, backend="ell")  # the default device is the card
    assert eb.in_tiles[0].idx.is_cuda
    r1, _ = apps.pagerank(fb, max_iters=20, tol=0.0)
    r2, _ = apps.pagerank(eb, max_iters=20, tol=0.0)
    np.testing.assert_allclose(r2.cpu().numpy(), r1.cpu().numpy(), atol=1e-7)
    assert torch.equal(apps.sssp(fb, 0)[0], apps.sssp(eb, 0)[0])
    src = apps.radii_sources(g.num_vertices, 8,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(apps.radii(fb, src)[0], apps.radii(eb, src)[0])


def test_wrapper_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels.edge_map import ell_edge_map

    x = torch.rand(100, device=cuda)
    idx = torch.zeros((8, 8), dtype=torch.int64, device=cuda)
    deg = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="uint16 or int32"):
        ell_edge_map(x, idx, deg, row_tile=8, width_tile=8)
    with pytest.raises(ValueError, match="identity 0"):
        ell_edge_map(x, idx.to(torch.int32), deg, identity=1.0, row_tile=8,
                     width_tile=8)
    with pytest.raises(ValueError, match="is on cpu"):
        ell_edge_map(x, idx.to(torch.int32), deg.cpu(), row_tile=8,
                     width_tile=8)


def _wide_tile(cuda, v, dtype, seed):
    """Rows of 1,025, 4,097 and 70,000 lanes (and shorter ones, an empty
    one, and padding rows) in one class wider than 1,024 lanes."""
    from repro_torch.device import to_device

    rng = np.random.default_rng(seed)
    degs = np.array([1025, 4097, 70_000, 0, 5, 8192, 4096, 1], np.int64)
    r, width = 16, 70_016
    idx = np.zeros((r, width), dtype)
    for i, d in enumerate(degs):
        idx[i, :d] = rng.integers(0, v, d)
    deg = np.zeros(r, np.int32)
    deg[: degs.size] = degs
    return to_device(idx, cuda), to_device(deg, cuda), deg


@pytest.mark.parametrize("dtype,v", [(np.uint16, 60_000), (np.int32, 80_000)])
def test_wide_rows_match_plain_version_on_every_variant(cuda, dtype, v):
    """The hub-class path (a 256-thread block per piece of a row, then the
    fold) against the plain version on every variant: with the class's
    segment list, with none (the wrapper builds the same list from deg),
    and with one segment per row; two calls bitwise equal."""
    from repro_torch.kernels.edge_map import (ell_edge_map, ell_edge_map_ref,
                                              row_segments)

    idx, deg, deg_host = _wide_tile(cuda, v, dtype, seed=4)
    r, width = idx.shape
    segs = torch.from_numpy(row_segments(deg_host)).to(cuda)
    whole = torch.from_numpy(row_segments(deg_host, width)).to(cuda)
    assert int(segs.shape[0]) > r and int(whole.shape[0]) == r
    gen = torch.Generator(device=cuda).manual_seed(5)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda)

    xs = {1: rand(v), 8: rand(v, 8)}
    frs = {"shared": (rand(v) < .5).to(torch.int8),
           "planar": (rand(v, 8) < .5).to(torch.int8)}
    w, alive = rand(r, width), (rand(r, width) < .8).to(torch.int8)
    before = ell_edge_map.launches
    calls = 0
    for reduce, weight, fr, al, init, k in itertools.product(
            ("sum", "min", "max"), ("none", "unit", "plane"),
            ("none", "shared", "planar"), (False, True), (False, True), (1, 8)):
        if fr == "planar" and k == 1:
            continue
        kw = dict(reduce=reduce, w=w if weight == "plane" else None,
                  unit_weights=weight == "unit",
                  frontier=None if fr == "none" else frs[fr],
                  alive=alive if al else None,
                  init_rows=(rand(r, k) if k > 1 else rand(r)) if init else None,
                  neutral={"sum": 0.0, "min": float("inf"),
                           "max": float("-inf")}[reduce])
        want = ell_edge_map_ref(xs[k], idx, deg, **kw)
        for seg in (segs, None, whole):
            got, again = (ell_edge_map(xs[k], idx, deg, segments=seg,
                                       row_tile=r, width_tile=width, **kw)
                          for _ in range(2))
            calls += 2
            assert torch.equal(got, again)
            if reduce == "sum":
                _close(got, want)
            else:
                assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert ell_edge_map.launches - before == 2 * calls  # pieces, then fold


# ------------------------------------------------- K4, K1, hist_bin, packed
def _close(got, want):
    scale = 1.0 + float(want[torch.isfinite(want)].abs().max())
    assert float((got - want).abs().max()) <= 2e-6 * scale


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32"])
def test_hot_spmv_matches_plain_version(cuda, dtype, weighted):
    from repro_torch.device import to_device
    from repro_torch.kernels.pack_spmv import hot_spmv, hot_spmv_ref

    rng = np.random.default_rng(1)
    v = {"uint8": 200, "uint16": 5_000, "uint32": 70_000}[dtype]
    x = torch.from_numpy(rng.random(v).astype(np.float32)).to(cuda)
    before = hot_spmv.launches
    # widths 8, 16, 256 and 2048 take the 8-, 16-, 32- and 256-lane groups
    for r, w in ((64, 8), (64, 16), (128, 256), (16, 2048)):
        idx = to_device(rng.integers(0, v, (r, w)).astype(dtype), cuda)
        deg = torch.from_numpy(rng.integers(0, w + 1, r).astype(np.int32)).to(cuda)
        wt = (torch.from_numpy(rng.random((r, w)).astype(np.float32)).to(cuda)
              if weighted else None)
        got = hot_spmv(x, idx, deg, wt, row_tile=r, width_tile=w)
        _close(got, hot_spmv_ref(x, idx, deg, wt))
    torch.cuda.synchronize()
    assert hot_spmv.launches == before + 4


def test_ell_spmv_matches_plain_version(cuda):
    from repro_torch.kernels.csr_spmv import ell_spmv, ell_spmv_ref

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random(4096).astype(np.float32)).to(cuda)
    before = ell_spmv.launches
    for r, w in ((64, 8), (64, 16), (128, 512), (16, 4096)):
        idx = torch.from_numpy(rng.integers(0, 4096, (r, w)).astype(np.int32)).to(cuda)
        wt = torch.from_numpy((rng.random((r, w)) > .3).astype(np.float32)).to(cuda)
        _close(ell_spmv(x, idx, wt, row_tile=r, width_tile=w),
               ell_spmv_ref(x, idx, wt))
    # padding (id 0, weight 0) is read: a non-finite x[0] reaches the row
    x[0] = float("inf")
    idx = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    y = ell_spmv(x, idx, torch.zeros((8, 8), device=cuda), row_tile=8,
                 width_tile=8)
    assert bool(torch.isnan(y).all())
    torch.cuda.synchronize()
    assert ell_spmv.launches == before + 6  # the 4096-lane plane is split: 2


def test_ell_spmv_with_degrees_matches_every_lane_and_plain(cuda):
    """K1 reading only lanes < deg against the every-lane path (bitwise on a
    finite x) and the plain version, wide planes split with and without a
    segment list; with a non-finite x[0] the padded rows are NaN on both
    paths and a full row, where there is one, is not."""
    from repro_torch.kernels.csr_spmv import ell_spmv, ell_spmv_ref
    from repro_torch.kernels.edge_map import row_segments

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random(5000).astype(np.float32)).to(cuda)
    before, launches = ell_spmv.launches, 0
    # (rows, width, longest row): short rows in a wider plane walk fewer
    # lanes per thread (the last DBG group; a 512-lane group of <= 100)
    for r, w, cap in ((64, 8, 8), (64, 16, 16), (128, 512, 512),
                      (256, 128, 9), (64, 512, 100), (16, 4096, 4096),
                      (8, 20_480, 20_480)):
        d = np.minimum(rng.integers(0, w + 1, r), cap)
        d[0] = cap  # the longest row: a full one where cap == w
        lane = np.arange(w)[None, :] < d[:, None]
        idx_np = np.where(lane, rng.integers(1, 5000, (r, w)), 0)
        w_np = np.where(lane, rng.random((r, w)), 0.0)
        idx = torch.from_numpy(idx_np.astype(np.int32)).to(cuda)
        wt = torch.from_numpy(w_np.astype(np.float32)).to(cuda)
        deg = torch.from_numpy(d.astype(np.int32)).to(cuda)
        wide = w > 1024
        segs = torch.from_numpy(row_segments(d)).to(cuda) if wide else None
        walks = [dict(deg=deg, max_deg=int(d.max()), segments=segs),
                 dict(deg=deg)]
        every = ell_spmv(x, idx, wt, row_tile=r, width_tile=w)
        for kw in walks:
            got = ell_spmv(x, idx, wt, row_tile=r, width_tile=w, **kw)
            assert torch.equal(got, every)
            _close(got, ell_spmv_ref(x, idx, wt, deg=deg))
        xi = x.clone()
        xi[0] = float("inf")
        for y in (ell_spmv(xi, idx, wt, row_tile=r, width_tile=w, **walks[0]),
                  ell_spmv(xi, idx, wt, row_tile=r, width_tile=w),
                  ell_spmv_ref(xi, idx, wt, deg=deg)):
            assert torch.equal(torch.isnan(y), torch.from_numpy(d < w).to(cuda))
        launches += 5 * (2 if wide else 1)
    torch.cuda.synchronize()
    assert ell_spmv.launches == before + launches


def test_hist_bin_and_dbg_bin_match_plain_and_host(cuda):
    from repro_torch.core.reorder import dbg_spec, group_reorder
    from repro_torch.kernels.hist_bin import dbg_bin, hist_bin, hist_bin_ref

    rng = np.random.default_rng(3)
    deg = rng.integers(0, 3000, 100_003).astype(np.int32)
    spec = dbg_spec(float(deg.mean()))
    d = torch.from_numpy(deg).to(cuda)
    before = hist_bin.launches
    for bounds in (spec.boundaries, (900, 300, 40, 7), (5, 50, 0, 500),
                   tuple(range(31 * 90, -1, -90))):
        b = torch.tensor(bounds, dtype=torch.int32, device=cuda)
        for got, want in zip(hist_bin(d, b), hist_bin_ref(d, b)):
            assert torch.equal(got, want)
    mapping, _, _ = dbg_bin(d, torch.tensor(spec.boundaries, dtype=torch.int32,
                                            device=cuda))
    np.testing.assert_array_equal(mapping.cpu().numpy(),
                                  group_reorder(deg, spec).mapping)
    torch.cuda.synchronize()
    assert hist_bin.launches == before + 5


def test_packed_path_matches_flat_on_the_card(cuda):
    from repro_torch import apps
    from repro_torch.core.reorder import dbg_spec, reorder_graph
    from repro_torch.kernels.csr_spmv import (csr_spmv_ref, dbg_spmv,
                                              ell_pack_groups)
    from repro_torch.kernels.pack_spmv import pack_spmv

    g, _ = reorder_graph(_graph(), "dbg")
    fb = apps.to_arrays(g, device=cuda)
    pb = apps.to_arrays(g, backend="packed")  # the default device is the card
    assert pb.in_tiles[0].idx.is_cuda and pb.device.type == "cuda"
    r1, _ = apps.pagerank(fb, max_iters=20, tol=0.0)
    r2, _ = apps.pagerank(pb, max_iters=20, tol=0.0)
    np.testing.assert_allclose(r2.cpu().numpy(), r1.cpu().numpy(), atol=1e-7)
    r1, _ = apps.pagerank_delta(fb)
    r2, _ = apps.pagerank_delta(pb)
    np.testing.assert_allclose(r2.cpu().numpy(), r1.cpu().numpy(), atol=1e-7)
    assert torch.equal(apps.sssp(fb, 0)[0], apps.sssp(pb, 0)[0])
    c1, d1, l1 = apps.bc(fb, 0)
    c2, d2, l2 = apps.bc(pb, 0)
    assert l1 == l2 and torch.equal(d1, d2)
    np.testing.assert_allclose(c2.cpu().numpy(), c1.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    src = apps.radii_sources(g.num_vertices, 8,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(apps.radii(fb, src)[0], apps.radii(pb, src)[0])
    # the graph is weighted: both SpMVs multiply by the edge weight
    x = torch.rand(g.num_vertices, device=cuda)
    ga = fb.ga
    pull = csr_spmv_ref(x, ga.in_src, ga.in_ptr, ga.in_w)
    _close(pack_spmv(x, pb.packed.in_adj), pull)
    bounds = dbg_spec(float(g.in_degrees().mean())).boundaries
    groups = ell_pack_groups(g, bounds, row_tile=64, width_tile=128)
    _close(dbg_spmv(x, groups, g.num_vertices, row_tile=64, width_tile=128),
           pull)


def test_new_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels.csr_spmv import ell_spmv
    from repro_torch.kernels.hist_bin import hist_bin
    from repro_torch.kernels.pack_spmv import hot_spmv

    x = torch.rand(100, device=cuda)
    deg = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="uint8, uint16 or uint32"):
        hot_spmv(x, torch.zeros((8, 8), dtype=torch.int32, device=cuda), deg,
                 row_tile=8, width_tile=8)
    with pytest.raises(ValueError, match="is on cpu"):
        hot_spmv(x, torch.zeros((8, 8), dtype=torch.uint16, device=cuda),
                 deg.cpu(), row_tile=8, width_tile=8)
    with pytest.raises(TypeError, match="int32"):
        ell_spmv(x, torch.zeros((8, 8), dtype=torch.int64, device=cuda),
                 torch.zeros((8, 8), device=cuda), row_tile=8, width_tile=8)
    with pytest.raises(ValueError, match="is on cpu"):
        ell_spmv(x, torch.zeros((8, 8), dtype=torch.int32, device=cuda),
                 torch.zeros((8, 8)), row_tile=8, width_tile=8)
    with pytest.raises(TypeError, match="int32"):
        hist_bin(torch.zeros(8, dtype=torch.int64, device=cuda),
                 torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="is on cpu"):
        hist_bin(deg, torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,c,d,t", [(128, 384, 128, 256), (4, 6, 6, 33),
                                     (16, 48, 100, 31), (64, 192, 2, 1000)])
def test_hot_gather_matches_plain_version(cuda, dtype, h, c, d, t):
    """Bitwise, on both entry points: ids past the table, negative ids, an
    all-hot and an all-cold batch; rows of 16-byte multiples take the vector
    path, the others (and a table that starts off a 16-byte boundary) the
    scalar one."""
    from repro_torch.kernels.gather_embed import (hot_gather, hot_gather_ref,
                                                  split_gather_ref)

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(h + d)
    full = torch.randn((h + c + 1, d), generator=gen, device=cuda).to(dt)
    hot, cold = full[:h], full[h + 1:]  # cold starts d * elem bytes in
    ids = torch.randint(-3, h + c + 9, (t,), generator=gen, device=cuda,
                        dtype=torch.int32)
    batches = {"mixed": ids, "hot": ids.clamp(0, h - 1),
               "cold": ids.clamp(h, h + c - 1)}
    before = hot_gather.launches
    for what, b in batches.items():
        got = hot_gather(b, hot, cold)
        assert torch.equal(got, split_gather_ref(hot, cold, b)), what
        assert torch.equal(hot_gather(b, hot), hot_gather_ref(b, hot)), what
    shifted = full.reshape(-1)[2:2 + h * d].view(h, d)  # off 16 B
    assert torch.equal(hot_gather(ids, shifted, cold),
                       split_gather_ref(shifted, cold, ids))
    torch.cuda.synchronize()
    assert hot_gather.launches == before + 2 * len(batches) + 1
    assert torch.equal(hot_gather(batches["cold"], hot),
                       torch.zeros((t, d), dtype=dt, device=cuda))


def test_hot_gather_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels.gather_embed import hot_gather

    hot = torch.randn((4, 8), device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        hot_gather(ids.long(), hot)
    with pytest.raises(ValueError, match="is on cpu"):
        hot_gather(ids, hot, torch.randn((4, 8)))
    with pytest.raises(ValueError, match="is on cpu"):
        hot_gather(ids.cpu(), hot)


def test_lm_generate_on_the_card_matches_the_cpu(cuda):
    """Reduced Yi-9B with GQA: the same weights on both devices give the same
    greedy tokens, logits within rtol 1e-4, atol 1e-5 (float32 matmuls, TF32
    off), and one K2 launch per decode step."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.gather_embed import hot_gather
    from repro_torch.lm import model
    from repro_torch.lm.serve import generate

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced(get_config("yi_9b"), n_kv_heads=2)
    m = model.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    want, want_lg = generate(m, prompt, max_new=8, return_logits=True)
    before = hot_gather.launches
    got, got_lg = generate(m.to(cuda), prompt.to(cuda), max_new=8,
                           return_logits=True)
    torch.cuda.synchronize()
    assert hot_gather.launches - before == 16
    assert torch.equal(got.cpu(), want)
    for a, b in zip(got_lg, want_lg):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
