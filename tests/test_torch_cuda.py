"""The port's CUDA kernels on the card (marked ``cuda``; skips without a card):
K5 (narrow classes, and rows wider than 1,024 lanes by block and split
across blocks), K4 (narrow tables, and hub rows split across blocks), K1
(every lane, and only the real ones), hist_bin and the stable rank
(``dbg_bin``) and K2 against their plain versions, the apps on
``ell`` and ``packed`` against ``flat``, the LM's greedy decode on the card
against the CPU, the wrappers raising rather than falling back, the
edge-map counters' ``on_pass`` making no device synchronization, and the
streaming plane: K5 over the stream's tiles (alive planes, a ``coo_tiles``
delta tile), the unfused stream push without float atomics, and the
incremental consumers against the CPU.

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
    assert hot_spmv.launches == before + 5  # the 2048-slot plane is split: 2


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype,v", [(np.uint8, 200), (np.uint16, 60_000),
                                     (np.uint32, 80_000)])
def test_hot_spmv_split_matches_plain_version(cuda, dtype, v, weighted):
    """K4's hub path (a 256-thread block per piece of a row, then the fold)
    on rows of 1,025, 4,097 and 70,000 slots: with the table's segment
    list, with ``max_deg`` alone and with nothing (the wrapper builds the
    same list from deg), each twice, all bitwise equal, and within the sum
    band of the plain version."""
    from repro_torch.kernels._wrap import row_segments
    from repro_torch.kernels.pack_spmv import hot_spmv, hot_spmv_ref

    idx, deg, deg_host = _wide_tile(cuda, v, dtype, seed=8)
    r, width = idx.shape
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.rand(v, generator=gen, device=cuda)
    wt = (torch.rand((r, width), generator=gen, device=cuda) if weighted
          else None)
    segs = torch.from_numpy(row_segments(deg_host)).to(cuda)
    want = hot_spmv_ref(x, idx, deg, wt)
    before, calls, first = hot_spmv.launches, 0, None
    for kw in (dict(max_deg=int(deg_host.max()), segments=segs),
               dict(max_deg=int(deg_host.max())), {}):
        for _ in range(2):
            got = hot_spmv(x, idx, deg, wt, row_tile=r, width_tile=width, **kw)
            first = got if first is None else first
            assert torch.equal(got, first)
            calls += 1
    _close(first, want)
    torch.cuda.synchronize()
    assert hot_spmv.launches - before == 2 * calls  # pieces, then fold


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
    """hist_bin bitwise against its plain version over DBG bounds, bounds
    that end above 0, unsorted bounds, K = 1 and K = 32, at V of 1, a tile
    and a tile +- 1 and 100,003; ``dbg_bin`` against the host mapping at
    each V.  One hist_bin launch per hist_bin call and per dbg_bin call."""
    from repro_torch.core.reorder import dbg_spec, group_reorder
    from repro_torch.kernels.hist_bin import (TILE, dbg_bin, hist_bin,
                                              hist_bin_ref)

    rng = np.random.default_rng(3)
    full = rng.integers(0, 3000, 100_003).astype(np.int32)
    before, calls = hist_bin.launches, 0
    for v in (100_003, 1, TILE - 1, TILE, TILE + 1):
        deg = full[:v]
        spec = dbg_spec(max(1.0, float(deg.mean())))
        d = torch.from_numpy(deg).to(cuda)
        for bounds in (spec.boundaries, (900, 300, 40, 7), (5, 50, 0, 500),
                       (int(np.median(deg)),), tuple(range(31 * 90, -1, -90))):
            b = torch.tensor(bounds, dtype=torch.int32, device=cuda)
            for got, want in zip(hist_bin(d, b), hist_bin_ref(d, b)):
                assert torch.equal(got, want), (v, bounds)
        mapping, _, _ = dbg_bin(d, torch.tensor(spec.boundaries,
                                                dtype=torch.int32, device=cuda))
        np.testing.assert_array_equal(mapping.cpu().numpy(),
                                      group_reorder(deg, spec).mapping)
        calls += 6
    torch.cuda.synchronize()
    assert hist_bin.launches == before + calls


@pytest.mark.parametrize("k", [1, 8, 32])
def test_dbg_bin_matches_plain_path_bitwise(cuda, k):
    """``dbg_bin`` on the card (hist_bin, then the rank kernel: two
    launches, no one-hot) against the plain path (``hist_bin_ref``, then
    ``stable_mapping_ref``), bitwise, and ``stable_mapping_from_groups``
    on the plain groups; V of 0, 1, a tile +- 1, several tiles with a
    ragged end; every vertex in the first group and in the last; an
    unaligned degree vector (the kernels' scalar path)."""
    from repro_torch.kernels.hist_bin import (TILE, dbg_bin, hist_bin,
                                              hist_bin_ref, stable_mapping_ref,
                                              stable_mapping_from_groups,
                                              stable_rank)

    gen = torch.Generator(device=cuda).manual_seed(k)
    deg = torch.randint(0, 5000, (5 * TILE + 7,), generator=gen, device=cuda,
                        dtype=torch.int32)
    bounds = torch.sort(torch.randint(1, 4000, (k,), generator=gen,
                                      device=cuda, dtype=torch.int32),
                        descending=True).values
    bounds[-1] = 0
    cases = [deg[:n] for n in (0, 1, TILE - 1, TILE + 1, 5 * TILE + 7)]
    cases += [deg + 4000, torch.zeros_like(deg), deg[1:]]  # first, last, off 16 B
    for d in cases:
        n0, r0 = hist_bin.launches, stable_rank.launches
        mapping, groups, hist = dbg_bin(d, bounds)
        assert (hist_bin.launches - n0, stable_rank.launches - r0) == (1, 1)
        ref_groups, ref_hist = hist_bin_ref(d, bounds)
        ref_mapping = stable_mapping_ref(ref_groups, k)
        assert mapping.dtype == torch.int64
        assert torch.equal(groups, ref_groups), d.shape[0]
        assert torch.equal(hist, ref_hist), d.shape[0]
        assert torch.equal(mapping, ref_mapping), d.shape[0]
        assert torch.equal(stable_mapping_from_groups(ref_groups, k),
                           ref_mapping), d.shape[0]
        assert torch.equal(stable_mapping_from_groups(ref_groups[1:], k),
                           stable_mapping_ref(ref_groups[1:], k))
    torch.cuda.synchronize()


def test_hist_bin_takes_a_ticket_per_stream(cuda, monkeypatch):
    """Calls on two streams at once never meet on one ticket: the ticket a
    launch is given is one per stream (the same for every call on a
    stream, another on the other), and hist_bin queued on two streams in
    turn behind a device sleep gives the plain version's groups and
    histogram in every call.  (Grids of two streams run together only now
    and then, so the test also reads the tickets.)"""
    import importlib

    from repro_torch.kernels.hist_bin import hist_bin, hist_bin_ref

    module = importlib.import_module("repro_torch.kernels.hist_bin.hist_bin")
    launch, seen = module.launch_on, []

    def spy(device, fn, *args):  # args end with (ticket, V)
        seen.append((torch.cuda.current_stream(device).cuda_stream, args[-2]))
        return launch(device, fn, *args)

    monkeypatch.setattr(module, "launch_on", spy)
    n = 2 ** 20 + 5
    gen = torch.Generator(device=cuda).manual_seed(5)
    d = torch.randint(0, 5000, (n + 8,), generator=gen, device=cuda,
                      dtype=torch.int32)
    b = torch.tensor([900, 300, 40, 7, 0], dtype=torch.int32, device=cuda)
    cases = [d[:n], d[8:]]  # one size: the streams keep step
    refs = [hist_bin_ref(x, b) for x in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            torch.cuda._sleep(40_000_000)  # ~20 ms: both queues fill first
    outs = []
    for _ in range(128):
        for st, x in zip(streams, cases):
            with torch.cuda.stream(st):
                outs.append(hist_bin(x, b))
    torch.cuda.synchronize()
    tickets = {st.cuda_stream: {t for s, t in seen if s == st.cuda_stream}
               for st in streams}
    assert all(len(t) == 1 for t in tickets.values()), tickets
    assert len(set.union(*tickets.values())) == 2, tickets
    bad = [i for i, (got, want) in enumerate(zip(outs, itertools.cycle(refs)))
           if not all(torch.equal(g, w) for g, w in zip(got, want))]
    assert not bad, f"{len(bad)} of {len(outs)} calls differ: {bad[:8]}"


def test_hist_bin_is_one_device_operation(cuda):
    """The kernel writes its own histogram: no fill ahead of it.  dbg_bin
    is two kernels.  Device events are read through the CUDA runtime calls
    of the session that launched them (they share a correlation id): the
    profiler can drop a session's device events, so it runs up to three
    times and the longest list stands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.hist_bin import dbg_bin, hist_bin

    d = torch.randint(0, 3000, (100_003,), device=cuda, dtype=torch.int32)
    b = torch.tensor([900, 300, 40, 7, 0], dtype=torch.int32, device=cuda)

    def ops(fn):
        fn()
        torch.cuda.synchronize()
        best = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = prof.events()
            device = {e.id: e.name for e in events
                      if e.device_type == DeviceType.CUDA}
            got = [device[e.id] for e in events
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith("cu") and e.id in device]
            best = max(best, got, key=len)
        return best

    hist_ops, dbg_ops = ops(lambda: hist_bin(d, b)), ops(lambda: dbg_bin(d, b))
    assert len(hist_ops) == 1 and "bin_kernel" in hist_ops[0], hist_ops
    assert len(dbg_ops) == 2, dbg_ops
    assert "bin_kernel" in dbg_ops[0] and "rank_kernel" in dbg_ops[1], dbg_ops


def test_stable_rank_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels.hist_bin import (bin_tiles, group_tiles,
                                              stable_mapping_from_groups,
                                              stable_rank)

    g = torch.zeros(16, dtype=torch.int32, device=cuda)
    _, hist, tiles = bin_tiles(g, torch.tensor([1, 0], dtype=torch.int32,
                                               device=cuda))
    strided = torch.zeros(32, dtype=torch.int32, device=cuda)[::2]
    before = stable_rank.launches
    with pytest.raises(TypeError, match="int32"):
        stable_mapping_from_groups(g.long(), 2)
    with pytest.raises(TypeError, match="contiguous int32"):
        stable_rank(g.long(), hist, tiles)
    with pytest.raises(TypeError, match="contiguous int32"):
        stable_rank(strided, hist, tiles)
    with pytest.raises(TypeError, match="contiguous int32"):
        group_tiles(strided, 2)
    with pytest.raises(TypeError, match="int32"):
        stable_rank(g, hist.long(), tiles)
    with pytest.raises(ValueError, match="is on cpu"):
        stable_rank(g, hist, tiles.cpu())
    with pytest.raises(ValueError, match="shape"):
        stable_rank(g, hist, tiles.repeat(2, 1))
    assert stable_rank.launches == before


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hot_gather_builds_match_plain_version(cuda, dtype):
    """K2 bitwise on both entry points: rows of 16 KiB, of 24,000 bytes, of
    a multiple of 16 bytes in float32 only, and of 3 elements; T = 0, 1, 4
    and 8,192; int32 and int64 ids, contiguous and strided, past the table
    and below 0."""
    from repro_torch.kernels.gather_embed import (hot_gather, hot_gather_ref,
                                                  split_gather_ref)

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(11)
    before, launches = hot_gather.launches, 0
    for h, c, d in ((64, 192, 4096), (16, 48, 6000), (16, 48, 100),
                    (8, 24, 3)):
        full = torch.randn((h + c, d), generator=gen, device=cuda).to(dt)
        hot, cold = full[:h], full[h:]
        for t in (0, 1, 4, 8192):
            ids = torch.randint(-3, h + c + 9, (t,), generator=gen,
                                device=cuda, dtype=torch.int32)
            pair = torch.stack([ids, ids.flip(0)], dim=1)
            cases = {"int32": ids, "int64": ids.long(),
                     "strided": pair[:, 1], "int64_strided": pair.long()[:, 0]}
            for what, b in cases.items():
                label = f"{dtype} D={d} T={t} {what}"
                assert torch.equal(hot_gather(b, hot, cold),
                                   split_gather_ref(hot, cold, b)), label
                assert torch.equal(hot_gather(b, hot),
                                   hot_gather_ref(b, hot)), label
                launches += 2
    torch.cuda.synchronize()
    assert hot_gather.launches - before == launches


def test_hot_gather_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels.gather_embed import hot_gather

    hot = torch.randn((4, 8), device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32 or int64"):
        hot_gather(ids.to(torch.int16), hot)
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


@pytest.mark.parametrize("backend", ["ell", "packed", "flat"])
def test_counters_on_pass_makes_no_device_sync(cuda, backend):
    """The edge-map counters' ``on_pass`` of frontier passes (a shared and a
    per-lane frontier) neither copies to the host nor synchronizes: it runs
    under ``set_sync_debug_mode("error")`` (which does not see every
    synchronizing call), and returns while the device still sleeps behind
    it.  The densities it holds, folded when the registry is read, equal
    the same passes' on the CPU."""
    from repro_torch import apps
    from repro_torch.obs import EdgeMapCounters, MetricsRegistry

    g = _graph()
    v = g.num_vertices
    gen = torch.Generator().manual_seed(0)
    prop = torch.rand((v, 4), generator=gen)
    shared = torch.rand(v, generator=gen) < 0.3
    planar = torch.rand((v, 4), generator=gen) < 0.6
    densities = []
    for dev in (cuda, torch.device("cpu")):
        ga = apps.to_arrays(g, backend=backend, device=dev)
        c = EdgeMapCounters(MetricsRegistry())
        p, f1, f2 = prop.to(dev), shared.to(dev), planar.to(dev)
        torch.cuda.synchronize()
        if dev.type == "cuda":
            torch.cuda._sleep(200_000_000)  # ~0.1 s of device time
        asleep = torch.cuda.Event()
        asleep.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            c.on_pass(ga, "push", p[:, 0], {"src_frontier": f1})
            c.on_pass(ga, "pull", p, {"src_frontier": f2,
                                      "use_weights": True})
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if dev.type == "cuda":
            assert not asleep.query()  # on_pass waited for nothing
        s = c.summary()
        assert s[f"edge_map.passes.{backend}.push"] == 1
        assert s["edge_map.frontier_density_count"] == 2
        densities.append(c.registry.histogram(
            "edge_map.frontier_density")._samples)
    assert densities[0] == densities[1]
    assert 0.0 < densities[0][0] < densities[0][1] < 1.0


# ------------------------------------------------------- K5 on stream tiles
def _stream_graph(seed=0):
    """A weighted graph of 5,000 vertices whose vertex 17 has 3,000
    in-edges (a class wider than 1,024 lanes), after one batch that
    tombstones 700 base edges (300 of them into the hub) and inserts 2,000
    edges, 1,500 of them into vertex 29 (a delta row wider than 1,024
    lanes)."""
    from repro_torch.graph import csr
    from repro_torch.stream import DeltaGraph

    rng = np.random.default_rng(seed)
    v = 5000
    src = np.concatenate([rng.integers(0, v, 40_000),
                          rng.integers(0, v, 3000)])
    dst = np.concatenate([rng.integers(0, v, 40_000), np.full(3000, 17)])
    w = rng.uniform(1, 16, src.shape[0]).astype(np.float32)
    dg = DeltaGraph(csr.from_edges(src, dst, v, weights=w))
    hub = np.flatnonzero(dst == 17)[:300]
    rest = rng.choice(40_000, 400, replace=False)
    kill = np.concatenate([hub, rest])
    a_src = rng.integers(0, v, 2000)
    a_dst = np.concatenate([np.full(1500, 29), rng.integers(0, v, 500)])
    dg.apply(add_src=a_src, add_dst=a_dst,
             add_w=rng.uniform(1, 16, 2000).astype(np.float32),
             del_src=src[kill], del_dst=dst[kill])
    return dg


@pytest.mark.parametrize("mode", ["push", "pull"])
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_k5_over_stream_tiles_matches_plain_version(cuda, reduce, mode):
    """K5 over the stream's tiles: the base in-direction with its alive
    plane (a class wider than 1,024 lanes among them) and a ``coo_tiles``
    delta tile wider than 1,024 lanes, folded in as ``extra_tiles``;
    push (``init``, weights, a frontier) and pull, against the same tiles
    on the CPU (K5's plain version): min/max bitwise, sums in the band;
    two calls bitwise; launches = base launches per pass + 2 for the delta
    tile."""
    from repro_torch.kernels._wrap import lanes_per_row
    from repro_torch.kernels.edge_map import ell_edge_map
    from repro_torch.stream import incremental

    dg = _stream_graph()
    v = dg.num_vertices
    tiles = {dev: incremental.stream_push_tiles(dg, device=dev)
             for dev in (torch.device("cpu"), cuda)}
    base, delta = tiles[cuda]
    assert all(t.alive is not None and t.alive.device.type == cuda.type
               for t in base)
    assert any(lanes_per_row(t.idx.shape[1]) == 256 for t in base)
    assert len(delta) == 1 and delta[0].segments is not None
    rows = delta[0].rows.cpu()
    assert torch.equal(rows, torch.unique(rows))
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(v, generator=gen) * 8
    front = torch.rand(v, generator=gen) < 0.7
    init = torch.rand(v, generator=gen) * 30

    def run(dev):
        b, d = tiles[dev]
        if mode == "push":
            return incremental.edge_map_push_stream_fused(
                b, d, x.to(dev), v, reduce=reduce, use_weights=True,
                src_frontier=front.to(dev), init=init.to(dev))
        return incremental.edge_map_pull_stream_fused(
            b, d, x.to(dev), v, reduce=reduce, use_weights=reduce != "sum",
            src_frontier=front.to(dev))

    want = run(torch.device("cpu"))
    before = ell_edge_map.launches
    got, again = run(cuda), run(cuda)
    torch.cuda.synchronize()
    per_pass = sum(2 if lanes_per_row(t.idx.shape[1]) == 256 else 1
                   for t in base + delta)
    assert ell_edge_map.launches - before == 2 * per_pass
    assert torch.equal(got, again)
    if reduce == "sum":
        _close(got.cpu(), want)
    else:
        assert torch.equal(got.cpu(), want)
    # and the same function as the edge-parallel stream map on the card
    sa = incremental.stream_arrays(dg, cuda)
    flat = (incremental.edge_map_push_stream(
        sa, x.to(cuda), reduce=reduce, use_weights=True,
        src_frontier=front.to(cuda), init=init.to(cuda))
        if mode == "push" else incremental.edge_map_pull_stream(
        sa, x.to(cuda), reduce=reduce, use_weights=reduce != "sum",
        src_frontier=front.to(cuda)))
    if reduce == "sum":
        _close(got, flat)
    else:
        assert torch.equal(got, flat)


@pytest.mark.parametrize("reduce", ["sum", "min"])
def test_unfused_stream_push_is_deterministic_on_the_card(cuda, reduce):
    """The edge-parallel stream push runs sorted-segment reductions, no
    float atomics: two calls bitwise equal, and within the band (sum) or
    bitwise (min) of the same push on the CPU."""
    from repro_torch.stream import incremental

    dg = _stream_graph(seed=2)
    v = dg.num_vertices
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(v, generator=gen)
    init = torch.rand(v, generator=gen)
    out = []
    for dev in (cuda, cuda, torch.device("cpu")):
        sa = incremental.stream_arrays(dg, dev)
        out.append(incremental.edge_map_push_stream(
            sa, x.to(dev), reduce=reduce, use_weights=reduce == "min",
            init=init.to(dev)).cpu())
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])
    if reduce == "sum":
        _close(out[0], out[2])
    else:
        assert torch.equal(out[0], out[2])


def test_incremental_consumers_on_the_card_match_the_cpu(cuda):
    """IncrementalSSSP fused and unfused (bitwise) and IncrementalPageRank
    fused and unfused (each within 1e-8 of the same path) on the card
    against the same consumers on the CPU, over three insert+delete batches
    and a compaction, on the graph of the reference's 1e-8 band (``lj``)."""
    from repro_torch.graph import datasets
    from repro_torch.stream import (DeltaGraph, IncrementalPageRank,
                                    IncrementalSSSP)

    base = datasets.load_weighted("lj", "test", seed=1)
    rng = np.random.default_rng(4)
    devs = (cuda, torch.device("cpu"))
    dgs = [DeltaGraph(base) for _ in devs]
    cons = [[IncrementalSSSP(dg, 0, device=dev),
             IncrementalSSSP(dg, 0, use_fused_push=True, device=dev),
             IncrementalPageRank(dg, device=dev),
             IncrementalPageRank(dg, use_fused_push=True, device=dev)]
            for dev, dg in zip(devs, dgs)]
    for step in range(4):
        if step:
            es, ed, _ = dgs[1].alive_edges()
            kill = rng.choice(es.shape[0], 100, replace=False)
            batch = dict(add_src=rng.integers(0, base.num_vertices, 300),
                         add_dst=rng.integers(0, base.num_vertices, 300),
                         add_w=rng.uniform(1, 16, 300).astype(np.float32),
                         del_src=es[kill], del_dst=ed[kill])
            for dg, cs in zip(dgs, cons):
                res = dg.apply(**batch)
                for c in cs:
                    c.ingest(res)
                if step == 3:
                    dg.compact()
                    for c in cs[2:]:
                        c.resync()
        got, want = ([c.query() for c in cs] for cs in cons)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[0])
        for g, w in zip(got[2:], want[2:]):  # each path against its twin
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)
