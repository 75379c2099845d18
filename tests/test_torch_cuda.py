"""The K5 CUDA kernel on the card (marked ``cuda``; skips without a card).

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
        pytest.skip("needs a CUDA card: the K5 kernel has no CPU mode")
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
