"""The plain K5 (``ell_edge_map_ref``, the CPU path of ``ell_edge_map``)
against ``repro``'s Pallas kernel in interpret mode, over every static
variant: {sum, min, max} × {no weight, +1, w plane} × {no frontier, shared,
per-query} × {alive, none} × {init, none} × {(V,), (V,8)} — the grid
``chip_smoke.py`` holds the CUDA kernel to on the card.  Min/max bitwise;
sums within ``2e-6 · (1 + max|y|)``.  For sums the tiles span two width
steps, so the reference accumulates across grid steps (min/max are
order-free, and one step keeps the file fast); ids alternate uint16 / int32.
The (V, 8) half of the grid runs from ``test_torch_edge_map_plane.py``, so
the two halves go to different test workers.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.edge_map import ell_edge_map_pallas  # noqa: E402
from repro_torch.kernels.edge_map import ell_edge_map  # noqa: E402

V, R, W = 97, 16, 16
GRID = [c for c in itertools.product(
    ("sum", "min", "max"), ("none", "unit", "plane"),
    ("none", "shared", "planar"), (False, True), (False, True), (1, 8))
    if not (c[2] == "planar" and c[5] == 1)]


def _inputs(i, weight, frontier, alive, init, k):
    rng = np.random.default_rng(i)
    shape = (V,) if k == 1 else (V, k)
    deg = rng.integers(0, W + 1, R).astype(np.int32)
    deg[:2] = (0, W)  # an empty row and a full one
    return dict(
        x=rng.standard_normal(shape).astype(np.float32),
        idx=rng.integers(0, V, (R, W)).astype(np.uint16 if i % 2 else np.int32),
        deg=deg,
        w=rng.random((R, W)).astype(np.float32) if weight == "plane" else None,
        frontier=(None if frontier == "none" else
                  (rng.random((V,) if frontier == "shared" else shape) < 0.5)
                  .astype(np.int8)),
        alive=((rng.random((R, W)) < 0.7).astype(np.int8) if alive else None),
        init_rows=(rng.standard_normal((R,) if k == 1 else (R, k))
                   .astype(np.float32) if init else None),
    )


def check_case(case):
    reduce, weight, frontier, alive, init, k = case
    arrays = _inputs(GRID.index(case), weight, frontier, alive, init, k)
    neutral = {"sum": 0.0, "min": np.inf, "max": -np.inf}[reduce]
    kw = dict(reduce=reduce, unit_weights=weight == "unit", neutral=neutral,
              row_tile=R, width_tile=W // 2 if reduce == "sum" else W)
    want = ell_edge_map_pallas(
        **{n: None if a is None else jnp.asarray(a) for n, a in arrays.items()},
        **kw)
    got = ell_edge_map(
        **{n: None if a is None else torch.from_numpy(a)
           for n, a in arrays.items()}, **kw)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if reduce == "sum":
        scale = 1.0 + np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    else:
        np.testing.assert_array_equal(got, want)


def case_id(case):
    return "-".join(map(str, case))


@pytest.mark.parametrize("case", [c for c in GRID if c[5] == 1], ids=case_id)
def test_plain_kernel_matches_pallas(case):
    check_case(case)


@pytest.mark.parametrize("reduce,identity", [("max", -128.0), ("min", 127.0)])
def test_finite_identity_for_integer_planes(reduce, identity):
    """Integer-sourced planes (Radii's int8 reachability) pad with a finite
    identity; rows with padding lanes take it, as the reference does."""
    arrays = _inputs(3, "none", "none", True, False, 8)
    arrays["x"] = (arrays["x"] > 0).astype(np.float32)
    kw = dict(reduce=reduce, identity=identity, row_tile=R, width_tile=W)
    want = ell_edge_map_pallas(
        **{n: None if a is None else jnp.asarray(a) for n, a in arrays.items()},
        **kw)
    got = ell_edge_map(
        **{n: None if a is None else torch.from_numpy(a)
           for n, a in arrays.items()}, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
