"""DBG binning (hist_bin) and ``dbg_bin`` against ``repro``'s.

The port's plain version — what ``hist_bin`` runs for CPU tensors — is held
to the TPU kernel ``hist_bin_pallas`` in interpret mode, bitwise, also with
bounds that do not end in 0 (a vertex no bound admits lands in group 0, the
argmax of an all-false mask).  ``dbg_bin``'s mapping, groups and histogram
equal the reference's, and its mapping equals the port's host
``group_reorder`` (Listing 1 end to end).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hist_bin import ops as ref_ops  # noqa: E402
from repro.kernels.hist_bin.hist_bin import hist_bin_pallas  # noqa: E402
from repro_torch.core.reorder import dbg_spec, group_reorder  # noqa: E402
from repro_torch.kernels.hist_bin import (MAX_BINS, assign_bins_ref,  # noqa: E402
                                          dbg_bin, hist_bin, histogram_ref,
                                          stable_mapping_from_groups)

BOUNDS = {
    "dbg": None,  # dbg_spec over the degrees' mean
    "no_zero": (900, 300, 40, 7),  # degrees below 7 match no bound
    "unsorted": (5, 50, 0, 500),
    "one": (3,),
    "wide": tuple(range(31 * 16, -1, -16)),  # 32 bounds
}


@pytest.mark.parametrize("bounds", sorted(BOUNDS))
@pytest.mark.parametrize("v,tile,max_deg", [(1024, 256, 5), (4096, 1024, 1000),
                                            (512, 512, 2000)])
def test_plain_matches_pallas(v, tile, max_deg, bounds):
    rng = np.random.default_rng(v + max_deg)
    deg = rng.integers(0, max_deg, v).astype(np.int32)
    b = BOUNDS[bounds]
    if b is None:
        b = dbg_spec(max(1.0, float(deg.mean()))).boundaries
    b = np.array(b, np.int32)
    want_g, want_h = hist_bin_pallas(jnp.asarray(deg), jnp.asarray(b),
                                     tile=tile)
    got_g, got_h = hist_bin(torch.from_numpy(deg), torch.from_numpy(b))
    assert got_g.dtype == got_h.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want_g), got_g.numpy())
    np.testing.assert_array_equal(np.asarray(want_h), got_h.numpy())
    np.testing.assert_array_equal(
        assign_bins_ref(torch.from_numpy(deg), torch.from_numpy(b)).numpy(),
        got_g.numpy())
    np.testing.assert_array_equal(
        histogram_ref(torch.from_numpy(deg), torch.from_numpy(b)).numpy(),
        got_h.numpy())
    assert int(got_h.sum()) == v


@pytest.mark.parametrize("v", [1000, 4096, 20_000])
@pytest.mark.parametrize("max_deg", [5, 1000])
def test_dbg_bin_matches_reference_and_host_mapping(v, max_deg):
    rng = np.random.default_rng(v + max_deg)
    deg = rng.integers(0, max_deg, v).astype(np.int32)
    spec = dbg_spec(max(1.0, float(deg.mean())))
    b = np.array(spec.boundaries, np.int32)
    want = ref_ops.dbg_bin(jnp.asarray(deg), jnp.asarray(b), tile=1024)
    got = dbg_bin(torch.from_numpy(deg), torch.from_numpy(b))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert got[0].dtype == torch.int64
    np.testing.assert_array_equal(got[0].numpy(),
                                  group_reorder(deg, spec).mapping)


def test_dbg_bin_histogram_counts_each_vertex_in_its_group():
    """Off DBG's contract (bounds that do not end in 0), the histogram still
    counts every vertex once, in the group it was assigned.  The reference
    pads V to its tile with degree-0 vertices and takes them back out of the
    LAST bin, which is where they land only when the last bound is 0."""
    deg = np.random.default_rng(0).integers(0, 1000, 1000).astype(np.int32)
    b = torch.tensor([900, 300, 40, 7], dtype=torch.int32)
    mapping, groups, hist = dbg_bin(torch.from_numpy(deg), b)
    np.testing.assert_array_equal(
        hist.numpy(), np.bincount(groups.numpy(), minlength=4))
    assert sorted(mapping.tolist()) == list(range(1000))


def test_stable_mapping_matches_reference():
    rng = np.random.default_rng(0)
    groups = rng.integers(0, 5, 1000).astype(np.int32)
    want = ref_ops.stable_mapping_from_groups(jnp.asarray(groups), 5)
    got = stable_mapping_from_groups(torch.from_numpy(groups), 5)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert sorted(got.tolist()) == list(range(1000))


def test_hist_bin_wrapper_checks():
    deg = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="1 <= K"):
        hist_bin(deg, torch.zeros(MAX_BINS + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="1 <= K"):
        hist_bin(deg, torch.zeros(0, dtype=torch.int32))
    before = hist_bin.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        hist_bin(deg.to("meta"), torch.zeros(2, dtype=torch.int32,
                                             device="meta"))
    assert hist_bin.launches == before
