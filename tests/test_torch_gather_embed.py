"""K2, the hot/cold split embedding gather, against ``repro``'s.

The port's plain path — what ``hot_gather`` and ``split_gather`` run for CPU
tensors — is held bitwise to the TPU kernel ``hot_gather_pallas`` and to
``ops.split_gather``, both in interpret mode as ``tests/test_kernels.py``
runs them: over that file's shapes, a property sweep over T, float32 and
bfloat16, and ids past the end of the table (the reference clamps them to
the last cold row).  The wrapper's checks raise before any launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.kernels.gather_embed import ops as ref_ops  # noqa: E402
from repro.kernels.gather_embed.gather_embed import hot_gather_pallas  # noqa: E402
from repro_torch.kernels.gather_embed import (gather_ref, hot_gather,  # noqa: E402
                                              hot_gather_ref, split_gather,
                                              split_gather_ref)

SHAPES = [(128, 1024, 128, 256, 64), (256, 2048, 256, 100, 64),
          (64, 512, 128, 512, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tables(rng, h, v, d, dtype):
    jdt, tdt = DTYPES[dtype]
    hot = rng.normal(size=(h, d)).astype(np.float32)
    cold = rng.normal(size=(v - h, d)).astype(np.float32)
    return ((jnp.asarray(hot).astype(jdt), jnp.asarray(cold).astype(jdt)),
            (torch.from_numpy(hot).to(tdt), torch.from_numpy(cold).to(tdt)))


def _same(jax_out, torch_out):
    """Bitwise: float32 and bfloat16 values both widen exactly to float32."""
    assert torch_out.dtype in (torch.float32, torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jax_out.astype(jnp.float32)),
                                  torch_out.float().numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,v,d,t,tile", SHAPES)
def test_split_gather_matches_reference(h, v, d, t, tile, dtype):
    rng = np.random.default_rng(h + v)
    (jh, jc), (th, tc) = _tables(rng, h, v, d, dtype)
    ids = rng.integers(0, v, t).astype(np.int32)
    want = ref_ops.split_gather(jh, jc, jnp.asarray(ids), token_tile=tile)
    got = split_gather(th, tc, torch.from_numpy(ids))
    assert got.shape == (t, d) and got.dtype == th.dtype
    _same(want, got)
    assert torch.equal(got, gather_ref(torch.cat([th, tc]), torch.from_numpy(ids)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,v,d,t,tile", SHAPES)
def test_hot_gather_matches_pallas_kernel(h, v, d, t, tile, dtype):
    """Cold ids give zero rows, as in the TPU kernel; the port takes any T,
    the reference a multiple of its tile (padded here, then cut)."""
    rng = np.random.default_rng(h * v)
    (jh, _), (th, _) = _tables(rng, h, v, d, dtype)
    ids = rng.integers(0, v, t).astype(np.int32)
    pad = np.zeros((-t) % tile, np.int32)
    want = hot_gather_pallas(jnp.asarray(np.concatenate([ids, pad])), jh,
                             token_tile=tile)[:t]
    got = hot_gather(torch.from_numpy(ids), th)
    _same(want, got)
    cold = torch.from_numpy(ids) >= h
    assert bool((got[cold] == 0).all())
    assert torch.equal(got, hot_gather_ref(torch.from_numpy(ids), th))


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 200), st.integers(0, 1))
def test_split_gather_property(t, all_hot):
    rng = np.random.default_rng(t)
    (jh, jc), (th, tc) = _tables(rng, 64, 256, 128, "float32")
    hi = 64 if all_hot else 256
    ids = rng.integers(0, hi, t).astype(np.int32)
    want = ref_ops.split_gather(jh, jc, jnp.asarray(ids), token_tile=64)
    _same(want, split_gather(th, tc, torch.from_numpy(ids)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ids_past_the_table_read_the_last_cold_row(dtype):
    """H 4, C 6: ids 10 and 50 both read cold[5] in the reference; the
    port's plain version (and so the kernel it is held to) does the same."""
    rng = np.random.default_rng(7)
    (jh, jc), (th, tc) = _tables(rng, 4, 10, 16, dtype)
    ids = np.array([0, 3, 4, 9, 10, 50, 2**31 - 1], np.int32)
    want = ref_ops.split_gather(jh, jc, jnp.asarray(ids), token_tile=8)
    got = split_gather(th, tc, torch.from_numpy(ids))
    _same(want, got)
    for row in (4, 5, 6):
        assert torch.equal(got[row], tc[5])
    assert torch.equal(split_gather_ref(th, tc, torch.from_numpy(ids)), got)


def test_negative_ids_read_row_zero():
    """Outside the contract; the kernel clamps them to 0 and so does the
    plain version it is held to on the card."""
    th, tc = torch.randn(4, 8), torch.randn(6, 8)
    ids = torch.tensor([-1, -7, 2], dtype=torch.int32)
    got = split_gather(th, tc, ids)
    assert torch.equal(got[0], th[0]) and torch.equal(got[1], th[0])
    assert torch.equal(hot_gather(ids, th)[:2], th[[0, 0]])


def test_split_gather_takes_any_integer_ids_and_empty_batches():
    th, tc = torch.randn(4, 8), torch.randn(6, 8)
    ids = torch.tensor([[1, 7], [9, 0]])
    assert torch.equal(split_gather(th, tc, ids.reshape(-1)),
                       torch.cat([th, tc])[ids.reshape(-1)])
    assert split_gather(th, tc, ids[:0].reshape(-1)).shape == (0, 8)


def test_wrapper_checks_and_takes_plain_version_only_for_cpu_tensors():
    th, tc = torch.randn(4, 8), torch.randn(6, 8)
    ids = torch.tensor([1, 5], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or int64"):
        hot_gather(ids.to(torch.int16), th)
    with pytest.raises(ValueError, match=r"shape \(T,\)"):
        hot_gather(ids[None], th)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hot_gather(ids, th.double())
    with pytest.raises(TypeError, match="float32"):
        hot_gather(ids, th, tc.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        hot_gather(ids, th, torch.randn(6, 9))
    with pytest.raises(ValueError, match="C >= 1"):
        hot_gather(ids, th, tc[:0])
    with pytest.raises(ValueError, match="contiguous"):
        hot_gather(ids, torch.randn(8, 4).t())
    before = hot_gather.launches
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        hot_gather(ids.to("meta"), meta)
    hot_gather(ids, th, tc)
    assert hot_gather.launches == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int64_and_strided_ids_match_reference(dtype):
    """The kernel reads int32 or int64 ids through their stride; the plain
    path takes the same ids and is bitwise equal to ``hot_gather_pallas``
    and ``ops.split_gather`` on their contiguous int32 copies."""
    rng = np.random.default_rng(21)
    h, v, d, t = 64, 256, 128, 100
    (jh, jc), (th, tc) = _tables(rng, h, v, d, dtype)
    ids = rng.integers(0, v, t).astype(np.int32)
    pad = np.zeros((-t) % 64, np.int32)
    want_split = ref_ops.split_gather(jh, jc, jnp.asarray(ids), token_tile=64)
    want_hot = hot_gather_pallas(jnp.asarray(np.concatenate([ids, pad])), jh,
                                 token_tile=64)[:t]
    pair = torch.from_numpy(np.stack([ids, ids[::-1]], axis=1))  # (T, 2)
    cases = {"int64": pair[:, 0].long().contiguous(), "strided": pair[:, 0],
             "int64_strided": pair.long()[:, 0]}
    assert not cases["strided"].is_contiguous()
    for what, b in cases.items():
        _same(want_split, split_gather(th, tc, b))
        _same(want_hot, hot_gather(b, th))
        assert torch.equal(hot_gather(b, th, tc),
                           split_gather_ref(th, tc, b)), what


def test_embed_lookup_of_a_strided_prefill_column_equals_the_reference():
    """A prefill step embeds ``prompt[:, t:t + 1]``, a strided column: the
    port's lookup reads it as it lies and equals ``repro.lm.embed``'s."""
    import jax

    from repro.lm import embed as ref_embed
    from repro_torch.lm import embed

    dims = ref_embed.EmbedDims(3000, 32, 256)
    params, _ = ref_embed.embed_init(jax.random.PRNGKey(5), dims)
    m_embed = embed.embed_init(embed.EmbedDims(3000, 32, 256), device="cpu")
    assert set(m_embed) == set(params) and "cold" in m_embed
    prompt = np.random.default_rng(8).integers(0, 3000, (3, 9)).astype(np.int32)
    prompt[0, :3] = (0, 255, 256)  # the split
    tp = torch.from_numpy(prompt)
    with torch.no_grad():
        for k, v in params.items():
            m_embed[k].copy_(torch.from_numpy(np.array(v)))
        for t in range(prompt.shape[1]):
            col = tp[:, t:t + 1]
            assert not col.reshape(-1).is_contiguous()
            got = embed.embed_lookup(m_embed, col)
            want = ref_embed.embed_lookup(params, jnp.asarray(prompt[:, t:t + 1]),
                                          dims)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
