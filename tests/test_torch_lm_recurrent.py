"""``local`` ring attention (ROADMAP A12.3) and the recurrent mixers, SSD
and RG-LRU (A12.5), against ``repro.lm`` on identical inputs.

Per function: ``_mha_decode_ring`` over 2.5 windows, so the ring wraps
(outputs, the k/v ring and its ``pos`` plane); ``ssd`` at S a multiple of
the chunk and not, ``ssd_decode`` step by step with its states;
``rglru`` and ``rglru_decode``; ``_causal_conv`` with and without a state.
Per family (reduced RecurrentGemma-9B with ``window`` 8: RG-LRU + local
attention; reduced Mamba2-780M: SSD, no channel mixer): params through
``convert``, forward logits (rtol 1e-5, atol 1e-5; Mamba2 at S = 64 atol
1e-4, below), decode logits at every step (rtol 1e-4, atol 1e-5) and the
caches, ``generate`` tokens (also at a ``max_len`` below the sequence,
which a ring or a state takes, as the reference does), the port's forward
against its own decode in the reference's band, and ``loss_fn`` with every
gradient against ``jax.value_and_grad`` (rtol 1e-4, atol 1e-6; Mamba2
3e-6, below), all finite: the SSD mask inside the exponent keeps them so.

Bands measured here: Mamba2's forward logits at S = 64 (two SSD chunks of
32) differ by up to 5.9e-5 at logits up to ~5; a float64 run of the port
puts the port 2.8e-5 and the reference 4.1e-5 from the exact values, so
the gap is float32 rounding on both sides, amplified through the
inter-chunk exponentials; the test holds atol 1e-4 there.  Mamba2's
gradients: 3 elements of ``embed.hot`` 1.49e-6 apart (gradients of rows
read once, cancellation noise), held at atol 3e-6.  Mamba2 at its
published 48 layers (reduced width): forward and decode drift apart past
the reference's elementwise band in both packages, so each is held to
1e-3 relative L2 of a float64 forward (1.6e-4 measured).  RG-LRU's
log-depth scan (the reference's ``associative_scan`` groups its sums in
another tree) keeps RecurrentGemma within the dense band (6.6e-6
measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_parity as P  # noqa: E402
import repro.configs as ref_configs  # noqa: E402
from repro.lm import layers as ref_layers  # noqa: E402
from repro.lm import model as ref_model  # noqa: E402
from repro.lm import ssm as ref_ssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.lm import model, ssm  # noqa: E402

FAMILIES = {"recurrentgemma": ("recurrentgemma_9b", dict(window=8)),
            "mamba2": ("mamba2_780m", {})}
#: Mamba2's forward at two or more SSD chunks (measured need 5.9e-5)
SSD_FORWARD_ATOL = 1e-4
#: Mamba2 at its published depth (48 SSD layers), reduced width, S = 64:
#: the forward and the decode logits of either package, each as relative L2
#: from a float64 forward of the same weights (measured: the port 1.6e-4 and
#: 1.3e-4, the reference 1.6e-4 and 1.2e-4)
DEPTH_REL_L2 = 1e-3


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    arch, kw = FAMILIES[request.param]
    return P.make_pair(arch, **kw)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- ring
@pytest.mark.parametrize("n_kv", [1, 2])
def test_ring_decode_wraps_and_matches_the_reference(n_kv):
    """Window 8 over 20 positions: slots are overwritten from position 8 on;
    every step's output, then the ring and its positions."""
    kw = dict(window=8, n_kv_heads=n_kv)
    rcfg = ref_configs.reduced(ref_configs.get_config("recurrentgemma_9b"),
                               **kw)
    cfg = configs.reduced(configs.get_config("recurrentgemma_9b"), **kw)
    p, _ = ref_layers.attn_init(jax.random.PRNGKey(1), rcfg.d_model,
                                ref_model._attn_dims(rcfg))
    rc = ref_model._layer_cache(rcfg, "local", 2, 32, jnp.float32)
    c = model._layer_cache(cfg, "local", 2, 32, torch.device("cpu"),
                           torch.float32)
    assert c["k"].shape == rc["k"].shape == (2, 8, n_kv, cfg.head_dim)
    tp = _t(p)
    x = _x((2, 20, cfg.d_model), 2)
    ring = jax.jit(ref_model._mha_decode_ring, static_argnums=2)
    for t in range(20):
        want, rc = ring(p, jnp.asarray(x[:, t:t + 1]), rcfg, rc, t)
        got = model._mha_decode_ring(tp, torch.from_numpy(x[:, t:t + 1]),
                                     cfg, c, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"position {t}")
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(rc["pos"]))
    np.testing.assert_array_equal(c["pos"].numpy(),
                                  [16, 17, 18, 19, 12, 13, 14, 15])
    for key in ("k", "v"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(rc[key]),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- SSD
SSD = dict(d_model=64, d_state=16, d_head=16)


def _ssd(chunk, seed=0):
    rd = ref_ssm.SsdDims(chunk=chunk, **SSD)
    p, _ = ref_ssm.ssd_init(jax.random.PRNGKey(seed), rd)
    return rd, ssm.SsdDims(chunk=chunk, **SSD), p


@pytest.mark.parametrize("s,chunk", [(64, 32), (32, 32), (50, 16), (7, 16)])
def test_ssd_matches_the_reference(s, chunk):
    """S a multiple of the chunk (one and two chunks) and not (padded after
    the real tokens, cut back)."""
    rd, dims, p = _ssd(chunk)
    x = _x((2, s, 64), 1)
    want = jax.jit(ref_ssm.ssd, static_argnums=2)(p, jnp.asarray(x), rd)
    got = ssm.ssd(_t(p), torch.from_numpy(x), dims)
    assert got.shape == (2, s, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ssd_decode_matches_the_reference_every_step():
    rd, dims, p = _ssd(16, seed=2)
    x = _x((2, 12, 64), 3)
    rh = jnp.zeros((2, rd.n_heads, rd.d_state, rd.d_head))
    rconv = jnp.zeros((2, rd.d_conv - 1, rd.d_inner))
    h = torch.zeros((2, dims.n_heads, dims.d_state, dims.d_head))
    conv = torch.zeros((2, dims.d_conv - 1, dims.d_inner))
    tp = _t(p)
    for t in range(12):
        want, rh, rconv = ref_ssm.ssd_decode(p, jnp.asarray(x[:, t:t + 1]), rd,
                                             rh, rconv)
        got, h, conv = ssm.ssd_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      dims, h, conv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
    assert h.dtype == conv.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(conv.numpy(), np.asarray(rconv), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_the_reference(with_state):
    """``silu`` of the convolution, and the last K-1 inputs before it."""
    xs, w = _x((2, 9, 24), 4), _x((4, 24), 5)
    state = _x((2, 3, 24), 6) if with_state else None
    want, want_tail = ref_ssm._causal_conv(
        jnp.asarray(xs), jnp.asarray(w),
        None if state is None else jnp.asarray(state))
    got, tail = ssm._causal_conv(torch.from_numpy(xs), torch.from_numpy(w),
                                 None if state is None
                                 else torch.from_numpy(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(want_tail))
    np.testing.assert_array_equal(tail.numpy(), xs[:, -3:])


# ---------------------------------------------------------------- RG-LRU
def _rglru(seed=0):
    rd = ref_ssm.RglruDims(d_model=48)
    p, _ = ref_ssm.rglru_init(jax.random.PRNGKey(seed), rd)
    return rd, ssm.RglruDims(d_model=48), p


@pytest.mark.parametrize("s", [1, 37, 256])
def test_rglru_matches_the_reference(s):
    rd, dims, p = _rglru()
    x = _x((2, s, 48), 7)
    want = jax.jit(ref_ssm.rglru, static_argnums=2)(p, jnp.asarray(x), rd)
    got = ssm.rglru(_t(p), torch.from_numpy(x), dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_rglru_decode_matches_the_reference_and_its_forward():
    rd, dims, p = _rglru(seed=1)
    x = _x((2, 10, 48), 8)
    rh, rconv = jnp.zeros((2, 48)), jnp.zeros((2, 3, 48))
    h, conv = torch.zeros((2, 48)), torch.zeros((2, 3, 48))
    tp = _t(p)
    steps = []
    for t in range(10):
        want, rh, rconv = ref_ssm.rglru_decode(p, jnp.asarray(x[:, t:t + 1]),
                                               rd, rh, rconv)
        got, h, conv = ssm.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                        dims, h, conv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {t}")
        steps.append(got)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-5,
                               atol=1e-6)
    full = ssm.rglru(tp, torch.from_numpy(x), dims)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- families
def test_params_round_trip(pair):
    P.check_round_trip(pair)


@pytest.mark.parametrize("s", [32, 64])
def test_forward_logits_match_the_reference(pair, s):
    ssd_chunks = pair.cfg.family == "ssm" and s > pair.cfg.ssm_chunk
    P.check_forward(pair, s, atol=SSD_FORWARD_ATOL if ssd_chunks else 1e-5)


def test_decode_logits_match_the_reference_every_step(pair):
    """16 steps: RecurrentGemma's ring of 8 wraps twice."""
    rcache, cache = P.check_decode(pair)
    for i, lc in enumerate(cache["layers"]):
        want = P.ref_layer_cache(rcache, pair.cfg, i)
        assert set(lc) == set(want)
        for key, t in lc.items():
            if key == "pos":
                np.testing.assert_array_equal(t.numpy(), want[key])
            else:
                np.testing.assert_allclose(t.numpy(), want[key], rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"layer {i} {key}")


@pytest.mark.parametrize("max_len", [None, 6])
def test_generate_tokens_equal_the_reference(pair, max_len):
    """``max_len`` 6 < 16 positions: the ring (6 slots) and the states take
    it, with no check, as in the reference."""
    P.check_generate(pair, max_len=max_len)


def test_a_linear_cache_still_bounds_max_len():
    from repro_torch.lm.serve import generate

    cfg = configs.reduced(configs.get_config("yi_9b"))
    assert model.has_linear_cache(cfg)
    assert not model.has_linear_cache(
        configs.reduced(configs.get_config("recurrentgemma_9b")))
    with pytest.raises(ValueError, match="max_len"):
        generate(model.init_params(cfg, device="cpu"),
                 torch.zeros((1, 4), dtype=torch.int32), max_new=4,
                 max_len=6)


def test_forward_matches_its_own_decode(pair):
    P.check_forward_against_own_decode(pair.m)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_mamba2_at_depth_drifts_as_the_reference_does(monkeypatch):
    """At 48 SSD layers float32 rounding carries forward and decode apart,
    past the reference's elementwise band between the two, in the reference
    as in the port: the reference's own pair misses it (6.6x over the 64
    positions, 1.65x at the last; the port 8.7x and 1.61x).  Both packages'
    forward and decode stay within DEPTH_REL_L2 of a float64 forward of the
    port (the weights widened exactly, the embedding rows read in float32
    and widened), and the port's gap between the two is the reference's
    (1.58e-4 against 1.52e-4, relative L2)."""
    import copy

    from repro_torch.lm import embed

    s = 64
    p = P.make_pair("mamba2_780m", n_layers=48)
    toks = P.tokens(p.cfg, s, 5)
    ref_full = np.asarray(ref_model.forward(p.params, p.rcfg,
                                            jnp.asarray(toks))[0])
    rcache = ref_model.init_cache(p.rcfg, 2, s + 1, dtype=jnp.float32)
    step = jax.jit(lambda prm, c, t: ref_model.decode_step(prm, p.rcfg, c, t))
    ref_dec = []
    for t in range(s):
        lg, rcache = step(p.params, rcache, jnp.asarray(toks[:, t:t + 1]))
        ref_dec.append(np.asarray(lg)[:, 0])
    ref_dec = np.stack(ref_dec, 1)
    tt = torch.from_numpy(toks)
    cache = model.init_cache(p.cfg, 2, s + 1, device="cpu",
                             dtype=torch.float32)
    dec = []
    with torch.no_grad():
        full = model.forward(p.m, tt)[0].numpy()
        for t in range(s):
            lg, cache = model.decode_step(p.m, cache, tt[:, t:t + 1])
            dec.append(lg[:, 0].numpy())
        dec = np.stack(dec, 1)
        real = embed.embed_lookup
        monkeypatch.setattr(embed, "embed_lookup", lambda prm, ids: real(
            {k: v.float() for k, v in prm.items()}, ids).double())
        exact = model.forward(copy.deepcopy(p.m).double(), tt)[0]
    assert exact.dtype == torch.float64
    exact = exact.numpy()

    def used(a, b):
        return float((np.abs(a - b) / (P.SELF_ATOL + P.SELF_RTOL * np.abs(b))
                      ).max())

    assert used(ref_full, ref_dec) > 1 and used(ref_full[:, -1],
                                                ref_dec[:, -1]) > 1
    for name, x in (("port forward", full), ("port decode", dec),
                    ("reference forward", ref_full),
                    ("reference decode", ref_dec)):
        assert _rel_l2(x, exact) <= DEPTH_REL_L2, name
    assert _rel_l2(full, dec) <= 2 * _rel_l2(ref_full, ref_dec)


def test_loss_and_gradients_match_the_reference(pair):
    # Mamba2's embed.hot: 3 of 16,384 elements 1.49e-6 apart (cancellation
    # noise in rows read once), past the dense slice's atol 1e-6
    P.check_loss_and_grads(pair, atol=3e-6 if pair.cfg.family == "ssm"
                           else 1e-6)


def test_ssd_gradients_are_finite_past_the_mask():
    """Long chunks with strong decay: the upper triangle's exponent would
    overflow if the mask came after ``exp``; every gradient stays finite."""
    dims = ssm.SsdDims(chunk=64, **SSD)
    m = torch.nn.Module()
    m.p = ssm.ssd_init(dims, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    with torch.no_grad():
        # A = -exp(A_log) down to -16·e^4: the upper triangle's exponents
        # reach the thousands, far past float32's e^88
        m.p["A_log"].add_(4.0)
    x = torch.from_numpy(_x((1, 64, 64), 9)).requires_grad_(True)
    ssm.ssd(m.p, x, dims).square().sum().backward()
    assert torch.isfinite(x.grad).all()
    assert all(torch.isfinite(q.grad).all() for q in m.parameters())
