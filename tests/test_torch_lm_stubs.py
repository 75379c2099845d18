"""The enc-dec and VLM stubs (ROADMAP A12.6) against ``repro.lm`` on
identical inputs.

Per function: ``mha_bidir`` (the encoder's unmasked blockwise softmax,
one block and several) and ``cross_attn`` over a memory of another length
than the queries.  Per family (reduced PaliGemma-3B: a projected patch
prefix before the tokens, GELU MLPs, MQA; reduced SeamlessM4T: an encoder
of ``bidir`` layers over stub frames, cross attention in every decoder
layer): params through ``convert`` (the encoder's stack unstacked), forward
logits with ``prefix`` / ``frames`` (rtol 1e-5, atol 1e-5), decode logits
at every step (rtol 1e-4, atol 1e-5), ``generate`` tokens, the port's
forward against its own decode in the reference's band, and ``loss_fn``
with its prefix positions left out.

A reference semantic the port keeps: decode's cross attention reads the
cache's ``cross_k``/``cross_v``, zeros over 4,096 positions that nothing
fills, so it adds exactly 0; the forward against decode therefore runs
with a zero memory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_parity as P  # noqa: E402
from repro.lm import layers as ref_layers  # noqa: E402
from repro.lm import model as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.lm import layers, model  # noqa: E402

FAMILIES = {"paligemma": "paligemma_3b", "seamless": "seamless_m4t_large_v2"}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    return P.make_pair(FAMILIES[request.param])


def _attn(h, hkv, dh, d=64, seed=0):
    rng = np.random.default_rng(seed)
    shapes = dict(q=(d, h * dh), k=(d, hkv * dh), v=(d, hkv * dh),
                  o=(h * dh, d))
    return {k: {"w": (rng.normal(size=sh) / np.sqrt(sh[0])).astype(
        np.float32)} for k, sh in shapes.items()}


def _both(w):
    return (jax.tree.map(jnp.asarray, w),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), w))


@pytest.mark.parametrize("s,block,hkv", [(32, 512, 4), (96, 32, 2)])
def test_mha_bidir_matches_the_reference(s, block, hkv):
    jw, tw = _both(_attn(4, hkv, 16))
    x = np.random.default_rng(1).normal(size=(2, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want = ref_layers.mha_bidir(jw, jnp.asarray(x),
                                ref_layers.AttnDims(4, hkv, 16),
                                positions=jnp.asarray(pos), block=block)
    got = layers.mha_bidir(tw, torch.from_numpy(x),
                           layers.AttnDims(4, hkv, 16),
                           positions=torch.from_numpy(pos), block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_mha_bidir_sees_the_future():
    """Unlike the causal attention, an early position's output moves when a
    later token changes."""
    _, tw = _both(_attn(4, 4, 16, seed=2))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 16, 64)).astype(np.float32))
    pos = torch.arange(16, dtype=torch.int32)[None]
    a = layers.mha_bidir(tw, x, layers.AttnDims(4, 4, 16), positions=pos)
    x2 = x.clone()
    x2[:, -1] += 1.0
    b = layers.mha_bidir(tw, x2, layers.AttnDims(4, 4, 16), positions=pos)
    assert not torch.allclose(a[:, 0], b[:, 0])


@pytest.mark.parametrize("s,sm,hkv", [(8, 24, 4), (12, 5, 1)])
def test_cross_attn_matches_the_reference(s, sm, hkv):
    jw, tw = _both(_attn(4, hkv, 16, seed=3))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    mem = rng.normal(size=(2, sm, 64)).astype(np.float32)
    want = ref_layers.cross_attn(jw, jnp.asarray(x), jnp.asarray(mem),
                                 ref_layers.AttnDims(4, hkv, 16))
    got = layers.cross_attn(tw, torch.from_numpy(x), torch.from_numpy(mem),
                            layers.AttnDims(4, hkv, 16))
    assert got.shape == (2, s, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------- families
def test_params_round_trip(pair):
    P.check_round_trip(pair)
    cfg, m = pair.cfg, pair.m
    if cfg.n_enc_layers:
        assert len(m.encoder) == cfg.n_enc_layers
        assert all(b.mixer == "bidir" and b.channel == "mlp"
                   for b in m.encoder)
        np.testing.assert_array_equal(
            m.encoder[1].mix["q"]["w"].detach().numpy(),
            pair.tree["encoder"]["mix"]["q"]["w"][1])
        assert all(hasattr(b, "cross") for b in m.layers)
    if cfg.prefix_len:
        np.testing.assert_array_equal(m.prefix_proj["w"].detach().numpy(),
                                      pair.tree["prefix_proj"]["w"])


@pytest.mark.parametrize("s", [16, 48])
def test_forward_logits_match_the_reference(pair, s):
    P.check_forward(pair, s)


def test_forward_needs_its_stub_inputs(pair):
    toks = torch.zeros((1, 4), dtype=torch.int32)
    if pair.cfg.n_enc_layers:
        with pytest.raises(ValueError, match="frames"):
            model.forward(pair.m, toks)
    else:
        with pytest.raises(ValueError, match="no encoder"):
            model.forward(pair.m, toks,
                          frames=torch.zeros((1, 4, pair.cfg.d_model)))


def test_decode_logits_match_the_reference_every_step(pair):
    rcache, cache = P.check_decode(pair)
    if pair.cfg.n_enc_layers:
        assert cache["cross_k"].shape == (2, 4096, pair.cfg.n_kv_heads,
                                          pair.cfg.head_dim)
        assert not cache["cross_k"].any() and not cache["cross_v"].any()
        np.testing.assert_array_equal(cache["cross_k"].numpy(),
                                      np.asarray(rcache["cross_k"]))


def test_generate_tokens_equal_the_reference(pair):
    P.check_generate(pair)


def test_forward_matches_its_own_decode(pair, monkeypatch):
    """Decode's cross attention adds exactly 0 (the cache's memory is
    zeros); so does the forward's over a zero memory."""
    if pair.cfg.n_enc_layers:
        monkeypatch.setattr(model, "_encode",
                            lambda m, frames: torch.zeros_like(frames))
        real = model.forward

        def with_frames(m, toks, **kw):
            return real(m, toks, frames=torch.zeros(
                (toks.shape[0], 8, m.cfg.d_model)), **kw)

        monkeypatch.setattr(model, "forward", with_frames)
    P.check_forward_against_own_decode(pair.m)


def test_cross_decode_adds_exactly_zero():
    """The kept reference semantic, one layer: over the cache's zero memory
    the cross attention's output is exactly 0 (a uniform softmax over zero
    values), whatever the query."""
    cfg = configs.reduced(configs.get_config("seamless_m4t_large_v2"))
    m = model.init_params(cfg, seed=1, device="cpu")
    cache = model.init_cache(cfg, 2, 4, device="cpu", dtype=torch.float32)
    x = torch.randn((2, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    with torch.no_grad():
        out = model._cross_decode(m.layers[0].cross, x, cfg,
                                  cache["cross_k"], cache["cross_v"])
    assert out.shape == x.shape and not out.any()


def test_loss_leaves_the_prefix_out(pair):
    """``loss_fn`` against the reference's value and its gradients, with
    the family's stub inputs (PaliGemma's prefix positions are sliced off
    the logits, at ``loss_chunk`` 0 and 8 alike)."""
    P.check_loss_and_grads(pair, s=16)
    toks = P.tokens(pair.cfg, 16, 7)
    ex = {k: torch.from_numpy(v) for k, v in P.extras(pair.cfg, 7).items()}
    t = torch.from_numpy(toks)
    with torch.no_grad():
        whole = model.loss_fn(pair.m, t, t, **ex)
        chunked = model.loss_fn(pair.m, t, t, loss_chunk=8, **ex)
    want = ref_model.loss_fn(pair.params, pair.rcfg, jnp.asarray(toks),
                             jnp.asarray(toks), loss_chunk=8,
                             **{k: jnp.asarray(v.numpy())
                                for k, v in ex.items()})
    np.testing.assert_allclose(float(chunked), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(whole), float(chunked), rtol=1e-5)
