"""The full-sequence forward against ``repro.lm`` on identical weights.

The reference's params cross through ``convert.lm_params_from_numpy``;
``forward``'s logits (also ``last_only`` and ``return_hidden``) agree with
``repro.lm.model.forward`` in float32 within rtol 1e-5, atol 1e-5 at S = 64
(one block) and S = 1,024 (two blocks of 512: the online softmax crosses
blocks).  The atol is the measured need, 5.3e-6 at logits up to ~5, from
XLA's and PyTorch's float32 ``exp``/``sin``/``rsqrt`` differing by an ulp;
one layer's ``mha`` holds atol 1e-6.  The port's forward against its own
``decode_step`` at every position in the reference's decode band (rtol
2e-2, atol 2e-4); one embedding lookup per forward.  The other block
kinds' forwards, with ``prefix`` and ``frames``, are held to the reference
in ``test_torch_lm_mla_moe``, ``test_torch_lm_recurrent`` and
``test_torch_lm_stubs``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.lm import layers as ref_layers  # noqa: E402
from repro.lm import model as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.gather_embed import ops as k2_ops  # noqa: E402
from repro_torch.lm import layers, model  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
CASES = {"yi_gqa": ("yi_9b", dict(n_kv_heads=2)), "olmo": ("olmo_1b", {})}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    arch, kw = CASES[request.param]
    rcfg = ref_configs.reduced(ref_configs.get_config(arch), **kw)
    cfg = configs.reduced(configs.get_config(arch), **kw)
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return rcfg, cfg, params, lm_params_from_numpy(tree, cfg, device="cpu")


def _tokens(cfg, s, seed=1, b=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("s", [64, 1024])
def test_forward_logits_match_the_reference(pair, s):
    rcfg, cfg, params, m = pair
    toks = _tokens(cfg, s)
    want, want_aux = ref_model.forward(params, rcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = model.forward(m, torch.from_numpy(toks))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(aux) == float(want_aux) == 0.0


def test_last_only_and_return_hidden_match_the_reference(pair):
    rcfg, cfg, params, m = pair
    toks = _tokens(cfg, 64, seed=2)
    with torch.no_grad():
        full, _ = model.forward(m, torch.from_numpy(toks))
        last, _ = model.forward(m, torch.from_numpy(toks), last_only=True)
        hidden, _ = model.forward(m, torch.from_numpy(toks),
                                  return_hidden=True)
    want_last, _ = ref_model.forward(params, rcfg, jnp.asarray(toks),
                                     last_only=True)
    want_hidden, _ = ref_model.forward(params, rcfg, jnp.asarray(toks),
                                       return_hidden=True)
    assert last.shape == (2, 1, full.shape[-1])
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert hidden.shape == (2, 64, cfg.d_model)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden),
                               rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        logits = model.unembed_apply(m, hidden)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("window", [None, 1, 16, 40, 96])
def test_mha_window_matches_the_reference(window):
    """128 positions in blocks of 32, so whole key blocks fall out of the
    window (or after every query) and the port skips them."""
    rng = np.random.default_rng(3)
    b, s, d, h, hkv, dh = 2, 128, 64, 4, 2, 16
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    shapes = dict(q=(d, h * dh), k=(d, hkv * dh), v=(d, hkv * dh),
                  o=(h * dh, d))
    w = {k: (rng.normal(size=sh) / np.sqrt(sh[0])).astype(np.float32)
         for k, sh in shapes.items()}
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = ref_layers.mha({k: {"w": jnp.asarray(v)} for k, v in w.items()},
                          jnp.asarray(x), ref_layers.AttnDims(h, hkv, dh),
                          positions=jnp.asarray(pos), window=window,
                          block_q=32, block_k=32)
    got = layers.mha({k: {"w": torch.from_numpy(v)} for k, v in w.items()},
                     torch.from_numpy(x), layers.AttnDims(h, hkv, dh),
                     positions=torch.from_numpy(pos), window=window,
                     block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_blockwise_attention_in_bfloat16_matches_the_reference():
    """bf16 inputs: scores in bf16, max/sum/accumulator in float32, the
    output cast back; within two bf16 ulps of the output's scale."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 64, hh, 16)).astype(np.float32)
               for hh in (4, 2, 2))
    bf = jnp.bfloat16
    want = ref_layers._blockwise_causal_attn(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        block_q=16, block_k=16)
    got = layers._blockwise_causal_attn(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        block_q=16, block_k=16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2 ** -8 * np.abs(want).max())


def test_sequence_must_be_a_multiple_of_the_block():
    q = torch.zeros((1, 48, 2, 8))
    with pytest.raises(ValueError, match="multiple of the blocks"):
        layers._blockwise_causal_attn(q, q, q, block_q=32, block_k=32)


def test_forward_matches_its_own_decode_in_the_reference_band(pair):
    _, cfg, _, m = pair
    toks = torch.from_numpy(_tokens(cfg, 16, seed=5))
    with torch.no_grad():
        full, _ = model.forward(m, toks)
    cache = model.init_cache(cfg, 2, 32, device="cpu", dtype=torch.float32)
    for t in range(16):
        logits, cache = model.decode_step(m, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(full[:, t].numpy(), logits[:, 0].numpy(),
                                   rtol=2e-2, atol=2e-4, err_msg=f"step {t}")


def test_forward_makes_one_embedding_gather(pair, monkeypatch):
    _, cfg, _, m = pair
    calls = []
    real = k2_ops.hot_gather

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(k2_ops, "hot_gather", spy)
    toks = torch.from_numpy(_tokens(cfg, 64, seed=6))
    model.forward(m, toks)
    model.loss_fn(m, toks, toks, loss_chunk=16)
    assert calls == [(128,), (128,)]


def test_remat_recomputes_the_same_forward(pair):
    import dataclasses

    _, cfg, _, m = pair
    toks = torch.from_numpy(_tokens(cfg, 64, seed=7))
    a, _ = model.forward(m, toks)
    assert a.requires_grad  # the checkpoint runs only under grad
    m.cfg = dataclasses.replace(cfg, remat=True)
    try:
        b, _ = model.forward(m, toks)
    finally:
        m.cfg = cfg
    assert torch.equal(a, b)
