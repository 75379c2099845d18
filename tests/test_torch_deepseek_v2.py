"""DeepSeek-V2-Lite as published (``configs.deepseek_v2_lite``) against the
plain reference of its published equations (``tests/deepseek_v2_ref.py``),
on the CPU at the ``reduced()`` size, on seeded random weights with every
RMSNorm scale drawn from U(0.5, 1.5).

The preset against the published ``config.json`` (the benchmark's file of
it), key for key; YaRN's frequencies, ``mscale`` and softmax scale against
the published formula; the full forward's logits; prefill then decode
through the cache (``generate`` with ``return_logits``) against the
reference's forward at every position; a ragged batch equal to each
sequence decoded alone, and raising on a model whose caches hold one
position; the fixed step a decode graph records equal to the plain one,
bitwise, at ragged and at equal lengths; the absorbed decode equal to the unabsorbed one on a bf16 cache;
the drop-free, unrenormalised MoE equal to the dense oracle where the
capacity-bounded one drops.

Bands: the port and the reference both compute in float32 and differ in
the order of their sums (blockwise attention and absorbed decode against
one softmax over expanded keys), a few ulps per value: rtol 1e-4 and atol
1e-5 on logits, as the port's decode band against ``repro``
(``lm_parity.DECODE_RTOL``).
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import deepseek_v2_ref as R
from repro_torch import configs
from repro_torch.lm import layers, model, moe
from repro_torch.lm.serve import DecodeGraph, generate
from repro_torch.obs import metrics

RTOL, ATOL = 1e-4, 1e-5
BENCH_CONFIG = R.ROOT / "bench" / "configs" / "deepseek-v2-lite.json"


@pytest.fixture(scope="module")
def lm():
    cfg = configs.reduced(configs.get_config("deepseek_v2_lite"))
    m = model.LM(cfg, generator=torch.Generator().manual_seed(0))
    R.scale_norms(m, seed=1)
    return m


def _tokens(cfg, b, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s))).to(torch.int32)


# ---------------------------------------------------------------- config
def test_preset_is_the_published_config():
    """The port's preset holds the published ``config.json`` (the catalog
    row the benchmark's configuration file copies) value for value."""
    pub = json.loads(BENCH_CONFIG.read_text())
    cfg = configs.get_config("deepseek-v2-lite")
    assert dataclasses.asdict(R.published(cfg)) == {
        k: v for k, v in dataclasses.asdict(R.Published.of(pub)).items()}
    assert (cfg.d_ff, cfg.moe_d_ff, cfg.n_shared_experts) == (
        pub["intermediate_size"], pub["moe_intermediate_size"],
        pub["n_shared_experts"])
    assert pub["q_lora_rank"] is None and pub["topk_method"] == "greedy"
    assert pub["scoring_func"] == "softmax" and not pub["tie_word_embeddings"]
    assert cfg.n_heads == cfg.n_kv_heads == pub["num_key_value_heads"]
    assert cfg.hot_vocab_rows == 16384 and "hot_vocab_rows" in pub["assumed"]


def test_old_preset_keeps_the_jax_packages_reading():
    """``deepseek_v2_lite_16b`` has none of the published options: its
    layers, routing and rope are the JAX package's."""
    cfg = configs.get_config("deepseek_v2_lite_16b")
    assert (cfg.first_dense_layers, cfg.moe_norm_topk, cfg.moe_drop_free,
            cfg.mla_latent_norm, cfg.yarn_factor) == (0, True, False, False,
                                                      0.0)
    assert model._yarn(cfg) is None
    assert model._mla_dims(cfg).scale == 1.0 / math.sqrt(192)


def test_reduced_keeps_the_published_options():
    full = configs.get_config("deepseek_v2_lite")
    cfg = configs.reduced(full)
    for f in ("first_dense_layers", "moe_norm_topk", "moe_drop_free",
              "mla_latent_norm", "yarn_factor", "yarn_mscale",
              "yarn_mscale_all_dim", "yarn_original_max_pos",
              "yarn_beta_fast", "yarn_beta_slow"):
        assert getattr(cfg, f) == getattr(full, f), f
    assert [cfg.layer_kind(i) for i in range(cfg.n_layers)] == [
        ("mla", "mlp"), ("mla", "moe")]


# ---------------------------------------------------------------- YaRN
def test_yarn_frequencies_and_mscale_match_the_formula():
    """DeepSeek-V2-Lite's numbers worked by hand: d 64, θ 1e4, factor 40,
    original length 4,096, β 32 / 1 give the correction range
    [floor(10.39), ceil(22.97)] = [10, 23]; mscale(40, 0.707) = 1 +
    0.0707 ln 40; cos/sin scaled by 1; the softmax by 192^-0.5 mscale²."""
    cfg = configs.get_config("deepseek_v2_lite")
    yarn = model._yarn(cfg)
    d, theta = 64, 10000.0
    i = np.arange(32, dtype=np.float64)
    extra = theta ** (-2 * i / d)
    ramp = np.clip((i - 10) / (23 - 10), 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    got = layers.rope_inv_freq(d, theta, yarn).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(R.yarn_inv_freq(R.published(cfg)).numpy(),
                               want, rtol=1e-6)
    m = 1 + 0.1 * 0.707 * math.log(40)
    assert layers.yarn_mscale(40, 0.707) == pytest.approx(m, rel=1e-12)
    assert yarn.cos_sin_scale == 1.0
    assert model._mla_dims(cfg).scale == pytest.approx(
        192 ** -0.5 * m * m, rel=1e-12)
    assert R.softmax_scale(R.published(cfg)) == pytest.approx(
        192 ** -0.5 * m * m, rel=1e-12)
    assert layers.yarn_mscale(1.0, 0.707) == 1.0


def test_rope_without_yarn_is_unchanged():
    x = torch.randn(2, 5, 3, 8, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)[None].expand(2, 5)
    half = 4
    f = 10000.0 ** (-torch.arange(half, dtype=torch.float32) / half)
    ang = pos[..., None].float() * f
    c, s = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    want = torch.cat([x[..., :half] * c - x[..., half:] * s,
                      x[..., half:] * c + x[..., :half] * s], dim=-1)
    torch.testing.assert_close(layers.rope(x, pos), want, rtol=0, atol=0)


# ---------------------------------------------------------------- forward
def test_forward_logits_match_the_reference(lm):
    cfg = lm.cfg
    toks = _tokens(cfg, 2, 24)
    got, _ = model.forward(lm, toks)
    want = R.forward(R.weights(lm), R.published(cfg), toks)
    np.testing.assert_allclose(got[..., :cfg.vocab_size].detach().numpy(),
                               want.numpy(), rtol=RTOL, atol=ATOL)


def test_prefill_then_decode_matches_the_reference_forward(lm):
    """``generate`` feeds the prompt through ``decode_step`` and then its
    own greedy picks: every step's logits equal the reference's forward
    over the generated tokens at that position."""
    cfg = lm.cfg
    prompt = _tokens(cfg, 2, 10, seed=3)
    toks, steps = generate(lm, prompt, max_new=6, return_logits=True)
    want = R.forward(R.weights(lm), R.published(cfg), toks)
    got = torch.cat(steps, dim=1)[..., :cfg.vocab_size]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def _fill(lm, cache, b, toks):
    """Prefill sequence ``b`` of ``cache`` alone with ``toks`` (1, S):
    every other sequence's rows are untouched."""
    one = model.init_cache(lm.cfg, 1, cache["layers"][0]["latent"].shape[1],
                           device="cpu", dtype=cache["layers"][0]
                           ["latent"].dtype)
    for t in range(toks.shape[1]):
        model.decode_step(lm, one, toks[:, t:t + 1])
    for layer, mine in zip(cache["layers"], one["layers"]):
        for k in layer:
            layer[k][b] = mine[k][0]


def test_a_ragged_batch_equals_each_sequence_alone(lm):
    """Three sequences at lengths 3, 11 and 7 decode 4 steps in one batch:
    each step's logits and the rows written equal that sequence's own
    decode, and the lengths advance per sequence."""
    cfg = lm.cfg
    lens = [3, 11, 7]
    hist = [_tokens(cfg, 1, n, seed=10 + i) for i, n in enumerate(lens)]
    nxt = _tokens(cfg, 3, 4, seed=20)
    cache = model.init_cache(cfg, 3, 24, device="cpu", dtype=torch.float32)
    for b, h in enumerate(hist):
        _fill(lm, cache, b, h)
    model.set_lengths(cache, lens)
    alone = []
    for b, h in enumerate(hist):
        c = model.init_cache(cfg, 1, 24, device="cpu", dtype=torch.float32)
        for t in range(h.shape[1]):
            model.decode_step(lm, c, h[:, t:t + 1])
        alone.append(c)
    for t in range(4):
        got, cache = model.decode_step(lm, cache, nxt[:, t:t + 1])
        for b in range(3):
            want, alone[b] = model.decode_step(lm, alone[b],
                                               nxt[b:b + 1, t:t + 1])
            np.testing.assert_allclose(got[b].numpy(), want[0].numpy(),
                                       rtol=RTOL, atol=ATOL)
    assert list(cache["len"]) == [n + 4 for n in lens]
    assert cache["len_dev"].tolist() == [n + 4 for n in lens]
    for b in range(3):
        n = lens[b] + 4
        for layer, mine in zip(cache["layers"], alone[b]["layers"]):
            np.testing.assert_allclose(layer["latent"][b, :n].numpy(),
                                       mine["latent"][0, :n].numpy(),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_780m"])
def test_a_ragged_batch_raises_where_caches_hold_one_position(arch):
    cfg = configs.reduced(configs.get_config(arch))
    assert not model.takes_ragged(cfg)
    m = model.LM(cfg, generator=torch.Generator().manual_seed(0))
    cache = model.init_cache(cfg, 2, 16, device="cpu", dtype=torch.float32)
    model.set_lengths(cache, [2, 5])
    with pytest.raises(ValueError, match="lengths 2 to 5"):
        model.decode_step(m, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert model.takes_ragged(configs.get_config("deepseek_v2_lite"))


@pytest.mark.parametrize("lens", [[3, 11, 7], [6, 6, 6]])
def test_the_decode_graphs_fixed_step_is_the_plain_step(lm, lens):
    """``DecodeGraph`` on the CPU runs the fixed step (device positions,
    never a uniform slice): logits, every row written, the lengths and the
    rows counted equal the plain ``decode_step``'s, bitwise, over steps and
    a new turn that sets the lengths back."""
    cfg = lm.cfg
    nxt = _tokens(cfg, 3, 5, seed=30)
    caches, counted = [], []
    for graphed in (False, True):
        metrics.reset_registry()
        cache = model.init_cache(cfg, 3, 24, device="cpu",
                                 dtype=torch.float32)
        g = torch.Generator().manual_seed(3)
        for layer in cache["layers"]:
            for t in layer.values():
                t.copy_(torch.randn(t.shape, generator=g))
        model.set_lengths(cache, lens)
        step = DecodeGraph(lm, cache) if graphed else None
        assert not graphed or step.graph is None and step.room == 24
        out = []
        for t in range(5):
            if t == 3:
                model.set_lengths(cache, [n + 1 for n in lens])
            tok = nxt[:, t:t + 1]
            out.append(step(tok)[0] if graphed else
                       model.decode_step(lm, cache, tok)[0])
        caches.append((cache, out))
        counted.append(metrics.get_registry().get(
            "lm.mla_decode.cache_rows").value)
    metrics.reset_registry()
    (plain, want), (fixed, got) = caches
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for la, lb in zip(fixed["layers"], plain["layers"]):
        for k in la:
            assert torch.equal(la[k], lb[k])
    assert list(fixed["len"]) == list(plain["len"]) == [n + 3 for n in lens]
    assert fixed["len_dev"].tolist() == [n + 3 for n in lens]
    assert counted[0] == counted[1] > 0


def test_a_decode_graph_raises_where_caches_hold_one_position():
    cfg = configs.reduced(configs.get_config("recurrentgemma_9b"))
    m = model.LM(cfg, generator=torch.Generator().manual_seed(0))
    cache = model.init_cache(cfg, 2, 16, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="a length per sequence"):
        DecodeGraph(m, cache)


def test_absorbed_decode_equals_the_unabsorbed_one(lm):
    """``mla_decode`` (k_up folded into the query, v_up into the output)
    against the reference's attention that expands every head's keys and
    values, per sequence at its own length, over a bf16 cache; the row it
    writes equals the reference's."""
    cfg = lm.cfg
    p = lm.layers[1].mix
    dims = model._mla_dims(cfg)
    g = torch.Generator().manual_seed(5)
    b, s_max = 3, 40
    lens = np.array([1, 17, 39])
    lat = torch.randn(b, s_max, cfg.kv_lora, generator=g).to(torch.bfloat16)
    kr = torch.randn(b, s_max, cfg.mla_d_rope,
                     generator=g).to(torch.bfloat16)
    x = torch.randn(b, 1, cfg.d_model, generator=g)
    at = layers.DecodeAt(lens, torch.from_numpy(lens))
    with torch.no_grad():
        got = layers.mla_decode(p, x, dims, lat, kr, at,
                                rope_theta=cfg.rope_theta)
    w = R.weights(lm)
    pub = R.published(cfg)
    for i in range(b):
        n = int(lens[i])
        pos = torch.tensor([n])
        latent, krope = R.new_rows(w, 1, pub, x[i], pos)
        np.testing.assert_allclose(
            lat[i, n].float().numpy(),
            latent[0].to(torch.bfloat16).float().numpy(), rtol=0, atol=0)
        want = R.attention(w, 1, pub, x[i], pos,
                            torch.cat([lat[i, :n].float(),
                                       lat[i, n:n + 1].float()]),
                            torch.cat([kr[i, :n].float(),
                                       kr[i, n:n + 1].float()]))
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_latent_attention_reads_only_each_sequences_rows():
    """The plain path's chunks (4,096 rows by default, 8 here) over rows
    past a sequence's length that hold NaN: never read."""
    from repro_torch.kernels.mla_decode import latent_attention_ref

    g = torch.Generator().manual_seed(0)
    b, h, c, r, s = 2, 3, 16, 4, 30
    ql, qr = torch.randn(b, h, c, generator=g), torch.randn(b, h, r,
                                                            generator=g)
    lat, kr = torch.randn(b, s, c, generator=g), torch.randn(b, s, r,
                                                             generator=g)
    rows = torch.tensor([5, 21])
    lat[0, 5:], kr[1, 21:] = float("nan"), float("nan")
    got = latent_attention_ref(ql, qr, lat, kr, rows, 0.3, 21, chunk=8)
    for i, n in enumerate(rows.tolist()):
        sc = (ql[i] @ lat[i, :n].T + qr[i] @ kr[i, :n].T) * 0.3
        want = torch.softmax(sc, dim=-1) @ lat[i, :n]
        torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- MoE
def test_drop_free_unrenormalised_moe_equals_the_dense_oracle():
    """Most tokens routed to one expert (a router that prefers expert 0):
    capacity-bounded panels drop slots, drop-free ones hold them all, and
    the output equals the dense oracle with the top-k probabilities as
    they are (summing to less than 1)."""
    dims = moe.MoeDims(32, 16, 8, 3, 1, norm_topk=False, drop_free=True)
    p = moe.moe_init(dims, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        p["router"]["w"][:, 0] += 0.2
    x = torch.randn(2, 20, 32, generator=torch.Generator().manual_seed(1))
    x[..., :] += 1.0  # every token's router logit of expert 0 is large
    _, top_e, top_p = moe.route(p, x.reshape(40, 32), dims)
    assert (top_e == 0).any(-1).float().mean() > 0.5
    assert (top_p.sum(-1) < 1).all()
    capped = dataclasses.replace(dims, drop_free=False)
    _, keep = moe.stable_bin_dispatch(top_e, 8, moe.capacity(40, capped))
    assert not keep.all()
    assert moe.capacity(40, dims) >= 40
    got, _ = moe.moe_apply(p, x, dims)
    np.testing.assert_allclose(got.detach().numpy(),
                               moe.moe_apply_ref(p, x, dims).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
