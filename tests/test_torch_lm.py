"""The dense LM serving path against ``repro.lm`` on identical weights.

The configs, the DBG vocabulary reordering and the Zipf pipeline are copies:
their fields and arrays must equal the reference's.  The reference's params
pytree crosses through ``convert.lm_params_from_numpy``; then ``embed_lookup``
(K2's plain path on the CPU) is bitwise, ``decode_step``'s logits agree at
every step within rtol 1e-4, atol 1e-5 (float32 sums in another order), and
``generate``'s greedy tokens are equal.  Every configuration of the repo
builds, serves and runs ``forward`` (the block kinds beyond ``attn`` +
``mlp`` are held to the reference in ``test_torch_lm_mla_moe``,
``test_torch_lm_recurrent`` and ``test_torch_lm_stubs``); the entry points
raise without CUDA unless the caller asks for the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.core import vocab as ref_vocab  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.lm import embed as ref_embed  # noqa: E402
from repro.lm import model as ref_model  # noqa: E402
from repro.lm.serve import generate as ref_generate  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_state_from_numpy  # noqa: E402
from repro_torch.core import vocab  # noqa: E402
from repro_torch.data import DataConfig, ZipfPipeline  # noqa: E402
from repro_torch.lm import embed, model  # noqa: E402
from repro_torch.lm.serve import generate  # noqa: E402
from lm_parity import as_reference  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _cfgs(case):
    """(reference config, port config) of a parity case."""
    pattern = (("attn", "mlp"), ("attn", "mlp"))
    over = {"yi_gqa": ("yi_9b", dict(n_kv_heads=2)),
            "olmo": ("olmo_1b", {}),
            # 1 period of 2 layers + 1 tail layer in repro; 3 blocks here
            "yi_tail": ("yi_9b", dict(pattern=pattern, n_layers=3))}
    arch, kw = over[case]
    return (ref_configs.reduced(ref_configs.get_config(arch), **kw),
            configs.reduced(configs.get_config(arch), **kw))


@pytest.fixture(scope="module", params=["yi_gqa", "olmo", "yi_tail"])
def pair(request):
    """Reference params and the port's model holding the same weights."""
    rcfg, cfg = _cfgs(request.param)
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return rcfg, cfg, params, tree, lm_params_from_numpy(tree, cfg, device="cpu")


def _prompt(cfg, seed=0, b=2, s=8):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------- copies
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(ref) == as_reference(port)
    assert (dataclasses.asdict(ref_configs.reduced(ref, remat=False))
            == as_reference(configs.reduced(port, remat=False)))
    assert ref.layer_pattern() == port.layer_pattern()
    assert ref.head_dim == port.head_dim
    assert ([dataclasses.asdict(c) for c in ref_configs.applicable_shapes(ref)]
            == [dataclasses.asdict(c) for c in configs.applicable_shapes(port)])


def test_registry_equals_the_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert set(configs.all_configs()) == set(ref_configs.all_configs())
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()})
    assert configs.get_config("yi-9b") == configs.get_config("yi_9b")


@pytest.mark.parametrize("v,kw", [(64000, {}), (4096, dict(alpha=1.3, seed=3)),
                                  (512, dict(seed=1))])
def test_reorder_vocab_arrays_equal_the_reference(v, kw):
    freq = vocab.zipf_frequencies(v, **kw)
    np.testing.assert_array_equal(freq, ref_vocab.zipf_frequencies(v, **kw))
    got, want = vocab.reorder_vocab(freq), ref_vocab.reorder_vocab(freq)
    np.testing.assert_array_equal(got.mapping, want.mapping)
    np.testing.assert_array_equal(got.inverse, want.inverse)
    np.testing.assert_array_equal(got.group_sizes, want.group_sizes)
    assert (got.hot_rows, got.coverage, got.vocab_size) == (
        want.hot_rows, want.coverage, want.vocab_size)
    assert got.mapping.dtype == want.mapping.dtype


@pytest.mark.parametrize("remap", [False, True])
def test_zipf_pipeline_batches_equal_the_reference(remap):
    kw = dict(vocab_size=4096, seq_len=64, batch_size=4, seed=5)
    rp = ref_pipeline.ZipfPipeline(ref_pipeline.DataConfig(**kw))
    pp = ZipfPipeline(DataConfig(**kw))
    np.testing.assert_array_equal(pp.frequencies(), rp.frequencies())
    if remap:
        rm = ref_vocab.reorder_vocab(rp.frequencies())
        rp = ref_pipeline.ZipfPipeline(rp.cfg, vocab_map=rm)
        pp = ZipfPipeline(pp.cfg, vocab_map=vocab.reorder_vocab(pp.frequencies()))
    for step, shard, n in ((0, 0, 1), (3, 1, 2), (17, 0, 4)):
        want, got = rp.batch(step, shard, n), pp.batch(step, shard, n)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


# ---------------------------------------------------------------- weights
def test_lm_params_from_numpy_round_trips(pair):
    rcfg, cfg, _, tree, m = pair
    state = lm_state_from_numpy(tree, cfg)
    assert set(state) == set(m.state_dict())
    # every element of the pytree lands in exactly one parameter
    assert (sum(a.size for a in state.values())
            == sum(a.size for a in jax.tree.leaves(tree))
            == sum(p.numel() for p in m.parameters()))
    for name, t in m.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), state[name])
    assert len(m.layers) == cfg.n_layers
    # the stacked slots land in layer period * len(pattern) + slot
    plen = len(cfg.layer_pattern())
    q0 = tree["periods"][plen - 1]["mix"]["q"]["w"][0]
    np.testing.assert_array_equal(
        m.layers[plen - 1].mix["q"]["w"].detach().numpy(), q0)
    if "tail" in tree:
        np.testing.assert_array_equal(
            m.layers[-1].chan["down"]["w"].detach().numpy(),
            tree["tail"][0]["chan"]["down"]["w"])


def test_lm_params_from_numpy_rejects_a_missing_weight(pair):
    _, cfg, _, tree, _ = pair
    broken = dict(tree, embed={k: v for k, v in tree["embed"].items()
                               if k != "hot"})
    with pytest.raises(RuntimeError, match="hot"):
        lm_params_from_numpy(broken, cfg, device="cpu")


# ---------------------------------------------------------------- parity
def test_embed_lookup_equals_the_reference(pair):
    rcfg, cfg, params, _, m = pair
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    ids[0, :3] = (0, cfg.hot_vocab_rows - 1, cfg.hot_vocab_rows)  # the split
    dims = ref_embed.EmbedDims(rcfg.vocab_size, rcfg.d_model, rcfg.hot_vocab_rows)
    want = ref_embed.embed_lookup(params["embed"], jnp.asarray(ids), dims)
    with torch.no_grad():
        got = embed.embed_lookup(m.embed, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pdims = embed.EmbedDims(cfg.vocab_size, cfg.d_model, cfg.hot_vocab_rows)
    assert (pdims.padded_vocab, pdims.cold_rows) == (dims.padded_vocab, dims.cold_rows)


@pytest.mark.parametrize("hot_rows", [0, 4096])
def test_embed_lookup_of_unsplit_and_hot_only_tables(hot_rows):
    """No split (one table) and a hot panel covering the padded vocabulary
    (no cold tail): the reference's two other layouts, ids past the end
    included (clamped, and row 0 of a hot-only panel, as in the reference)."""
    dims = ref_embed.EmbedDims(512, 64, hot_rows)
    params, _ = ref_embed.embed_init(jax.random.PRNGKey(2), dims)
    m_embed = embed.embed_init(embed.EmbedDims(512, 64, hot_rows), device="cpu")
    assert set(m_embed) == set(params)
    with torch.no_grad():
        for k, v in params.items():
            m_embed[k].copy_(torch.from_numpy(np.asarray(v)))
        ids = np.array([[0, 5, 511, 2047], [2048, 5000, 1, 7]], np.int32)
        got = embed.embed_lookup(m_embed, torch.from_numpy(ids))
    want = ref_embed.embed_lookup(params, jnp.asarray(ids), dims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_step_logits_match_the_reference_every_step(pair):
    rcfg, cfg, params, _, m = pair
    tokens = np.concatenate([_prompt(cfg), _prompt(cfg, seed=9)], axis=1)
    rcache = ref_model.init_cache(rcfg, 2, 17, dtype=jnp.float32)
    cache = model.init_cache(cfg, 2, 17, device="cpu", dtype=torch.float32)
    step = jax.jit(lambda p, c, t: ref_model.decode_step(p, rcfg, c, t))
    for t in range(16):
        want, rcache = step(params, rcache, jnp.asarray(tokens[:, t:t + 1]))
        got, cache = model.decode_step(m, cache, torch.from_numpy(tokens[:, t:t + 1]))
        assert got.shape == want.shape and (cache["len"] == t + 1).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
    np.testing.assert_allclose(cache["layers"][0]["k"].numpy(),
                               np.asarray(rcache["periods"][0]["k"][0]),
                               rtol=RTOL, atol=ATOL)


def test_generate_tokens_equal_the_reference(pair):
    rcfg, cfg, params, _, m = pair
    prompt = _prompt(cfg, seed=4)
    want = np.asarray(ref_generate(params, rcfg, jnp.asarray(prompt), max_new=8))
    got, logits = generate(m, torch.from_numpy(prompt), max_new=8,
                           return_logits=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and len(logits) == 16
    assert all(bool(torch.isfinite(lg).all()) for lg in logits)
    assert torch.equal(generate(m, torch.from_numpy(prompt), max_new=8), got)


# ---------------------------------------------------------------- scope
def test_cache_positions_are_checked():
    cfg = configs.reduced(configs.get_config("yi_9b"))
    m = model.init_params(cfg, device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len"):
        generate(m, prompt, max_new=4, max_len=7)
    cache = model.init_cache(cfg, 1, 1, device="cpu")
    model.decode_step(m, cache, prompt[:, :1])
    with pytest.raises(ValueError, match="cannot write position 1"):
        model.decode_step(m, cache, prompt[:, :1])


def test_bfloat16_model_serves():
    cfg = configs.reduced(configs.get_config("olmo_1b"))
    m = model.init_params(cfg, seed=1, device="cpu", dtype=torch.bfloat16)
    assert m.embed["hot"].dtype == torch.bfloat16
    out = generate(m, torch.from_numpy(_prompt(cfg)), max_new=3,
                   cache_dtype=torch.bfloat16)
    assert out.shape == (2, 11) and int(out.max()) < cfg.vocab_size


def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu(
        monkeypatch, capsys):
    from repro_torch.launch import serve

    cfg = configs.reduced(configs.get_config("yi_9b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(cfg, 1, 4)
    tree = {"embed": {}, "periods": ()}
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--batch", "1"])
    assert serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                       "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "generated (2, 7)" in out
