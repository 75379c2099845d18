"""Shared cases of the LM block-kind parity tests (``test_torch_lm_mla_moe``,
``test_torch_lm_recurrent``, ``test_torch_lm_stubs``): a reduced config's
reference params and the port's model holding the same weights, and the
family-level checks, each against ``repro.lm`` on the same inputs.  Not a
test module (pytest collects ``test_*.py`` only)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
from repro.lm import model as ref_model
from repro.lm.serve import generate as ref_generate
from repro.train import step as ref_step_mod
from repro_torch import configs
from repro_torch.convert import (lm_params_from_numpy, lm_state_from_numpy,
                                 opt_state_from_numpy)
from repro_torch.lm import model
from repro_torch.lm.serve import generate
from repro_torch.train import step as step_mod

#: decode_step logits against the reference's (float32 sums in another
#: order), as in the dense slice
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-5
#: the reference's own band between its forward and its decode
#: (tests/test_lm.py)
SELF_RTOL, SELF_ATOL = 2e-2, 2e-4


@dataclasses.dataclass
class Pair:
    rcfg: object
    cfg: object
    params: dict  # the reference's (JAX arrays)
    tree: dict  # the same as numpy
    m: model.LM  # the port's, the same weights, on the CPU


def make_pair(arch, seed=0, **kw) -> Pair:
    rcfg = ref_configs.reduced(ref_configs.get_config(arch), **kw)
    cfg = configs.reduced(configs.get_config(arch), **kw)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return Pair(rcfg, cfg, params, tree,
                lm_params_from_numpy(tree, cfg, device="cpu"))


def tokens(cfg, s, seed=0, b=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def extras(cfg, seed=0, b=2, s_src=24):
    """The stub inputs a family takes: VLM patch embeddings, enc-dec
    frames; numpy, float32."""
    rng = np.random.default_rng(100 + seed)
    out = {}
    if cfg.prefix_len:
        out["prefix"] = rng.normal(
            size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.n_enc_layers:
        out["frames"] = rng.normal(
            size=(b, s_src, cfg.d_model)).astype(np.float32)
    return out


def check_round_trip(p: Pair):
    state = lm_state_from_numpy(p.tree, p.cfg)
    assert set(state) == set(p.m.state_dict())
    assert (sum(a.size for a in state.values())
            == sum(a.size for a in jax.tree.leaves(p.tree))
            == sum(t.numel() for t in p.m.parameters()))
    for name, t in p.m.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), state[name], err_msg=name)
    assert len(p.m.layers) == p.cfg.n_layers
    pattern = p.cfg.layer_pattern()
    assert [(b.mixer, b.channel) for b in p.m.layers] == [
        pattern[i % len(pattern)] for i in range(p.cfg.n_layers)]


def check_forward(p: Pair, s, *, seed=1, rtol=1e-5, atol=1e-5):
    """``forward`` logits and aux against the reference's, with the
    family's stub inputs; returns the logits' largest |gap|."""
    toks = tokens(p.cfg, s, seed)
    ex = extras(p.cfg, seed)
    want, want_aux = ref_model.forward(
        p.params, p.rcfg, jnp.asarray(toks),
        **{k: jnp.asarray(v) for k, v in ex.items()})
    with torch.no_grad():
        got, aux = model.forward(p.m, torch.from_numpy(toks),
                                 **{k: torch.from_numpy(v)
                                    for k, v in ex.items()})
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-6)
    return float(np.abs(got.numpy() - want).max())


def check_decode(p: Pair, steps=16, max_len=None, seed=2):
    """``decode_step`` logits at every step against the reference's, then
    the caches' final state."""
    toks = tokens(p.cfg, steps, seed)
    max_len = max_len or steps + 1
    rcache = ref_model.init_cache(p.rcfg, 2, max_len, dtype=jnp.float32)
    cache = model.init_cache(p.cfg, 2, max_len, device="cpu",
                             dtype=torch.float32)
    step = jax.jit(lambda prm, c, t: ref_model.decode_step(prm, p.rcfg, c, t))
    for t in range(steps):
        want, rcache = step(p.params, rcache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = model.decode_step(p.m, cache,
                                       torch.from_numpy(toks[:, t:t + 1]))
        assert got.shape == want.shape and cache["len"] == t + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DECODE_RTOL, atol=DECODE_ATOL,
                                   err_msg=f"step {t}")
    return rcache, cache


def ref_layer_cache(rcache, cfg, layer):
    """Layer ``layer``'s cache in the reference's stacked tree."""
    plen = len(cfg.layer_pattern())
    n_periods = cfg.n_layers // plen
    if layer < n_periods * plen:
        return jax.tree.map(lambda a: np.asarray(a)[layer // plen],
                            rcache["periods"][layer % plen])
    return jax.tree.map(np.asarray, rcache["tail"][layer - n_periods * plen])


def check_generate(p: Pair, max_new=8, max_len=None, seed=4):
    prompt = tokens(p.cfg, 8, seed)
    want = np.asarray(ref_generate(p.params, p.rcfg, jnp.asarray(prompt),
                                   max_new=max_new, max_len=max_len))
    got, logits = generate(p.m, torch.from_numpy(prompt), max_new=max_new,
                           max_len=max_len, return_logits=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and len(logits) == 8 + max_new
    assert all(bool(torch.isfinite(lg).all()) for lg in logits)


def check_forward_against_own_decode(m: model.LM, s=16, seed=5):
    """The port's forward against its own decode at every position, in the
    reference's band between the two."""
    toks = torch.from_numpy(tokens(m.cfg, s, seed))
    with torch.no_grad():
        full, _ = model.forward(m, toks)
    cache = model.init_cache(m.cfg, 2, s + 1, device="cpu",
                             dtype=torch.float32)
    for t in range(s):
        logits, cache = model.decode_step(m, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(full[:, t].numpy(), logits[:, 0].numpy(),
                                   rtol=SELF_RTOL, atol=SELF_ATOL,
                                   err_msg=f"step {t}")


def _flat_grads(gtree, cfg):
    """The reference's gradient pytree under the port's names."""
    return lm_state_from_numpy(jax.tree.map(np.asarray, gtree), cfg)


def check_loss_and_grads(p: Pair, s=32, seed=6, *, rtol=1e-4, atol=1e-6):
    """``loss_fn`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's; every gradient finite.
    Returns the largest gradient gap as a share of the band."""
    toks = tokens(p.cfg, s, seed)
    labels = np.roll(toks, -1, axis=1)
    ex = extras(p.cfg, seed)
    jx = {k: jnp.asarray(v) for k, v in ex.items()}
    want_loss, want_g = jax.value_and_grad(
        lambda prm: ref_model.loss_fn(prm, p.rcfg, jnp.asarray(toks),
                                      jnp.asarray(labels), **jx))(p.params)
    p.m.zero_grad()
    loss = model.loss_fn(p.m, torch.from_numpy(toks), torch.from_numpy(labels),
                         **{k: torch.from_numpy(v) for k, v in ex.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = _flat_grads(want_g, p.cfg)
    worst = 0.0
    for name, t in p.m.named_parameters():
        assert t.grad is not None, name
        g = t.grad.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, want[name], rtol=rtol, atol=atol,
                                   err_msg=name)
        worst = max(worst, float((np.abs(g - want[name])
                                  / (atol + rtol * np.abs(want[name]))).max()))
    return worst


def port_leaf_names(tree, cfg):
    """(the port's state-dict name, the reference's leaf, stacked?) for
    every leaf of a reference params-shaped ``tree``: a leaf of a stacked
    period (``periods``) or of the stacked ``encoder`` stands for one port
    tensor per period or encoder layer, its leading dim dropped; a tail
    layer's and every other leaf stands for one."""
    plen = len(cfg.layer_pattern())

    def walk(sub, prefix):
        if isinstance(sub, dict):
            for k, v in sub.items():
                yield from walk(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], sub

    out = []
    for key, sub in tree.items():
        if key == "periods":
            for slot, s in enumerate(sub):
                for name, leaf in walk(s, ""):
                    out += [(f"layers.{p * plen + slot}.{name}", leaf, True)
                            for p in range(cfg.n_layers // plen)]
        elif key == "tail":
            base = (cfg.n_layers // plen) * plen
            for i, s in enumerate(sub):
                out += [(f"layers.{base + i}.{name}", leaf, False)
                        for name, leaf in walk(s, "")]
        elif key == "encoder":
            for name, leaf in walk(sub, ""):
                out += [(f"encoder.{i}.{name}", leaf, True)
                        for i in range(cfg.n_enc_layers)]
        else:
            out += [(name, leaf, False) for name, leaf in walk(sub, f"{key}.")]
    return out


#: the train-step parity of the new families (A12.8): the dense configs'
#: float32 band (``test_torch_train``), elements whose gradient is noise
#: at Adam's eps excepted
TRAIN_OC = dict(lr=1e-3, warmup=2, total_steps=10, compute_dtype="float32")
TRAIN_NOISE_ELEMENTS, TRAIN_NOISE_ATOL = 4, 1e-3


def _train_batch(cfg, i, b=4, s=32):
    toks = tokens(cfg, s + 1, seed=40 + i, b=b)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out.update(extras(cfg, seed=40 + i, b=b))
    return out


def check_three_train_steps(arch):
    """3 float32 steps of the port's ``make_train_step`` against the
    reference's from its state after 2 steps (``test_torch_train_families``'
    docstring has the bands)."""
    rcfg = ref_configs.reduced(ref_configs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    oc = ref_step_mod.OptConfig(**TRAIN_OC)
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    opt = ref_step_mod.init_opt(params)
    ts = jax.jit(ref_step_mod.make_train_step(rcfg, oc))
    for i in range(2):  # moments nonzero and step > 0 before comparing
        params, opt, _ = ts(params, opt, {k: jnp.asarray(v) for k, v in
                                          _train_batch(cfg, i).items()})
    m = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")
    start = {n: p.detach().clone() for n, p in m.named_parameters()}
    popt = opt_state_from_numpy(jax.tree.map(np.asarray, opt), cfg,
                                device="cpu")
    pstep = step_mod.make_train_step(cfg, step_mod.OptConfig(**TRAIN_OC))
    for i in range(2, 5):
        b = _train_batch(cfg, i)
        params, opt, want = ts(params, opt, {k: jnp.asarray(v)
                                             for k, v in b.items()})
        got = pstep(m, popt, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "grad_norm"):
            w = float(want[key])
            assert abs(float(got[key]) - w) <= 1e-5 * abs(w), (i, key)
    assert int(popt["step"]) == int(opt["step"]) == 5
    want_p = lm_state_from_numpy(jax.tree.map(np.asarray, params), cfg)
    outside = 0
    for n, p in m.named_parameters():
        gap = p.detach().numpy() - want_p[n]
        update = want_p[n] - start[n].numpy()
        assert np.linalg.norm(gap) <= 1e-2 * np.linalg.norm(update) + 1e-7, n
        outside += int((np.abs(gap) > 1e-6).sum())
        assert np.abs(gap).max() <= TRAIN_NOISE_ATOL, (n, np.abs(gap).max())
    assert outside <= TRAIN_NOISE_ELEMENTS, outside
    for key in ("m", "v"):
        want_m = lm_state_from_numpy(jax.tree.map(np.asarray, opt[key]), cfg)
        for n, t in popt[key].items():
            np.testing.assert_allclose(t.numpy(), want_m[n], rtol=0,
                                       atol=1e-7, err_msg=f"{key}.{n}")
