"""MLA and the MoE with the stable-bin dispatch (ROADMAP A12.4) against
``repro.lm`` on identical inputs.

Per function: ``mla`` and ``mla_decode`` (the latent cache, written in
place, against the reference's returned caches), ``stable_bin_dispatch``
bitwise (ranks and keeps) at capacity factors 1.0 (slots drop) and 8.0
(none) with ties planted in the router's probabilities, the router's
expert choices equal to ``jax.lax.top_k``'s (a tie takes the lower expert)
before any value is compared, ``moe_apply``'s output and aux, and
``moe_apply`` against the port's dense ``moe_apply_ref`` where nothing
drops.  Per family (reduced DeepSeek-V2-Lite: MLA + MoE with shared
experts; reduced Grok-1: GQA + MoE): params through ``convert``, forward
logits and aux (rtol 1e-5, atol 1e-5, the dense slice's band), decode
logits at every step (rtol 1e-4, atol 1e-5) and the caches, ``generate``
tokens, the port's forward against its own decode in the reference's band
(at ``capacity_factor`` 8.0, as the reference's own test runs DeepSeek),
and ``loss_fn`` with every gradient against ``jax.value_and_grad`` (rtol 1e-4,
atol 1e-6), all finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_parity as P  # noqa: E402
from repro.lm import layers as ref_layers  # noqa: E402
from repro.lm import moe as ref_moe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.lm import layers, model, moe  # noqa: E402

FAMILIES = {"deepseek": "deepseek_v2_lite_16b", "grok": "grok_1_314b"}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    return P.make_pair(FAMILIES[request.param])


def _t(tree):
    """A numpy/JAX params tree as torch tensors (copies)."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------- MLA
MLA = dict(n_heads=4, kv_lora=48, d_nope=16, d_rope=8, d_v=24)


def _mla_weights(d=64, seed=0):
    dims = ref_layers.MlaDims(**MLA)
    p, _ = ref_layers.mla_init(jax.random.PRNGKey(seed), d, dims)
    return dims, layers.MlaDims(**MLA), p


@pytest.mark.parametrize("s,block", [(32, 512), (64, 16)])
def test_mla_matches_the_reference(s, block):
    """d_v (24) differs from the key head dim (16 + 8); at blocks of 16 the
    online softmax crosses key blocks."""
    rdims, dims, p = _mla_weights()
    x = np.random.default_rng(1).normal(size=(2, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want = ref_layers.mla(p, jnp.asarray(x), rdims, positions=jnp.asarray(pos),
                          block_q=block, block_k=block)
    got = layers.mla(_t(p), torch.from_numpy(x), dims,
                     positions=torch.from_numpy(pos), block_q=block,
                     block_k=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_mla_decode_matches_the_reference_every_step():
    rdims, dims, p = _mla_weights(seed=2)
    s_max, b = 12, 2
    x = np.random.default_rng(3).normal(size=(b, s_max, 64)).astype(np.float32)
    r_lat = jnp.zeros((b, s_max, MLA["kv_lora"]))
    r_kr = jnp.zeros((b, s_max, MLA["d_rope"]))
    lat = torch.zeros((b, s_max, MLA["kv_lora"]))
    kr = torch.zeros((b, s_max, MLA["d_rope"]))
    tp = _t(p)
    for t in range(s_max):
        want, r_lat, r_kr = ref_layers.mla_decode(
            p, jnp.asarray(x[:, t:t + 1]), rdims, r_lat, r_kr, t)
        got = layers.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), dims,
                                lat, kr, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {t}")
    np.testing.assert_allclose(lat.numpy(), np.asarray(r_lat), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(kr.numpy(), np.asarray(r_kr), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="cannot write position 12"):
        layers.mla_decode(tp, torch.from_numpy(x[:, :1]), dims, lat, kr, s_max)


def test_mla_decode_reads_a_bfloat16_cache():
    """A bfloat16 latent cache against float32 weights: promoted to float32,
    as JAX promotes it."""
    rdims, dims, p = _mla_weights(seed=4)
    x = np.random.default_rng(5).normal(size=(2, 1, 64)).astype(np.float32)
    r_lat = jnp.zeros((2, 4, MLA["kv_lora"]), jnp.bfloat16)
    r_kr = jnp.zeros((2, 4, MLA["d_rope"]), jnp.bfloat16)
    want, r_lat, _ = ref_layers.mla_decode(p, jnp.asarray(x), rdims, r_lat,
                                           r_kr, 0)
    lat = torch.zeros((2, 4, MLA["kv_lora"]), dtype=torch.bfloat16)
    kr = torch.zeros((2, 4, MLA["d_rope"]), dtype=torch.bfloat16)
    got = layers.mla_decode(_t(p), torch.from_numpy(x), dims, lat, kr, 0)
    np.testing.assert_array_equal(lat.float().numpy(),
                                  np.asarray(r_lat.astype(jnp.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------- MoE
def _moe_case(cf, *, t=64, e=8, k=2, ties=True, shared=1, seed=0):
    """Reference MoE params (router columns duplicated in pairs when
    ``ties``, so pairs of experts score exactly equal) and inputs."""
    dims = ref_moe.MoeDims(d_model=32, d_ff=48, n_experts=e, top_k=k,
                           n_shared=shared, capacity_factor=cf)
    p, _ = ref_moe.moe_init(jax.random.PRNGKey(seed), dims)
    if ties:
        w = np.asarray(p["router"]["w"]).copy()
        w[:, 1::2] = w[:, 0::2]  # expert 2i+1 ties expert 2i on every token
        p = dict(p, router={"w": jnp.asarray(w)})
    x = np.random.default_rng(seed + 1).normal(
        size=(2, t // 2, 32)).astype(np.float32)
    pdims = moe.MoeDims(32, 48, e, k, shared, capacity_factor=cf)
    return dims, pdims, p, x


def _ref_route(p, x, dims):
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ p["router"]["w"]).astype(jnp.float32), -1)
    top_p, top_e = jax.lax.top_k(probs, dims.top_k)
    return np.asarray(probs), np.asarray(top_e), np.asarray(top_p)


@pytest.mark.parametrize("ties", [True, False])
def test_router_choices_equal_top_k_with_ties(ties):
    dims, pdims, p, x = _moe_case(1.0, ties=ties)
    probs, want_e, _ = _ref_route(p, x, dims)
    if ties:  # the planted ties are exact, and they decide choices
        assert (probs[:, 0::2] == probs[:, 1::2]).all()
    _, top_e, top_p = moe.route(_t(p), torch.from_numpy(x).reshape(-1, 32),
                                pdims)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    if ties:  # each first choice is an even expert, its twin second
        assert (want_e[:, 0] % 2 == 0).all()
        np.testing.assert_array_equal(want_e[:, 1], want_e[:, 0] + 1)
    assert top_p.dtype == torch.float32
    np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("ties", [True, False])
def test_stable_bin_dispatch_is_bitwise(cf, ties):
    dims, pdims, p, x = _moe_case(cf, ties=ties, k=3)
    _, top_e, _ = _ref_route(p, x, dims)
    t = top_e.shape[0]
    cap = moe.capacity(t, pdims)
    assert cap == max(8, -(-int(np.ceil(t * 3 * cf / 8)) // 8) * 8)
    want_r, want_k = ref_moe.stable_bin_dispatch(jnp.asarray(top_e), 8, cap)
    rank, keep = moe.stable_bin_dispatch(torch.from_numpy(top_e), 8, cap)
    assert rank.dtype == torch.int32 and keep.dtype == torch.bool
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_k))
    assert bool((~keep).any()) == (cf == 1.0)  # 1.0 drops, 8.0 does not
    # the DBG property: within an expert, ranks rise in token order
    flat_e, flat_r = top_e.reshape(-1), rank.numpy().reshape(-1)
    for e in range(8):
        np.testing.assert_array_equal(flat_r[flat_e == e],
                                      np.arange((flat_e == e).sum()))


@pytest.mark.parametrize("cf,ties,shared", [(1.0, True, 1), (1.0, False, 0),
                                            (8.0, True, 0), (8.0, False, 1)])
def test_moe_apply_matches_the_reference(cf, ties, shared):
    dims, pdims, p, x = _moe_case(cf, ties=ties, shared=shared, seed=3)
    _, want_e, _ = _ref_route(p, x, dims)
    _, top_e, _ = moe.route(_t(p), torch.from_numpy(x).reshape(-1, 32), pdims)
    np.testing.assert_array_equal(top_e.numpy(), want_e)  # choices first
    want, want_aux = ref_moe.moe_apply(p, jnp.asarray(x), dims)
    got, aux = moe.moe_apply(_t(p), torch.from_numpy(x), pdims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    if cf == 8.0:  # nothing drops: the dense oracles agree too
        dense = moe.moe_apply_ref(_t(p), torch.from_numpy(x), pdims)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            dense.numpy(),
            np.asarray(ref_moe.moe_apply_ref(p, jnp.asarray(x), dims)),
            rtol=1e-5, atol=1e-6)


def test_moe_dispatch_drops_leave_zero_contributions():
    """At capacity factor 1.0 with every token on one expert pair, the
    dropped slots add nothing: the output equals the dense oracle's with
    the dropped (token, choice) weights set to zero."""
    dims, pdims, p, x = _moe_case(1.0, t=64, e=4, k=1, shared=0, seed=5)
    w = np.zeros((32, 4), np.float32)
    w[:, 0] = 1.0
    p = dict(p, router={"w": jnp.asarray(w)})
    xt = np.abs(x) + 0.1  # every token's first choice is expert 0
    got, _ = moe.moe_apply(_t(p), torch.from_numpy(xt), pdims)
    cap = moe.capacity(64, pdims)
    assert cap == 16  # so 48 of 64 tokens drop
    want = np.asarray(ref_moe.moe_apply(p, jnp.asarray(xt), dims)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    flat = got.numpy().reshape(64, 32)
    assert (flat[cap:] == 0).all() and (np.abs(flat[:cap]).sum(1) > 0).all()


def test_moe_gradients_match_the_reference():
    """The index ops of the dispatch and combine under autograd: the
    gradients of the input and every weight against ``jax.grad``."""
    dims, pdims, p, x = _moe_case(1.0, ties=True, seed=7)

    def ref_loss(prm, xx):
        y, aux = ref_moe.moe_apply(prm, xx, dims)
        return jnp.sum(y * jnp.cos(y)) + aux

    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = _t(p)
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(tp, xt, pdims)
    (torch.sum(y * torch.cos(y)) + aux).backward()
    # gradients up to ~13 in magnitude: atol 1e-5 (measured need 2.5e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for got, want in zip(jax.tree.leaves(tp), jax.tree.leaves(gp)):
        assert torch.isfinite(got.grad).all()
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- families
def test_params_round_trip(pair):
    P.check_round_trip(pair)
    blk = pair.m.layers[0]
    assert blk.chan["gate"].shape == (pair.cfg.n_experts, pair.cfg.d_model,
                                      pair.cfg.moe_d_ff or pair.cfg.d_ff)
    np.testing.assert_array_equal(blk.chan["gate"].detach().numpy(),
                                  pair.tree["periods"][0]["chan"]["gate"][0])


@pytest.mark.parametrize("s", [32, 64])
def test_forward_logits_and_aux_match_the_reference(pair, s):
    P.check_forward(pair, s)


def test_decode_logits_match_the_reference_every_step(pair):
    rcache, cache = P.check_decode(pair)
    for i, lc in enumerate(cache["layers"]):
        want = P.ref_layer_cache(rcache, pair.cfg, i)
        for key, t in lc.items():
            np.testing.assert_allclose(t.numpy(), want[key], rtol=1e-4,
                                       atol=1e-5, err_msg=f"layer {i} {key}")


def test_generate_tokens_equal_the_reference(pair):
    P.check_generate(pair)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_its_own_decode(family):
    """At capacity factor 8.0, as the reference's own test runs DeepSeek:
    the forward's T = 32 tokens then drop no slot."""
    cfg = configs.reduced(configs.get_config(FAMILIES[family]),
                          capacity_factor=8.0)
    P.check_forward_against_own_decode(model.init_params(cfg, seed=3,
                                                         device="cpu"))


def test_loss_and_gradients_match_the_reference(pair):
    P.check_loss_and_grads(pair)
