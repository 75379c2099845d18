"""Training on the port against ``repro.lm`` / ``repro.train`` on identical
weights and optimizer state.

* ``loss_fn`` at ``loss_chunk`` 0 and 16 within 1e-6 relative of the
  reference's; every parameter's gradient, by name, within rtol 1e-4, atol
  1e-6 of ``jax.grad``; remat on and off bitwise equal.
* K2's backward (``gather_backward`` behind ``gather_rows``) against
  ``jax.grad`` of ``repro.lm.embed.embed_lookup`` on the split, hot-only
  and unsplit tables, and deterministic.  An id at or past the padded
  vocabulary reads the clamped row in both packages; the port sends its
  gradient there, ``jax.grad`` drops it (XLA's scatter drops out-of-range
  indices), so those cases are held to ``jax.grad`` of the same lookup on
  the clamped ids, whose forward is the same.
* ``make_train_step``: 3 steps from the reference's weights and its
  optimizer state after 2 steps (``opt_state_from_numpy``).  Float32: loss
  and grad norm within 1e-5 relative, moments within atol 1e-7, and every
  parameter within atol 1e-6 (measured 4.0e-7; 8.0e-7 with
  ``grad_accum = 2``) but at most ``NOISE_ELEMENTS`` of the 819,840, which
  are within 1e-3.  Those are elements whose gradient is cancellation
  noise at Adam's eps (an ``embed.hot`` element read once: -9.3e-8 in XLA,
  -2.9e-8 here, in a row whose largest is 8e-2): ``m̂ / (√v̂ + eps)`` turns
  either into most of a step, so the gap reaches 3.8e-4 (1 element; 1.0e-4
  with ``grad_accum = 2``).  Each tensor's gap is also held to its
  reference update over the 3 steps in the L2 norm, within 1e-2 (measured
  2.7e-3, that element).  The clip bound and unbound in the same bands.
  bfloat16 compute: loss within 1e-3 / grad norm 2e-3 relative (measured
  2.1e-4, 6.7e-4: bf16 rounding at other points of XLA's fusions), every
  parameter within 5e-3 and each tensor's gap within 0.15 of its update
  in the L2 norm (measured 3.0e-3 and 7.2e-2, ``embed.cold``).  There a
  row read for the first time takes a step of ~lr whose sign per element
  is that of its bf16 gradient, so an element whose gradient rounds to the
  other sign moves a whole step the other way: the per-element band cannot
  be under the update, and the L2 band is what holds the update rule.
  bfloat16 moments within 2e-2 relative and 1e-6 absolute (two bf16 ulps;
  measured 2.7e-2 of a cancelling 1.8e-5, 4.8e-7 absolute) and parameters
  within atol 2e-5 (measured 6.9e-6: a moment rounded to the other bf16
  neighbour moves its step by ~0.4% of lr).
* The schedule, the clip bound and unbound, the weight-decay rule.
* ``quantize_int8`` / ``ef_compress_grads`` bitwise; ``compressed_all_reduce``
  on 2 and 4 gloo ranks bitwise against ``compressed_psum`` on as many host
  devices (``tests/dist_workers.py``).
* Checkpoints (roundtrip, keep-last-k, corrupt and partial ones skipped),
  the driver's kill-and-resume bitwise against an uninterrupted run, and
  the reference's ``test_tiny_training_loss_decreases`` on the port.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.lm import embed as ref_embed  # noqa: E402
from repro.lm import model as ref_model  # noqa: E402
from repro.train import compress as ref_compress  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_state_from_numpy, opt_state_from_numpy)
from repro_torch.data import DataConfig, ZipfPipeline  # noqa: E402
from repro_torch.kernels.gather_embed import (gather_backward,  # noqa: E402
                                              gather_rows)
from repro_torch.launch import ckpt  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.lm import embed, model  # noqa: E402
from repro_torch.train import compress, step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import dist_workers as workers  # noqa: E402

CASES = {"yi_gqa": ("yi_9b", dict(n_kv_heads=2)), "olmo": ("olmo_1b", {}),
         "olmo_hot_only": ("olmo_1b", dict(hot_vocab_rows=2048))}
RANK_TIMEOUT = 300


# ---------------------------------------------------------------------------
# the compression ranks: started with the module, read by their test
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def compress_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("compress_ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    script = os.path.join(ROOT, "tests", "dist_workers.py")
    procs = []
    for d in (2, 4):
        procs.append(subprocess.Popen(
            [sys.executable, script, "jax-compress",
             str(out / f"ref_{d}.npz"), str(d)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        for r in range(d):
            procs.append(subprocess.Popen(
                [sys.executable, script, "torch-compress", str(out), str(r),
                 str(d), str(out / f"init_{d}")],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _pair(case):
    arch, kw = CASES[case]
    rcfg = ref_configs.reduced(ref_configs.get_config(arch), **kw)
    cfg = configs.reduced(configs.get_config(arch), **kw)
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, params


@pytest.fixture(scope="module", params=["yi_gqa", "olmo"])
def pair(request):
    return _pair(request.param)


def _port(params, cfg):
    return lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")


def _batch(cfg, seed, b=2, s=64, hi=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, hi or cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return toks, labels


def _ref_grads(params, rcfg, toks, labels, chunk=0):
    return jax.value_and_grad(lambda p: ref_model.loss_fn(
        p, rcfg, jnp.asarray(toks), jnp.asarray(labels),
        loss_chunk=chunk))(params)


def _port_grads(m, toks, labels, chunk=0):
    m.zero_grad(set_to_none=True)
    loss = model.loss_fn(m, torch.from_numpy(toks), torch.from_numpy(labels),
                         loss_chunk=chunk)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}


def _assert_grads(got, want_tree, cfg):
    want = lm_state_from_numpy(jax.tree.map(np.asarray, want_tree), cfg)
    assert set(got) == set(want)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


# ---------------------------------------------------------------- the loss
@pytest.mark.parametrize("chunk", [0, 16])
def test_loss_and_every_gradient_match_the_reference(pair, chunk):
    rcfg, cfg, params = pair
    m = _port(params, cfg)
    toks, labels = _batch(cfg, 1)
    want_loss, want = _ref_grads(params, rcfg, toks, labels, chunk)
    loss, got = _port_grads(m, toks, labels, chunk)
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    _assert_grads(got, want, cfg)
    assert float(got["embed.hot"].abs().sum()) > 0
    assert float(got["embed.cold"].abs().sum()) > 0


@pytest.mark.parametrize("case", ["olmo", "olmo_hot_only"])
def test_gradients_with_ids_past_the_tables(case):
    """Ids up to 600 past the padded vocabulary: the split table sends them
    to its last cold row, the hot-only table to row 0 (the reference's
    ``where``, whose gradient ``jax.grad`` keeps), as the forward reads
    them."""
    rcfg, cfg, params = _pair(case)
    m = _port(params, cfg)
    padded = embed.EmbedDims(cfg.vocab_size, cfg.d_model,
                             cfg.hot_vocab_rows).padded_vocab
    toks, labels = _batch(cfg, 2, hi=padded + 600)
    assert (toks >= padded).any()
    want_loss, want = _ref_grads(params, rcfg, toks, labels)
    clamped = np.minimum(toks, padded - 1)
    if case == "olmo":  # jax.grad drops the clamped ids' rows
        _, want = _ref_grads(params, rcfg, clamped, labels)
    loss, got = _port_grads(m, toks, labels)
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    _assert_grads(got, want, cfg)
    if case == "olmo_hot_only":
        assert "embed.cold" not in got
        rows = np.where(toks < padded, toks, 0)
    else:
        rows = clamped
    read = np.zeros(padded, bool)
    read[rows.reshape(-1)] = True
    table = torch.cat([got["embed.hot"]] + ([got["embed.cold"]]
                                            if "embed.cold" in got else []))
    assert bool((table[torch.from_numpy(read)] != 0).any(dim=1).all())
    assert not bool(table[torch.from_numpy(~read)].any())


def test_remat_gradients_are_bitwise_equal(pair):
    _, cfg, params = pair
    m = _port(params, cfg)
    toks, labels = _batch(cfg, 3)
    for chunk in (0, 16):
        loss_a, a = _port_grads(m, toks, labels, chunk)
        m.cfg = dataclasses.replace(cfg, remat=True)
        try:
            loss_b, b = _port_grads(m, toks, labels, chunk)
        finally:
            m.cfg = cfg
        assert torch.equal(loss_a, loss_b)
        for n in a:
            assert torch.equal(a[n], b[n]), n


# ---------------------------------------------------------------- K2's backward
@pytest.mark.parametrize("layout", ["split", "hot_only", "table"])
def test_k2_backward_matches_jax_grad(layout):
    h, c, d = 32, 96, 16
    rng = np.random.default_rng(4)
    dims = {"split": ref_embed.EmbedDims(h + c, d, h),
            "hot_only": ref_embed.EmbedDims(h, d, h),
            "table": ref_embed.EmbedDims(h + c, d, 0)}[layout]
    dims = dataclasses.replace(dims, pad_multiple=1)
    tables = {"split": {"hot": (h, d), "cold": (c, d)},
              "hot_only": {"hot": (h, d)}, "table": {"table": (h + c, d)}}
    tabs = {k: rng.normal(size=sh).astype(np.float32)
            for k, sh in tables[layout].items()}
    n = dims.padded_vocab
    ids = rng.integers(0, n, (4, 50)).astype(np.int32)
    ids[0, :5] = [0, 0, n - 1, n - 1, 1]  # repeated rows
    gout = rng.normal(size=(4, 50, d)).astype(np.float32)

    def f(p):
        return jnp.sum(ref_embed.embed_lookup(p, jnp.asarray(ids), dims)
                       * gout)

    want = jax.grad(f)({k: jnp.asarray(v) for k, v in tabs.items()})
    ptabs = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in tabs.items()})
    ptabs["unembed"] = torch.nn.Parameter(torch.zeros(d, n))
    out = embed.embed_lookup(ptabs, torch.from_numpy(ids))
    (out * torch.from_numpy(gout)).sum().backward()
    for k in tabs:
        np.testing.assert_allclose(ptabs[k].grad.numpy(),
                                   np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_rows_and_determinism(dtype):
    """Below 0 → row 0; split: at or past H + C → the last cold row;
    hot-only: at or past H → nothing.  Sums in float32, cast once; two calls
    bitwise equal; ``gather_rows`` gives the tables these gradients."""
    h, c, d = 8, 24, 4
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(-5, h + c + 9, (300,), generator=gen)
    grad = torch.randn(300, d, generator=gen).to(dtype)
    gh, gc = gather_backward(ids, grad, h, c, dtype)
    gh2, gc2 = gather_backward(ids, grad, h, c, dtype)
    assert torch.equal(gh, gh2) and torch.equal(gc, gc2)
    assert gh.dtype == gc.dtype == dtype
    full = torch.zeros(h + c, d, dtype=torch.float64)
    full.index_add_(0, ids.clamp(0, h + c - 1), grad.double())
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(torch.cat([gh, gc]).double().numpy(),
                               full.numpy(), rtol=tol, atol=tol)
    gh, none = gather_backward(ids, grad, h, 0, dtype)
    assert none is None
    keep = (ids < h)
    want = torch.zeros(h, d, dtype=torch.float64)
    want.index_add_(0, ids.clamp(min=0)[keep], grad.double()[keep])
    np.testing.assert_allclose(gh.double().numpy(), want.numpy(),
                               rtol=1e-2 if dtype == torch.bfloat16 else 1e-6,
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-6)
    hot = torch.randn(h, d, generator=gen).to(dtype).requires_grad_()
    cold = torch.randn(c, d, generator=gen).to(dtype).requires_grad_()
    gather_rows(ids, hot, cold).backward(grad)
    ref_h, ref_c = gather_backward(ids, grad, h, c, dtype)
    assert torch.equal(hot.grad, ref_h) and torch.equal(cold.grad, ref_c)


# ---------------------------------------------------------------- the step
def _mid_training(rcfg, cfg, oc_kw, pre_steps=2):
    """The reference's params and optimizer state after ``pre_steps``
    steps (so the moments are nonzero and step > 0)."""
    oc = ref_step.OptConfig(**oc_kw)
    mdt = jnp.bfloat16 if oc.moment_dtype == "bfloat16" else jnp.float32
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    opt = ref_step.init_opt(params, mdt)
    ts = jax.jit(ref_step.make_train_step(rcfg, oc))
    for i in range(pre_steps):
        toks, labels = _batch(cfg, 20 + i, b=4, s=32)
        params, opt, _ = ts(params, opt, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)})
    return params, opt, ts


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


STEP_CASES = {
    # name: (OptConfig overrides, loss rtol, grad-norm rtol, params atol,
    #        moments rtol, moments atol, update gap (L2, relative))
    "f32": (dict(), 1e-5, 1e-5, 1e-6, 0, 1e-7, 1e-2),
    "f32_accum2": (dict(grad_accum=2), 1e-5, 1e-5, 1e-6, 0, 1e-7, 1e-2),
    "bf16_compute": (dict(compute_dtype="bfloat16"), 1e-3, 2e-3, 5e-3, 0,
                     1e-3, 0.15),
    "bf16_moments": (dict(moment_dtype="bfloat16"), 1e-5, 1e-5, 2e-5, 2e-2,
                     1e-6, 1e-2),
    "clip_bound": (dict(clip_norm=1e-2), 1e-5, 1e-5, 1e-6, 0, 1e-7, 1e-2),
    "clip_unbound": (dict(clip_norm=1e6), 1e-5, 1e-5, 1e-6, 0, 1e-7, 1e-2),
}
# elements whose gradient is noise at Adam's eps may lie outside the
# parameter band, within NOISE_ATOL (module docstring)
NOISE_ELEMENTS, NOISE_ATOL = 4, 1e-3


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_the_reference(case):
    over, r_loss, r_norm, p_atol, m_rtol, m_atol, u_rtol = STEP_CASES[case]
    rcfg, cfg, _ = _pair("yi_gqa")
    oc_kw = dict(dict(lr=1e-3, warmup=2, total_steps=10,
                      compute_dtype="float32"), **over)
    params, opt, ts = _mid_training(rcfg, cfg, oc_kw)
    m = _port(params, cfg)
    start = {n: p.detach().clone() for n, p in m.named_parameters()}
    popt = opt_state_from_numpy(jax.tree.map(np.asarray, opt), cfg,
                                device="cpu")
    assert int(popt["step"]) == 2
    pstep = step.make_train_step(cfg, step.OptConfig(**oc_kw))
    for i in range(3):
        toks, labels = _batch(cfg, 30 + i, b=4, s=32)
        params, opt, want = ts(params, opt, {"tokens": jnp.asarray(toks),
                                             "labels": jnp.asarray(labels)})
        got = pstep(m, popt, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)})
        for key, rtol in (("loss", r_loss), ("grad_norm", r_norm),
                          ("lr", 1e-6)):
            assert isinstance(got[key], torch.Tensor) and got[key].dim() == 0
            w = float(want[key])
            assert abs(float(got[key]) - w) <= rtol * abs(w), (i, key)
    assert int(popt["step"]) == int(opt["step"]) == 5
    want_p = lm_state_from_numpy(_np(params), cfg)
    outside = 0
    for n, p in m.named_parameters():
        gap = p.detach().numpy() - want_p[n]
        update = want_p[n] - start[n].numpy()
        assert np.linalg.norm(gap) <= u_rtol * np.linalg.norm(update), n
        diff = np.abs(gap)
        outside += int((diff > p_atol).sum())
        assert diff.max() <= max(p_atol, NOISE_ATOL), (n, diff.max())
    assert outside <= NOISE_ELEMENTS, outside
    for key in ("m", "v"):
        want_m = lm_state_from_numpy(_np(opt[key]), cfg)
        for n, t in popt[key].items():
            assert t.dtype == (torch.bfloat16 if "moment_dtype" in over
                               else torch.float32)
            np.testing.assert_allclose(t.float().numpy(), want_m[n],
                                       rtol=m_rtol, atol=m_atol,
                                       err_msg=f"{key}.{n}")
    if case == "clip_bound":  # the clip scale was below 1 at every step
        assert float(want["grad_norm"]) > 1e-2


def test_schedule_and_global_norm_match_the_reference():
    oc_kw = dict(lr=3e-4, warmup=7, total_steps=40)
    for s in range(0, 48):
        want = float(ref_step._schedule(jnp.int32(s),
                                        ref_step.OptConfig(**oc_kw)))
        got = float(step._schedule(torch.tensor(s, dtype=torch.int32),
                                   step.OptConfig(**oc_kw)))
        assert abs(got - want) <= 1e-6 * want, s
    rng = np.random.default_rng(6)
    xs = [rng.normal(size=sh).astype(np.float32)
          for sh in ((3, 4), (17,), (5, 6, 7))]
    want = float(ref_step._global_norm([jnp.asarray(x) for x in xs]))
    got = float(step._global_norm(torch.from_numpy(x) for x in xs))
    assert abs(got - want) <= 1e-6 * want


def test_weight_decay_follows_the_references_leaf_ranks():
    """Scales of layers in stacked periods decay (a (periods, d) leaf in the
    reference), a tail layer's and the final norm's do not."""
    cfg = configs.reduced(configs.get_config("yi_9b"), n_layers=3,
                          pattern=(("attn", "mlp"), ("attn", "mlp")))
    m = model.init_params(cfg, device="cpu")
    got = {n: step.decays(cfg, n, p) for n, p in m.named_parameters()}
    assert got["layers.0.norm1.scale"] and got["layers.1.norm2.scale"]
    assert not got["layers.2.norm1.scale"]
    assert not got["final_norm.scale"]
    assert got["layers.2.mix.q.w"] and got["embed.hot"]


def test_opt_state_from_numpy_keeps_names_and_dtypes():
    rcfg, cfg, params = _pair("olmo")
    opt = ref_step.init_opt(params, jnp.bfloat16)
    opt["step"] = jnp.int32(7)
    popt = opt_state_from_numpy(jax.tree.map(np.asarray, opt), cfg,
                                device="cpu")
    m = _port(params, cfg)
    assert set(popt["m"]) == set(popt["v"]) == set(dict(
        m.named_parameters()))
    assert all(t.dtype == torch.bfloat16 for t in popt["m"].values())
    assert popt["step"].dtype == torch.int32 and int(popt["step"]) == 7


# ---------------------------------------------------------------- compression
def test_quantize_and_error_feedback_are_bitwise():
    rng = np.random.default_rng(7)
    grads = {"a": rng.normal(size=(64, 33)).astype(np.float32),
             "b": (rng.normal(size=(500,)) * np.logspace(-6, 1, 500))
             .astype(np.float32),
             "c": np.zeros((4, 4), np.float32)}
    for x in grads.values():
        q, s = compress.quantize_int8(torch.from_numpy(x))
        rq, rs = ref_compress.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(
            compress.dequantize_int8(q, s).numpy(),
            np.asarray(ref_compress.dequantize_int8(rq, rs)))
    res = {k: torch.zeros(v.shape) for k, v in grads.items()}
    rres = {k: jnp.zeros(v.shape, jnp.float32) for k, v in grads.items()}
    for r in range(3):
        g = {k: v * (r + 1) for k, v in grads.items()}
        out, res = compress.ef_compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, res)
        rout, rres = ref_compress.ef_compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, rres)
        for k in grads:
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(rout[k]))
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(rres[k]))


def test_compressed_all_reduce_on_gloo_ranks_matches_compressed_psum(
        compress_ranks):
    out, procs = compress_ranks
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        log, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        assert p.returncode == 0 and "OK" in log, log[-4000:]
    for d in (2, 4):
        ref = dict(np.load(out / f"ref_{d}.npz"))
        xs = workers.compress_inputs(d)
        for r in range(d):
            got = dict(np.load(out / f"torch_compress_{d}_{r}.npz"))
            for k, x in xs.items():
                np.testing.assert_array_equal(got[k], ref[k][r],
                                              err_msg=f"D={d} rank {r} {k}")
                np.testing.assert_allclose(
                    got[k], x.mean(axis=0),
                    atol=2 * float(np.abs(x).max()) / 127)


def test_compressed_all_reduce_on_one_rank(tmp_path):
    import torch.distributed as tdist

    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/i",
                             rank=0, world_size=1)
    try:
        x = torch.randn(300, generator=torch.Generator().manual_seed(8))
        q, s = compress.quantize_int8(x)
        assert torch.equal(compress.compressed_all_reduce(x),
                           compress.dequantize_int8(q, s))
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------- checkpoints
def _small_state(seed):
    cfg = configs.reduced(configs.get_config("olmo_1b"), n_layers=1)
    m = model.init_params(cfg, seed=seed, device="cpu")
    opt = step.init_opt(m, torch.bfloat16)
    for t in list(opt["m"].values()) + list(opt["v"].values()):
        t.normal_(generator=torch.Generator().manual_seed(seed))
    opt["step"] += 3 + seed
    return m, opt


def _equal_state(m1, o1, m2, o2):
    s1, s2 = m1.state_dict(), m2.state_dict()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    for key in ("m", "v"):
        assert all(torch.equal(o1[key][k], o2[key][k]) for k in o1[key])
    assert torch.equal(o1["step"], o2["step"])


def test_checkpoint_roundtrip_keep_last_and_skip_corrupt(tmp_path, capsys):
    root = str(tmp_path / "ck")
    m0, o0 = _small_state(0)
    gen = torch.Generator().manual_seed(9)
    rng_state = gen.get_state()
    for s in (10, 20, 30, 40):
        ckpt.save_checkpoint(root, s, m0, o0, data_cursor=s + 1,
                             rng_state=rng_state, keep=2)
    assert ckpt.list_checkpoints(root) == ["ckpt_00000030", "ckpt_00000040"]
    assert sorted(d for d in os.listdir(root) if d.startswith("ckpt_")) == [
        "ckpt_00000030", "ckpt_00000040"]
    m1, o1 = _small_state(1)
    got = ckpt.restore_latest(root, m1, o1)
    assert got["step"] == 40 and got["data_cursor"] == 41
    assert torch.equal(got["rng_state"], rng_state)
    _equal_state(m0, o0, m1, o1)
    # a newer checkpoint that is corrupt is skipped
    ckpt.save_checkpoint(root, 50, *_small_state(2), data_cursor=51, keep=3)
    with open(os.path.join(root, "ckpt_00000050", "params.pt"), "wb") as f:
        f.write(b"truncated")
    m3, o3 = _small_state(3)
    got = ckpt.restore_latest(root, m3, o3)
    assert got["step"] == 40 and "skipping ckpt_00000050" in capsys.readouterr().out
    _equal_state(m0, o0, m3, o3)
    # a partial save (its temporary directory) is never listed
    os.makedirs(os.path.join(root, ".tmp_partial"))
    assert all(not n.startswith(".tmp") for n in ckpt.list_checkpoints(root))
    # a checkpoint of another model is skipped, the state left untouched
    other = configs.reduced(configs.get_config("olmo_1b"), n_layers=2)
    mo = model.init_params(other, device="cpu")
    oo = step.init_opt(mo, torch.bfloat16)
    before = {k: v.clone() for k, v in mo.state_dict().items()}
    assert ckpt.restore_latest(root, mo, oo) is None
    assert all(torch.equal(before[k], v) for k, v in mo.state_dict().items())
    assert ckpt.restore_latest(str(tmp_path / "empty"), m3, o3) is None


DRIVER = ["--preset", "tiny", "--steps", "6", "--batch", "2", "--seq", "32",
          "--ckpt-every", "3", "--device", "cpu"]


def _final(root):
    path = os.path.join(root, ckpt.list_checkpoints(root)[-1])
    return (torch.load(os.path.join(path, "params.pt"), weights_only=True),
            torch.load(os.path.join(path, "opt.pt"), weights_only=True))


def _preempted_at(monkeypatch, n):
    """Makes the driver's train step raise SIGTERM in its ``n``-th call, as
    a preemption during that step would."""
    real = train_driver.step_mod.make_train_step

    def preempted(cfg, oc):
        fn, calls = real(cfg, oc), []

        def ts(*a):
            calls.append(1)
            if len(calls) == n:
                signal.raise_signal(signal.SIGTERM)
            return fn(*a)
        return ts

    monkeypatch.setattr(train_driver.step_mod, "make_train_step", preempted)


def test_driver_kill_and_resume_is_bitwise(tmp_path, monkeypatch):
    straight = str(tmp_path / "straight")
    assert train_driver.main(DRIVER + ["--ckpt-dir", straight]) == 0
    # preempted in step 2, resumed and preempted in step 4, then resumed to
    # the end
    resumed = str(tmp_path / "resumed")
    handler = signal.getsignal(signal.SIGTERM)
    _preempted_at(monkeypatch, 2)
    assert train_driver.main(DRIVER + ["--ckpt-dir", resumed]) == 0
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert ckpt.list_checkpoints(resumed) == ["ckpt_00000002"]
    assert train_driver.main(DRIVER + ["--ckpt-dir", resumed]) == 0
    assert ckpt.list_checkpoints(resumed)[-2:] == ["ckpt_00000003",
                                                  "ckpt_00000004"]
    monkeypatch.undo()
    assert train_driver.main(DRIVER + ["--ckpt-dir", resumed]) == 0
    (pa, oa), (pb, ob) = _final(straight), _final(resumed)
    assert set(pa) == set(pb) and set(oa) == set(ob)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(oa[k], ob[k]) for k in oa)
    assert int(oa["step"]) == 6


def test_tiny_training_loss_decreases():
    """The reference's ``test_tiny_training_loss_decreases`` on the port."""
    cfg = configs.reduced(configs.get_config("olmo_1b"), remat=False,
                          n_layers=2, vocab_size=512, d_model=64, d_ff=128,
                          n_heads=2, n_kv_heads=2, d_head=32,
                          hot_vocab_rows=64)
    pipe = ZipfPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   batch_size=8, motif_prob=0.5))
    m = model.init_params(cfg, seed=0, device="cpu")
    opt = step.init_opt(m)
    ts = step.make_train_step(cfg, step.OptConfig(
        lr=3e-3, warmup=5, total_steps=40, compute_dtype="float32"))
    losses = []
    for i in range(40):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
        losses.append(float(ts(m, opt, batch)["loss"]))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.1, losses
