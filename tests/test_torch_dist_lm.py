"""The sharded LM (A12.7) on 4 gloo ranks against ``repro.lm`` /
``repro.train`` on one device.

The reference's own sharded test (``tests/test_dist.py``) fails under JAX
0.9.0, so the port's sharded step is held to the reference's single-device
``make_train_step`` in that test's bands, and to its own unsharded step:

* 3 train steps of reduced Yi-9B (2 layers, remat off, float32, batch
  (8, 32)) on meshes (2, 2), (4, 1) and (1, 4): loss within rtol 2e-5 of
  the reference's at every step and every parameter within rtol 2e-3,
  atol 2e-5 (``tests/test_dist.py:61-63``) but at most ``NOISE_ELEMENTS``
  of the 819,840, which are within 1e-3 (one element of
  ``layers.0.chan.down.w`` is 1.1e-4 off on (1, 4): a gradient that is
  cancellation noise at Adam's eps, as ``test_torch_train`` finds between
  the two packages on one device); against the port's unsharded
  step, loss within 1e-6 relative and parameters within atol
  ``PLAIN_ATOL`` (measured 3.3e-5 to 1.1e-4 over the meshes: a sum over
  shards reorders float32 additions, and Adam's ``m̂ / (√v̂ + eps)`` turns
  an element whose gradient is noise at eps into most of a step, as in
  ``test_torch_train``);
* one step of reduced DeepSeek (MLA + MoE, 4 experts on ``model``) in the
  same bands;
* ``decode_step`` on (2, 2) with its cache placed by ``cache_specs``: the
  logits at every step within the decode band (rtol 1e-4, atol 1e-5) of
  the reference's single-device ``decode_step``;
* every rank's local shard shape equals the parameter's shape divided by
  the mesh axes of its spec, and the moments follow the placements.

The four ranks (``tests/dist_workers.py torch-lm``) start with the module;
the tests read their npz files.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.lm import model as ref_model  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_state_from_numpy)
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.lm import model  # noqa: E402
from repro_torch.train import step  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dist_workers import LM_MESHES, _lm_case  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-3, 2e-5
# elements whose gradient is noise at Adam's eps may lie outside the
# parameter band, within NOISE_ATOL (module docstring)
NOISE_ELEMENTS, NOISE_ATOL = 4, 1e-3
PLAIN_ATOL = 2e-4
STEPS = {"yi_9b": 3, "deepseek_v2_lite_16b": 1}


def _ref_case(arch):
    return ref_configs.reduced(ref_configs.get_config(arch), remat=False,
                               n_layers=2)


def _batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's start and steps here; the port's four ranks in
    subprocesses, started before any test runs."""
    out = tmp_path_factory.mktemp("lm_ranks")
    data, starts = {}, {}
    for seed, (arch, n) in enumerate(STEPS.items()):
        rcfg, cfg = _ref_case(arch), _lm_case(arch)
        params = ref_model.init_params(rcfg, jax.random.PRNGKey(seed))
        starts[arch] = (rcfg, cfg, params)
        for k, v in lm_state_from_numpy(jax.tree.map(np.asarray, params),
                                        cfg).items():
            data[f"{arch}/p/{k}"] = v
        for i, b in enumerate(_batches(cfg, n, 10 + seed)):
            for k, v in b.items():
                data[f"{arch}/b{i}/{k}"] = v
    toks = np.random.default_rng(3).integers(
        0, starts["yi_9b"][1].vocab_size, (8, 6)).astype(np.int32)
    data["yi_9b/decode_tokens"] = toks
    np.savez(out / "data.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    script = os.path.join(ROOT, "tests", "dist_workers.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "torch-lm", str(out), str(r), "4",
         str(out / "init")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    # the reference's steps, the port's unsharded steps and the reference's
    # decode while the ranks run
    ref = {}
    oc = ref_step.OptConfig(compute_dtype="float32", lr=1e-3, warmup=2,
                            total_steps=10)
    for arch, n in STEPS.items():
        rcfg, cfg, params = starts[arch]
        opt = ref_step.init_opt(params)
        ts = jax.jit(ref_step.make_train_step(rcfg, oc))
        losses = []
        for i in range(n):
            b = {k: jnp.asarray(data[f"{arch}/b{i}/{k}"])
                 for k in ("tokens", "labels")}
            params, opt, m = ts(params, opt, b)
            losses.append(float(m["loss"]))
        ref[arch] = (losses, lm_state_from_numpy(
            jax.tree.map(np.asarray, params), cfg))
        m = lm_params_from_numpy(jax.tree.map(np.asarray, starts[arch][2]),
                                 cfg, device="cpu")
        popt = step.init_opt(m)
        pts = step.make_train_step(cfg, step.OptConfig(**dataclasses.asdict(
            oc)))
        plain = []
        for i in range(n):
            got = pts(m, popt, {k: torch.from_numpy(data[f"{arch}/b{i}/{k}"])
                                for k in ("tokens", "labels")})
            plain.append(float(got["loss"]))
        ref[f"{arch}/plain"] = (plain, {n: p.detach().numpy()
                                        for n, p in m.named_parameters()})
    rcfg, _, params = starts["yi_9b"]
    cache = ref_model.init_cache(rcfg, 8, toks.shape[1] + 1,
                                 dtype=jnp.float32)
    dec = jax.jit(lambda p, c, t: ref_model.decode_step(p, rcfg, c, t))
    ref["decode"] = []
    for t in range(toks.shape[1]):
        logits, cache = dec(params, cache, jnp.asarray(toks[:, t:t + 1]))
        ref["decode"].append(np.asarray(logits))
    yield out, procs, ref
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def results(ranks):
    out, procs, ref = ranks
    for p in procs:
        text, _ = p.communicate(timeout=RANK_TIMEOUT)
        assert p.returncode == 0 and "OK" in text, text[-3000:]
    got = [dict(np.load(out / f"lm_rank{r}.npz")) for r in range(4)]
    return got, ref


@pytest.mark.parametrize("arch,shape", [("yi_9b", s) for s in LM_MESHES]
                         + [("deepseek_v2_lite_16b", (2, 2))])
def test_sharded_train_steps_match_the_single_device_reference(
        results, arch, shape):
    got, ref = results
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    losses, want = ref[arch]
    for i, w in enumerate(losses):
        for r in range(4):  # every rank reads the same loss
            assert got[r][f"{tag}/loss{i}"] == got[0][f"{tag}/loss{i}"]
        assert abs(float(got[0][f"{tag}/loss{i}"]) - w) <= LOSS_RTOL * abs(w)
    names = [k[len(tag) + 3:] for k in got[0] if k.startswith(f"{tag}/p/")]
    assert sorted(names) == sorted(want)
    outside = 0
    for n in names:
        a, w = got[0][f"{tag}/p/{n}"], want[n]
        diff = np.abs(a - w)
        outside += int((diff > PARAM_ATOL + PARAM_RTOL * np.abs(w)).sum())
        assert diff.max() <= NOISE_ATOL, (tag, n, diff.max())
    assert outside <= NOISE_ELEMENTS, (tag, outside)


@pytest.mark.parametrize("arch", sorted(STEPS))
def test_sharded_steps_match_the_ports_unsharded_step(results, arch):
    got, ref = results
    losses, want = ref[f"{arch}/plain"]
    for shape in (LM_MESHES if arch == "yi_9b" else [(2, 2)]):
        tag = f"{arch}/{shape[0]}x{shape[1]}"
        for i, w in enumerate(losses):
            assert abs(float(got[0][f"{tag}/loss{i}"]) - w) <= 1e-6 * abs(w)
        for n, w in want.items():
            np.testing.assert_allclose(got[0][f"{tag}/p/{n}"], w, rtol=0,
                                       atol=PLAIN_ATOL, err_msg=f"{tag} {n}")


@pytest.mark.parametrize("arch,shape", [("yi_9b", s) for s in LM_MESHES]
                         + [("deepseek_v2_lite_16b", (2, 2))])
def test_local_shards_are_the_shape_divided_by_the_mesh_axes(
        results, arch, shape):
    got, _ = results
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    cfg = _lm_case(arch)
    m = model.LM(cfg, device="meta")
    sizes = {"data": shape[0], "model": shape[1]}
    specs = shd.param_specs(m, mesh=sizes)
    for n, p in m.named_parameters():
        want = tuple(d // int(np.prod([sizes[a] for a in
                                       shd._axes_tuple(e)]))
                     for d, e in zip(p.shape, specs[n]))
        for r in range(4):
            assert tuple(got[r][f"{tag}/local/{n}"]) == want, (tag, n, r)
            assert str(got[r][f"{tag}/spec/{n}"]) == repr(specs[n])
    if arch == "deepseek_v2_lite_16b":  # the experts split on 'model'
        assert specs["layers.1.chan.gate"][0] == "model"


def test_sharded_decode_matches_the_reference(results):
    got, ref = results
    for t, want in enumerate(ref["decode"]):
        for r in range(4):
            np.testing.assert_allclose(got[r][f"decode/logits{t}"], want,
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {t} rank {r}")
    cfg = _lm_case("yi_9b")
    # the cache's batch of 8 over data (2): 4 rows per rank
    assert tuple(got[0]["decode/cache_local"]) == (
        4, 7, cfg.n_kv_heads, cfg.head_dim)
