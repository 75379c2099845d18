"""The LM decode path's spans and counters (``repro_torch.obs``), on the CPU.

Spans: ``lm.decode_step`` around each step, with an ``lm.mla_decode`` per
MLA layer and an ``lm.moe`` per MoE layer inside it; logits bitwise the
same with the tracer on and off.  Counters: ``lm.mla_decode.cache_rows``
adds every sequence's rows read (its length + 1) per MLA layer, from the
host lengths; ``lm.mla_decode.launches`` stays 0 off the card.  A
prefill through the forward adds no rows: it reads no cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.lm import model  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_obs_state():
    obs_trace.disable()
    metrics.reset_registry()
    yield
    obs_trace.disable()
    metrics.reset_registry()


@pytest.fixture(scope="module")
def lm():
    cfg = configs.reduced(configs.get_config("deepseek_v2_lite"), n_layers=3)
    return model.LM(cfg, generator=torch.Generator().manual_seed(0))


def _steps(lm, lens, steps=2):
    cfg = lm.cfg
    cache = model.init_cache(cfg, len(lens), 32, device="cpu",
                             dtype=torch.float32)
    model.set_lengths(cache, lens)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (len(lens), steps))).to(torch.int32)
    return [model.decode_step(lm, cache, toks[:, t:t + 1])[0]
            for t in range(steps)]


def _value(name):
    return getattr(metrics.get_registry().get(name), "value", None)


def test_decode_spans_nest_and_change_nothing(lm):
    plain = _steps(lm, [4, 9])
    tracer = obs_trace.enable()
    traced = _steps(lm, [4, 9])
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    spans = tracer.spans_unix_ns()
    steps = [(s, e) for s, e, n in spans if n == "lm.decode_step"]
    inner = {n: [(s, e) for s, e, m in spans if m == n]
             for n in ("lm.mla_decode", "lm.moe")}
    assert len(steps) == 2
    assert len(inner["lm.mla_decode"]) == 2 * lm.cfg.n_layers
    assert len(inner["lm.moe"]) == 2 * (lm.cfg.n_layers
                                        - lm.cfg.first_dense_layers)
    for s, e in inner["lm.mla_decode"] + inner["lm.moe"]:
        assert any(s0 <= s and e <= e0 for s0, e0 in steps)


def test_decode_counts_rows_and_launches(lm):
    lens = [4, 9, 0]
    _steps(lm, lens, steps=2)
    rows = sum(n + 1 for n in lens) + sum(n + 2 for n in lens)
    assert _value("lm.mla_decode.cache_rows") == rows * lm.cfg.n_layers
    assert not _value("lm.mla_decode.launches")


def test_forward_spans_its_moe_layers_and_reads_no_cache(lm):
    tracer = obs_trace.enable()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, lm.cfg.vocab_size, (2, 5))).to(torch.int32)
    model.forward(lm, toks)
    names = [n for _, _, n in tracer.spans_unix_ns()]
    assert names.count("lm.moe") == (lm.cfg.n_layers
                                     - lm.cfg.first_dense_layers)
    assert "lm.mla_decode" not in names and "lm.decode_step" not in names
    assert not _value("lm.mla_decode.cache_rows")
