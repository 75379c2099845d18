"""The LM decode cell end to end on the CPU at a tiny size: the spec loads,
the published configuration is the program's preset, a run reads correct,
each planted fault reads not correct, and the per-layer readers return
``None`` where nothing was traced."""
import copy
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from bench.lib import harness, lm_work
from bench.systems import lm_decode
from bench.tests import plant

ROOT = Path(__file__).resolve().parents[2]
CELL = "deepseek-v2-lite.decode"
METRICS = ("mla_decode_roofline", "mla_decode_device_share",
           "lm_launches_per_step", "decode_mfu", "lm_device_idle_share")

#: DeepSeek-V2-Lite's layers at tiny widths: a dense layer and two MoE
#: layers of its 64 experts, top-6 and 2 shared, YaRN and the published
#: options as they are
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128,
        "moe_intermediate_size": 32, "n_routed_experts": 64,
        "num_experts_per_tok": 6, "n_shared_experts": 2,
        "num_hidden_layers": 3, "vocab_size": 512, "hot_vocab_rows": 128}
TINY_MIX = {"batch": 4, "history": {"min": 48, "max": 160},
            "answer": {"min": 3, "max": 6}}


@pytest.fixture(autouse=True)
def steady_clock(monkeypatch):
    """A window of a fixed number of steps: the harness's clock advances
    10 ms at each reading, two readings a step."""
    import itertools
    import time
    import types

    ticks = itertools.count()
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * 0.01, time_ns=time.time_ns))


#: The whole-depth limits at three layers: the cell's (0.45) are set for
#: 27 layers, where the bf16 path's expert choices flip at near-ties and
#: its error grows to ~0.17; at three layers it stays under 0.02, and a
#: renormalised top-k reads 0.2-0.36 (the limit on the rows down to the
#: first near-tie is the cell's own)
SHALLOW = {"logits_rel_l2": 0.1, "cache_row_rel_l2": 0.1}


@pytest.fixture
def spec():
    s = harness.load_spec(ROOT, CELL)
    s.config.update(TINY)
    s.mix.update(TINY_MIX)
    s.check["limits"].update(SHALLOW)
    return s


def _run(spec, seed=2**31 + 77, seconds=0.2, trace=False):
    return harness.run_cell(spec, seed, seconds, trace, torch.device("cpu"),
                            0.0, {"hbm_bytes_per_s": 3.35e12})


def test_the_spec_loads_and_is_the_programs_preset():
    from repro_torch import configs

    s = harness.load_spec(ROOT, CELL)
    assert s.chips == 1 and s.config["system"] == "lm_decode"
    assert lm_decode.program_config(s.config) == configs.get_config(
        s.config["program_arch"])
    assert s.mix["batch"] == 32 and s.mix["jobs"] == [{"app": "decode"}]
    assert set(s.check["limits"]) == {"logits_rel_l2", "cache_row_rel_l2",
                                      "cache_row_rel_l2_untied"}
    assert s.check["sample_per_app"] == s.mix["batch"]  # every slot
    assert {m["name"] for m in s.per_layer} == set(METRICS)
    assert {m["name"] for m in s.end_to_end} == {"setup_s", "jobs_per_s",
                                                  "job_p95_ms"}


def test_a_value_the_program_has_no_option_for_raises():
    config = copy.deepcopy(harness.load_spec(ROOT, CELL).config)
    config["norm_topk_prob"] = True  # an option the program has: taken
    assert lm_decode.program_config(config).moe_norm_topk
    config["q_lora_rank"] = 1536
    with pytest.raises(ValueError, match="q_lora_rank"):
        lm_decode.program_config(config)


def test_the_untied_depth_stops_at_the_first_near_tie():
    errs = [0.003, 0.009, 0.012, 0.014, 0.02]
    # (layer, margin, spread): layer 2's margin 0.04 is under 8 x 0.012 x 0.5
    routers = [(1, 0.5, 1.0), (2, 0.04, 0.5), (3, 0.0, 1.0), (4, 0.0, 1.0)]
    assert lm_decode.untied_depth(errs, routers, 8.0) == 2
    assert lm_decode.untied_depth(errs, routers[:1], 8.0) == 4
    assert lm_decode.untied_depth(errs, [(1, 0.07, 1.0)], 8.0) == 1


def test_the_work_counts_of_deepseek_v2_lite():
    """2.45 B active weights a token (A2.4B), 34,816 FLOPs a cached row
    and layer, 1,152 B a row."""
    config = harness.load_spec(ROOT, CELL).config
    active = sum(lm_work.active_params(config).values())
    assert 2.40e9 < active < 2.50e9
    assert lm_work.attention_flops_per_row(config) == 34816
    assert lm_work.cache_row_bytes(config) == 1152


def test_a_sound_run_is_correct(spec):
    result, compared = _run(spec)
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] > 4
    assert set(result["metrics"]) == {"setup_s", "jobs_per_s", "job_p95_ms"}
    assert all(v == v for v, _ in compared.values())  # no NaN: steps kept
    json.dumps(result)


@pytest.mark.parametrize("fault", plant.FAULTS)
def test_a_planted_fault_reads_not_correct(spec, fault):
    with plant.planted(fault):
        result, compared = _run(spec)
    assert not result["correct"], (fault, compared)


def test_readers_find_nothing_untraced(spec):
    result, _ = _run(spec, trace=True)
    assert not set(METRICS) & set(result["metrics"])
    run = harness.Run(spec, 1.0, harness.Window([("decode", 0.1)], 0.1, {},
                                                0), None, {}, {}, {})
    for name in METRICS:
        assert harness._reader(name)(run) is None


def test_the_turns_restart_at_each_slots_history(spec):
    """A slot's turn ends after its drawn answer and its length goes back
    to its history's end; every kept step lies inside its slot's turn."""
    cell = lm_decode.Cell(spec.config, spec.mix, spec.check, 5,
                          torch.device("cpu"), harness.Spans(lambda: None))
    cell.warm_up()
    hist = cell.history.copy()
    assert (cell.cache["len"] == hist).all()
    for _ in range(12):
        cell.run("decode", {})
        lens = cell.cache["len"]
        assert ((lens >= hist) & (lens < hist + TINY_MIX["answer"]["max"]
                                  + 1)).all()
        for s, pos in cell.kept.items():
            assert hist[s] <= pos < lens[s]
    assert dataclasses.asdict(cell.cfg)["first_dense_layers"] == 1


def test_a_window_counts_its_own_rows(spec):
    """A step's rows, as the window reads them, are that step's alone
    (warm-up's counted before the window starts): every sequence's
    length + 1 in every layer."""
    cell = lm_decode.Cell(spec.config, spec.mix, spec.check, 11,
                          torch.device("cpu"), harness.Spans(lambda: None))
    cell.warm_up()
    before = dict(cell.counters)
    lens = cell.cache["len"].copy()
    cell.run("decode", {})
    cell.done("decode", {}, None, 0.0)
    rows = cell.counters["lm.mla_decode.cache_rows"] - before[
        "lm.mla_decode.cache_rows"]
    assert rows == int((lens + 1).sum()) * cell.cfg.n_layers
    assert cell.counters["lm.mla_decode.launches"] == 0  # no kernel here
