"""BENCHMARK.json keeps to the contract's names and shapes, and the harness
finds configurations, cells, mixes and metrics by name alone."""
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from bench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                    r"_dim$|_rank$|expansion|experts_per_tok)")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])


def test_every_name_and_unit_uses_the_allowed_characters():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for e in BENCH["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert e["chips"] in (1, 4)
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert PATH.match(c["file"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert LINE.match(w["why"])
    names = [e["name"] for e in entries]
    groups = (BENCH["configs"], BENCH["workloads"],
              BENCH["end_to_end"] + BENCH["per_layer"])
    for group in groups:
        assert len({e["name"] for e in group}) == len(group)
    assert all(NAME.match(n) for n in names)


def test_metric_entries():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert LINE.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        spec = harness.load_spec(ROOT, cell)
        assert "setup_s" in {m["name"] for m in spec.end_to_end}
        assert len(spec.end_to_end) >= 2 and spec.per_layer


def test_configs_files_and_reductions():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert any(path.is_relative_to(ROOT / p) for p in BENCH["paths"])
        config = json.loads(path.read_text())
        for key in c["reduced"]:
            assert key in config and not WIDTHS.search(key)
            assert config["published"][key] != config[key]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    spec = harness.load_spec(ROOT, cell)
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    assert spec.chips == entry["chips"]
    assert (ROOT / "bench/systems" / f"{spec.config['system']}.py").exists()
    assert spec.mix["jobs"]
    assert set(spec.check) == {"sample_per_app", "limits"}
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness._reader(m["name"]))


def test_a_cell_added_as_files_alone_runs(tmp_path, monkeypatch, small_spec):
    """A new mix, cell and metric: data files, one reader and entries in
    BENCHMARK.json, with no edit to a file the harness has."""
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "traffic" / "bc_only.json").write_text(json.dumps({
        "weighted": False,
        "jobs": [{"app": "bc", "root": {"draw": "vertex",
                                        "min_out_degree": 1}}]}))
    (bench / "workloads" / "uni-s21.bc.json").write_text(json.dumps({
        "sample_per_app": 2,
        "limits": {"mapping_mismatch": 0, "bc_gap": 1e-4,
                   "bc_level_mismatch": 0}}))
    (bench / "metrics" / "bc_jobs.py").write_text(
        "def read(run):\n    return float(len(run.window.jobs))\n")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "uni-s21.bc", "config": "uni-s21",
                             "traffic": "bc_only", "chips": 1,
                             "why": "test"})
    doc["end_to_end"].append({"name": "bc_jobs", "unit": "jobs",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["uni-s21.bc"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (tmp_path / "bench" / "configs").mkdir(exist_ok=True)
    monkeypatch.setattr(harness, "BENCH", bench)
    spec = harness.load_spec(tmp_path, "uni-s21.bc")
    spec.config.update(small_spec("uni-s21.pagerank").config)
    result, compared = harness.run_cell(spec, 7, 0.5, False,
                                        torch.device("cpu"), 0.0, {})
    assert result["correct"], compared
    assert result["metrics"]["bc_jobs"]["value"] == result["attempted"]
