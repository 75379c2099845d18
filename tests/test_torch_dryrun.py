"""The port's dry run (A12.7, ``repro_torch.launch.dryrun``) and its
roofline terms.

One subprocess (``tests/dist_workers.py torch-dryrun``: the dry run joins
fake process groups of 256 and 1 ranks) runs:

* the reference test's cell (``tests/test_dist.py::
  test_dryrun_smoke_reduced_config``): reduced ``olmo_1b`` / ``train_4k`` /
  ``single``, with its assertions (status ``ok``, no failure, flops > 0,
  collective total > 0);
* ``argument_bytes`` against the local shard bytes of the parameters, both
  moments and the batch counted apart from the specs;
* the per-device FLOPs on local shards: on a (1, 1) mesh the count equals
  the unsharded step's, and a product split on rows over ``data`` and
  columns over ``model`` of a (16, 16) mesh counts 1/256 of the whole;
* resume (a second run re-runs no ``ok`` cell) and the ``long_500k`` skip
  of an arch with full attention.

``model_flops`` and ``roofline_terms`` against the reference's on the same
inputs; on the ``"h100"`` profile ``collective_s`` is 0 and says so.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.roofline import analysis as ref_roofline  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tests",
                                                     "dist_workers.py"),
                        "torch-dryrun", str(out)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout[-2000:]
                                                    + r.stderr[-3000:])
    with open(out / "dr.json") as f:
        cells = json.load(f)
    with open(out / "summary.json") as f:
        return cells, json.load(f)


def test_reduced_smoke_cell_is_ok(dry):
    cells, summary = dry
    cell = cells["olmo_1b|train_4k|single"]
    assert summary["failures"] == 0 and cell["status"] == "ok"
    pd = cell["per_device"]
    assert pd["flops"] > 0
    assert pd["collective_bytes"]["total"] > 0
    assert pd["collective_bytes"]["total"] == sum(
        v for k, v in pd["collective_bytes"].items() if k != "total")
    assert cell["mesh"] == "16x16" and cell["n_devices"] == 256
    assert pd["peak_bytes"] == pd["argument_bytes"] + pd["temp_bytes"]
    assert pd["bytes_accessed"] > 0 and pd["temp_bytes"] > 0
    r = cell["roofline"]
    assert r["collective_s"] == 0 and "collective_note" in r
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"])


def test_argument_bytes_are_the_local_shards(dry):
    cells, summary = dry
    got = cells["olmo_1b|train_4k|single"]["per_device"]["argument_bytes"]
    assert got == summary["argument_bytes_apart"]


def test_flops_are_counted_on_local_shards(dry):
    _, summary = dry
    assert summary["flops_1x1"] == summary["flops_plain"] > 0
    assert summary["matmul_flops_16x16"] * 256 == summary["matmul_flops_whole"]


def test_resume_and_the_long_context_skip(dry):
    cells, summary = dry
    assert summary["resume_failures"] == 0
    skip = cells["olmo_1b|long_500k|single"]
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]


def test_model_flops_and_roofline_terms_match_the_reference():
    for kind in ("train", "prefill", "decode"):
        assert roofline.model_flops(1.3e9, 4096 * 256, kind) == \
            ref_roofline.model_flops(1.3e9, 4096 * 256, kind)
    ref_hw = ref_roofline.HW()
    hw = roofline.HW(peak_flops=ref_hw.peak_flops, hbm_bw=ref_hw.hbm_bw,
                     link_bw=ref_hw.link_bw, name="v5e-numbers")
    for args in ((1e15, 1e11, 1e9), (1e12, 1e12, 0.0), (1e10, 1e9, 5e10)):
        want = ref_roofline.roofline_terms(*args, hw=ref_hw)
        got = roofline.roofline_terms(*args, hw=hw)
        assert got == want
    h100 = roofline.roofline_terms(1e15, 1e11, 1e9)
    assert h100["collective_s"] == 0.0 and math.isinf(
        roofline.HW.profile().link_bw)
    assert "infinite" in h100["collective_note"]
    assert h100["compute_s"] == 1e15 / roofline.HW.profile().peak_flops
