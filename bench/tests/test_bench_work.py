"""The yardstick: the work bytes of a pull, and the table of peaks."""
import json
from pathlib import Path

from bench.lib import work

BENCH = Path(__file__).resolve().parents[1]


def test_pull_bytes_at_the_cells_size():
    v, e = 2**21, 20 * 2**21
    # 4 E ids + 4 (V + 1) offsets + 4 V read + 4 V written
    assert work.pull_bytes(v, e) == 192_937_988
    assert abs(work.pull_bytes(v, e) / 3.35e12 - 57.59e-6) < 0.01e-6


def test_pull_bytes_counts_each_term_once():
    assert work.pull_bytes(0, 0) == 4
    assert work.pull_bytes(1, 0) == 4 * 2 + 8
    assert work.pull_bytes(3, 5) - work.pull_bytes(3, 4) == 4
    assert work.pull_bytes(4, 5) - work.pull_bytes(3, 5) == 12


def test_peak_table_names_the_card_and_its_source():
    peaks = json.loads((BENCH / "peaks.json").read_text())
    h100 = peaks["NVIDIA H100 80GB HBM3"]
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in h100["source"]


def test_k5_kernel_names_are_the_programs():
    src = (BENCH.parent / "src/repro_torch/kernels/edge_map/csrc/"
           "edge_map.cu").read_text()
    for name in work.K5_KERNELS:
        assert f"\n{name}(" in src, name
