"""The (V, 8) property-plane half of the K5 variant grid: the plain kernel
against ``repro``'s Pallas kernel in interpret mode (see
``test_torch_edge_map_grid.py`` for the grid and the bands)."""
import pytest

pytest.importorskip("torch")

from test_torch_edge_map_grid import GRID, case_id, check_case  # noqa: E402


@pytest.mark.parametrize("case", [c for c in GRID if c[5] == 8], ids=case_id)
def test_plain_kernel_matches_pallas_on_planes(case):
    check_case(case)
