"""The numbers that decide ``correct`` in the graph cells.

Each app's answer, in original vertex ids, is compared with the plain
reference's answer to the same job (``graph.run``), and gives one or two
numbers, each held to a limit of the cell's own:

* ``pr_gap``: PageRank, the largest gap of a rank as a share of the
  reference's rank (every rank is at least 0.15 / V, so the share is
  always defined);
* ``prd_gap``: PageRank-delta, the L1 gap of the ranks as a share of the
  reference's L1 norm (a vertex whose change lies within rounding of the
  activity threshold may go either way, which moves a few ranks by up to
  a few per cent: the L1 gap counts that as the small thing it is);
* ``sssp_mismatch``, ``bc_level_mismatch``, ``radii_mismatch``: vertices
  whose distance, BFS level or radius differs (integer weights make every
  distance exact, so these are exact comparisons with the limit 0);
* ``bc_gap``: the largest gap of a dependency, as a share of the
  reference's dependency where that is above 1 and as it is below 1;
* ``mapping_mismatch``: vertices whose DBG id differs from the
  reference's (exact).
"""
from __future__ import annotations

from typing import Dict

import torch

from . import graph

__all__ = ["run", "numbers", "mapping_mismatch"]


def run(app: str, edges: graph.Edges, params: dict, dtype):
    """The reference's answer to one job, in the shape ``numbers`` takes."""
    if app == "pagerank":
        return graph.pagerank(edges, damping=params["damping"],
                              tol=params["tol"], dtype=dtype)[0]
    if app == "pagerank_delta":
        return graph.pagerank_delta(edges, damping=params["damping"],
                                    epsilon=params["epsilon"], dtype=dtype)[0]
    if app == "sssp":
        return graph.sssp(edges, params["root"], dtype=dtype)
    if app == "bc":
        return graph.bc(edges, params["root"], dtype=dtype)
    if app == "radii":
        return graph.radii(edges, torch.as_tensor(params["sources"]))
    raise ValueError(f"no reference for app {app!r}")


def _count(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.to(want.dtype) != want).sum())


def numbers(app: str, got, want) -> Dict[str, float]:
    """The numbers of one job: ``got`` is the program's answer (or the
    control's), ``want`` the reference's, both in original ids."""
    if app == "pagerank":
        g, w = got.double(), want.double()
        return {"pr_gap": float(((g - w).abs() / w).max())}
    if app == "pagerank_delta":
        g, w = got.double(), want.double()
        return {"prd_gap": float((g - w).abs().sum() / w.abs().sum())}
    if app == "sssp":
        return {"sssp_mismatch": _count(got.double(), want.double())}
    if app == "bc":
        (c, lv), (cw, lvw) = got, want
        c, cw = c.double(), cw.double()
        gap = float(((c - cw).abs() / cw.abs().clamp(min=1.0)).max())
        return {"bc_gap": gap, "bc_level_mismatch": _count(lv, lvw)}
    if app == "radii":
        return {"radii_mismatch": _count(got, want)}
    raise ValueError(f"no comparison for app {app!r}")


def mapping_mismatch(got, want) -> float:
    return float((torch.as_tensor(got) != torch.as_tensor(want)).sum())
