"""Host-side ELL packer + device entry point for the degree-binned SpMV (K1).

Port of ``repro.kernels.csr_spmv.ops``.  ``dbg_spmv`` is the pull-mode edge
map over a DBG-reordered graph: host-side, rows (destinations) are packed
per DBG group into ELL planes whose width is the group's degree ceiling
(geometric ranges → ≤ 2x padding); on the device, one K1 launch per group,
and each group's row sums are written into place with ``index_copy_`` (a
row lies in exactly one group, so the writes never meet).  The per-group
widths are the paper's Table IV column structure made executable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ...device import resolve_device
from ...graph import csr as csr_mod
from .._wrap import class_segments
from ..edge_map.ops import _round_up
from .csr_spmv import ell_spmv

__all__ = ["EllGroup", "ell_pack_groups", "dbg_spmv", "ell_spmv"]


@dataclasses.dataclass(frozen=True)
class EllGroup:
    rows: torch.Tensor  # (R,) int64 destination vertex ids (R_true of them)
    idx: torch.Tensor  # (R_pad, W_pad) int32 source indices (0 for padding)
    w: torch.Tensor  # (R_pad, W_pad) float32 weights (0 for padding)
    num_rows: int  # true (unpadded) row count
    # (R_pad,) int32 true degrees, 0 for padding rows; None when unknown
    # (the planes alone cannot tell: a real edge may have weight 0)
    deg: Optional[torch.Tensor] = None
    max_deg: Optional[int] = None  # the largest of deg (host), with deg
    # (S, 3) int32 row_segments(deg) of a group wider than 1,024 lanes
    segments: Optional[torch.Tensor] = None


def ell_pack_groups(
    g: csr_mod.Graph,
    boundaries: Sequence[int],
    *,
    row_tile: int = 256,
    width_tile: int = 512,
    device: Optional[Union[str, torch.device]] = None,
) -> List[EllGroup]:
    """Pack in-CSR rows into per-DBG-group ELL planes on ``device`` (``None``:
    the CUDA card, raising without one).

    The reference fills each row in a Python loop; this fill is one
    vectorized scatter per group (``csr.ragged_offsets``) and gives the same
    arrays.  Unweighted graphs get weight 1 in every valid lane.  Each group
    also keeps its rows' true degrees (``deg``, ``max_deg``), which K1 walks
    to, and a group wider than 1,024 lanes its segment list.
    """
    device = resolve_device(device)
    in_csr = g.in_csr
    deg = in_csr.degrees()
    b = np.asarray(boundaries, dtype=np.int64)
    asc = b[::-1]
    grp = (len(b) - 1) - (np.searchsorted(asc, deg, side="right") - 1)
    groups: List[EllGroup] = []
    for k in range(len(b)):
        rows = np.where(grp == k)[0]
        if rows.size == 0:
            continue
        rdeg = deg[rows].astype(np.int64)
        wmax = int(rdeg.max())
        if wmax == 0:
            continue  # zero-degree rows contribute nothing
        w_pad = _round_up(wmax, width_tile)
        r_pad = _round_up(rows.size, row_tile)
        src = csr_mod.ragged_offsets(in_csr.indptr[rows], rdeg)
        dst = csr_mod.ragged_offsets(
            np.arange(rows.size, dtype=np.int64) * w_pad, rdeg)
        idx = np.zeros((r_pad, w_pad), dtype=np.int32)
        wgt = np.zeros((r_pad, w_pad), dtype=np.float32)
        idx.ravel()[dst] = in_csr.indices[src]
        wgt.ravel()[dst] = (in_csr.weights[src] if in_csr.weights is not None
                            else 1.0)
        gdeg = np.zeros(r_pad, dtype=np.int32)
        gdeg[: rows.size] = rdeg
        groups.append(EllGroup(
            rows=torch.from_numpy(rows.astype(np.int64)).to(device),
            idx=torch.from_numpy(idx).to(device),
            w=torch.from_numpy(wgt).to(device),
            num_rows=int(rows.size),
            deg=torch.from_numpy(gdeg).to(device),
            max_deg=wmax,
            segments=class_segments(gdeg, wmax, device)))
    return groups


def dbg_spmv(
    x: torch.Tensor,
    groups: List[EllGroup],
    num_vertices: int,
    *,
    row_tile: int = 256,
    width_tile: int = 512,
) -> torch.Tensor:
    """Full pull-mode edge map: per-group row sums written back to vertex
    ids; vertices in no group keep 0.  A group that keeps its degrees
    (``gr.deg``) reads only its real lanes.

    ``row_tile``/``width_tile`` must match the values used by
    ``ell_pack_groups`` (the packer pads every group to these multiples).
    """
    y = torch.zeros((num_vertices,), dtype=x.dtype, device=x.device)
    for gr in groups:
        ys = ell_spmv(x, gr.idx, gr.w, deg=gr.deg, max_deg=gr.max_deg,
                      segments=gr.segments, row_tile=row_tile,
                      width_tile=width_tile)
        y.index_copy_(0, gr.rows, ys[: gr.num_rows])
    return y
