"""The work a kernel has to do, counted from the input's sizes alone.

A roofline share divides this work by the measured time and the chip's
peak (``peaks.json``).  The count is fixed by the input, whatever layout
or kernel implements the step, so a change of layout cannot move the
yardstick.
"""
from __future__ import annotations

__all__ = ["K5_KERNELS", "pull_bytes"]


def pull_bytes(num_vertices: int, num_edges: int) -> int:
    """Bytes of one sum pull ``y[d] = sum over in-edges (s, d) of x[s]``:
    each input byte read once and each output byte written once, with
    int32 ids and offsets (every count here is below 2**31) and float32
    values: the in-neighbour ids (4 E), the offsets (4 (V + 1)), ``x``
    read (4 V) and ``y`` written (4 V)."""
    return 4 * num_edges + 4 * (num_vertices + 1) + 8 * num_vertices

#: K5's kernels (``src/repro_torch/kernels/edge_map/csrc/edge_map.cu``) as
#: the profiler names them: the row kernel, the split hub rows' block
#: kernel and their fold.
K5_KERNELS = ("edge_map_kernel", "edge_map_block_kernel", "fold_kernel")
