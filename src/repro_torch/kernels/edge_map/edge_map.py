"""The fused edge map (kernel family K5): a hand-written CUDA kernel.

Port of ``repro.kernels.edge_map.edge_map`` (the TPU kernel
``ell_edge_map_pallas``).  One launch per ELL tile class fuses the flat
engine's separate O(E) passes — gather ``x[src]``, add the weight, mask the
frontier, reduce — into one pass over the class's rows:

  * ``reduce`` in {sum, min, max};
  * additive weights from a (R, W) plane, or a constant ``+1`` with no plane
    read (``unit_weights`` on an unweighted graph);
  * a source frontier gathered through the same ids: inactive sources give
    ``neutral``;
  * padding lanes (past the row's degree) and dead lanes of the alive plane
    give the reduction's exact identity, so min / max match the flat engine
    bit for bit;
  * ``init_rows`` seeds the accumulator: push is the pull of the transposed
    direction with an init-seeded accumulator;
  * ``x`` may be a (V, K) plane, with a shared (V,) or per-query (V, K)
    frontier.

The kernel is ``csrc/edge_map.cu``; it is built with ``nvcc`` at first use
(``repro_torch.kernels._build``).  :func:`ell_edge_map` launches it for CUDA
tensors and runs the plain PyTorch version (``ref.ell_edge_map_ref``) for
tensors the caller put on the CPU; it never falls back from one to the other.
A whole tile set goes through ``ops.fused_edge_map``, which maps every class
in one call of the library's grouped entry.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from .._wrap import (SEGMENT_LANES, class_segments, lanes_per_row, require,
                     row_segments)

__all__ = ["REDUCE_IDENTITY", "SEGMENT_LANES", "reduce_identity",
           "edge_map_tile_bytes", "row_segments", "ell_edge_map",
           "load_kernels"]

REDUCE_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}

_SOURCE = Path(__file__).resolve().parent / "csrc" / "edge_map.cu"
_VARIANTS = {"sum": ["-DK5_REDUCE=0"], "min": ["-DK5_REDUCE=1"],
             "max": ["-DK5_REDUCE=2"]}
_KERNELS: Dict[str, ctypes._CFuncPtr] = {}


def reduce_identity(reduce: str) -> float:
    """Identity element of an engine reduction — THE canonical table.

    Every layer that pads must fill with this exact value so padding can
    never leak into a combiner.  ``"or"`` is the engine's max over {0,1}
    reachability lanes; its identity is 0 (no bit set).
    """
    if reduce == "or":
        return 0.0
    return REDUCE_IDENTITY[reduce]


def edge_map_tile_bytes(r_pad: int, w_pad: int, num_vertices: int, *,
                        weighted: bool, frontier: bool, alive: bool,
                        init: bool, idx_itemsize: int = 4,
                        plane_k: int = 1,
                        frontier_planar: bool = False) -> int:
    """Single-pass HBM bytes of one fused tile call over the PADDED planes.

    ``plane_k`` is the batched-query lane count: the property/init/output
    bytes scale with K while the tile structure (idx/w/alive/deg) is read
    ONCE for all K lanes.  ``frontier_planar`` marks a per-query (V, K)
    frontier vs one shared (V,) vector.  The CUDA kernel never reads the
    padding lanes, so this is an upper bound on what it has to move.
    """
    b = r_pad * w_pad * idx_itemsize  # idx plane (minimal-width ids)
    if weighted:
        b += r_pad * w_pad * 4  # w plane
    if alive:
        b += r_pad * w_pad  # int8 alive plane
    b += r_pad * 4  # deg
    b += num_vertices * 4 * plane_k  # x (counted once)
    if frontier:
        b += num_vertices * (plane_k if frontier_planar else 1)  # int8
    if init:
        b += r_pad * 4 * plane_k
    b += r_pad * 4 * plane_k  # y
    return b


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
    for red, lib in libs.items():
        fn = getattr(lib, f"k5_edge_map_{red}")
        fn.argtypes = [p, p, i32, p, p, i32, p, i32, p, p, p, p, i64, p, i64,
                       i64, i64, i32, i32, f32, f32, p]
        fn.restype = ctypes.c_int
        _KERNELS[red] = fn
        fn = getattr(lib, f"k5_grouped_{red}")
        fn.argtypes = [p, i32, i32, p, p, i32, p, p, p, i64, i32, i64, i64,
                       i32, f32, f32, p, p]
        fn.restype = ctypes.c_int
        _KERNELS[f"grouped_{red}"] = fn


def load_kernels() -> Dict[str, ctypes._CFuncPtr]:
    """Build (first use) and bind the three K5 libraries: ``reduce`` → the
    one-class C entry, ``"grouped_" + reduce`` → the whole-tile-set entry
    (``ops.fused_edge_map``)."""
    if not _KERNELS:
        from .._build import load_libraries

        _bind(load_libraries(_SOURCE, _VARIANTS))
    return _KERNELS


def ell_edge_map(
    x: torch.Tensor,
    idx: torch.Tensor,
    deg: torch.Tensor,
    *,
    reduce: str = "sum",
    w: Optional[torch.Tensor] = None,
    unit_weights: bool = False,
    frontier: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    init_rows: Optional[torch.Tensor] = None,
    neutral: float = 0.0,
    identity: Optional[float] = None,
    segments: Optional[torch.Tensor] = None,
    row_tile: int = 64,
    width_tile: int = 128,
) -> torch.Tensor:
    """y (R,) = REDUCE over valid lanes of masked(x[idx] (+ w)) [seeded by init].

    The arguments of ``ell_edge_map_pallas`` without ``interpret``.
    ``idx``/``deg`` as the packer emits them (R % row_tile == 0, W %
    width_tile == 0).  ``x`` (V,) or (V, K) float32; ``idx`` uint16 or int32
    (R, W); ``deg`` int32 (R,); ``w`` float32 (R, W); ``frontier`` int8 (V,)
    or (V, K); ``alive`` int8 (R, W); ``init_rows`` float32 (R,) or (R, K).
    Every id must be < V.

    A tile wider than 1,024 lanes takes a 256-thread block per piece of a
    row and a second launch that folds each row's pieces: ``segments``
    (S, 3) int32, the tile's ``row_segments(deg)`` (``EllTileGroup.segments``,
    built with the tiles), cuts each row at every ``SEGMENT_LANES`` of its
    degree.  A caller that passes none gets that list built here from
    ``deg`` (a copy to the host: set-up, not per-call work, so callers on a
    hot path pass the tiles' own).  Any list that covers each row's
    ``[0, deg)`` in order computes the same function.  That copy is a
    counted host read (``obs.counters.host_read``).

    CUDA tensors launch the K5 kernel (and count its launches in
    ``ell_edge_map.launches``: one, or two for a wide tile); CPU tensors
    take the plain PyTorch version.
    """
    if reduce not in REDUCE_IDENTITY:
        raise ValueError(reduce)
    r, width = idx.shape
    if r % row_tile or width % width_tile:
        raise ValueError(f"idx shape {tuple(idx.shape)} is not a multiple of "
                         f"the ({row_tile}, {width_tile}) tile")
    if identity is None:
        identity = REDUCE_IDENTITY[reduce]
    if x.device.type == "cpu":
        from .ref import ell_edge_map_ref

        return ell_edge_map_ref(
            x, idx, deg, reduce=reduce, w=w, unit_weights=unit_weights,
            frontier=frontier, alive=alive, init_rows=init_rows,
            neutral=neutral, identity=identity)
    if x.device.type != "cuda":
        raise ValueError(f"ell_edge_map runs on cuda or cpu, not {x.device}")
    if reduce == "sum" and identity != 0.0:
        raise ValueError("the sum kernel takes identity 0 only")
    dev = x.device
    if x.dtype != torch.float32 or x.dim() not in (1, 2) or not x.is_contiguous():
        raise TypeError("x must be a contiguous float32 (V,) or (V, K) tensor")
    v = x.shape[0]
    k = x.shape[1] if x.dim() == 2 else 1
    row_shape = (r, k) if x.dim() == 2 else (r,)
    if idx.dtype not in (torch.uint16, torch.int32):
        raise TypeError(f"idx must be uint16 or int32, got {idx.dtype}")
    require(idx, "idx", idx.dtype, (r, width), dev)
    require(deg, "deg", torch.int32, (r,), dev)
    if w is not None:
        require(w, "w", torch.float32, (r, width), dev)
    fmode = 0
    if frontier is not None:
        fmode = 2 if frontier.dim() == 2 else 1
        fshape = (v, k) if fmode == 2 else (v,)
        if fmode == 2 and x.dim() != 2:
            raise ValueError("a (V, K) frontier needs a (V, K) x")
        require(frontier, "frontier", torch.int8, fshape, dev)
    if alive is not None:
        require(alive, "alive", torch.int8, (r, width), dev)
    if init_rows is not None:
        require(init_rows, "init_rows", torch.float32, row_shape, dev)
    if v == 0:
        raise ValueError("x is empty")
    group = lanes_per_row(width)
    partial = None
    if group == 256:
        if segments is None:
            from ...obs.counters import host_read

            segments = class_segments(host_read(deg), width, dev)
        require(segments, "segments", torch.int32, (segments.shape[0], 3), dev)
        partial = torch.empty((segments.shape[0], k), dtype=torch.float32,
                              device=dev)
    elif segments is not None:
        raise ValueError(f"a ({r}, {width}) tile is narrow: segments split "
                         "only rows wider than 1,024 lanes")

    y = torch.empty(row_shape, dtype=torch.float32, device=dev)
    fn = load_kernels()[reduce]
    wmode = 2 if w is not None else (1 if unit_weights else 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), idx.data_ptr(), idx.element_size(),
                 deg.data_ptr(), ptr(w), wmode, ptr(frontier), fmode,
                 ptr(alive), ptr(init_rows), y.data_ptr(), ptr(segments),
                 0 if segments is None else segments.shape[0], ptr(partial),
                 r, width, v, k, group, float(neutral), float(identity),
                 stream)
    if err != 0:
        raise RuntimeError(f"K5 edge-map launch failed: cudaError {err}")
    # a wide tile is two launches: the pieces' blocks, then the fold
    ell_edge_map.launches += 2 if group == 256 else 1
    return y


ell_edge_map.launches = 0
