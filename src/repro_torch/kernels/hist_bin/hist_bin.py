"""DBG degree binning + histogram (Listing 1, steps 1-2) and the stable rank
(step 3): hand-written CUDA kernels.

Port of ``repro.kernels.hist_bin.hist_bin`` (the TPU kernel
``hist_bin_pallas``).  One launch bins every vertex: ``groups[v]`` is the
first k with ``deg[v] >= bounds[k]`` (0 when none matches, the TPU kernel's
argmax of the >= mask), and ``hist[k]`` counts group k.  The kernel takes
any V, so the reference's padding to a tile (and the correction of the last
bin that undoes it) has no counterpart here.  It works in tiles of
:data:`TILE` vertices and also writes each tile's offsets (every group's
vertices in earlier tiles), which ``dbg_bin`` needs; the rank kernel
(:func:`stable_rank`) turns groups, histogram and offsets into the stable
mapping that the reference computes in XLA.

The kernels are ``csrc/hist_bin.cu``, built with ``nvcc`` at first use
(``repro_torch.kernels._build``).  :func:`hist_bin` launches for CUDA
tensors and runs the plain PyTorch version (``ref``) for tensors the caller
put on the CPU; it never falls back from one to the other.
:func:`bin_tiles`, :func:`group_tiles` and :func:`stable_rank` take CUDA
tensors only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from .._wrap import launch_on, require

__all__ = ["MAX_BINS", "TILE", "bin_tiles", "group_tiles", "hist_bin",
           "load_kernels", "stable_rank"]

#: Most bounds the kernels take (the paper's DBG uses 8).
MAX_BINS = 32
#: Vertices per block of both kernels (``kTile`` in ``csrc/hist_bin.cu``).
TILE = 4096

_SOURCE = Path(__file__).resolve().parent / "csrc" / "hist_bin.cu"
_VARIANTS = {"all": []}
_KERNELS: Dict[str, ctypes._CFuncPtr] = {}
#: One zeroed uint32 per (device, raw stream): the binning kernel's ticket,
#: which its last block resets.  Launches on one stream run in order, so no
#: two grids meet on a ticket; calls on two streams at once each take their
#: own.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _bind(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib = libs["all"]
    lib.hist_bin_tile.argtypes = []
    lib.hist_bin_tile.restype = ctypes.c_int
    if lib.hist_bin_tile() != TILE:
        raise RuntimeError(f"hist_bin.cu tiles {lib.hist_bin_tile()} "
                           f"vertices, the wrapper {TILE}")
    for name, args in (("hist_bin", [p, p, i32, p, p, p, i64, p, i64, p]),
                       ("group_tiles", [p, i32, p, p, i64, p, i64, p]),
                       ("stable_rank", [p, i32, p, p, i64, p, i64, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn


def load_kernels() -> Dict[str, ctypes._CFuncPtr]:
    """Build (first use) and bind the hist_bin library."""
    if not _KERNELS:
        from .._build import load_libraries

        _bind(load_libraries(_SOURCE, _VARIANTS))
    return _KERNELS


def _check_bins(k: int) -> None:
    if not 1 <= k <= MAX_BINS:
        raise ValueError(f"1 <= K <= {MAX_BINS} groups, got {k}")


def _check_vertices(x: torch.Tensor, name: str) -> int:
    """V of an int32 (V,) CUDA tensor the kernels read raw: contiguous and
    below 2^31."""
    if x.dim() != 1:
        raise ValueError(f"{name} must be (V,), got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}: this kernel runs on cuda")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise TypeError(f"{name} must be a contiguous int32 (V,) tensor")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"V = {x.shape[0]}: the kernels take V < 2^31")
    return x.shape[0]


def _tiles_shape(v: int, k: int) -> Tuple[int, int]:
    """(tiles, kp): the kernels' per-tile rows are K wide rounded up to a
    power of two."""
    return max(1, -(-v // TILE)), 1 << (k - 1).bit_length()


def _tiles(v: int, k: int, device) -> torch.Tensor:
    return torch.empty(_tiles_shape(v, k), dtype=torch.int32, device=device)


def _ticket(device) -> torch.Tensor:
    """The ticket of ``device``'s current stream, the one the launch
    takes (made zero on that stream at its first use)."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def hist_bin(degrees: torch.Tensor,
             boundaries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(groups (V,) int32, histogram (K,) int32) of int32 ``degrees`` (V,)
    over int32 ``boundaries`` (K,), 1 <= K <= 32 (descending in DBG).

    CUDA tensors launch the kernel, one device operation (and count one
    launch in ``hist_bin.launches``); CPU tensors take the plain PyTorch
    version.
    """
    if boundaries.dim() != 1 or not 1 <= boundaries.shape[0] <= MAX_BINS:
        raise ValueError(f"boundaries must be (K,) with 1 <= K <= {MAX_BINS}, "
                         f"got {tuple(boundaries.shape)}")
    if degrees.dim() != 1:
        raise ValueError(f"degrees must be (V,), got {tuple(degrees.shape)}")
    if degrees.device.type == "cpu":
        from .ref import hist_bin_ref

        return hist_bin_ref(degrees, boundaries)
    if degrees.device.type != "cuda":
        raise ValueError(f"hist_bin runs on cuda or cpu, not {degrees.device}")
    groups, hist, _ = bin_tiles(degrees, boundaries)
    return groups, hist


def bin_tiles(degrees: torch.Tensor, boundaries: torch.Tensor):
    """The binning kernel on CUDA tensors: (groups, histogram, tiles), where
    ``tiles`` (ceil(V / TILE), K rounded up to a power of two) int32 holds
    every group's vertices in the tiles before each tile (what
    :func:`stable_rank` takes with the histogram).  Counts one launch in
    ``hist_bin.launches``."""
    v = _check_vertices(degrees, "degrees")
    dev = degrees.device
    k = boundaries.shape[0]
    _check_bins(k)
    require(boundaries, "boundaries", torch.int32, (k,), dev)
    groups = torch.empty((v,), dtype=torch.int32, device=dev)
    hist = torch.empty((k,), dtype=torch.int32, device=dev)
    tiles = _tiles(v, k, dev)
    err = launch_on(dev, load_kernels()["hist_bin"], degrees.data_ptr(),
                    boundaries.data_ptr(), k, groups.data_ptr(),
                    hist.data_ptr(), tiles.data_ptr(), tiles.numel(),
                    _ticket(dev).data_ptr(), v)
    _raise(err, "hist_bin")
    hist_bin.launches += 1
    return groups, hist, tiles


def group_tiles(groups: torch.Tensor, num_groups: int):
    """(histogram, tiles) as :func:`bin_tiles` gives them, for int32
    ``groups`` in ``[0, num_groups)`` on the card: the binning kernel
    counting groups it is given (one launch in ``hist_bin.launches``)."""
    v = _check_vertices(groups, "groups")
    _check_bins(num_groups)
    dev = groups.device
    hist = torch.empty((num_groups,), dtype=torch.int32, device=dev)
    tiles = _tiles(v, num_groups, dev)
    err = launch_on(dev, load_kernels()["group_tiles"], groups.data_ptr(),
                    num_groups, hist.data_ptr(), tiles.data_ptr(),
                    tiles.numel(), _ticket(dev).data_ptr(), v)
    _raise(err, "group_tiles")
    hist_bin.launches += 1
    return hist, tiles


def stable_rank(groups: torch.Tensor, hist: torch.Tensor,
                tiles: torch.Tensor) -> torch.Tensor:
    """Listing 1 step 3 on the card: mapping (V,) int64, new id = the start
    of my group (from ``hist``) + my group's vertices in earlier tiles
    (``tiles``) + my rank among my tile's earlier vertices of my group.
    ``hist`` and ``tiles`` are what :func:`bin_tiles` or
    :func:`group_tiles` returned for these groups.  Counts one launch in
    ``stable_rank.launches``."""
    v = _check_vertices(groups, "groups")
    dev = groups.device
    k = hist.shape[0] if hist.dim() == 1 else 0
    _check_bins(k)
    require(hist, "hist", torch.int32, (k,), dev)
    require(tiles, "tiles", torch.int32, _tiles_shape(v, k), dev)
    mapping = torch.empty((v,), dtype=torch.int64, device=dev)
    err = launch_on(dev, load_kernels()["stable_rank"], groups.data_ptr(), k,
                    hist.data_ptr(), tiles.data_ptr(), tiles.numel(),
                    mapping.data_ptr(), v)
    _raise(err, "stable_rank")
    stable_rank.launches += 1
    return mapping


hist_bin.launches = 0
stable_rank.launches = 0
