"""Delta + byte-aligned group-varint codec for adjacency lists.

The ordering↔compressibility coupling (Floros et al., PAPERS.md) is the whole
point of this codec: a locality-friendly vertex ordering (DBG, Gorder) maps
the high-reuse hub vertices to *small ids*, so after per-row delta encoding
("first neighbor, then ascending gaps") most values fit in one byte.  The
byte stream is a streamvbyte-style **group varint**: every group of 4 values
owns one control byte (2 bits per value = its byte length 1..4), followed by
the values' little-endian bytes.  Byte alignment keeps decode a pair of
vectorized gathers — no bit twiddling — and 4 bytes cover any int32 vertex id.

Blocks: rows are grouped into fixed-count blocks (``rows_per_block``); each
block's value count is padded to a multiple of 4 so every block owns whole
control bytes and is **independently decodable** from its (ctrl, data) byte
offsets — the per-block metadata of the packed layout.  Both encode and
decode are single-pass vectorized NumPy over the whole segment; the per-block
entry point just slices the same arrays.

This is the PyTorch port's own copy of ``repro.pack.codec`` (host-side
numpy): the port imports nothing of ``repro``, and
``tests/test_torch_pack.py`` holds the two copies to bitwise-equal arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..graph.csr import ragged_offsets

__all__ = [
    "GroupVarintLists",
    "encode_values",
    "decode_all",
    "decode_block",
    "delta_encode_rows",
    "delta_decode_values",
    "min_uint_dtype",
    "value_data_offsets",
]


def min_uint_dtype(max_value: int) -> np.dtype:
    """Smallest unsigned dtype holding ``max_value`` (degree-implied CSR)."""
    for dt in (np.uint8, np.uint16, np.uint32):
        if max_value <= np.iinfo(dt).max:
            return np.dtype(dt)
    return np.dtype(np.uint64)


@dataclasses.dataclass(frozen=True)
class GroupVarintLists:
    """A segment of varint-encoded per-row value lists.

    ``ctrl``/``data`` are the concatenated per-block byte streams;
    ``block_ctrl``/``block_data`` are (B+1,) offsets into them; ``vpb`` is the
    TRUE (unpadded) value count per block.  Row structure (how many values
    each row owns) lives with the caller as a degree array — the layout's
    "offset-free, degree-implied" contract: no per-row offsets are stored.
    """

    ctrl: np.ndarray  # (C,) uint8 — one control byte per 4 (padded) values
    data: np.ndarray  # (D,) uint8 — little-endian value bytes
    vpb: np.ndarray  # (B,) int64 — true values per block
    block_ctrl: np.ndarray  # (B+1,) int64 offsets into ctrl
    block_data: np.ndarray  # (B+1,) int64 offsets into data
    rows_per_block: int
    num_rows: int

    @property
    def num_blocks(self) -> int:
        return int(self.vpb.shape[0])

    @property
    def num_values(self) -> int:
        return int(self.vpb.sum())

    @property
    def nbytes_ctrl(self) -> int:
        return int(self.ctrl.shape[0])

    @property
    def nbytes_data(self) -> int:
        return int(self.data.shape[0])

    @property
    def nbytes_meta(self) -> int:
        # the independently-decodable-block metadata: both offset arrays
        return int(self.block_ctrl.nbytes + self.block_data.nbytes)


def _value_lengths(values: np.ndarray) -> np.ndarray:
    """Byte length (1..4) of each value under the group-varint encoding."""
    v = values
    return (1 + (v >= (1 << 8)).astype(np.int64) + (v >= (1 << 16))
            + (v >= (1 << 24)))


def encode_values(
    values: np.ndarray, counts: np.ndarray, *, rows_per_block: int = 64
) -> GroupVarintLists:
    """Group-varint encode per-row value lists (vectorized, one pass).

    ``values`` is the concatenation of every row's value list; ``counts`` is
    the per-row value count (sum == len(values)).  Values must be in
    [0, 2**32).
    """
    values = np.asarray(values, dtype=np.int64).ravel()
    counts = np.asarray(counts, dtype=np.int64).ravel()
    if int(counts.sum()) != values.shape[0]:
        raise ValueError("counts must sum to len(values)")
    if values.size and (values.min() < 0 or values.max() >= (1 << 32)):
        raise ValueError("values out of varint range [0, 2**32)")
    rpb = int(rows_per_block)
    num_rows = counts.shape[0]
    nblocks = max(1, -(-num_rows // rpb))

    # true + padded value counts per block
    row_block = np.arange(num_rows, dtype=np.int64) // rpb
    vpb = np.bincount(row_block, weights=counts, minlength=nblocks).astype(
        np.int64)
    pad_vpb = -(-vpb // 4) * 4  # round up to whole control bytes
    block_val = np.zeros(nblocks + 1, np.int64)
    np.cumsum(pad_vpb, out=block_val[1:])

    # scatter true values into the per-block padded stream (pad slots = 0,
    # which encodes as 1 byte and is dropped again at decode)
    padded = np.zeros(int(block_val[-1]), np.int64)
    padded[ragged_offsets(block_val[:-1], vpb)] = values

    # per-value byte lengths -> control bytes (2 bits each, 4 per byte)
    lens = _value_lengths(padded)
    l4 = (lens - 1).reshape(-1, 4)
    ctrl = (l4[:, 0] | (l4[:, 1] << 2) | (l4[:, 2] << 4)
            | (l4[:, 3] << 6)).astype(np.uint8)

    # data bytes: value i occupies data[off[i] : off[i] + lens[i]], LE
    cum = np.zeros(padded.shape[0] + 1, np.int64)
    np.cumsum(lens, out=cum[1:])
    data = np.zeros(int(cum[-1]), np.uint8)
    off = cum[:-1]
    for k in range(4):
        m = lens > k
        data[off[m] + k] = (padded[m] >> (8 * k)) & 0xFF

    return GroupVarintLists(
        ctrl=ctrl,
        data=data,
        vpb=vpb,
        block_ctrl=block_val // 4,
        block_data=cum[block_val],
        rows_per_block=rpb,
        num_rows=num_rows,
    )


def _ctrl_lengths(ctrl: np.ndarray) -> np.ndarray:
    """Per-value byte lengths of a (padded) stream, from its control bytes."""
    if ctrl.shape[0] == 0:
        return np.zeros(0, np.int64)
    c = ctrl.astype(np.int64)
    return np.stack([(c >> s) & 3 for s in (0, 2, 4, 6)], axis=1).ravel() + 1


def _pad_keep_mask(vpb: np.ndarray) -> np.ndarray:
    """Mask over the padded value stream marking the TRUE (unpadded) slots."""
    pad_vpb = -(-vpb // 4) * 4
    starts = np.zeros(vpb.shape[0], np.int64)
    np.cumsum(pad_vpb[:-1], out=starts[1:])
    within = np.arange(int(pad_vpb.sum()), dtype=np.int64) - np.repeat(
        starts, pad_vpb)
    return within < np.repeat(vpb, pad_vpb)


def _decode_stream(ctrl: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Decode a (ctrl, data) byte stream into its padded value stream."""
    lens = _ctrl_lengths(ctrl)
    if lens.shape[0] == 0:
        return np.zeros(0, np.int64)
    cum = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=cum[1:])
    off = cum[:-1]
    dpad = np.concatenate([data, np.zeros(3, np.uint8)]).astype(np.int64)
    vals = np.zeros(lens.shape[0], np.int64)
    for k in range(4):
        m = lens > k
        vals[m] |= dpad[off[m] + k] << (8 * k)
    return vals


def decode_all(gvl: GroupVarintLists) -> np.ndarray:
    """Decode every block — the exact inverse of ``encode_values``."""
    return _decode_stream(gvl.ctrl, gvl.data)[_pad_keep_mask(gvl.vpb)]


def value_data_offsets(gvl: GroupVarintLists) -> np.ndarray:
    """Byte offset into ``data`` of every TRUE value's encoding.

    The structure-address hook for the cache model
    (``PackedAdjacency.structure_addresses``): where each value's bytes
    physically live, derived from the same control-byte lengths and padding
    rule the decoder uses, so the two can never desynchronize.
    """
    lens = _ctrl_lengths(gvl.ctrl)
    return (np.cumsum(lens) - lens)[_pad_keep_mask(gvl.vpb)]


def decode_block(gvl: GroupVarintLists, b: int) -> Tuple[np.ndarray, int]:
    """Decode block ``b`` alone (independently of every other block).

    Returns ``(values, first_row)`` — the block's true values and the index
    of its first row (row structure comes from the caller's degree array).
    """
    ctrl = gvl.ctrl[gvl.block_ctrl[b]:gvl.block_ctrl[b + 1]]
    data = gvl.data[gvl.block_data[b]:gvl.block_data[b + 1]]
    vals = _decode_stream(ctrl, data)[: int(gvl.vpb[b])]
    return vals, b * gvl.rows_per_block


def delta_encode_rows(neighbors: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-row delta encoding: [first, gap, gap, ...] for each row.

    ``neighbors`` concatenates the rows' neighbor lists; every row must be
    sorted ascending (the layout canonicalizes), so all gaps are >= 0.
    """
    neighbors = np.asarray(neighbors, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if neighbors.shape[0] == 0:
        return neighbors.copy()
    first = np.zeros(neighbors.shape[0], dtype=bool)
    starts = np.cumsum(counts) - counts
    first[starts[counts > 0]] = True
    gaps = np.concatenate([[0], np.diff(neighbors)])
    vals = np.where(first, neighbors, gaps)
    if vals.min() < 0:
        raise ValueError("rows must be sorted ascending for delta encoding")
    return vals


def delta_decode_values(values: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Inverse of ``delta_encode_rows`` — segmented cumulative sum.

    Within each row the running sum of [first, gaps...] IS the neighbor list,
    so one global cumsum minus each row's pre-row prefix restores all rows in
    one vectorized pass.
    """
    values = np.asarray(values, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if values.shape[0] == 0:
        return values.copy()
    c = np.cumsum(values)
    nz = counts[counts > 0]
    starts = np.cumsum(nz) - nz
    pre_row = np.repeat(c[starts] - values[starts], nz)
    return c - pre_row
