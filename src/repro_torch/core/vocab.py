"""DBG applied to the vocabulary (integration K2): a numpy copy of
``repro.core.vocab``.

Token frequency in natural corpora is Zipfian — the same power-law skew the
paper exploits for vertices.  Token ids are binned by observed frequency into
DBG's geometric groups (frequency playing the role of degree), stable within
groups.  The first ``hot_rows`` rows of the reordered embedding table are the
hot set that K2 (``kernels/gather_embed``) serves.

``VocabReordering`` carries the permutation and its inverse so the data
pipeline can remap token streams.  The parity tests hold every array to the
reference's, bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .reorder import ReorderResult, _assign_groups, dbg_spec, group_reorder

__all__ = ["VocabReordering", "reorder_vocab", "zipf_frequencies"]


@dataclasses.dataclass(frozen=True)
class VocabReordering:
    mapping: np.ndarray        # old token id -> new row
    inverse: np.ndarray        # new row -> old token id
    hot_rows: int              # first hot_rows rows are the hot set
    group_sizes: np.ndarray    # per DBG group
    coverage: float            # fraction of total frequency mass in hot rows

    @property
    def vocab_size(self) -> int:
        return int(self.mapping.shape[0])


def zipf_frequencies(vocab_size: int, *, alpha: float = 1.1, seed: int = 0) -> np.ndarray:
    """Synthetic Zipf-like frequency table (rank r mass ~ r^-alpha) with the
    id->frequency association shuffled, modeling a tokenizer whose ids are
    not frequency-ordered (worst case for locality, like a scattered graph)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    freq = ranks ** (-alpha)
    rng.shuffle(freq)
    return freq


def reorder_vocab(
    frequencies: np.ndarray,
    *,
    num_hot_groups: int = 6,
    hot_group_count: int = 3,
    row_multiple: int = 128,
) -> VocabReordering:
    """Apply DBG over token frequencies.

    ``hot_group_count`` — how many of the hottest groups form the hot set
    (paper Table IV argument: the >=8A groups are ~12% of hot vertices but
    own the reuse).  ``row_multiple`` — hot_rows is rounded up to it.
    """
    freq = np.asarray(frequencies, dtype=np.float64)
    v = freq.shape[0]
    # map frequency to integer pseudo-degree for the shared grouping framework
    scale = (v * 4) / max(freq.mean(), 1e-30)
    pseudo_deg = np.maximum(0, np.round(freq * scale)).astype(np.int64)
    avg = max(1.0, float(pseudo_deg.mean()))
    spec = dbg_spec(avg, num_hot_groups=num_hot_groups)
    res: ReorderResult = group_reorder(pseudo_deg, spec, technique="dbg_vocab")
    mapping = res.mapping
    inverse = np.empty_like(mapping)
    inverse[mapping] = np.arange(v, dtype=mapping.dtype)

    groups = _assign_groups(pseudo_deg, spec.boundaries)
    sizes = np.bincount(groups, minlength=spec.num_groups)
    hot = int(sizes[: min(hot_group_count, sizes.shape[0])].sum())
    hot = min(v, ((hot + row_multiple - 1) // row_multiple) * row_multiple)
    coverage = float(freq[inverse[:hot]].sum() / max(freq.sum(), 1e-30))
    return VocabReordering(
        mapping=mapping, inverse=inverse, hot_rows=hot,
        group_sizes=sizes, coverage=coverage,
    )
