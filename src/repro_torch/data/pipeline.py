"""Synthetic token stream with Zipfian skew: a numpy copy of
``repro.data.pipeline`` (the LM analogue of the paper's power-law degrees).

``batch(step, shard)`` is a pure function of (seed, step, shard).  The
frequency table feeds the DBG vocabulary reordering (``core.vocab``); a
``vocab_map`` remaps the stream into the reordered id space, where the
first ``hot_vocab_rows`` ids are the hot rows K2 serves.  The parity tests
hold every batch to the reference's, bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..core.vocab import VocabReordering

__all__ = ["DataConfig", "ZipfPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int  # per-shard batch
    alpha: float = 1.1  # Zipf exponent
    seed: int = 0
    motif_prob: float = 0.15  # fraction of positions drawn from repeated motifs
    motif_len: int = 16
    n_motifs: int = 256


class ZipfPipeline:
    """Stateless-indexed Zipf token stream with injected motif structure."""

    def __init__(self, cfg: DataConfig, vocab_map: Optional[VocabReordering] = None):
        self.cfg = cfg
        self.vocab_map = vocab_map
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.alpha)
        # id->frequency association shuffled: tokenizer ids are not
        # frequency-sorted (this is what DBG reordering later fixes)
        rng.shuffle(probs)
        self.probs = probs / probs.sum()
        self.cum = np.cumsum(self.probs)
        self.motifs = rng.integers(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int64
        )

    def frequencies(self) -> np.ndarray:
        return self.probs.copy()

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + shard * num_shards + 17
        )
        b, s = cfg.batch_size, cfg.seq_len
        u = rng.random((b, s + 1))
        toks = np.searchsorted(self.cum, u).astype(np.int64)
        # paste motifs at random offsets (learnable n-gram structure)
        n_paste = int(b * (s + 1) * cfg.motif_prob / cfg.motif_len)
        if n_paste:
            rows = rng.integers(0, b, size=n_paste)
            cols = rng.integers(0, s + 1 - cfg.motif_len, size=n_paste)
            which = rng.integers(0, cfg.n_motifs, size=n_paste)
            for r, c, m in zip(rows, cols, which):
                toks[r, c : c + cfg.motif_len] = self.motifs[m]
        if self.vocab_map is not None:
            toks = self.vocab_map.mapping[toks]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
