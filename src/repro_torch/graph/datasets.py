"""Scaled dataset registry mirroring Table IX / Table X of the paper.

Each entry regenerates, at tractable scale, a graph with the same *signature*
(skew + structured-or-not original ordering) as the paper's dataset.  Scale is
settable; the default "bench" scale keeps every graph < ~2M edges so the whole
40-datapoint matrix runs on one CPU core, while "test" scale is tiny.

Paper Table IX:
  kr  Kron        67M/1323M  synthetic, unstructured
  pl  PLD         43M/623M   real, unstructured
  tw  Twitter     62M/1468M  real, unstructured
  sd  SD          95M/1937M  real, unstructured
  lj  LiveJournal  5M/68M    real, structured
  wl  WikiLinks   18M/172M   real, structured
  fr  Friendster  64M/2147M  real, structured
  mp  MPI         53M/1963M  real, structured
Table X: uni (RMAT a=b=c=25%), road (USA road network).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from . import csr, generators

__all__ = ["DatasetSpec", "REGISTRY", "load", "SCALES"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    key: str
    kind: str  # 'rmat' | 'plc' | 'uni' | 'road'
    structured: bool
    avg_degree: float
    synthetic: bool
    # relative size multiplier vs the base vertex count of the chosen scale
    size_mult: float = 1.0
    extra: dict = dataclasses.field(default_factory=dict)


# Signature-faithful entries. avg_degree follows Table IX ratios.
REGISTRY: Dict[str, DatasetSpec] = {
    "kr": DatasetSpec("kr", "rmat", False, 20.0, True, 1.0, {"a": 0.57, "b": 0.19, "c": 0.19}),
    "pl": DatasetSpec("pl", "plc", False, 15.0, False, 0.7, {"alpha": 2.0}),
    "tw": DatasetSpec("tw", "plc", False, 24.0, False, 1.0, {"alpha": 1.95}),
    "sd": DatasetSpec("sd", "plc", False, 20.0, False, 1.4, {"alpha": 1.9}),
    "lj": DatasetSpec("lj", "plc", True, 14.0, False, 0.35, {"alpha": 2.15}),
    "wl": DatasetSpec("wl", "plc", True, 9.0, False, 0.6, {"alpha": 1.9}),
    "fr": DatasetSpec("fr", "plc", True, 33.0, False, 1.0, {"alpha": 2.1}),
    "mp": DatasetSpec("mp", "plc", True, 37.0, False, 0.8, {"alpha": 1.95}),
    # Table X no-skew controls
    "uni": DatasetSpec("uni", "rmat", False, 20.0, True, 1.0, {"a": 0.25, "b": 0.25, "c": 0.25}),
    "road": DatasetSpec("road", "road", True, 2.4, False, 1.0),
}

# base vertex counts per scale
SCALES = {"test": 2_000, "small": 20_000, "bench": 60_000, "large": 200_000}


def load(key: str, scale: str = "bench", seed: int = 0) -> csr.Graph:
    """Materialize a dataset at the requested scale."""
    spec = REGISTRY[key]
    base_v = SCALES[scale]
    v = max(64, int(base_v * spec.size_mult))
    if spec.kind == "rmat":
        e = int(v * spec.avg_degree)
        return generators.rmat(v, e, seed=seed, name=key, **spec.extra)
    if spec.kind == "plc":
        ncomm = max(4, v // 300)
        return generators.powerlaw_community(
            v,
            spec.avg_degree,
            num_communities=ncomm,
            structured_ids=spec.structured,
            seed=seed,
            name=key,
            **spec.extra,
        )
    if spec.kind == "road":
        side = int(np.sqrt(v))
        return generators.road_grid(side, seed=seed, name=key)
    raise KeyError(spec.kind)


def load_weighted(key: str, scale: str = "bench", seed: int = 0) -> csr.Graph:
    return generators.with_weights(load(key, scale, seed), seed=seed + 1)
