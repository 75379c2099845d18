"""The one generator of every traffic mix: a closed loop of jobs.

A mix is a data file, ``bench/traffic/<mix>.json``:

    {"jobs": [{"app": "sssp",
               "root": {"draw": "vertex", "min_out_degree": 1}}, ...]}

One client runs its jobs back to back, each after the last has finished.
The jobs come in rounds: every round holds each entry of ``jobs`` once,
in an order drawn from the run's seed.  Every key of an entry besides
``app`` is a parameter of the job: a literal, or an object that the cell's
system resolves for each job (``resolve``), such as a root drawn from the
seed.  So every seed gives the same mix of jobs, in another order and with
other roots.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterator, Tuple

import numpy as np

__all__ = ["load", "jobs"]


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if not mix.get("jobs"):
        raise ValueError(f"{path}: no jobs")
    for entry in mix["jobs"]:
        if "app" not in entry:
            raise ValueError(f"{path}: every job names an app")
    return mix


def jobs(mix: dict, rng: np.random.Generator,
         resolve: Callable[[dict, np.random.Generator], object]
         ) -> Iterator[Tuple[str, Dict]]:
    """Endless ``(app, params)`` of ``mix``, drawn from ``rng``."""
    entries = mix["jobs"]
    while True:
        for i in rng.permutation(len(entries)):
            entry = entries[i]
            params = {k: resolve(v, rng) if isinstance(v, dict) else v
                      for k, v in entry.items() if k != "app"}
            yield entry["app"], params
