"""Incremental DBG: maintain the paper's degree groups under edge updates.

The port's copy of ``repro.stream.regroup`` (numpy only, bitwise equal
mappings and ``RemapDelta``s; ``tests/test_torch_stream.py``).  It bins on
the host through ``core.reorder._assign_groups``.

The insight that makes online reordering tractable is exactly the paper's
coarse-grain grouping (Listing 1 / Table V): group membership depends only on
which degree *range* a vertex falls in, so an edge update moves a vertex only
when its degree crosses a group boundary — the overwhelming majority of
updates leave the layout untouched.

``IncrementalDBG`` maintains:

  * the per-vertex degree vector and its running mean,
  * the group assignment ``group_of`` (0 = hottest, as in ``core.reorder``),
  * per-group member sets in insertion order (O(1) move in/out),

and emits a ``RemapDelta`` per update batch naming exactly the vertices that
changed group.  ``current_mapping()`` lays groups out hottest-first — on a
freshly built instance it reproduces ``core.reorder.dbg``'s mapping bit-for-
bit, and after updates with ``hysteresis=0`` its group assignment equals
batch ``group_reorder`` on the current degree vector.

Hysteresis (documented band): with hysteresis ``h``, a vertex currently in
group ``c`` moves hotter only once its degree clears the next boundary by the
multiplicative margin ``ceil(b[c-1] * (1+h))``, and moves colder only once it
falls below ``b[c] / (1+h)``.  Inside the band it stays put, so a vertex
oscillating around a boundary does not churn the mapping.  Consequently the
incremental assignment differs from the pure one only for vertices whose
degree lies inside the band of the boundary adjacent to their current group
(property-tested in ``tests/test_stream.py``).

Boundary drift: the paper's DBG derives boundaries from the average degree.
When the running mean drifts from the mean the spec was built at by more than
``spec_drift_tol`` (relative), the instance rebuilds its boundaries and
re-bins every vertex (stable in the current layout order) — rare by
construction, amortized O(V) like a compaction.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from ..core.reorder import GroupingSpec, _assign_groups, dbg_spec

__all__ = ["RemapDelta", "IncrementalDBG"]


@dataclasses.dataclass(frozen=True)
class RemapDelta:
    """Vertices that changed degree group in one update pass."""

    moved: np.ndarray  # original vertex ids
    old_group: np.ndarray
    new_group: np.ndarray
    spec_rebuilt: bool  # True when boundary drift forced a full re-bin
    seconds: float

    @property
    def num_moved(self) -> int:
        return int(self.moved.shape[0])

    @classmethod
    def merge(cls, deltas: "List[RemapDelta]") -> "RemapDelta":
        """Coalesce a delta sequence into one net move set.

        A vertex keeps its FIRST old group and LAST new group; vertices that
        ended up back where they started drop out entirely — exactly what a
        consumer applying the deltas in one shot (the sharded layout's
        ``repro_torch.dist.graph.apply_remap``) needs.  Seconds accumulate;
        ``spec_rebuilt`` ORs.
        """
        if not deltas:
            return cls(moved=np.zeros(0, np.int64),
                       old_group=np.zeros(0, np.int64),
                       new_group=np.zeros(0, np.int64),
                       spec_rebuilt=False, seconds=0.0)
        moved = np.concatenate([d.moved for d in deltas]).astype(np.int64)
        old_g = np.concatenate([d.old_group for d in deltas]).astype(np.int64)
        new_g = np.concatenate([d.new_group for d in deltas]).astype(np.int64)
        uniq, first = np.unique(moved, return_index=True)
        _, last_rev = np.unique(moved[::-1], return_index=True)
        last = moved.shape[0] - 1 - last_rev
        keep = old_g[first] != new_g[last]
        return cls(moved=uniq[keep], old_group=old_g[first][keep],
                   new_group=new_g[last][keep],
                   spec_rebuilt=any(d.spec_rebuilt for d in deltas),
                   seconds=float(sum(d.seconds for d in deltas)))


class IncrementalDBG:
    def __init__(
        self,
        degrees: np.ndarray,
        *,
        num_hot_groups: int = 6,
        hysteresis: float = 0.25,
        spec_drift_tol: float = 0.2,
        spec: Optional[GroupingSpec] = None,
    ):
        self.degrees = np.asarray(degrees, dtype=np.int64).copy()
        self.num_hot_groups = num_hot_groups
        self.hysteresis = float(hysteresis)
        self.spec_drift_tol = float(spec_drift_tol)
        self._deg_sum = int(self.degrees.sum())
        self.spec = spec or dbg_spec(self._mean(), num_hot_groups=num_hot_groups)
        self._spec_mean = self._mean()
        self.group_of = _assign_groups(self.degrees, self.spec.boundaries)
        # stable binning: original id order inside each group == batch DBG
        self._members: List[dict] = self._bin_members(
            np.arange(self.degrees.shape[0], dtype=np.int64))
        self.total_moved = 0
        self.total_seconds = 0.0
        self.updates_applied = 0

    def _mean(self) -> float:
        return max(1.0, self._deg_sum / max(1, self.degrees.shape[0]))

    @property
    def num_groups(self) -> int:
        return self.spec.num_groups

    def _layout_order(self) -> np.ndarray:
        """Vertices in layout order (groups hottest-first, insertion order
        within each group) — C-level key extraction, no per-vertex loop."""
        parts = [np.fromiter(m.keys(), dtype=np.int64, count=len(m))
                 for m in self._members if m]
        order = (np.concatenate(parts) if parts
                 else np.empty(0, dtype=np.int64))
        if order.shape[0] != self.degrees.shape[0]:
            raise RuntimeError(
                f"IncrementalDBG member sets cover {order.shape[0]} of "
                f"{self.degrees.shape[0]} vertices")
        return order

    def _bin_members(self, order: np.ndarray) -> List[dict]:
        """Split ``order`` (already in desired intra-group order) into per-
        group insertion-ordered member dicts via one vectorized pass."""
        groups = self.group_of[order]
        counts = np.bincount(groups, minlength=self.spec.num_groups)
        offs = np.concatenate([[0], np.cumsum(counts)])
        sort = np.argsort(groups, kind="stable")
        by_group = order[sort]
        return [dict.fromkeys(by_group[offs[g]:offs[g + 1]].tolist())
                for g in range(self.spec.num_groups)]

    # -- queries --------------------------------------------------------------
    def current_mapping(self) -> np.ndarray:
        """Full permutation M[v] = new id, groups laid out hottest-first."""
        n = self.degrees.shape[0]
        mapping = np.empty(n, dtype=np.int64)
        mapping[self._layout_order()] = np.arange(n, dtype=np.int64)
        return mapping

    def pure_groups(self) -> np.ndarray:
        """Hysteresis-free assignment of the current degrees (the batch-DBG
        reference the incremental state is validated against)."""
        return _assign_groups(self.degrees, self.spec.boundaries)

    def hot_ids(self, num_hot_groups: int) -> np.ndarray:
        """Vertices currently in the ``num_hot_groups`` hottest groups —
        the live hot set a sharded layout replicates (what
        ``shard_graph(hot_override=...)`` takes when rebuilding after a
        ``RemapOverflow``)."""
        return np.flatnonzero(self.group_of < int(num_hot_groups))

    # -- updates --------------------------------------------------------------
    def update(self, vertices: np.ndarray, new_degrees: np.ndarray) -> RemapDelta:
        """Set ``degrees[vertices] = new_degrees``; move boundary-crossers.

        O(|vertices|) plus O(V) only when boundary drift triggers a re-bin.
        """
        t0 = time.perf_counter()
        vertices = np.asarray(vertices, dtype=np.int64).ravel()
        new_degrees = np.asarray(new_degrees, dtype=np.int64).ravel()
        if vertices.size:
            # dedupe, keeping the LAST occurrence (assignment semantics)
            _, last = np.unique(vertices[::-1], return_index=True)
            keep = vertices.shape[0] - 1 - last
            vertices, new_degrees = vertices[keep], new_degrees[keep]
        self._deg_sum += int(new_degrees.sum() - self.degrees[vertices].sum())
        self.degrees[vertices] = new_degrees

        rebuilt = False
        mean = self._mean()
        if abs(mean - self._spec_mean) > self.spec_drift_tol * self._spec_mean:
            moved, old_g, new_g = self._rebuild()
            rebuilt = True
        else:
            moved, old_g, new_g = self._move_crossers(vertices, new_degrees)

        dt = time.perf_counter() - t0
        self.total_moved += moved.shape[0]
        self.total_seconds += dt
        self.updates_applied += 1
        return RemapDelta(moved=moved, old_group=old_g, new_group=new_g,
                          spec_rebuilt=rebuilt, seconds=dt)

    def _move_crossers(self, vertices, degs):
        b = np.asarray(self.spec.boundaries, dtype=np.int64)
        cur = self.group_of[vertices]
        pure = _assign_groups(degs, self.spec.boundaries)
        h = self.hysteresis
        # hotter move: degree cleared the lower bound of group c-1 by margin
        up = pure < cur
        next_b = b[np.maximum(cur - 1, 0)]
        up &= degs >= np.ceil(next_b * (1.0 + h)).astype(np.int64)
        # colder move: degree fell below own lower bound by margin
        down = (pure > cur) & (degs < b[cur] / (1.0 + h))
        move = up | down
        moved_v = vertices[move]
        old_g = cur[move].copy()
        new_g = pure[move]
        for vtx, og, ng in zip(moved_v.tolist(), old_g.tolist(), new_g.tolist()):
            del self._members[og][vtx]
            self._members[ng][vtx] = None
            self.group_of[vtx] = ng
        return moved_v, old_g, new_g

    def _rebuild(self):
        """Boundary drift: new spec from the current mean, stable re-bin in
        the CURRENT layout order (DBG semantics relative to the live layout)."""
        order = self._layout_order()
        self.spec = dbg_spec(self._mean(), num_hot_groups=self.num_hot_groups)
        self._spec_mean = self._mean()
        old_groups = self.group_of.copy()
        self.group_of = _assign_groups(self.degrees, self.spec.boundaries)
        self._members = self._bin_members(order)
        changed = np.where(old_groups != self.group_of)[0]
        return changed, old_groups[changed], self.group_of[changed]
