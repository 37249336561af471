"""Serving-plane caches: compiled plans and materialized results.

The port's copy of ``daft_tpu/serving/caches.py``. Both are
byte-budgeted LRUs keyed by the logical-plan fingerprint
(``logical/fingerprint.py``: literal-stripped structure, bound-parameter
vector and source versions; see that module for the invalidation rules).

- :class:`PlanCache` amortizes ``optimize() + translate()`` and keeps the
  translated physical plan's scan tasks (footer reads already done) warm;
  the device tier's compiled projections key on the expressions
  (``device/runtime._get_compiled``), so a hit also re-enters them.
- :class:`ResultCache` short-circuits execution for an identical
  literal-inclusive fingerprint over unchanged sources: a hit runs no
  kernel. Entries are immutable ``PartitionSet``s and account their
  ``size_bytes()``.

Thread-safe; the hit, miss and eviction counters feed the serving stats
block and ``/metrics``.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Tuple


class _LRUCache:
    """Byte-budgeted LRU with counters. ``budget <= 0`` disables it."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Tuple, Tuple[object, int]]" \
            = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def enabled(self) -> bool:
        return self.budget > 0

    def get(self, key: Tuple):
        if not self.enabled or key is None:
            return None
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent[0]

    def put(self, key: Tuple, value, nbytes: int) -> None:
        if not self.enabled or key is None:
            return
        nbytes = max(int(nbytes), 1)
        if nbytes > self.budget:
            return  # a single over-budget entry would evict everything
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.budget and self._entries:
                _, (_, sz) = self._entries.popitem(last=False)
                self._bytes -= sz
                self.evictions += 1

    def invalidate(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "entries":
                    len(self._entries), "bytes": self._bytes,
                    "budget": self.budget}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class PlanCache(_LRUCache):
    """fingerprint.key → (optimized logical plan, translated physical
    plan). Entries are plan trees — small; accounted at a flat estimate
    per node so the budget still bounds growth. Also tracks *structure*
    hits: a submission whose literal-stripped shape was seen before (even
    with different bound parameters) re-enters the device tier's compiled
    projections, which the serving counters report."""

    _NODE_COST = 2048  # bytes charged per plan node (descriptor-sized)

    def __init__(self, budget_bytes: int):
        super().__init__(budget_bytes)
        self._structures: Dict[str, int] = {}
        self.structure_hits = 0

    @staticmethod
    def _tree_size(node) -> int:
        return 1 + sum(PlanCache._tree_size(c)
                       for c in getattr(node, "children", ()))

    def get_plan(self, fp):
        if fp is None:
            return None
        with self._lock:
            seen = fp.structure in self._structures
            if seen:
                self.structure_hits += 1
        hit = self.get(fp.key)
        return hit

    def put_plan(self, fp, optimized_plan, physical_plan) -> None:
        if fp is None or not self.enabled:
            return
        nbytes = self._NODE_COST * (self._tree_size(optimized_plan)
                                    + self._tree_size(physical_plan))
        self.put(fp.key, (optimized_plan, physical_plan), nbytes)
        with self._lock:
            if len(self._structures) > 65536:  # bound the shape index
                self._structures.clear()
            self._structures[fp.structure] = \
                self._structures.get(fp.structure, 0) + 1

    def stats(self) -> Dict[str, float]:
        out = super().stats()
        out["structure_hits"] = self.structure_hits
        return out


class ResultCache(_LRUCache):
    """fingerprint.key → materialized PartitionSet (immutable)."""

    def get_result(self, fp):
        return self.get(fp.key) if fp is not None else None

    def put_result(self, fp, partition_set) -> None:
        if fp is None or not self.enabled:
            return
        try:
            nbytes = int(partition_set.size_bytes() or 0)
        except Exception:
            return
        self.put(fp.key, partition_set, nbytes)
