"""Adaptive query execution.

The port of ``daft_tpu/physical/adaptive.py`` (reference ``AdaptivePlanner``,
``src/daft-physical-plan/src/physical_planner/planner.rs:451-640`` —
``next_stage`` / ``update_stats``): stages materialize at exchange
boundaries and ACTUAL cardinalities feed back into planning of the
remaining query. Three adaptive layers compose:

1. **Stage re-planning** (``runners/native_runner.py:_run_adaptive``):
   join inputs materialize cheapest-first; each one's measured rows/bytes
   replace its subtree as an in-memory source and the WHOLE optimizer
   re-runs over the remainder — join order (ReorderJoins with actuals)
   and broadcast-vs-hash flip from measurements. ``record_replan`` logs
   each round.
2. **Shuffle resizing** (executor ``_fan_exchange_streaming``):
   engine-inserted shuffles coalesce buckets from materialized bytes.
3. **Join demotion** (executor ``_adaptive_hash_join``): a planned hash
   join whose measured input fits the broadcast threshold skips both
   shuffles.

Enable with ``set_execution_config(enable_aqe=True)``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# ------------------------------------------------------ adaptive counters
# process-wide, the spill counters' snapshot/delta pattern: ``replans``
# (one per re-plan of any layer), ``join_demotions``, ``shuffle_resizes``
# and ``history_evictions``

_counters_lock = threading.Lock()
_counters: Dict[str, float] = {}


def count(name: str, n: float = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n
    # also credit the thread's attributed query (its ``adaptive`` block)
    from .. import observability as obs
    obs.bump_plane("adaptive", name, n)


def counters_snapshot() -> Dict[str, float]:
    with _counters_lock:
        return dict(_counters)


def counters_delta(before: Dict[str, float],
                   after: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
    if after is None:
        after = counters_snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


def counters_reset() -> None:
    with _counters_lock:
        _counters.clear()


#: bound on ``AdaptivePlanner.history``: the planner lives as long as its
#: executor, and an unbounded decision log in a long-lived process is a
#: slow leak (the reference's default cap)
HISTORY_CAP = 512


@dataclass
class StageStats:
    rows: int = 0
    size_bytes: int = 0
    partitions: int = 0
    decision: str = ""


class AdaptivePlanner:
    """Records per-boundary actuals and decides adapted partition counts.

    ``history`` is BOUNDED (:data:`HISTORY_CAP`): appends past the cap
    evict the oldest entry, counted in ``evictions`` (and the process-wide
    ``history_evictions`` counter)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._lock = threading.Lock()
        self.history: List[StageStats] = []
        self.evictions = 0
        self._cap = HISTORY_CAP
        #: the last physical plan the runner's AQE loop executed
        self.final_plan = None

    def _append_locked(self, s: StageStats) -> None:
        self.history.append(s)
        while len(self.history) > self._cap:
            self.history.pop(0)
            self.evictions += 1
            count("history_evictions")

    def adapt_partition_count(self, planned: int, total_bytes: int,
                              total_rows: int) -> int:
        """Engine-inserted shuffle → partition count sized from ACTUAL
        materialized bytes, bounded by the planned count."""
        target = max(self.cfg.target_partition_size_bytes, 1)
        by_size = max(math.ceil(total_bytes / target), 1)
        adapted = max(min(planned, by_size), 1)
        if adapted < planned:
            count("replans")
            count("shuffle_resizes")
        with self._lock:
            self._append_locked(StageStats(
                rows=total_rows, size_bytes=total_bytes, partitions=adapted,
                decision=(f"shuffle {planned}→{adapted} parts "
                          f"({total_bytes} bytes materialized)")))
        return adapted

    def record_replan(self, decision: str, rows: int = 0,
                      size_bytes: int = 0) -> None:
        """Stage-level re-plan: a join input was materialized, its ACTUAL
        stats folded back into the logical plan, and the optimizer re-run
        over the remainder (the reference's update_stats → next_stage)."""
        count("replans")
        with self._lock:
            self._append_locked(StageStats(
                rows=rows, size_bytes=size_bytes, partitions=0,
                decision=decision))

    def record_join(self, decision: str, measured_bytes: int) -> None:
        """Join-strategy adaptation from measured input sizes (hash ↔
        broadcast demotion)."""
        if decision != "hash":
            count("replans")
            count("join_demotions")
        with self._lock:
            self._append_locked(StageStats(
                rows=0, size_bytes=measured_bytes, partitions=0,
                decision=f"join {decision} "
                         f"({measured_bytes} bytes measured)"))

    def explain_analyze(self) -> str:
        lines = ["== Adaptive execution =="]
        with self._lock:
            if self.evictions:
                lines.append(f"(history capped at {self._cap}; "
                             f"{self.evictions} oldest entries evicted)")
            for i, s in enumerate(self.history):
                lines.append(f"stage {i}: rows={s.rows} "
                             f"bytes={s.size_bytes} → {s.decision}")
        return "\n".join(lines)


_last: Optional[AdaptivePlanner] = None
_last_lock = threading.Lock()


def new_planner(cfg) -> AdaptivePlanner:
    global _last
    p = AdaptivePlanner(cfg)
    with _last_lock:
        _last = p
    return p


def last_planner() -> Optional[AdaptivePlanner]:
    return _last
