"""Cardinality / size estimation over logical plans.

Reference: ``daft_tpu/logical/stats.py`` (after the reference engine's
``src/daft-logical-plan/src/stats.rs``). Scan stats come from parquet
footers via materialized scan tasks (cached on the Source node); everything
else applies selectivity heuristics. Estimates are deliberately coarse —
they only rank join orders (``ReorderJoins``) and gate
``SemiJoinReduction`` — and equal the reference's on the same sources.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

from . import plan as lp

# default selectivities (the reference hardcodes similar factors in its
# ApproxStats arms)
FILTER_SELECTIVITY = 0.2
EQ_FILTER_SELECTIVITY = 0.05
AGG_GROUP_FACTOR = 0.1


@dataclass(frozen=True)
class Stats:
    rows: Optional[float]
    size_bytes: Optional[float]

    def scaled(self, f: float) -> "Stats":
        return Stats(None if self.rows is None else max(self.rows * f, 1.0),
                     None if self.size_bytes is None
                     else max(self.size_bytes * f, 1.0))


UNKNOWN = Stats(None, None)


def _scan_tasks(node: lp.Source):
    tasks = getattr(node, "materialized_tasks", None)
    if tasks is None and node.scan_op is not None:
        tasks = node.scan_op.to_scan_tasks(node.pushdowns)
        node.materialized_tasks = tasks
    return tasks


def _source_stats(node: lp.Source) -> Stats:
    if node.partitions is not None:
        parts = node.partitions
        # a SpillBuffer (the runner's AQE actuals) counts at append time:
        # summing would reload its spilled entries from disk
        rows = getattr(parts, "total_rows", None)
        size = getattr(parts, "total_bytes", None)
        if rows is None:
            rows = sum(len(p) for p in parts)
        if size is None:
            size = sum(p.size_bytes() or 0 for p in parts)
        return Stats(float(rows), float(size) or None)
    tasks = _scan_tasks(node)
    if not tasks:
        return Stats(0.0, 0.0)
    rows = 0.0
    size = 0.0
    rows_known = True
    for t in tasks:
        r = t.num_rows()
        if r is None:
            rows_known = False
        else:
            rows += r
        size += t.size_bytes() or 0
    if not rows_known:
        # filters pushed into the scan hide exact counts: estimate from
        # bytes at ~100 B/row, times the filter selectivity
        est = (size / 100.0) * FILTER_SELECTIVITY if size else None
        return Stats(est, size * FILTER_SELECTIVITY if size else None)
    if node.pushdowns.limit is not None:
        rows = min(rows, node.pushdowns.limit)
    return Stats(rows, size or None)


def _filter_selectivity(pred) -> float:
    # an equality against a literal is much more selective than a range
    ops = set()

    def walk(e):
        ops.add(e.op)
        for c in e.args:
            walk(c)

    walk(pred)
    if "eq" in ops and "or" not in ops:
        return EQ_FILTER_SELECTIVITY
    return FILTER_SELECTIVITY


def estimate(node: lp.LogicalPlan) -> Stats:
    """Bottom-up estimated (rows, bytes) for a plan subtree."""
    if isinstance(node, lp.Source):
        return _source_stats(node)
    kids = [estimate(c) for c in node.children]
    if isinstance(node, lp.Filter):
        return kids[0].scaled(_filter_selectivity(node.predicate))
    if isinstance(node, lp.Limit):
        s = kids[0]
        rows = node.limit if s.rows is None else min(s.rows, node.limit)
        return Stats(float(rows), s.size_bytes)
    if isinstance(node, lp.Sample):
        if node.fraction is not None:
            return kids[0].scaled(node.fraction)
        return Stats(float(node.size), None)
    if isinstance(node, lp.Aggregate):
        if not node.group_by:
            return Stats(1.0, 256.0)
        return kids[0].scaled(AGG_GROUP_FACTOR)
    if isinstance(node, lp.Distinct):
        return kids[0].scaled(AGG_GROUP_FACTOR)
    if isinstance(node, lp.Explode):
        return kids[0].scaled(4.0)
    if isinstance(node, lp.Concat):
        l, r = kids
        rows = None if l.rows is None or r.rows is None else l.rows + r.rows
        size = None if l.size_bytes is None or r.size_bytes is None \
            else l.size_bytes + r.size_bytes
        return Stats(rows, size)
    if isinstance(node, lp.Join):
        l, r = kids
        if node.how == "cross":
            if l.rows is None or r.rows is None:
                return UNKNOWN
            return Stats(l.rows * r.rows,
                         None if l.size_bytes is None or r.size_bytes is None
                         else l.size_bytes * max(r.rows, 1.0)
                         + r.size_bytes * max(l.rows, 1.0))
        if node.how in ("semi", "anti"):
            return l.scaled(0.5)
        if node.how == "left":
            return l
        if node.how == "right":
            return r
        # inner equi-join: PK-FK assumption — output ≈ the larger (fact)
        # side
        if l.rows is None or r.rows is None:
            return UNKNOWN
        rows = max(l.rows, r.rows)
        size = None
        if l.size_bytes is not None and r.size_bytes is not None:
            lw = l.size_bytes / max(l.rows, 1.0)
            rw = r.size_bytes / max(r.rows, 1.0)
            size = rows * (lw + rw)
        return Stats(rows, size)
    # row-preserving ops (Project/UDFProject/Sort/TopN/Window/
    # MonotonicallyIncreasingId)
    if kids:
        return kids[0]
    return UNKNOWN


# ------------------------------------------------------------------ NDV

def column_ndv(node: lp.LogicalPlan, name: str,
               est_rows: Optional[float] = None) -> Optional[float]:
    """Approximate distinct-value count of a column in a plan subtree.

    Integer/date key columns get ``max - min + 1`` from parquet footer
    statistics (exact for the dense surrogate keys join graphs are built
    on: nationkey 0–24 → 25), capped by the subtree's estimated rows.
    Columns without usable stats fall back to the row estimate
    (near-unique assumption, i.e. FK-join-shaped).

    ``est_rows``: the caller's row estimate for ``node``, if already
    computed (avoids a redundant estimate() walk)."""
    est = estimate(node).rows if est_rows is None else est_rows
    footer = column_ndv_footer(node, name, est_rows=est)
    return est if footer is None else footer


def column_ndv_footer(node: lp.LogicalPlan, name: str,
                      est_rows: Optional[float] = None) -> Optional[float]:
    """Like :func:`column_ndv` but returns None instead of the near-unique
    row-estimate fallback: only parquet-footer min/max evidence counts."""
    src = _find_source_with(node, name)
    if src is None:
        return None
    rng = _source_column_range(src, name)
    if rng is None:
        return None
    est = estimate(node).rows if est_rows is None else est_rows
    return rng if est is None else min(rng, est)


def _find_source_with(node: lp.LogicalPlan, name: str):
    if isinstance(node, lp.Source):
        return node if name in node.schema().column_names else None
    for c in node.children:
        if name in c.schema().column_names:
            return _find_source_with(c, name)
    return None


def _footer_range(md, name: str):
    """(min, max) of an int/date column over every row group of one
    parquet footer, or None when a group lacks min/max statistics or the
    column is of another type. A date counts by day; a timestamp does not
    (a day of distinct timestamps would collapse to ndv 1). None too for
    a file without a footer (CSV, JSON)."""
    if md is None:
        return None
    idx = {md.schema.column(i).name: i
           for i in range(md.num_columns)}.get(name)
    if idx is None:
        return None
    lo = hi = None
    for rg in range(md.num_row_groups):
        st = md.row_group(rg).column(idx).statistics
        if st is None or not st.has_min_max:
            return None
        mn, mx = st.min, st.max
        if not isinstance(mn, int) or isinstance(mn, bool):
            if isinstance(mn, datetime.datetime) \
                    or not isinstance(mn, datetime.date):
                return None
            mn, mx = mn.toordinal(), mx.toordinal()
        lo = mn if lo is None else min(lo, mn)
        hi = mx if hi is None else max(hi, mx)
    return None if lo is None else (lo, hi)


def _source_column_range(node: lp.Source, name: str) -> Optional[float]:
    """(max-min+1) over all files' footer stats for an int/date column."""
    cache = getattr(node, "_ndv_cache", None)
    if cache is None:
        cache = node._ndv_cache = {}
    if name in cache:
        return cache[name]
    out = None
    tasks = _scan_tasks(node) if node.scan_op is not None else None
    if tasks:
        lo = hi = None
        seen_paths = set()
        files = ((p, md) for t in tasks for p, md, _ in t.files())
        for path, md in files:
            # split tasks share a file: one footer per path
            if path in seen_paths:
                continue
            seen_paths.add(path)
            rng = _footer_range(md, name)
            if rng is None:
                lo = None
                break
            lo = rng[0] if lo is None else min(lo, rng[0])
            hi = rng[1] if hi is None else max(hi, rng[1])
        if lo is not None:
            out = float(hi - lo + 1)
    cache[name] = out
    return out
