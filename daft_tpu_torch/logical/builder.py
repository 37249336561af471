"""LogicalPlanBuilder: the construction API the DataFrame/SQL layers target.

Reference: ``src/daft-logical-plan/src/builder/mod.rs:59`` and the expression
resolution in ``builder/resolve_expr.rs`` (agg extraction / post-projection).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..expressions import Expression, col
from ..schema import Schema
from . import plan as lp


def _to_exprs(items) -> List[Expression]:
    out = []
    for x in items:
        if isinstance(x, Expression):
            out.append(x)
        elif isinstance(x, str):
            out.append(col(x))
        else:
            raise TypeError(f"expected Expression or column name, got {x!r}")
    return out


class LogicalPlanBuilder:
    def __init__(self, plan: lp.LogicalPlan):
        self._plan = plan

    # ---- sources ---------------------------------------------------------
    @classmethod
    def from_scan(cls, scan_op) -> "LogicalPlanBuilder":
        return cls(lp.Source(scan_op=scan_op, schema=scan_op.schema()))

    @classmethod
    def from_in_memory(cls, partitions, schema: Schema) -> "LogicalPlanBuilder":
        return cls(lp.Source(partitions=list(partitions), schema=schema))

    @property
    def plan(self) -> lp.LogicalPlan:
        return self._plan

    def schema(self) -> Schema:
        return self._plan.schema()

    def _wrap(self, node) -> "LogicalPlanBuilder":
        return LogicalPlanBuilder(node)

    # ---- relational ops --------------------------------------------------
    def select(self, exprs: Sequence) -> "LogicalPlanBuilder":
        resolved: List[Expression] = []
        for x in exprs:
            if isinstance(x, str) and x == "*":
                resolved.extend(col(n) for n in self.schema().column_names)
            else:
                resolved.extend(_to_exprs([x]))
        return self._wrap(lp.Project(self._plan, resolved))

    def with_columns(self, exprs: Sequence[Expression]) -> "LogicalPlanBuilder":
        new_names = {e.name() for e in exprs}
        keep = [col(n) for n in self.schema().column_names
                if n not in new_names]
        return self._wrap(lp.Project(self._plan, keep + list(exprs)))

    def with_columns_renamed(self, mapping: Dict[str, str]) -> "LogicalPlanBuilder":
        exprs = []
        for n in self.schema().column_names:
            exprs.append(col(n).alias(mapping[n]) if n in mapping else col(n))
        return self._wrap(lp.Project(self._plan, exprs))

    def exclude(self, names: Sequence[str]) -> "LogicalPlanBuilder":
        drop = set(names)
        keep = [col(n) for n in self.schema().column_names if n not in drop]
        return self._wrap(lp.Project(self._plan, keep))

    def filter(self, predicate: Expression) -> "LogicalPlanBuilder":
        f = predicate.to_field(self.schema())
        if not f.dtype.is_boolean():
            raise ValueError(f"filter predicate must be Boolean, got {f.dtype!r}")
        return self._wrap(lp.Filter(self._plan, predicate))

    def limit(self, n: int, offset: int = 0) -> "LogicalPlanBuilder":
        return self._wrap(lp.Limit(self._plan, n, offset))

    def unpivot(self, ids, values, variable_name="variable",
                value_name="value") -> "LogicalPlanBuilder":
        vals = _to_exprs(values) if values else []
        if not vals:
            idn = {e.name() for e in _to_exprs(ids)}
            vals = [col(n) for n in self.schema().column_names
                    if n not in idn]
        return self._wrap(lp.Unpivot(self._plan, _to_exprs(ids), vals,
                                     variable_name, value_name))

    def sort(self, sort_by, descending=False, nulls_first=None
             ) -> "LogicalPlanBuilder":
        keys = _to_exprs(sort_by)
        desc = [descending] * len(keys) if isinstance(descending, bool) \
            else list(descending)
        nf = desc if nulls_first is None else (
            [nulls_first] * len(keys) if isinstance(nulls_first, bool)
            else list(nulls_first))
        return self._wrap(lp.Sort(self._plan, keys, desc, nf))

    def aggregate(self, to_agg: Sequence[Expression],
                  group_by: Sequence[Expression]) -> "LogicalPlanBuilder":
        group_by = _to_exprs(group_by)
        schema = self.schema()
        gb_names = {e.name() for e in group_by}
        for e in to_agg:
            if e.name() in gb_names:
                raise ValueError(
                    f"aggregation output {e.name()!r} collides with a "
                    f"group-by key; alias the aggregation to a new name")
        base_aggs, final_exprs = _extract_aggs(list(to_agg), schema)
        node: lp.LogicalPlan = lp.Aggregate(self._plan, base_aggs, group_by)
        if final_exprs is not None:
            gb_cols = [col(e.name()) for e in group_by]
            node = lp.Project(node, gb_cols + final_exprs)
        return self._wrap(node)

    def pivot(self, group_by, pivot_col, value_col, agg_fn: str,
              names: Optional[List[str]] = None) -> "LogicalPlanBuilder":
        """Pre-aggregates to one row per (group, pivot value) with
        ``value_col.<agg_fn>()`` (the port's agg path and strategies), then
        spreads the pivot values into columns; ``names`` None runs the
        distinct pivot values first (reference: ``builder.py:pivot``)."""
        group_by = _to_exprs(group_by)
        pivot_col = _to_exprs([pivot_col])[0]
        value_col = _to_exprs([value_col])[0]
        agg_expr = getattr(value_col, agg_fn)()
        if names is None:
            # through the process's runner, as every query runs
            from ..context import get_runner
            distinct_b = LogicalPlanBuilder(self._plan).select([pivot_col]) \
                .distinct()
            rb = get_runner().run(distinct_b).to_recordbatch()
            names = rb.get_column(rb.column_names()[0]).to_pylist()
        pre = lp.Aggregate(self._plan, [agg_expr], group_by + [pivot_col])
        return self._wrap(lp.Pivot(pre, group_by, pivot_col, value_col,
                                   agg_expr, names))

    def hash_repartition(self, num_partitions: Optional[int],
                         by: Sequence) -> "LogicalPlanBuilder":
        n = num_partitions or self._plan.num_partitions()
        return self._wrap(lp.Repartition(
            self._plan, lp.ClusteringSpec("hash", n, tuple(_to_exprs(by)))))

    def random_shuffle(self, num_partitions: Optional[int]
                       ) -> "LogicalPlanBuilder":
        n = num_partitions or self._plan.num_partitions()
        return self._wrap(lp.Repartition(
            self._plan, lp.ClusteringSpec("random", n)))

    def into_partitions(self, num_partitions: int) -> "LogicalPlanBuilder":
        return self._wrap(lp.Repartition(
            self._plan, lp.ClusteringSpec("unknown", num_partitions)))

    def sample(self, fraction=None, size=None, with_replacement=False,
               seed=None) -> "LogicalPlanBuilder":
        return self._wrap(lp.Sample(self._plan, fraction, size,
                                    with_replacement, seed))

    def distinct(self, on: Optional[Sequence] = None) -> "LogicalPlanBuilder":
        return self._wrap(lp.Distinct(self._plan,
                                      _to_exprs(on) if on else None))

    def window(self, window_exprs, partition_by, order_by=(), descending=(),
               nulls_first=(), frame=None) -> "LogicalPlanBuilder":
        return self._wrap(lp.Window(self._plan, list(window_exprs),
                                    _to_exprs(partition_by),
                                    _to_exprs(order_by), list(descending),
                                    list(nulls_first), frame))

    def join(self, right: "LogicalPlanBuilder", left_on, right_on,
             how: str = "inner", strategy: Optional[str] = None,
             prefix: Optional[str] = None,
             suffix: Optional[str] = None) -> "LogicalPlanBuilder":
        if how == "cross":
            return self._wrap(lp.Join(self._plan, right._plan, [], [],
                                      "cross", strategy, prefix, suffix))
        return self._wrap(lp.Join(self._plan, right._plan,
                                  _to_exprs(left_on), _to_exprs(right_on),
                                  how, strategy, prefix, suffix))

    def concat(self, other: "LogicalPlanBuilder") -> "LogicalPlanBuilder":
        return self._wrap(lp.Concat(self._plan, other._plan))

    def intersect(self, other: "LogicalPlanBuilder",
                  all: bool = False) -> "LogicalPlanBuilder":
        # the rows (distinct unless ``all``), semi-joined on every column,
        # as the reference desugars INTERSECT
        return self._set_join(other, "semi", all)

    def except_(self, other: "LogicalPlanBuilder",
                all: bool = False) -> "LogicalPlanBuilder":
        return self._set_join(other, "anti", all)

    def _set_join(self, other: "LogicalPlanBuilder", how: str,
                  all: bool = False) -> "LogicalPlanBuilder":
        base = self if all else self.distinct()
        return base._wrap(lp.Join(
            base._plan, other._plan,
            [col(n) for n in self.schema().column_names],
            [col(n) for n in other.schema().column_names], how))

    def union(self, other: "LogicalPlanBuilder",
              all: bool = False) -> "LogicalPlanBuilder":
        out = self.concat(other)
        return out if all else out.distinct()

    def add_monotonically_increasing_id(self, column_name=None
                                        ) -> "LogicalPlanBuilder":
        return self._wrap(lp.MonotonicallyIncreasingId(
            self._plan, column_name or "id"))

    # ---- optimize --------------------------------------------------------
    def table_write(self, kind: str, root_dir: str, partition_cols=None,
                    mode: str = "append", options=None
                    ) -> "LogicalPlanBuilder":
        return self._wrap(lp.Sink(self._plan, {
            "kind": kind, "root_dir": root_dir,
            "partition_cols": _to_exprs(partition_cols)
            if partition_cols else None,
            "mode": mode, "options": options or {}}))

    def write_sink(self, sink) -> "LogicalPlanBuilder":
        return self._wrap(lp.Sink(self._plan, {"kind": "sink",
                                               "sink": sink}))

    def optimize(self) -> "LogicalPlanBuilder":
        from .optimizer import Optimizer
        return LogicalPlanBuilder(Optimizer().optimize(self._plan))

    def repr_ascii(self) -> str:
        return self._plan.repr_ascii()


def _extract_aggs(to_agg: List[Expression], schema: Schema
                  ) -> Tuple[List[Expression], Optional[List[Expression]]]:
    """Split possibly-compound agg expressions into base aggregations plus an
    optional final projection (reference: resolve_expr's agg extraction)."""
    base: List[Expression] = []
    base_keys: Dict[Tuple, str] = {}
    needs_project = False

    def extract(e: Expression) -> Expression:
        nonlocal needs_project
        if e.op.startswith("agg."):
            k = e._key()
            if k not in base_keys:
                nm = e.name() if e.name() not in {b.name() for b in base} \
                    else f"__agg{len(base)}__"
                base_keys[k] = nm
                base.append(e.alias(nm) if nm != e.name() else e)
            return col(base_keys[k])
        if e.op == "col":
            raise ValueError(
                f"column {e.params[0]!r} used in aggregation output without "
                f"an aggregation; wrap it in an agg or add it to group_by")
        needs_project = True
        return e.with_children([extract(c) for c in e.args])

    finals: List[Expression] = []
    direct = True
    for e in to_agg:
        inner = e._unalias()
        if inner.op.startswith("agg."):
            base.append(e)
            finals.append(col(e.name()))
            continue
        direct = False
        finals.append(extract(inner).alias(e.name()))
    if direct and not needs_project:
        return base, None
    return base, finals
