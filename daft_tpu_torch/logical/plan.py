"""Logical plan nodes.

Reference: ``src/daft-logical-plan/src/logical_plan.rs:25`` — the LogicalPlan
enum — and ``partitioning.rs`` (ClusteringSpec). The port carries the nodes
of the grouped-aggregation, join, TPC-H, SQL and TPC-DS slices: Source/
Project/Filter/Limit/Sort/TopN/Repartition/Distinct/Aggregate/Join (equi
and cross)/Window/Concat/Sample/MonotonicallyIncreasingId/Pivot/Unpivot/
Explode/Sink.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..expressions import Expression
from ..schema import Field, Schema


@dataclasses.dataclass(frozen=True)
class ClusteringSpec:
    """How rows are distributed across partitions."""

    kind: str = "unknown"            # hash | range | random | unknown
    num_partitions: int = 1
    by: Tuple[Expression, ...] = ()
    descending: Tuple[bool, ...] = ()

    def normalized(self) -> "ClusteringSpec":
        return self


class LogicalPlan:
    """Base node; immutable tree."""

    def __init__(self, children: List["LogicalPlan"]):
        self._children = children
        self._schema: Optional[Schema] = None

    @property
    def children(self) -> List["LogicalPlan"]:
        return self._children

    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = self._compute_schema()
        return self._schema

    def _compute_schema(self) -> Schema:
        raise NotImplementedError

    def with_children(self, children: List["LogicalPlan"]) -> "LogicalPlan":
        raise NotImplementedError

    def clustering_spec(self) -> ClusteringSpec:
        if self._children:
            return self._children[0].clustering_spec()
        return ClusteringSpec()

    def num_partitions(self) -> int:
        return self.clustering_spec().num_partitions

    def name(self) -> str:
        return type(self).__name__

    def multiline_display(self) -> List[str]:
        return [self.name()]

    # generic tree utilities -------------------------------------------
    def transform_up(self, fn) -> "LogicalPlan":
        new_children = [c.transform_up(fn) for c in self._children]
        node = self if new_children == self._children \
            else self.with_children(new_children)
        return fn(node)

    def transform_down(self, fn) -> "LogicalPlan":
        node = fn(self)
        new_children = [c.transform_down(fn) for c in node.children]
        return node if new_children == node.children \
            else node.with_children(new_children)

    def semantic_id(self) -> Tuple:
        return (self.name(),
                tuple(repr(x) for x in self._params()),
                tuple(c.semantic_id() for c in self._children))

    def _params(self) -> Tuple:
        return ()

    def content_id(self) -> Tuple:
        """``semantic_id`` with each file scan named by its files, not by
        its operator object: equal for two DataFrames built the same way
        over the same files (a query's identity across its runs)."""
        return (self.name(),
                tuple(repr(x) for x in self._content_params()),
                tuple(c.content_id() for c in self._children))

    def _content_params(self) -> Tuple:
        return self._params()

    def repr_ascii(self, depth: int = 0) -> str:
        pad = "  " * depth
        lines = [pad + ("* " if depth == 0 else "|- ") +
                 "\n  ".join(self.multiline_display())]
        for c in self._children:
            lines.append(c.repr_ascii(depth + 1))
        return "\n".join(lines)


class Source(LogicalPlan):
    def __init__(self, scan_op=None, partitions=None, schema: Schema = None,
                 pushdowns=None, num_partitions: int = 1):
        super().__init__([])
        from ..io.scan import Pushdowns
        self.scan_op = scan_op
        self.partitions = partitions   # list[MicroPartition] for in-memory
        self._source_schema = schema
        self.pushdowns = pushdowns or Pushdowns()
        self._num_partitions = num_partitions

    def _compute_schema(self) -> Schema:
        base = self._source_schema
        if self.pushdowns.columns is not None:
            return base.project([c for c in self.pushdowns.columns if c in base])
        return base

    def with_children(self, children):
        assert not children
        return self

    def with_pushdowns(self, pushdowns) -> "Source":
        return Source(self.scan_op, self.partitions, self._source_schema,
                      pushdowns, self._num_partitions)

    def clustering_spec(self) -> ClusteringSpec:
        if self.partitions is not None:
            return ClusteringSpec("unknown", max(len(self.partitions), 1))
        if self.scan_op is not None:
            # partition count = materialized scan-task count, sharing the
            # same cache execution/translate use so footers are read once
            tasks = getattr(self, "materialized_tasks", None)
            if tasks is None:
                try:
                    tasks = self.scan_op.to_scan_tasks(self.pushdowns)
                    self.materialized_tasks = tasks
                except Exception:
                    return ClusteringSpec("unknown", self._num_partitions)
            return ClusteringSpec("unknown", max(len(tasks), 1))
        return ClusteringSpec("unknown", self._num_partitions)

    def _params(self):
        return (id(self.scan_op) if self.scan_op else id(self.partitions),
                self.pushdowns)

    def _content_params(self):
        paths = getattr(self.scan_op, "_paths", None)
        if not paths:
            return self._params()
        return (type(self.scan_op).__name__, tuple(paths),
                tuple(self.scan_op.multiline_display()), self.pushdowns)

    def multiline_display(self):
        src = "InMemory" if self.partitions is not None else \
            type(self.scan_op).__name__
        out = [f"Source [{src}]", f"schema = {self.schema().column_names}"]
        if self.pushdowns.filters is not None:
            out.append(f"filter pushdown = {self.pushdowns.filters!r}")
        if self.pushdowns.limit is not None:
            out.append(f"limit pushdown = {self.pushdowns.limit}")
        return out


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: List[Expression]):
        super().__init__([child])
        self.exprs = list(exprs)

    def _compute_schema(self) -> Schema:
        s = self._children[0].schema()
        return Schema([e.to_field(s) for e in self.exprs])

    def with_children(self, children):
        return Project(children[0], self.exprs)

    def _params(self):
        return tuple(e._key() for e in self.exprs)

    def multiline_display(self):
        return [f"Project: {', '.join(repr(e) for e in self.exprs[:6])}"
                + ("…" if len(self.exprs) > 6 else "")]


class UDFProject(LogicalPlan):
    """Projection containing a stateful/actor UDF, isolated so the executor
    can give it its own worker pool (reference: ActorPoolProject)."""

    def __init__(self, child: LogicalPlan, exprs: List[Expression],
                 concurrency: Optional[int] = None):
        super().__init__([child])
        self.exprs = list(exprs)
        self.concurrency = concurrency

    def _compute_schema(self) -> Schema:
        s = self._children[0].schema()
        return Schema([e.to_field(s) for e in self.exprs])

    def with_children(self, children):
        return UDFProject(children[0], self.exprs, self.concurrency)

    def _params(self):
        return tuple(e._key() for e in self.exprs)


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, predicate: Expression):
        super().__init__([child])
        self.predicate = predicate

    def _compute_schema(self) -> Schema:
        return self._children[0].schema()

    def with_children(self, children):
        return Filter(children[0], self.predicate)

    def _params(self):
        return (self.predicate._key(),)

    def multiline_display(self):
        return [f"Filter: {self.predicate!r}"]


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, limit: int, offset: int = 0):
        super().__init__([child])
        self.limit = limit
        self.offset = offset

    def _compute_schema(self) -> Schema:
        return self._children[0].schema()

    def with_children(self, children):
        return Limit(children[0], self.limit, self.offset)

    def _params(self):
        return (self.limit, self.offset)

    def multiline_display(self):
        return [f"Limit: {self.limit}"]


class Explode(LogicalPlan):
    """One row per element of each ``.explode()`` list expression; the
    other columns repeat (reference: ``daft_tpu/logical/plan.py:Explode``)."""

    def __init__(self, child: LogicalPlan, exprs: List[Expression]):
        super().__init__([child])
        self.exprs = list(exprs)

    def _compute_schema(self) -> Schema:
        s = self._children[0].schema()
        out = []
        explode_names = {e.name(): e for e in self.exprs}
        for f in s:
            if f.name in explode_names:
                out.append(explode_names[f.name].to_field(s))
            else:
                out.append(f)
        for e in self.exprs:
            if e.name() not in s:
                out.append(e.to_field(s))
        return Schema(out)

    def with_children(self, children):
        return Explode(children[0], self.exprs)

    def _params(self):
        return tuple(e._key() for e in self.exprs)


class Unpivot(LogicalPlan):
    """Wide to long: per input row, one row per value column holding the
    ids, the column's name (``variable_name``) and its value
    (``value_name``, the values' supertype)."""

    def __init__(self, child, ids, values, variable_name, value_name):
        super().__init__([child])
        self.ids = list(ids)
        self.values = list(values)
        self.variable_name = variable_name
        self.value_name = value_name

    def _compute_schema(self) -> Schema:
        from ..datatype import DataType
        from ..expressions.typing import supertype
        s = self._children[0].schema()
        fields = [e.to_field(s) for e in self.ids]
        vdt = None
        for e in self.values:
            d = e.to_field(s).dtype
            vdt = d if vdt is None else supertype(vdt, d)
        fields.append(Field(self.variable_name, DataType.string()))
        fields.append(Field(self.value_name, vdt))
        return Schema(fields)

    def with_children(self, children):
        return Unpivot(children[0], self.ids, self.values,
                       self.variable_name, self.value_name)

    def _params(self):
        return (tuple(e._key() for e in self.ids),
                tuple(e._key() for e in self.values),
                self.variable_name, self.value_name)


class Sort(LogicalPlan):
    def __init__(self, child, sort_by, descending, nulls_first):
        super().__init__([child])
        self.sort_by = list(sort_by)
        self.descending = list(descending)
        self.nulls_first = list(nulls_first)

    def _compute_schema(self) -> Schema:
        return self._children[0].schema()

    def with_children(self, children):
        return Sort(children[0], self.sort_by, self.descending, self.nulls_first)

    def clustering_spec(self) -> ClusteringSpec:
        return ClusteringSpec("range", self._children[0].num_partitions(),
                              tuple(self.sort_by), tuple(self.descending))

    def _params(self):
        return (tuple(e._key() for e in self.sort_by),
                tuple(self.descending), tuple(self.nulls_first))

    def multiline_display(self):
        return [f"Sort: {', '.join(repr(e) for e in self.sort_by)}"]


class TopN(LogicalPlan):
    def __init__(self, child, sort_by, descending, nulls_first, limit: int):
        super().__init__([child])
        self.sort_by = list(sort_by)
        self.descending = list(descending)
        self.nulls_first = list(nulls_first)
        self.limit = limit

    def _compute_schema(self) -> Schema:
        return self._children[0].schema()

    def with_children(self, children):
        return TopN(children[0], self.sort_by, self.descending,
                    self.nulls_first, self.limit)

    def _params(self):
        return (tuple(e._key() for e in self.sort_by), tuple(self.descending),
                tuple(self.nulls_first), self.limit)


class Repartition(LogicalPlan):
    """Rows redistributed per ``spec``: ``hash`` by ``spec.by``,
    ``random``, ``range``, or ``unknown`` (``into_partitions``: split by
    position, order kept)."""

    def __init__(self, child, spec: ClusteringSpec):
        super().__init__([child])
        self.spec = spec

    def _compute_schema(self) -> Schema:
        return self._children[0].schema()

    def with_children(self, children):
        return Repartition(children[0], self.spec)

    def clustering_spec(self) -> ClusteringSpec:
        return self.spec

    def _params(self):
        return (self.spec.kind, self.spec.num_partitions,
                tuple(e._key() for e in self.spec.by))

    def multiline_display(self):
        return [f"Repartition[{self.spec.kind}] n={self.spec.num_partitions}"]


class Sample(LogicalPlan):
    """A ``fraction`` of each partition's rows (or its first ``size``),
    drawn from ``seed``."""

    def __init__(self, child, fraction: Optional[float], size: Optional[int],
                 with_replacement: bool, seed: Optional[int]):
        super().__init__([child])
        self.fraction = fraction
        self.size = size
        self.with_replacement = with_replacement
        self.seed = seed

    def _compute_schema(self) -> Schema:
        return self._children[0].schema()

    def with_children(self, children):
        return Sample(children[0], self.fraction, self.size,
                      self.with_replacement, self.seed)

    def _params(self):
        return (self.fraction, self.size, self.with_replacement, self.seed)


class Distinct(LogicalPlan):
    """Rows unique over ``on`` (every column when None), each the first
    of its duplicates."""

    def __init__(self, child, on: Optional[List[Expression]] = None):
        super().__init__([child])
        self.on = on

    def _compute_schema(self) -> Schema:
        return self._children[0].schema()

    def with_children(self, children):
        return Distinct(children[0], self.on)

    def _params(self):
        return tuple(e._key() for e in (self.on or []))


class Aggregate(LogicalPlan):
    def __init__(self, child, aggs: List[Expression],
                 group_by: List[Expression]):
        super().__init__([child])
        self.aggs = list(aggs)
        self.group_by = list(group_by)

    def _compute_schema(self) -> Schema:
        s = self._children[0].schema()
        fields = [e.to_field(s) for e in self.group_by]
        fields += [e.to_field(s) for e in self.aggs]
        return Schema(fields)

    def with_children(self, children):
        return Aggregate(children[0], self.aggs, self.group_by)

    def _params(self):
        return (tuple(e._key() for e in self.aggs),
                tuple(e._key() for e in self.group_by))

    def multiline_display(self):
        return [f"Aggregate: {', '.join(repr(a) for a in self.aggs[:4])}",
                f"group_by = {[repr(g) for g in self.group_by]}"]


class Pivot(LogicalPlan):
    """Long to wide over a child pre-aggregated to one row per (group,
    pivot value): one row per group, one column per name in ``names``."""

    def __init__(self, child, group_by, pivot_col, value_col, agg_expr,
                 names):
        super().__init__([child])
        self.group_by = list(group_by)
        self.pivot_col = pivot_col
        self.value_col = value_col
        self.agg_expr = agg_expr
        self.names = list(names)

    def _compute_schema(self) -> Schema:
        s = self._children[0].schema()
        fields = [e.to_field(s) for e in self.group_by]
        vdt = self.value_col.to_field(s).dtype
        for n in self.names:
            fields.append(Field(str(n), vdt))
        return Schema(fields)

    def with_children(self, children):
        return Pivot(children[0], self.group_by, self.pivot_col,
                     self.value_col, self.agg_expr, self.names)

    def _params(self):
        return (tuple(e._key() for e in self.group_by),
                self.pivot_col._key(), self.value_col._key(),
                tuple(self.names))


class Join(LogicalPlan):
    """Equi-join, ``how`` ∈ inner/left/right/outer/semi/anti, or a
    ``cross`` join (no keys). Semi and anti keep the left schema; otherwise the left columns, then the right ones,
    where a right key named like its left key is dropped and any other
    right name that collides with a left name takes the prefix (default
    ``right.``) and suffix."""

    def __init__(self, left, right, left_on, right_on, how: str = "inner",
                 strategy: Optional[str] = None, prefix: Optional[str] = None,
                 suffix: Optional[str] = None):
        super().__init__([left, right])
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.how = how
        self.strategy = strategy
        self.prefix = prefix
        self.suffix = suffix

    def _compute_schema(self) -> Schema:
        l, r = self._children[0].schema(), self._children[1].schema()
        if self.how in ("semi", "anti"):
            return l
        fields = list(l.fields)
        lnames = set(l.column_names)
        rkey_names = [e.name() for e in self.right_on]
        lkey_names = [e.name() for e in self.left_on]
        for f in r.fields:
            if f.name in rkey_names:
                ki = rkey_names.index(f.name)
                if ki < len(lkey_names) and lkey_names[ki] == f.name:
                    continue
            nm = f.name
            if nm in lnames:
                nm = (self.prefix or "right.") + nm + (self.suffix or "")
            fields.append(Field(nm, f.dtype))
        return Schema(fields)

    def with_children(self, children):
        return Join(children[0], children[1], self.left_on, self.right_on,
                    self.how, self.strategy, self.prefix, self.suffix)

    def _params(self):
        return (tuple(e._key() for e in self.left_on),
                tuple(e._key() for e in self.right_on), self.how,
                self.strategy)

    def multiline_display(self):
        return [f"Join[{self.how}] on "
                f"{[repr(e) for e in self.left_on]} = "
                f"{[repr(e) for e in self.right_on]}"]


class Window(LogicalPlan):
    """Window expressions of one spec appended to the child's columns
    (reference: ``daft_tpu/logical/plan.py:Window``); row-preserving."""

    def __init__(self, child, window_exprs: List[Expression],
                 partition_by, order_by, descending, nulls_first, frame=None):
        super().__init__([child])
        self.window_exprs = list(window_exprs)
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.descending = list(descending)
        self.nulls_first = list(nulls_first)
        self.frame = frame

    def _compute_schema(self) -> Schema:
        from ..window_exec import window_field
        s = self._children[0].schema()
        fields = list(s.fields)
        for e in self.window_exprs:
            fields.append(window_field(e, s))
        return Schema(fields)

    def with_children(self, children):
        return Window(children[0], self.window_exprs, self.partition_by,
                      self.order_by, self.descending, self.nulls_first,
                      self.frame)

    def _params(self):
        return (tuple(e._key() for e in self.window_exprs),
                tuple(e._key() for e in self.partition_by),
                tuple(e._key() for e in self.order_by),
                tuple(self.descending), tuple(self.nulls_first),
                repr(self.frame))


class Concat(LogicalPlan):
    """The left child's rows, then the right child's (same column names)."""

    def __init__(self, left, right):
        super().__init__([left, right])

    def _compute_schema(self) -> Schema:
        l, r = self._children[0].schema(), self._children[1].schema()
        if l.column_names != r.column_names:
            raise ValueError(
                f"concat requires matching schemas: {l.column_names} vs "
                f"{r.column_names}")
        return l

    def with_children(self, children):
        return Concat(children[0], children[1])

    def clustering_spec(self) -> ClusteringSpec:
        return ClusteringSpec(
            "unknown", self._children[0].num_partitions()
            + self._children[1].num_partitions())


class MonotonicallyIncreasingId(LogicalPlan):
    """Prepends a uint64 id column: partition index in the upper 28 bits,
    row index within the partition in the lower 36."""

    def __init__(self, child, column_name: str):
        super().__init__([child])
        self.column_name = column_name

    def _compute_schema(self) -> Schema:
        from ..datatype import DataType
        s = self._children[0].schema()
        return Schema([Field(self.column_name, DataType.uint64())] + s.fields)

    def with_children(self, children):
        return MonotonicallyIncreasingId(children[0], self.column_name)

    def _params(self):
        return (self.column_name,)


class Sink(LogicalPlan):
    """Write sink (reference ``logical/plan.py:556``). info = dict(kind =
    parquet/csv/json/sink, root_dir, partition_cols, mode, options,
    sink)."""

    def __init__(self, child, info: dict):
        super().__init__([child])
        self.info = info

    def _compute_schema(self) -> Schema:
        from ..datatype import DataType
        if self.info.get("kind") == "sink":
            return self.info["sink"].schema()
        fields = [Field("path", DataType.string())]
        for e in self.info.get("partition_cols") or []:
            fields.append(e.to_field(self._children[0].schema()))
        return Schema(fields)

    def with_children(self, children):
        return Sink(children[0], self.info)

    def _params(self):
        return (self.info.get("kind"), self.info.get("root_dir"))
