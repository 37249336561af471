"""Physical plan nodes (reference: ``src/daft-local-plan/src/plan.rs:20``).

The port is single-node: there are no exchange nodes, and a final-mode
Aggregate, Sort or TopN consumes its whole input stream, as a HashJoin
consumes whole each side it gathers."""

from __future__ import annotations

from typing import Any, List

from ..expressions import Expression
from ..schema import Schema


class PhysicalPlan:
    def __init__(self, children: List["PhysicalPlan"], schema: Schema):
        self.children = children
        self._schema = schema

    def schema(self) -> Schema:
        return self._schema

    def name(self) -> str:
        return type(self).__name__


class ScanSource(PhysicalPlan):
    def __init__(self, tasks: List[Any], schema: Schema):
        super().__init__([], schema)
        self.tasks = tasks


class InMemorySource(PhysicalPlan):
    def __init__(self, partitions: List[Any], schema: Schema):
        super().__init__([], schema)
        self.partitions = partitions


class Project(PhysicalPlan):
    def __init__(self, child, exprs: List[Expression], schema: Schema):
        super().__init__([child], schema)
        self.exprs = exprs


class Filter(PhysicalPlan):
    def __init__(self, child, predicate: Expression):
        super().__init__([child], child.schema())
        self.predicate = predicate


class Limit(PhysicalPlan):
    def __init__(self, child, limit: int, offset: int = 0):
        super().__init__([child], child.schema())
        self.limit = limit
        self.offset = offset


class Aggregate(PhysicalPlan):
    """One aggregation stage. mode: single | partial | final."""

    def __init__(self, child, aggs, group_by, schema, mode: str = "single"):
        super().__init__([child], schema)
        self.aggs = aggs
        self.group_by = group_by
        self.mode = mode


class DeviceFragmentAgg(PhysicalPlan):
    """Fused scan→filter→project→partial-agg fragment: one torch program per
    morsel (see device/fragment.py). A morsel whose expressions do not
    compile for the device runs the equivalent host chain."""

    def __init__(self, source, predicate, aggs, group_by, schema, mode):
        super().__init__([source], schema)
        self.predicate = predicate
        self.aggs = aggs          # substituted over source columns
        self.group_by = group_by  # substituted over source columns
        self.mode = mode


class Sort(PhysicalPlan):
    def __init__(self, child, sort_by, descending, nulls_first):
        super().__init__([child], child.schema())
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first


class TopN(PhysicalPlan):
    def __init__(self, child, sort_by, descending, nulls_first, limit):
        super().__init__([child], child.schema())
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first
        self.limit = limit


class HashJoin(PhysicalPlan):
    """Equi-join. strategy: ``broadcast_right`` (gather the right side,
    stream the left), ``broadcast_left`` (the mirror), or ``hash`` (gather
    both sides, one join)."""

    def __init__(self, left, right, left_on, right_on, how, schema,
                 strategy: str = "hash"):
        super().__init__([left, right], schema)
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.strategy = strategy
