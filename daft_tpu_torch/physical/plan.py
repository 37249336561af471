"""Physical plan nodes (reference: ``src/daft-local-plan/src/plan.rs:20``
and ``daft_tpu/physical/plan.py``).

The translator places the reference's exchanges (``Exchange``: hash,
random, range, split, gather) under partitioned joins, two-phase
aggregates, ``Dedup``, windows and repartitions; the executor streams each
through spill stores under the breaker budget (``execution/memory.py``).
``FusedRegion`` is a fusion region (``physical/fusion.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

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
        # estimates the translator sets on a final-mode agg: expected
        # output rows and the group keys' footer NDV (advisory)
        self.group_rows_est: Optional[int] = None
        self.group_ndv: Optional[float] = None


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
        # the final agg's estimates, carried over for the cost model's
        # hash-vs-sort choice and upload gates (None: no evidence)
        self.group_rows_est: Optional[int] = None
        self.group_ndv: Optional[float] = None


class DeviceExchangeAgg(PhysicalPlan):
    """Shuffle and final aggregate as one mesh program (reference
    ``daft_tpu/physical/plan.py:123``): the child's partial group blocks
    are sharded over the device mesh, exchanged by key hash with the
    all_to_all of ``parallel/exchange.py`` and merged
    (``sharded_grouped_agg``). Replaces the host Exchange(hash) and final
    Aggregate pair when every key and partial value has a device plane
    and every final op merges with itself. Yields one partition per mesh
    shard (disjoint key sets); the host pair runs at execution when the
    encoding declines."""

    def __init__(self, child, aggs, group_by, schema):
        super().__init__([child], schema)
        self.aggs = aggs          # final-merge aggs over partial columns
        self.group_by = group_by


class Dedup(PhysicalPlan):
    """Rows unique over ``on``, per partition of its child: the translator
    puts a hash ``Exchange`` on ``on`` under it, so every duplicate meets
    in one partition."""

    def __init__(self, child, on: List[Expression]):
        super().__init__([child], child.schema())
        self.on = on


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
    stream the left), ``broadcast_left`` (the mirror), ``hash``
    (co-partitioned pairs over hash exchanges on both sides, else the
    grace hash join) or ``sort_merge`` (both sides range-bucketed on one
    sampled boundary set, joined pair by pair)."""

    def __init__(self, left, right, left_on, right_on, how, schema,
                 strategy: str = "hash"):
        super().__init__([left, right], schema)
        self.left_on = left_on
        self.right_on = right_on
        self.how = how
        self.strategy = strategy
        # planner byte estimates of the two sides (the grace join's
        # first-level radix fanout, ``out_of_core.plan_partitions``)
        self.left_bytes_est: Optional[int] = None
        self.right_bytes_est: Optional[int] = None


class CrossJoin(PhysicalPlan):
    """Every left row with every right row: the right side is gathered
    once and paired with each morsel of the left."""

    def __init__(self, left, right, schema):
        super().__init__([left, right], schema)


class Concat(PhysicalPlan):
    """Streams the left child, then the right."""

    def __init__(self, left, right):
        super().__init__([left, right], left.schema())


class MonotonicallyIncreasingId(PhysicalPlan):
    def __init__(self, child, column_name: str, schema: Schema):
        super().__init__([child], schema)
        self.column_name = column_name


class Window(PhysicalPlan):
    """Window expressions over partition-clustered input: the child is an
    ``Exchange`` that puts every row of one window partition in one
    MicroPartition (``window_exec.run_window`` per partition)."""

    def __init__(self, child, window_exprs, partition_by, order_by,
                 descending, nulls_first, frame, schema):
        super().__init__([child], schema)
        self.window_exprs = window_exprs
        self.partition_by = partition_by
        self.order_by = order_by
        self.descending = descending
        self.nulls_first = nulls_first
        self.frame = frame


class Exchange(PhysicalPlan):
    """Repartition boundary (reference: ``daft_tpu/physical/plan.py:
    Exchange``, ``ops/shuffle_exchange.rs:41-58``). ``kind``: ``hash``
    (``num_partitions`` partitions by the hash of ``by``), ``random``,
    ``range`` (by ``by`` and ``descending``, on sampled boundaries),
    ``split`` (by position, order kept) or ``gather`` (one partition).
    ``engine_inserted`` marks the planner's own shuffles (agg and distinct
    co-partitioning), which AQE may coalesce; ``join_side`` marks a hash
    join's two sides."""

    def __init__(self, child, kind: str, num_partitions: int,
                 by: Tuple = (), descending: Tuple = (),
                 engine_inserted: bool = False):
        super().__init__([child], child.schema())
        self.kind = kind
        self.num_partitions = num_partitions
        self.by = by
        self.descending = descending
        self.engine_inserted = engine_inserted
        self.join_side = False


class Unpivot(PhysicalPlan):
    def __init__(self, child, ids, values, variable_name, value_name,
                 schema):
        super().__init__([child], schema)
        self.ids = ids
        self.values = values
        self.variable_name = variable_name
        self.value_name = value_name


class Pivot(PhysicalPlan):
    def __init__(self, child, group_by, pivot_col, value_col, names,
                 schema):
        super().__init__([child], schema)
        self.group_by = group_by
        self.pivot_col = pivot_col
        self.value_col = value_col
        self.names = names


class Sample(PhysicalPlan):
    """A ``fraction`` of each morsel's rows (drawn from ``seed``), or each
    morsel's first ``size`` rows."""

    def __init__(self, child, fraction, size, with_replacement, seed):
        super().__init__([child], child.schema())
        self.fraction = fraction
        self.size = size
        self.with_replacement = with_replacement
        self.seed = seed


class StageInput(PhysicalPlan):
    """Leaf standing for another stage's exchanged output (reference:
    flotilla's PreviousStageScan seam). The executor resolves it from the
    stage-input bindings the distributed stage runner gives ``run``
    (``distributed/stages.py`` cuts the plan at every Exchange)."""

    def __init__(self, stage_id: int, schema: Schema):
        super().__init__([], schema)
        self.stage_id = stage_id


class FusedRegion(PhysicalPlan):
    """A maximal device-eligible operator chain run as ONE torch program
    per morsel (``physical/fusion.py``, reference ``daft_tpu/physical/
    plan.py:FusedRegion``). ``shape``:

    - ``chain`` — Filter*/Project* over a source: predicate, projections
      and a compaction in one dispatch, one packed fetch of the survivors;
    - ``topk`` — a chain with a TopN tail: the argsort runs in the program
      and only a static top-k bucket comes back;
    - ``join_agg`` — partial grouped Aggregate ← Project*/Filter* ← inner
      single-key broadcast HashJoin ← chain over the probe source: the
      build side is encoded and key-sorted once, and each probe morsel
      joins, projects and partially aggregates in one dispatch.

    ``fallback`` keeps the unfused subtree: the executor runs it whenever
    the region declines (cost gate, no lowering, encode failure), so
    fusion is an execution strategy, never a change of semantics."""

    def __init__(self, shape: str, source, exprs, predicate, schema,
                 fallback, fused_ops: Tuple[str, ...] = (),
                 sort_by=(), descending=(), nulls_first=(), limit=None,
                 build=None, left_on=(), right_on=(),
                 aggs=(), group_by=(), mode: str = "partial"):
        children = [source] + ([build] if build is not None else [])
        super().__init__(children, schema)
        self.shape = shape            # chain | topk | join_agg
        self.source = source          # probe-side ScanSource/InMemorySource
        self.exprs = exprs            # outputs, substituted over source cols
        self.predicate = predicate    # combined row-local conjuncts (or None)
        self.fallback = fallback      # original unfused subtree root
        self.fused_ops = fused_ops    # operator names folded into the region
        # topk tail
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first
        self.limit = limit
        # join_agg spine
        self.build = build            # broadcast build-side subplan
        self.left_on = left_on        # probe-side join keys
        self.right_on = right_on      # build-side join keys
        self.aggs = aggs              # partial aggs over joined columns
        self.group_by = group_by      # group keys over joined columns
        self.mode = mode
        #: the join_agg's post-join conjuncts over the joined columns
        self.post_predicate = None
        # estimates carried over from the folded Aggregate
        self.group_rows_est: Optional[int] = None
        self.group_ndv: Optional[float] = None


class Write(PhysicalPlan):
    """A write of its child's rows (``lp.Sink``'s info); one partition of
    the written paths (or of the sink's results) out."""

    def __init__(self, child, info: dict, schema: Schema):
        super().__init__([child], schema)
        self.info = info
