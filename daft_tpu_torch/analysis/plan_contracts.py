"""The port's declarative plan-node and optimizer-rule contract registry.

The port's copy of ``daft_tpu/analysis/plan_contracts.py``, declared
against the port's own plan modules. Every ``LogicalPlan`` /
``PhysicalPlan`` node type of ``daft_tpu_torch/logical/plan.py`` and
``daft_tpu_torch/physical/plan.py`` is declared here once, with what the
rest of the engine may rely on:

- **schema derivation** — ``leaf`` (fixed at construction from the
  source), ``computed`` (an explicit ``Schema`` passed to the constructor)
  or ``child`` (inherited verbatim from the first child);
- **partitioning / ordering derivation** — prose contracts that the
  runtime plan sanitizer (``analysis/plan_sanitizer.py``) spot-checks:
  ``membership_check`` nodes get sampled hash-membership re-verification,
  ``order_check`` nodes get output sort-order verification,
  ``row_conservation`` nodes get row-count conservation accounting;
- **field inventory** — ``semantic_fields`` (what the node means),
  ``estimate_fields`` (advisory, rewritable from measurements) and
  ``late_fields`` (attached after construction). ``analysis/rule_plans.py``
  proves the inventory against the constructors in both directions.

``RULE_CONTRACTS`` registers every ``Rule`` subclass of
``daft_tpu_torch/logical/optimizer.py`` as schema-preserving or not; the
sanitizer asserts root-schema equality after each application of a
preserving one.

``REPLAN_MUTABLE`` is the closed set of (class, field) pairs the adaptive
layers (``physical/adaptive.py`` and the distributed re-planner,
``distributed/replan.py``, with its ``Boundary`` / ``BoundaryActuals``
entries) may mutate in place on a built plan.

Nodes of the reference the port does not have (``Explode``,
``UDFProject``) are not declared; a node the port adds fails the lint
run until it is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# --------------------------------------------------------------- contracts


@dataclasses.dataclass(frozen=True)
class NodeContract:
    name: str
    layer: str                     # "logical" | "physical"
    schema: str                    # "leaf" | "computed" | "child"
    partitioning: str              # derivation of the output partitioning
    ordering: str                  # derivation of the output sort order
    rewrite_safety: str            # "frozen" | "estimate" | "strategy"
    semantic_fields: Tuple[str, ...]
    estimate_fields: Tuple[str, ...] = ()
    late_fields: Tuple[str, ...] = ()
    row_conservation: bool = False
    membership_check: bool = False
    order_check: bool = False


@dataclasses.dataclass(frozen=True)
class RuleContract:
    name: str
    schema_preserving: bool
    note: str


@dataclasses.dataclass(frozen=True)
class MutableField:
    cls: str
    field: str
    reason: str


def _n(name, layer, schema, partitioning, ordering, rewrite_safety,
       semantic_fields, **kw) -> NodeContract:
    return NodeContract(name, layer, schema, partitioning, ordering,
                        rewrite_safety, tuple(semantic_fields), **kw)


# ------------------------------------------------------- logical registry
# ``semantic_fields`` lists the public constructor self-assignments
# (underscore-prefixed attributes are internal caches owned by the class).

LOGICAL_NODES: Dict[str, NodeContract] = {c.name: c for c in [
    _n("Source", "logical", "leaf",
       "scan-task count (scan) / partition-list length (in-memory)",
       "none", "frozen",
       ("scan_op", "partitions", "pushdowns"),
       late_fields=("materialized_tasks",)),
    _n("Project", "logical", "computed", "inherits child", "preserves",
       "frozen", ("exprs",), row_conservation=True),
    _n("Filter", "logical", "child", "inherits child (subset per part)",
       "preserves", "frozen", ("predicate",)),
    _n("Limit", "logical", "child", "inherits child (prefix truncation)",
       "preserves", "frozen", ("limit", "offset")),
    _n("Unpivot", "logical", "computed", "inherits child (rows multiply "
       "in place)", "preserves row groups", "frozen",
       ("ids", "values", "variable_name", "value_name")),
    _n("Sort", "logical", "child", "range(sort_by) over child partition "
       "count", "establishes sort_by", "frozen",
       ("sort_by", "descending", "nulls_first"), row_conservation=True),
    _n("TopN", "logical", "child", "single partition", "establishes "
       "sort_by", "frozen", ("sort_by", "descending", "nulls_first",
                             "limit")),
    _n("Repartition", "logical", "child", "explicit spec", "destroys",
       "frozen", ("spec",), row_conservation=True),
    _n("Distinct", "logical", "child", "inherits child", "destroys",
       "frozen", ("on",)),
    _n("Aggregate", "logical", "computed", "hash(group_by) after engine "
       "exchange; single partition when ungrouped", "destroys", "frozen",
       ("aggs", "group_by")),
    _n("Pivot", "logical", "computed", "hash(group_by) after engine "
       "exchange", "destroys", "frozen",
       ("group_by", "pivot_col", "value_col", "agg_expr", "names")),
    _n("Window", "logical", "computed", "hash(partition_by) after engine "
       "exchange", "preserves within partitions", "frozen",
       ("window_exprs", "partition_by", "order_by", "descending",
        "nulls_first", "frame"), row_conservation=True),
    _n("Concat", "logical", "child", "sum of both children's partitions",
       "destroys", "frozen", (), row_conservation=True),
    _n("Join", "logical", "computed", "hash(left_on/right_on) after "
       "engine exchange, or broadcast keeps probe-side partitioning",
       "destroys", "frozen",
       ("left_on", "right_on", "how", "strategy", "prefix", "suffix")),
    _n("Sample", "logical", "child", "inherits child (subset per part)",
       "preserves", "frozen",
       ("fraction", "size", "with_replacement", "seed")),
    _n("MonotonicallyIncreasingId", "logical", "computed",
       "inherits child", "preserves", "frozen", ("column_name",),
       row_conservation=True),
    _n("Sink", "logical", "computed", "single partition (manifest)",
       "none", "frozen", ("info",)),
]}


# ------------------------------------------------------ physical registry

PHYSICAL_NODES: Dict[str, NodeContract] = {c.name: c for c in [
    _n("ScanSource", "physical", "computed", "one partition per scan task",
       "none", "frozen", ("tasks",)),
    _n("InMemorySource", "physical", "computed", "one partition per "
       "in-memory micropartition", "none", "frozen", ("partitions",)),
    _n("Project", "physical", "computed", "inherits child", "preserves",
       "frozen", ("exprs",), row_conservation=True),
    _n("Filter", "physical", "child", "inherits child (subset per part)",
       "preserves", "frozen", ("predicate",)),
    _n("Limit", "physical", "child", "inherits child (prefix "
       "truncation)", "preserves", "frozen", ("limit", "offset")),
    _n("Unpivot", "physical", "computed", "inherits child (rows multiply "
       "in place)", "preserves row groups", "frozen",
       ("ids", "values", "variable_name", "value_name")),
    _n("Sample", "physical", "child", "inherits child (subset per part)",
       "preserves", "frozen",
       ("fraction", "size", "with_replacement", "seed")),
    _n("MonotonicallyIncreasingId", "physical", "computed",
       "inherits child", "preserves", "frozen", ("column_name",),
       row_conservation=True),
    _n("Aggregate", "physical", "computed", "partial: inherits child; "
       "final/single: grouped output per input partition (exchange "
       "upstream provides co-partitioning)", "destroys", "estimate",
       ("aggs", "group_by", "mode"),
       estimate_fields=("group_rows_est", "group_ndv"),
       late_fields=("group_ndv_footer",)),
    _n("DeviceFragmentAgg", "physical", "computed", "inherits source",
       "destroys", "estimate", ("predicate", "aggs", "group_by", "mode"),
       estimate_fields=("group_rows_est", "group_ndv")),
    _n("DeviceExchangeAgg", "physical", "computed", "hash(group_by) over "
       "mesh shards (disjoint key sets, one partition per shard)",
       "destroys", "frozen", ("aggs", "group_by")),
    _n("FusedRegion", "physical", "computed", "inherits source (chain/"
       "topk single output for topk)", "topk establishes sort_by; else "
       "preserves", "estimate",
       ("shape", "source", "exprs", "predicate", "post_predicate",
        "fallback", "fused_ops",
        "sort_by", "descending", "nulls_first", "limit", "build",
        "left_on", "right_on", "aggs", "group_by", "mode"),
       estimate_fields=("group_rows_est", "group_ndv")),
    _n("Dedup", "physical", "child", "inherits child", "destroys",
       "frozen", ("on",)),
    _n("Pivot", "physical", "computed", "inherits child", "destroys",
       "frozen", ("group_by", "pivot_col", "value_col", "names")),
    _n("Window", "physical", "computed", "inherits child (exchange "
       "upstream provides hash(partition_by))", "preserves within "
       "partitions", "frozen",
       ("window_exprs", "partition_by", "order_by", "descending",
        "nulls_first", "frame"), row_conservation=True),
    _n("Sort", "physical", "child", "range(sort_by) buckets in range "
       "order, or one fully-sorted partition", "establishes sort_by",
       "frozen", ("sort_by", "descending", "nulls_first"),
       row_conservation=True, order_check=True),
    _n("TopN", "physical", "child", "single partition",
       "establishes sort_by", "frozen",
       ("sort_by", "descending", "nulls_first", "limit"),
       order_check=True),
    _n("Exchange", "physical", "child", "kind(by): hash membership h(k) "
       "% n, range boundaries, round-robin split, or gather to 1",
       "destroys (hash/random/split) / range order across buckets",
       "strategy",
       ("kind", "num_partitions", "by", "descending", "engine_inserted"),
       estimate_fields=("join_side",),
       row_conservation=True, membership_check=True),
    _n("StageInput", "physical", "computed", "upstream stage's exchanged "
       "output partitioning", "none", "frozen", ("stage_id",)),
    _n("Concat", "physical", "child", "left partitions then right "
       "partitions", "destroys", "frozen", (), row_conservation=True),
    _n("HashJoin", "physical", "computed", "hash: co-partitioned inputs "
       "give hash(keys) output; broadcast: inherits probe side",
       "destroys", "estimate",
       ("left_on", "right_on", "how", "strategy"),
       estimate_fields=("left_bytes_est", "right_bytes_est")),
    _n("CrossJoin", "physical", "computed", "inherits left", "destroys",
       "frozen", ()),
    _n("Write", "physical", "computed", "single partition (manifest)",
       "none", "frozen", ("info",)),
]}

# Attributes the physical translator may attach to ANY physical node
# after construction (planner annotations shared across node types).
PHYSICAL_SHARED_LATE_FIELDS: Tuple[str, ...] = ("shared_consumers",)


# --------------------------------------------------------- rule registry
# Every ``Rule`` subclass in ``daft_tpu_torch/logical/optimizer.py``. ``schema_preserving``
# means the ROOT schema (names + dtypes, in order) is identical before and
# after ``apply`` — internal nodes may change freely. The runtime sanitizer
# asserts this per rule application.

RULE_CONTRACTS: Dict[str, RuleContract] = {c.name: c for c in [
    RuleContract("SimplifyExpressions", True,
                 "rewrites expressions to equivalent simpler forms"),
    RuleContract("PushDownFilter", True,
                 "moves Filter below row-local ops; predicates unchanged"),
    RuleContract("PushDownProjection", True,
                 "prunes unused columns below the root projection"),
    RuleContract("PushDownLimit", True,
                 "pushes Limit into sources; fuses Sort+Limit into TopN"),
    RuleContract("DropRepartition", True,
                 "removes redundant repartitions of identical specs"),
    RuleContract("MaterializeScans", True,
                 "binds scan pushdowns; column pruning already applied"),
    RuleContract("EliminateCrossJoin", True,
                 "converts cross join + equi-filter into an equi-join"),
    RuleContract("ReorderJoins", True,
                 "re-orders the join tree; wraps in a Project restoring "
                 "the original column order"),
    RuleContract("SimplifyNullFilteredJoin", True,
                 "strengthens outer joins under null-rejecting filters"),
    RuleContract("PushDownAntiSemiJoin", True,
                 "pushes semi/anti joins below row-local left-side ops"),
    RuleContract("FilterNullJoinKey", True,
                 "adds not-null key filters on non-preserved join sides"),
    RuleContract("SemiJoinReduction", True,
                 "inserts internal __sjr*__ semi-join reducers; output "
                 "columns unchanged"),
    RuleContract("PushDownJoinPredicate", True,
                 "clones literal key predicates across equi-joins"),
]}


# ------------------------------------------------- replan mutability set
# The ONLY in-place attribute mutations the adaptive layer may perform on
# already-built plan objects. Everything
# here is advisory (estimates) or a declared execution-strategy swap;
# none of it changes keys, join types, schemas, or expressions.

REPLAN_MUTABLE: Tuple[MutableField, ...] = (
    MutableField("Aggregate", "group_rows_est",
                 "measured output rows replace the planner's estimate"),
    MutableField("Aggregate", "group_ndv",
                 "measured key NDV replaces the footer-derived estimate"),
    MutableField("Aggregate", "group_ndv_footer",
                 "stash-once of the original footer NDV for explain"),
    MutableField("HashJoin", "left_bytes_est",
                 "measured build/probe bytes re-pick broadcast vs hash"),
    MutableField("HashJoin", "right_bytes_est",
                 "measured build/probe bytes re-pick broadcast vs hash"),
    MutableField("Boundary", "kind",
                 "broadcast demotion swaps hash shuffle for gather; "
                 "execution strategy only, downstream join is re-keyed "
                 "to match"),
    MutableField("Boundary", "num_partitions",
                 "partition count is execution strategy, not semantics"),
    MutableField("BoundaryActuals", "ndv",
                 "measured key NDV recorded as evidence"),
    MutableField("BoundaryActuals", "exact_ndv",
                 "marks the NDV evidence as exact, not estimated"),
)

REPLAN_MUTABLE_FIELDS = frozenset(m.field for m in REPLAN_MUTABLE)


def registered_estimate_fields() -> frozenset:
    """All estimate/late fields declared across the physical registry."""
    out = set()
    for c in PHYSICAL_NODES.values():
        out.update(c.estimate_fields)
        out.update(c.late_fields)
    return frozenset(out)
