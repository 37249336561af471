"""Stage planning: split the physical plan at exchange boundaries.

Reference model: flotilla's ``StagePlan::from_logical_plan`` splits at data
movement (``src/daft-distributed/src/stage/mod.rs:54-80``). Here the split
runs over the already-translated physical plan: every ``Exchange`` node
becomes a stage boundary — its subtree is the upstream stage, and the
downstream stage sees a ``StageInput`` leaf. The exchange itself is executed
by the driver between stages (the classic fully-materializing map/reduce
transport; the mesh-collective DeviceExchangeAgg stays *inside* a stage
because it is one fused program, not a materialization point).

A stage is therefore an exchange-free fragment whose leaves are scan tasks,
in-memory partitions, or upstream stage outputs — exactly the shape of a
dispatchable worker task (flotilla's SwordfishTask carries a LocalPhysicalPlan
fragment the same way).

Stage/task identities (``Stage.task_key``) double as the lineage keys of
the resilience plane: every shuffle receipt a boundary consumes is
registered against the producing map task, so a lost partition re-executes
only its producer (``distributed/resilience.py``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..physical import plan as pp


@dataclass
class Boundary:
    """An exchange edge feeding a stage."""

    upstream: int
    kind: str
    num_partitions: int
    by: Tuple = ()
    descending: Tuple = ()
    engine_inserted: bool = False  # preserves the AQE-adaptability flag
    # join-side co-partitioning exchange (translate marks the pair):
    # strategy-adaptable — the runtime re-planner may demote it to a
    # broadcast from measured sizes, exactly like the local AQE path
    join_side: bool = False


@dataclass
class Stage:
    id: int
    plan: pp.PhysicalPlan
    boundaries: List[Boundary] = field(default_factory=list)

    def task_key(self, task_idx: int, phase: str = "") -> str:
        """Stable identity of one of this stage's tasks, minted at the
        planning layer: stage ids come from the deterministic plan-split
        counter and task indices from the deterministic sharding, so the
        same query produces the same keys run after run. The resilience
        plane keys fault-injection decisions and shuffle lineage on these
        (never on run-specific uuids), which is what makes chaos runs
        replay bit-identically."""
        p = f".{phase}" if phase else ""
        return f"s{self.id}{p}.t{task_idx}"

    def is_map_like(self) -> bool:
        """True when the fragment is partition-parallel end-to-end, so its
        scan tasks can shard across workers without changing semantics."""
        ok = (pp.ScanSource, pp.InMemorySource, pp.StageInput, pp.Project,
              pp.Filter, pp.UDFProject, pp.Explode, pp.Unpivot, pp.Sample,
              pp.DeviceFragmentAgg)

        def walk(n) -> bool:
            if isinstance(n, pp.Aggregate):
                return n.mode == "partial" and all(walk(c)
                                                   for c in n.children)
            if not isinstance(n, ok):
                return False
            return all(walk(c) for c in n.children)

        return walk(self.plan)

    def scan_source(self) -> Optional[pp.ScanSource]:
        found = []

        def walk(n):
            if isinstance(n, pp.ScanSource):
                found.append(n)
            for c in n.children:
                walk(c)

        walk(self.plan)
        return found[0] if len(found) == 1 else None

    def with_scan_tasks(self, tasks) -> pp.PhysicalPlan:
        """Shallow-clone the fragment with the (single) ScanSource's task
        list replaced — used to shard a map-like stage across workers."""

        def clone(n):
            c = copy.copy(n)
            if isinstance(c, pp.ScanSource):
                c.tasks = list(tasks)
            else:
                c.children = [clone(ch) for ch in n.children]
            return c

        return clone(self.plan)


class StagePlan:
    """Topologically-ordered stages; the last stage is the query root."""

    def __init__(self, stages: List[Stage]):
        self.stages = stages

    @property
    def root(self) -> Stage:
        return self.stages[-1]

    @classmethod
    def from_physical(cls, plan: pp.PhysicalPlan) -> "StagePlan":
        stages: List[Stage] = []
        counter = [0]

        def cut(node: pp.PhysicalPlan, boundaries: List[Boundary]):
            """Rewrite `node`'s subtree for the current stage, emitting
            upstream stages at every Exchange."""
            if isinstance(node, pp.Exchange):
                up_boundaries: List[Boundary] = []
                up_plan = cut(node.children[0], up_boundaries)
                sid = counter[0]
                counter[0] += 1
                stages.append(Stage(sid, up_plan, up_boundaries))
                boundaries.append(Boundary(
                    sid, node.kind, node.num_partitions, tuple(node.by),
                    tuple(node.descending),
                    getattr(node, "engine_inserted", False),
                    getattr(node, "join_side", False)))
                return pp.StageInput(sid, node.schema())
            n = copy.copy(node)
            n.children = [cut(c, boundaries) for c in node.children]
            return n

        root_boundaries: List[Boundary] = []
        root_plan = cut(plan, root_boundaries)
        sid = counter[0]
        stages.append(Stage(sid, root_plan, root_boundaries))
        return cls(stages)

    @staticmethod
    def _contains_input(node, upstream: int) -> bool:
        if isinstance(node, pp.StageInput):
            return node.stage_id == upstream
        return any(StagePlan._contains_input(c, upstream)
                   for c in node.children)

    @staticmethod
    def _subtree_safe(node, b: Boundary) -> bool:
        """True when ``node``'s subtree consumes the boundary's StageInput
        only through partition-local operators — rows sharing the exchange
        keys never need to meet rows from other partitions. Global
        operators (sort, limit, monotonic ids, windows) disqualify."""
        by_names = {e.name() for e in b.by}

        def walk(n) -> tuple:
            """→ (subtree references this boundary, safe so far)."""
            if isinstance(n, pp.StageInput):
                return n.stage_id == b.upstream, True
            has_any = False
            for c in n.children:
                has, safe = walk(c)
                if has and not safe:
                    return True, False
                has_any = has_any or has
            if not has_any:
                return False, True
            if isinstance(n, (pp.Project, pp.Filter, pp.UDFProject,
                              pp.Explode, pp.Unpivot)):
                return True, True
            if isinstance(n, pp.HashJoin):
                # hash strategy: both sides are engine-inserted hash
                # boundaries on the join keys (co-partitioned); broadcast:
                # the build side is a replicated gather boundary and the
                # probe is row-local. sort_merge inserts NO exchanges —
                # fanning it out would re-run the embedded side per task
                # and duplicate outer-side unmatched rows.
                return True, n.strategy != "sort_merge"
            if isinstance(n, pp.Aggregate):
                group_names = {e.name() for e in n.group_by}
                return True, by_names <= group_names
            if isinstance(n, pp.Dedup):
                on_names = {e.name() for e in (n.on or [])} \
                    if n.on else None
                return True, on_names is None or by_names <= on_names
            return True, False

        has, safe = walk(node)
        return has and safe

    def fanout_safe(self, stage: Stage, b: Boundary) -> bool:
        """The whole consumer fragment can run one task per hash
        partition."""
        if b.kind != "hash" or not b.by:
            return False
        return self._subtree_safe(stage.plan, b)

    def collective_safe(self, stage: Stage, b: Boundary) -> bool:
        """Structural eligibility of one hash boundary for the
        collective / hierarchical exchange family (the placement layer's
        precondition, topology- and cost-blind): the consumer fragment
        must be partition-local END TO END over this boundary — a
        collective exchange hands each reduce task one already-exchanged
        bucket, so there is no safe-frontier split to fall back on — and
        every sibling input must be hash (co-partitioned: the mesh pid
        chain and ``partition_by_hash`` agree by construction) or gather
        (replicated)."""
        return (b.kind == "hash" and b.num_partitions > 1
                and all(ob.kind in ("hash", "gather")
                        for ob in stage.boundaries)
                and self.fanout_safe(stage, b))

    def split_for_fanout(self, stage: Stage, b: Boundary):
        """Cut the consumer fragment at its SAFE FRONTIER: the highest node
        on the StageInput's path whose subtree is partition-local. →
        (sub_plan to fan out per partition, remainder plan reading the
        fan-out's output through StageInput(placeholder_id),
        placeholder_id) or None when no useful split exists (reference:
        flotilla keeps per-partition pipeline nodes below the global op
        and materializes between — the same seam)."""
        if b.kind != "hash" or not b.by:
            return None

        def descend(n):
            if self._subtree_safe(n, b):
                return n
            kids = [c for c in n.children
                    if self._contains_input(c, b.upstream)]
            if len(kids) != 1:
                return None
            return descend(kids[0])

        cut = descend(stage.plan)
        if cut is None or cut is stage.plan \
                or isinstance(cut, pp.StageInput):
            return None  # whole-stage fanout, nothing local, or no split
        placeholder_id = -(stage.id + 1) * 1000 - b.upstream
        placeholder = pp.StageInput(placeholder_id, cut.schema())

        def clone(n):
            if n is cut:
                return placeholder
            c = copy.copy(n)
            c.children = [clone(ch) for ch in n.children]
            return c

        return cut, clone(stage.plan), placeholder_id

    def combine_for_boundary(self, consumer: Stage, b: Boundary,
                             upstream: Stage):
        """Map-side combine plan for one hash boundary: when the boundary
        feeds a final grouped aggregation whose aggs are all associative
        self-merges (``aggs.AGG_DECOMPOSITION``), return
        ``(combine_aggs, combine_by, agg_node)`` — the merge expressions
        each map task applies per partition before ``ShuffleCache.push``
        (wire carries group states instead of rows), aliased so the
        combined output keeps the upstream stage's EXACT wire schema.
        None when the consumer isn't that shape, any agg falls outside
        the self-merge table (non-decomposable sets keep today's plan),
        or the combine would drop a wire column no final agg reads."""
        from ..aggs import merge_exprs_for
        if b.kind != "hash" or not b.by:
            return None
        agg = self._consumer_agg(consumer.plan, b.upstream)
        if agg is None or not agg.group_by:
            return None
        if {e.name() for e in b.by} != {e.name() for e in agg.group_by}:
            return None
        merge = merge_exprs_for(agg.aggs, alias_to="source")
        if merge is None:
            return None
        wire_cols = list(upstream.plan.schema().column_names)
        by_names = {e.name() for e in b.by}
        if {e.name() for e in merge} | by_names != set(wire_cols):
            return None  # a wire column no final agg reads would vanish
        order = {n: i for i, n in enumerate(wire_cols)}
        merge.sort(key=lambda e: order[e.name()])
        return tuple(merge), tuple(b.by), agg

    @staticmethod
    def _consumer_agg(node, upstream: int):
        """The UNIQUE final Aggregate directly consuming
        ``StageInput(upstream)``, else None (an aggregate reached through
        intermediate operators can't combine: the wire rows feed those
        operators first)."""
        found = []

        def walk(n):
            if isinstance(n, pp.Aggregate) and n.children \
                    and isinstance(n.children[0], pp.StageInput) \
                    and n.children[0].stage_id == upstream \
                    and n.mode in ("final", "single"):
                found.append(n)
            for c in n.children:
                walk(c)

        walk(node)
        return found[0] if len(found) == 1 else None

    def repr_ascii(self) -> str:
        lines = []
        for s in self.stages:
            ins = ", ".join(f"stage{b.upstream}→{b.kind}({b.num_partitions})"
                            for b in s.boundaries) or "-"
            lines.append(f"Stage {s.id}: root={s.plan.name()} inputs=[{ins}]"
                         f" map_like={s.is_map_like()}")
        return "\n".join(lines)
