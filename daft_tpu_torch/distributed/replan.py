"""Distributed runtime re-planning: boundary actuals → stage decisions.

The local runner's ``_run_adaptive`` loop (materialize → replace subtree
with actuals → re-optimize) never existed in the distributed tier, yet
the stage runner sits on EXACT evidence at every materialized boundary:
map receipts carry pushed rows/bytes (and, on combined boundaries, the
pushed group-state count — a bound on the boundary keys' NDV), driver-
materialized partitions carry exact sizes, and in-memory sources are
right there to measure. This module closes loop (b) of the self-tuning
plan (ROADMAP item 4): before the :class:`~.scheduler.StageRunner`
dispatches a stage, a :class:`StageReplanner` folds those actuals back
into the remaining plan —

- **estimate rewrites** — ``Aggregate.group_rows_est`` /
  ``Aggregate.group_ndv`` and ``HashJoin.left/right_bytes_est`` inside
  the not-yet-dispatched fragment are replaced with measured boundary
  actuals, so the kernel strategy ladder (``groupby_strategy``), the
  fused-gate, and the grace-join spill fanout (``plan_partitions`` /
  ``spill_plan_wins``) price from evidence instead of footer guesses;
- **combine gating** — ``shuffle_combine_wins`` re-priced with the
  stage's measured input rows and (when affordable) the EXACT key NDV
  of in-memory sources: a near-unique boundary flips a default-accepted
  combine off, a mis-estimated-near-unique footer flips a declined
  combine on;
- **broadcast demotion** — a hash boundary feeding one side of a
  downstream hash join demotes to a replicated ``gather`` when the
  producing stage's measured output bound fits the broadcast threshold
  (join-type gated exactly like the static translate decision);
- **exchange rung** — the r18 collective/hierarchical/flight ladder is
  re-priced with measured rows and row widths instead of the
  evidence-free default-accept.

Chaos-determinism contract: ``DAFT_TORCH_CHAOS_SERIALIZE=1`` or an active
fault plan disables re-planning entirely (``adaptive_enabled`` returns
False and counts ``replan_frozen``) — a replayed run must plan exactly
like the recorded one. Every decision lands in the process-wide adaptive
counters (``physical/adaptive.py``) → the per-query ``adaptive`` stats
block, the flight recorder, and ``daft_torch_adaptive_*`` metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..physical import adaptive
from ..physical import plan as pp
from .stages import Boundary, Stage, StagePlan

#: exact-NDV measurement cap: a driver-side distinct over more rows than
#: this costs more than the decision it informs
_NDV_MEASURE_CAP = 1 << 21

#: only a measured side at least this factor under the threshold demotes
#: (headroom for the row-local output bound being an upper bound on a
#: *different* quantity than the broadcast build table)
_DEMOTE_HEADROOM = 1.0


def adaptive_enabled() -> bool:
    """Master gate for distributed runtime re-planning:
    ``DAFT_TORCH_ADAPTIVE`` env overrides the per-query
    ``ExecutionConfig.adaptive`` mirror; chaos-serialize or an
    active fault plan freezes it regardless (counted)."""
    from .. import knobs
    raw = knobs.env_raw("DAFT_TORCH_ADAPTIVE")
    if raw is not None:
        want = bool(knobs.env_bool("DAFT_TORCH_ADAPTIVE"))
    else:
        try:
            from ..context import get_context
            want = bool(get_context().execution_config.adaptive)
        except Exception:
            want = False
    if not want:
        return False
    if knobs.env_bool("DAFT_TORCH_CHAOS_SERIALIZE"):
        adaptive.count("replan_frozen")
        return False
    from .resilience import active_fault_plan
    if active_fault_plan() is not None:
        adaptive.count("replan_frozen")
        return False
    return True


@dataclasses.dataclass
class BoundaryActuals:
    """Measured evidence for one stage input (or one stage's output
    bound): exact rows/bytes, and an NDV bound on the boundary keys —
    ``exact_ndv`` when it came from a driver-side distinct, else it is
    the summed per-task combine-state count (an upper bound)."""

    rows: int = 0
    nbytes: int = 0
    ndv: Optional[int] = None
    exact_ndv: bool = False


def measure_key_ndv(parts, names: List[str]) -> Optional[int]:
    """EXACT distinct count of ``names`` over a list of materialized
    partitions, or None when it would cost too much (row cap) or the
    columns aren't all present. Driver-side, bounded, counted, and
    vectorized (arrow count_distinct / group_by — a python set over a
    million key tuples would cost more than the decision it informs)."""
    try:
        import pyarrow as pa
        import pyarrow.compute as pc
        total = sum(len(p) for p in parts)
        if total == 0 or total > _NDV_MEASURE_CAP:
            return None
        tbls = []
        for p in parts:
            if len(p) == 0:
                continue
            tbl = p.combined().to_arrow_table()
            if any(n not in tbl.column_names for n in names):
                return None
            tbls.append(tbl.select(names))
        if not tbls:
            return None
        t = tbls[0] if len(tbls) == 1 else pa.concat_tables(tbls)
        if len(names) == 1:
            ndv = pc.count_distinct(t.column(0)).as_py()
        else:
            ndv = t.group_by(names).aggregate([]).num_rows
        adaptive.count("ndv_measured")
        return int(ndv)
    except Exception:
        return None


def _by_names(b: Boundary) -> Optional[List[str]]:
    try:
        names = [e.name() for e in b.by]
        return names if names else None
    except Exception:
        return None


#: fragment nodes through which "output bytes ≤ input bytes" holds (the
#: conservative bound the demotion and exchange evidence rely on);
#: anything else — joins, explodes, concats — can expand and disqualifies
_NON_EXPANDING = (pp.Project, pp.Filter, pp.Aggregate,
                  pp.DeviceFragmentAgg, pp.StageInput, pp.InMemorySource,
                  pp.Limit, pp.Sample, pp.Dedup, pp.TopN, pp.ScanSource)


def _non_expanding(plan) -> bool:
    """Whole-fragment check for the bound above. A ScanSource leaf is
    structurally allowed (the allowed set is single-child chains, so a
    scan can never sit beside a measured boundary) — scan-rooted stages
    simply have no input actuals and resolve to no bound."""
    if not isinstance(plan, _NON_EXPANDING):
        return False
    return all(_non_expanding(c) for c in plan.children)


def _in_memory_parts(plan) -> Optional[list]:
    """Every partition of the fragment's in-memory sources, or None when
    there are none or any source is spill-backed (re-draining a buffer
    is not a free peek)."""
    srcs: List[pp.InMemorySource] = []

    def walk(n):
        if isinstance(n, pp.InMemorySource):
            srcs.append(n)
        for c in n.children:
            walk(c)

    walk(plan)
    if not srcs:
        return None
    parts: List = []
    for s in srcs:
        sp = getattr(s, "partitions", None)
        if not isinstance(sp, (list, tuple)):
            return None
        parts.extend(sp)
    return parts


class StageReplanner:
    """One query's runtime re-planner, driven by the StageRunner: peeks
    each stage's input actuals before dispatch, rewrites the fragment's
    estimates, and re-picks the boundary decisions. Owns an
    :class:`~daft_tpu_torch.physical.adaptive.AdaptivePlanner` so every
    decision shows up in ``explain_analyze`` next to the local AQE
    layer's."""

    def __init__(self, stage_plan: StagePlan, planner=None):
        from ..context import get_context
        self.stage_plan = stage_plan
        self.cfg = get_context().execution_config
        # share the distributed AQE loop's planner when one is active so
        # both layers' decisions interleave in ONE explain_analyze log
        self.planner = planner if planner is not None \
            else adaptive.new_planner(self.cfg)
        #: per-stage output-bound evidence (set in before_stage, used
        #: when pricing that stage's own consumer-boundary decisions)
        self._evidence: Dict[int, BoundaryActuals] = {}

    # ------------------------------------------------------------ inputs
    def _input_actuals(self, stage: Stage, outputs: Dict[int, list],
                       out_mode: Dict[int, str]
                       ) -> Dict[int, BoundaryActuals]:
        """Measured actuals per input boundary, PEEKED from the producer
        outputs the runner has not bound yet."""
        acts: Dict[int, BoundaryActuals] = {}
        for b in stage.boundaries:
            up_out = outputs.get(b.upstream)
            if up_out is None:
                continue
            mode = out_mode.get(b.upstream, "mat")
            a = None
            if mode == "shuffled":
                rows = sum(int(getattr(r, "rows", 0)) for r in up_out)
                nbytes = sum(int(getattr(r, "nbytes", 0)) for r in up_out)
                states = [getattr(r, "state_rows", None) for r in up_out]
                ndv = sum(states) if states and \
                    all(s is not None for s in states) else None
                a = BoundaryActuals(rows, nbytes, ndv, exact_ndv=False)
            elif mode == "collective":
                parts = [p for pl in up_out for p in pl]
                a = BoundaryActuals(sum(len(p) for p in parts),
                                    sum(int(p.size_bytes() or 0)
                                        for p in parts))
            else:  # driver-materialized
                a = BoundaryActuals(sum(len(p) for p in up_out),
                                    sum(int(p.size_bytes() or 0)
                                        for p in up_out))
                names = _by_names(b)
                if b.kind == "hash" and names:
                    ndv = measure_key_ndv(up_out, names)
                    if ndv is not None:
                        a.ndv, a.exact_ndv = ndv, True
            acts[b.upstream] = a
        return acts

    def _source_actuals(self, stage: Stage, b: Optional[Boundary]
                        ) -> Optional[BoundaryActuals]:
        """Exact evidence from the fragment's own in-memory sources
        (first stages have no input boundaries, but their data is right
        here): rows/bytes always, key NDV when the boundary keys are
        plain source columns and the row cap affords a distinct."""
        parts = _in_memory_parts(stage.plan)
        if parts is None:
            return None
        a = BoundaryActuals(sum(len(p) for p in parts),
                            sum(int(p.size_bytes() or 0) for p in parts))
        names = _by_names(b) if b is not None else None
        if b is not None and b.kind == "hash" and names:
            ndv = measure_key_ndv(parts, names)
            if ndv is not None:
                a.ndv, a.exact_ndv = ndv, True
        return a

    # ------------------------------------------------------ before_stage
    def before_stage(self, stage: Stage, cons, outputs: Dict[int, list],
                     out_mode: Dict[int, str]) -> None:
        """Fold measured evidence into ``stage`` before the runner plans
        its dispatch: rewrite fragment estimates from input actuals,
        build this stage's output-bound evidence, and demote its
        consumer boundary to a broadcast when the bound fits."""
        acts = self._input_actuals(stage, outputs, out_mode)
        if acts:
            self._rewrite_estimates(stage, acts)
        b = cons[1] if cons is not None else None
        ev = self._output_bound(stage, acts, b)
        if ev is not None and ev.ndv is None and b is not None \
                and b.kind == "hash":
            # the consumer-boundary keys' NDV wasn't carried by any
            # receipt: measure it EXACTLY over whatever materialized
            # rows the driver already holds (mat inputs + in-memory
            # sources), when the key columns pass through by name and
            # the row cap affords a distinct
            names = _by_names(b)
            parts = self._driver_resident_parts(stage, outputs, out_mode)
            if names and parts is not None:
                ndv = measure_key_ndv(parts, names)
                if ndv is not None:
                    ev.ndv, ev.exact_ndv = ndv, True
        self._evidence[stage.id] = ev
        if cons is not None:
            self._maybe_demote(stage, cons[0], cons[1])

    def _driver_resident_parts(self, stage: Stage,
                               outputs: Dict[int, list],
                               out_mode: Dict[int, str]):
        """Every materialized partition of this stage's inputs the
        driver holds right now (mat boundary outputs + in-memory source
        partitions), or None when any input is NOT driver-resident —
        the NDV of a partial view is not the NDV of the stage."""
        parts: List = []
        for ob in stage.boundaries:
            if out_mode.get(ob.upstream, "mat") != "mat":
                return None
            up_out = outputs.get(ob.upstream)
            if up_out is None:
                return None
            parts.extend(up_out)
        src_parts = _in_memory_parts(stage.plan)
        if src_parts is not None:
            parts.extend(src_parts)
        return parts if parts else None

    def _output_bound(self, stage: Stage,
                      acts: Dict[int, BoundaryActuals],
                      b: Optional[Boundary]) -> Optional[BoundaryActuals]:
        """Upper bound on this stage's output (rows/bytes/key-NDV) —
        only claimed when the fragment is non-expanding end to end and
        every input is measured (or the data is an in-memory source)."""
        if not _non_expanding(stage.plan):
            return None
        if stage.boundaries and acts \
                and all(ob.upstream in acts for ob in stage.boundaries):
            rows = sum(a.rows for a in acts.values())
            nbytes = sum(a.nbytes for a in acts.values())
            ndvs = [a for a in acts.values() if a.ndv is not None]
            ndv = min((a.ndv for a in ndvs), default=None) \
                if len(ndvs) == len(acts) and acts else None
            exact = bool(ndvs) and all(a.exact_ndv for a in ndvs) \
                and ndv is not None
            return BoundaryActuals(rows, nbytes, ndv, exact)
        if not stage.boundaries:
            return self._source_actuals(stage, b)
        return None

    # ------------------------------------------------------- est rewrite
    def _rewrite_estimates(self, stage: Stage,
                           acts: Dict[int, BoundaryActuals]) -> None:
        """Replace the fragment's planner estimates with boundary
        actuals — the distributed analogue of the local AQE loop's
        replace-subtree-with-in-memory-source step."""
        rewrites = 0

        def feeding(n, up: int) -> bool:
            return StagePlan._contains_input(n, up)

        def walk(n):
            nonlocal rewrites
            if isinstance(n, pp.Aggregate) and n.mode == "final":
                ups = [u for u in acts if feeding(n, u)]
                if ups:
                    rows = sum(acts[u].rows for u in ups)
                    old_ndv = getattr(n, "group_ndv", None)
                    n.group_rows_est = rows
                    rewrites += 1
                    ndvs = [acts[u].ndv for u in ups]
                    if all(v is not None for v in ndvs) and ndvs:
                        ndv = sum(ndvs)
                        if not hasattr(n, "group_ndv_footer"):
                            # stash the ORIGINAL footer evidence (even
                            # None): the NDV_FOOTER_RATIO observation
                            # must compare actuals against what the
                            # footer CLAIMED — a rewritten EXACT value
                            # observing ratio≈1.0 would EWMA-erase the
                            # learned damping
                            n.group_ndv_footer = old_ndv
                        n.group_ndv = ndv
                        if old_ndv and (old_ndv >= 2 * ndv
                                        or ndv >= 2 * old_ndv):
                            adaptive.count("ndv_corrections")
            if isinstance(n, pp.HashJoin):
                lups = [u for u in acts if feeding(n.children[0], u)]
                if lups:
                    n.left_bytes_est = sum(acts[u].nbytes for u in lups)
                    rewrites += 1
                rups = [u for u in acts if feeding(n.children[1], u)]
                if rups:
                    n.right_bytes_est = sum(acts[u].nbytes for u in rups)
                    rewrites += 1
            for c in n.children:
                walk(c)

        walk(stage.plan)
        if rewrites:
            adaptive.count("est_rewrites", rewrites)
            rows = sum(a.rows for a in acts.values())
            nbytes = sum(a.nbytes for a in acts.values())
            self.planner.record_replan(
                f"stage s{stage.id}: {rewrites} fragment estimate(s) "
                f"rewritten from boundary actuals", rows, nbytes)

    # -------------------------------------------------------- demotion
    def _maybe_demote(self, stage: Stage, cstage: Stage,
                      b: Boundary) -> None:
        """Hash-boundary → broadcast demotion from measured evidence:
        when this stage's output bound fits the broadcast threshold and
        its consumer is a hash join whose join type tolerates a
        replicated build side, the boundary becomes a ``gather`` — the
        small side skips the worker-cache shuffle entirely and
        replicates to the reduce tasks instead (the distributed
        analogue of the executor's ``_adaptive_hash_join`` demotion).
        Guards: only join-side co-partitioning exchanges (the pair
        translate marked strategy-adaptable), never when the sibling
        side is already demoted (one side must stay partitioned), and
        never the LARGER side when both are measured."""
        if b.kind != "hash" or b.num_partitions <= 1 or not b.join_side:
            return
        ev = self._evidence.get(stage.id)
        if ev is None or ev.nbytes <= 0:
            return
        threshold = self.cfg.broadcast_join_size_bytes_threshold
        if ev.nbytes > threshold * _DEMOTE_HEADROOM:
            return
        side_how = self._join_side(cstage.plan, stage.id)
        if side_how is None:
            return
        side, how, join_node = side_how
        if side == "right" and how not in ("inner", "left", "semi",
                                           "anti"):
            return
        if side == "left" and how not in ("inner", "right"):
            return
        sib = self._sibling_boundary(cstage, join_node, side, stage.id)
        if sib is not None:
            if sib.kind != "hash":
                return  # sibling already demoted: keep this side fanned
            sib_ev = self._sibling_evidence(sib)
            if sib_ev is not None and sib_ev.nbytes < ev.nbytes:
                return  # the smaller side should broadcast, not this one
        b.kind = "gather"
        b.num_partitions = 1
        adaptive.count("broadcast_demotions")
        self.planner.record_join(
            f"s{stage.id} hash→broadcast_{side} (measured {ev.nbytes} "
            f"bytes ≤ threshold {threshold})", ev.nbytes)

    def _sibling_boundary(self, cstage: Stage, join_node, side: str,
                          upstream: int) -> Optional[Boundary]:
        """The consumer boundary feeding the OTHER side of the join."""
        other = join_node.children[1 if side == "left" else 0]
        for ob in cstage.boundaries:
            if ob.upstream != upstream \
                    and StagePlan._contains_input(other, ob.upstream):
                return ob
        return None

    def _sibling_evidence(self, sib: Boundary
                          ) -> Optional[BoundaryActuals]:
        """Best available output bound for the sibling side's producer:
        its recorded evidence when that stage was already processed,
        else a recursive bound over its (not-yet-processed) stage chain
        down to in-memory sources — parquet scans stay unknown."""
        return self._recursive_bound(sib.upstream, depth=0)

    def _recursive_bound(self, stage_id: int, depth: int
                         ) -> Optional[BoundaryActuals]:
        if depth > 8:
            return None
        ev = self._evidence.get(stage_id)
        if ev is not None:
            return ev
        st = next((s for s in self.stage_plan.stages
                   if s.id == stage_id), None)
        if st is None:
            return None
        if not _non_expanding(st.plan):
            return None
        if not st.boundaries:
            return self._source_actuals(st, None)
        bounds = [self._recursive_bound(ob.upstream, depth + 1)
                  for ob in st.boundaries]
        if any(b is None for b in bounds):
            return None
        return BoundaryActuals(sum(b.rows for b in bounds),
                               sum(b.nbytes for b in bounds))

    @staticmethod
    def _join_side(plan, upstream: int):
        """→ ("left"|"right", how, node) when the UNIQUE hash-strategy
        HashJoin consuming ``StageInput(upstream)`` does so through
        exactly one side; None otherwise."""
        found = []

        def walk(n):
            if isinstance(n, pp.HashJoin) and n.strategy == "hash":
                in_l = StagePlan._contains_input(n.children[0], upstream)
                in_r = StagePlan._contains_input(n.children[1], upstream)
                if in_l != in_r:
                    found.append(("left" if in_l else "right", n.how, n))
            for c in n.children:
                walk(c)

        walk(plan)
        return found[0] if len(found) == 1 else None

    # ------------------------------------------------- boundary pricing
    def combine_evidence(self, stage: Stage):
        """(rows, ndv, exact) evidence for this stage's map-side combine
        decision, or None when nothing was measured."""
        ev = self._evidence.get(stage.id)
        if ev is None or ev.rows <= 0:
            return None
        return ev.rows, ev.ndv, ev.exact_ndv

    def exchange_evidence(self, stage: Stage):
        """(rows, row_bytes) evidence for the exchange-path ladder."""
        ev = self._evidence.get(stage.id)
        if ev is None or ev.rows <= 0:
            return None
        return ev.rows, max(ev.nbytes / ev.rows, 1.0)

    # ------------------------------------------------------ after_stage
    def after_stage(self, stage: Stage, result: list, mode: str) -> None:
        """Post-completion feedback: a driver-materialized stage whose
        fragment holds a final grouped Aggregate with footer NDV
        evidence reveals the TRUE group count — observed into the
        calibrated ``NDV_FOOTER_RATIO`` so future footer evidence is
        damped toward reality."""
        if mode != "mat" or not result:
            return
        agg = self._final_agg_with_footer(stage.plan)
        if agg is None:
            return
        if hasattr(agg, "group_ndv_footer"):
            # a rewrite happened: only the stashed ORIGINAL footer (which
            # may be None — no footer evidence existed) may be observed
            footer = agg.group_ndv_footer
        else:
            footer = getattr(agg, "group_ndv", None)
        try:
            actual = sum(len(p) for p in result)
        except Exception:
            return
        if not footer or footer <= 0 or actual <= 0:
            return
        from ..device import calibration
        calibration.observe("NDV_FOOTER_RATIO", actual / float(footer))
        self.planner.record_replan(
            f"stage s{stage.id}: observed {actual} groups vs footer NDV "
            f"{int(footer)} (ratio {actual / float(footer):.3g})", actual)

    @staticmethod
    def _final_agg_with_footer(plan):
        found = []

        def walk(n):
            if not (isinstance(n, pp.Aggregate)
                    and n.mode in ("final", "single") and n.group_by):
                for c in n.children:
                    walk(c)
                return
            footer = n.group_ndv_footer \
                if hasattr(n, "group_ndv_footer") \
                else getattr(n, "group_ndv", None)
            if footer:
                found.append(n)
            for c in n.children:
                walk(c)

        walk(plan)
        return found[0] if len(found) == 1 else None
