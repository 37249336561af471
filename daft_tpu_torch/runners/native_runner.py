"""NativeRunner: optimize → translate → the local engine.

Reference: ``daft_tpu/runners/native_runner.py`` (``daft/runners/
native_runner.py:49-99``). The engine is the push pipeline
(``execution/pipeline.py:PushExecutor``) unless ``local_executor`` /
``DAFT_TORCH_LOCAL_EXECUTOR`` asks for the pull interpreter (``interp``).
With ``enable_aqe=True`` the runner becomes the reference's
AdaptivePlanner loop (``physical_planner/planner.rs:451-640``
next_stage/update_stats): join inputs materialize stage by stage, their
ACTUAL cardinalities are folded back into the logical plan as in-memory
sources, and the whole optimizer re-runs over the remainder — join order
and broadcast decisions are made from measurements, not estimates.

The device is resolved once per query, before anything is read, so a
query asked to run on a card that is not there fails at once.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Tuple

from .. import knobs
from ..execution.executor import LocalExecutor
from ..micropartition import MicroPartition
from ..physical.translate import translate
from .runner import Runner


def local_executor_kind(cfg) -> str:
    """``push`` or ``interp``: ``DAFT_TORCH_LOCAL_EXECUTOR``, else
    ``ExecutionConfig.local_executor``."""
    kind = (knobs.env_raw("DAFT_TORCH_LOCAL_EXECUTOR")
            or cfg.local_executor).strip().lower()
    if kind not in ("push", "interp"):
        raise ValueError(f"local executor {kind!r}: expected 'push' or "
                         "'interp'")
    return kind


def make_local_executor(cfg, device) -> LocalExecutor:
    """Engine pick: the push-based morsel pipeline (default), or the
    pull-generator interpreter."""
    if local_executor_kind(cfg) == "interp":
        return LocalExecutor(device)
    from ..execution.pipeline import PushExecutor
    return PushExecutor(device)


class NativeRunner(Runner):
    name = "native"

    def run_iter(self, builder, results_buffer_size: Optional[int] = None
                 ) -> Iterator[MicroPartition]:
        from .. import tracing
        from ..context import get_context
        from ..device import backend, warmup
        cfg = get_context().execution_config
        device = backend.resolve_device()
        warmup.maybe_warmup_session()
        # the trace (when sampled in) starts HERE so the planner spans
        # land on it; the executor's stats context adopts it and the
        # export fires when the query ends. Until that adoption the
        # recorder has no owner: a planning failure closes and
        # unregisters it here, or it would stay in the registry with the
        # trace lost
        tctx = tracing.maybe_start_trace("query")
        try:
            with tracing.attach(tctx):
                if cfg.enable_aqe:
                    return self._run_adaptive(builder, cfg, device)
                with tracing.span("plan:optimize", lane="planner"):
                    optimized = builder.optimize()
                with tracing.span("plan:translate", lane="planner"):
                    pplan = translate(optimized.plan)
                return make_local_executor(cfg, device).run(pplan)
        except BaseException:
            tracing.abort_trace(tctx)
            raise

    # ------------------------------------------------------------- AQE
    def _run_adaptive(self, builder, cfg, device
                      ) -> Iterator[MicroPartition]:
        """Stage-by-stage adaptive loop: materialize the cheapest
        unresolved join input, substitute an in-memory source carrying its
        ACTUAL rows/bytes, re-optimize the remainder, repeat. The final
        translate sees only measured sizes, so broadcast-vs-hash and join
        order are decided from actuals (each re-plan is recorded on the
        planner, ``adaptive.last_planner()``). The materializations run
        in a nested observability scope: their operators land on the
        query's trace, and the query's exports fire once, at its end."""
        from .. import observability as obs
        from .. import tracing
        from ..execution import memory
        from ..logical import plan as lp
        from ..logical.optimizer import Optimizer
        from ..physical import adaptive

        planner = adaptive.new_planner(cfg)
        with tracing.span("plan:optimize", lane="planner"):
            plan = Optimizer().optimize(builder.plan)
        for _round in range(32):  # bound the loop defensively
            target = _pick_join_input(plan)
            if target is None:
                break
            ex = make_local_executor(cfg, device)
            ex._aqe_planner = planner
            with tracing.span("plan:translate", lane="planner"):
                tplan = translate(target)
            # spill-bounded, like a join build: the loop eventually
            # materializes the largest fact side, which must not bypass
            # the memory budget
            with obs.nested_scope():
                buf = memory.materialize(ex.run(tplan))
            rows, size = buf.total_rows, buf.total_bytes
            src = lp.Source(partitions=buf, schema=target.schema(),
                            num_partitions=max(len(buf), 1))
            planner.record_replan(
                f"materialized join input ({rows} rows, {size} bytes "
                f"actual) → re-optimized remainder", rows, size)
            plan = _replace_subtree(plan, target, src)
            with tracing.span("plan:optimize", lane="planner"):
                plan = Optimizer().optimize(plan)
        ex = make_local_executor(cfg, device)
        ex._aqe_planner = planner
        with tracing.span("plan:translate", lane="planner"):
            planner.final_plan = translate(plan)
        return ex.run(planner.final_plan)


def _is_measured(node) -> bool:
    """Only a bare in-memory source carries EXACT stats — anything above
    it (Filter/Aggregate/Join/scan) still runs on estimates and is worth
    materializing before the join decision. The optimizer's own derived
    null-key filters (FilterNullJoinKey re-adds them every pass) don't
    count: treating them as unmeasured would re-materialize the same
    source forever."""
    from ..logical import plan as lp
    from ..logical.optimizer import split_conjuncts
    while isinstance(node, lp.Filter) and all(
            c._unalias().op == "not_null"
            and c._unalias().args[0].op == "col"
            for c in split_conjuncts(node.predicate)):
        node = node.children[0]
    return isinstance(node, lp.Source) and node.partitions is not None


def _pick_join_input(plan):
    """The cheapest-estimated unmeasured input of the bottom-most join
    that still has one, or None when every join input is a measured
    in-memory source. Joins whose inputs are all measured stop blocking
    their ancestors, so the loop works its way up the join tree."""
    from ..logical import plan as lp
    from ..logical import stats as lstats

    best: Optional[Tuple[float, object]] = None

    def visit(node) -> bool:
        """True iff the subtree contains a join with unmeasured inputs."""
        nonlocal best
        kid_flags = [visit(c) for c in node.children]  # no short-circuit
        has_inner = any(kid_flags)
        if isinstance(node, lp.Join):
            pending = [c for c in node.children if not _is_measured(c)]
            if not pending:
                return has_inner
            if not has_inner:
                for c in pending:
                    est = lstats.estimate(c).size_bytes
                    key = est if est is not None else float("inf")
                    if best is None or key < best[0]:
                        best = (key, c)
            return True
        return has_inner

    visit(plan)
    return None if best is None else best[1]


def _replace_subtree(plan, target, replacement):
    if plan is target:
        return replacement
    kids = [_replace_subtree(c, target, replacement)
            for c in plan.children]
    return plan.with_children(kids)


_runner: Optional[NativeRunner] = None
_runner_lock = threading.Lock()


def get_runner() -> NativeRunner:
    """The process's runner."""
    global _runner
    with _runner_lock:
        if _runner is None:
            _runner = NativeRunner()
        return _runner
