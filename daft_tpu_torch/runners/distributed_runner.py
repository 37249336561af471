"""Distributed runner: stage plan → scheduler → workers.

Reference architecture: the flotilla engine (``src/daft-distributed``): the
logical/physical plan splits into exchange-free stages
(``stage/mod.rs:54-80``), a scheduler actor places stage tasks on workers
through a pluggable policy (``scheduling/scheduler/mod.rs:18-23``), and each
worker runs the local streaming engine on its fragment. The port's copy
of ``daft_tpu/runners/distributed_runner.py``: workers are in-process
executors sharing the process's card (``DAFT_TORCH_NUM_WORKERS``; remote
worker processes plug into the same ``Worker`` seam), hash boundaries
ride the Flight shuffle, the mesh or the driver, and mesh-collective
aggregations (``DeviceExchangeAgg``) stay inside stages. Selected with
``DAFT_TORCH_RUNNER=distributed`` or ``set_runner``.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

from ..distributed import (InProcessWorker, LeastLoadedScheduler, StagePlan,
                           StageRunner, WorkerManager)
from ..micropartition import MicroPartition
from ..physical.translate import translate
from .runner import Runner


class DistributedRunner(Runner):
    name = "torch_distributed"

    def __init__(self, num_workers: Optional[int] = None, scheduler=None):
        super().__init__()
        from .. import knobs
        self.num_workers = num_workers or max(
            knobs.env_int("DAFT_TORCH_NUM_WORKERS")
            or min((os.cpu_count() or 4) // 2, 8), 2)
        self._scheduler = scheduler
        self._manager: Optional[WorkerManager] = None

    def _get_manager(self) -> WorkerManager:
        if self._manager is None:
            slots = max((os.cpu_count() or 4) // self.num_workers, 1)
            self._manager = WorkerManager(
                [InProcessWorker(f"worker-{i}", num_slots=slots)
                 for i in range(self.num_workers)])
        return self._manager

    def shutdown(self) -> None:
        """Stop the in-process workers' thread pools."""
        if self._manager is not None:
            self._manager.shutdown()
            self._manager = None

    def run_iter(self, builder, results_buffer_size: Optional[int] = None
                 ) -> Iterator[MicroPartition]:
        from .. import observability as obs
        from .. import tracing
        from ..context import get_context
        cfg = get_context().execution_config
        tctx = tracing.maybe_start_trace("distributed")
        # a planning failure strikes before the driver stats context
        # below takes ownership of the recorder — close and unregister it
        # on that path or it leaks (daft-lint: trace-recorder-leak)
        try:
            with tracing.attach(tctx):
                aqe_planner = None
                if cfg.enable_aqe:
                    # the native runner's AQE loop, distributed (round
                    # 20): join inputs materialize THROUGH the stage
                    # runner, their actual rows/bytes replace the
                    # subtree, and the optimizer re-runs — join ORDER
                    # and broadcast decisions in this tier come from
                    # measurements too
                    with tracing.span("plan:optimize", lane="planner"):
                        plan, aqe_planner = self._adaptive_logical(
                            builder, cfg)
                    with tracing.span("plan:translate", lane="planner"):
                        pplan = translate(plan)
                else:
                    with tracing.span("plan:optimize", lane="planner"):
                        optimized = builder.optimize()
                    with tracing.span("plan:translate", lane="planner"):
                        pplan = translate(optimized.plan)
                stage_plan = StagePlan.from_physical(pplan)
                runner = StageRunner(
                    self._get_manager(),
                    self._scheduler or LeastLoadedScheduler())
                runner._aqe_planner = aqe_planner
                # driver-level query stats: each stage task runs its own
                # local executor (whose stats only cover that fragment);
                # this context spans the whole query, so its
                # resilience-counter delta carries every recovery event
                # of the run into explain_analyze and the dashboard
                stats = obs.new_query_stats()
                stats.plan = pplan
            it = runner.run(stage_plan)
        except BaseException:
            tracing.abort_trace(tctx)
            raise
        try:
            # each pull runs under (a) the query's span context, so the
            # stage runner / task supervisor / driver-side exchange spans
            # join the merged trace, and (b) a nested scope, so fragment
            # executors' set_last_stats never fire the per-query exports
            while True:
                with obs.nested_scope(), tracing.attach(stats.trace_ctx):
                    try:
                        p = next(it)
                    except StopIteration:
                        break
                yield p
        finally:
            # the export chain (set_last_stats → finalize_query) must
            # run even when the stage runner's generator cleanup — or
            # finish() itself — raises; otherwise the trace recorder
            # outlives the query (daft-lint: trace-recorder-leak)
            try:
                with obs.nested_scope(), tracing.attach(stats.trace_ctx):
                    it.close()
                stats.finish()
            finally:
                obs.set_last_stats(stats)

    # ------------------------------------------------------------- AQE
    def _adaptive_logical(self, builder, cfg):
        """Distributed port of ``NativeRunner._run_adaptive``'s planning
        loop (the reference's next_stage/update_stats): the cheapest
        unmeasured join input materializes through the DISTRIBUTED stage
        runner (workers, shuffle plane, resilience included), an
        in-memory source carrying its ACTUAL rows/bytes replaces the
        subtree, and the whole optimizer re-runs — repeated until every
        join input is measured. → (final logical plan, the AdaptivePlanner
        holding the re-plan history, shared with the stage runner's
        boundary-level re-planner)."""
        from .. import observability as obs
        from ..logical import plan as lp
        from ..logical.optimizer import Optimizer
        from ..physical import adaptive
        from .native_runner import _pick_join_input, _replace_subtree

        planner = adaptive.new_planner(cfg)
        plan = Optimizer().optimize(builder._plan)
        for _round in range(32):  # bound the loop defensively
            target = _pick_join_input(plan)
            if target is None:
                break
            sub_runner = StageRunner(
                self._get_manager(),
                self._scheduler or LeastLoadedScheduler())
            sub_runner._aqe_planner = planner
            with obs.nested_scope():  # no per-query exports mid-loop
                parts = [p for p in sub_runner.run(
                    StagePlan.from_physical(translate(target)))
                    if len(p)]
            rows = sum(len(p) for p in parts)
            size = sum(int(p.size_bytes() or 0) for p in parts)
            src = lp.Source(partitions=parts, schema=target.schema(),
                            num_partitions=max(len(parts), 1))
            planner.record_replan(
                f"materialized join input distributed ({rows} rows, "
                f"{size} bytes actual) → re-optimized remainder",
                rows, size)
            plan = _replace_subtree(plan, target, src)
            plan = Optimizer().optimize(plan)
        return plan, planner
