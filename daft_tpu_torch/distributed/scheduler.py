"""Pluggable scheduling policies + the stage-driving runner.

Reference: flotilla's ``Scheduler`` trait and scheduler actor
(``src/daft-distributed/src/scheduling/scheduler/mod.rs:18-23``; default
locality/spread policy ``scheduler/default.rs``, linear policy
``scheduler/linear.rs``) — policies are pure functions over worker snapshots
so they unit-test against mock workers with no hardware, exactly like the
reference's ``scheduling/tests.rs``.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional

from ..micropartition import MicroPartition
from ..physical import plan as pp
from .resilience import (FetchRetryState, ResilienceContext, RetryPolicy,
                         ShuffleFetchError, TaskSupervisor, count)
from .stages import Boundary, Stage, StagePlan
from .topology import WorkerTopology
from .worker import (FetchSpec, ShuffleOutSpec, StageTask, WorkerManager,
                     WorkerState, _task_device)


def _sort_fragment_root(remainder, pid: int):
    """The remainder's global Sort node, when the fragment is shaped
    Project* → Sort(col keys) → StageInput(pid) — the shape the
    worker-side range-sort protocol handles. Projects above the sort are
    row-order-preserving, so per-range outputs concatenate to the global
    order."""
    n = remainder
    while isinstance(n, pp.Project):
        n = n.children[0]
    if isinstance(n, pp.Sort) \
            and isinstance(n.children[0], pp.StageInput) \
            and n.children[0].stage_id == pid \
            and all(e.op == "col" for e in n.sort_by):
        return n
    return None


class Scheduler:
    """Policy: pick a worker for a task given current worker states."""

    def pick(self, task: StageTask, states: List[WorkerState]) -> str:
        raise NotImplementedError


class RoundRobinScheduler(Scheduler):
    """Spread tasks evenly regardless of load (reference linear policy)."""

    def __init__(self):
        self._counter = itertools.count()

    def pick(self, task: StageTask, states: List[WorkerState]) -> str:
        if task.preferred_worker is not None:
            for st in states:
                if st.worker.id == task.preferred_worker:
                    return st.worker.id
        return states[next(self._counter) % len(states)].worker.id


class LeastLoadedScheduler(Scheduler):
    """Soft-affinity + least-active placement (reference default policy:
    WorkerAffinity falls back to Spread)."""

    def pick(self, task: StageTask, states: List[WorkerState]) -> str:
        if task.preferred_worker is not None:
            for st in states:
                if st.worker.id == task.preferred_worker \
                        and st.active < st.worker.num_slots:
                    return st.worker.id
        return min(states, key=lambda s: (s.active, s.worker.id)).worker.id


class StageRunner:
    """Drives a StagePlan: dispatches each stage's tasks through the
    scheduler, feeds results downstream. Hash boundaries whose consumer
    fragment is partition-local are planned by the PLACEMENT LAYER
    (``topology.WorkerTopology`` + the exchange-path decision ladder):

    - ``collective`` — producer and consumer live on one device mesh;
      the boundary repartitions through the mesh's all_to_all programs
      (``parallel/exchange.py``) and never touches the Flight wire;
    - ``hierarchical`` — across meshes; each mesh's map outputs exchange
      intra-mesh, then ONE Flight stream per mesh (not per worker)
      crosses the wire; per-mesh streams are all-or-nothing lineage
      units recomputed as whole exchange groups;
    - ``flight`` — today's per-worker shuffle service: map tasks spill
      hash-partitioned output into their worker's cache, reduce tasks
      fan out one-per-partition and fetch their slice from every map
      worker (the reference's flight-shuffle map/serve/fetch pipeline).

    Every other boundary materializes through the driver. Failures route
    through the resilience plane (``resilience.py``): bounded retries
    with backoff on other workers, per-worker quarantine, lineage
    recomputation of lost shuffle partitions, and speculative backups
    for stragglers. ``DAFT_TORCH_DISTRIBUTED_SHUFFLE=driver`` forces the
    materializing path; ``DAFT_TORCH_CHAOS_SERIALIZE=1`` degrades every
    boundary to the verbatim flight path for bit-identical replay."""

    def __init__(self, manager: WorkerManager,
                 scheduler: Optional[Scheduler] = None,
                 max_retries: Optional[int] = None):
        self.manager = manager
        self.scheduler = scheduler or LeastLoadedScheduler()
        self.max_retries = max_retries  # None → DAFT_TORCH_MAX_RETRIES
        self._rctx: Optional[ResilienceContext] = None
        # set by the distributed runner's AQE loop so the runtime
        # re-planner folds its decisions into the SAME history the
        # materialize-and-reoptimize rounds record into
        self._aqe_planner = None

    def _resilience(self) -> ResilienceContext:
        if self._rctx is None:
            self._rctx = ResilienceContext(
                policy=RetryPolicy(max_retries=self.max_retries))
        return self._rctx

    def _supervisor(self) -> TaskSupervisor:
        return TaskSupervisor(self._resilience(), self.manager,
                              self.scheduler)

    # ------------------------------------------------------------------
    @staticmethod
    def _shuffle_enabled() -> bool:
        from .. import knobs
        return knobs.env_str("DAFT_TORCH_DISTRIBUTED_SHUFFLE") != "driver"

    def run(self, stage_plan: StagePlan) -> Iterator[MicroPartition]:
        from . import replan
        # fresh resilience state per query: quarantines/lineage span
        # stages but not queries
        self._rctx = ResilienceContext(
            policy=RetryPolicy(max_retries=self.max_retries))
        consumer: Dict[int, tuple] = {}
        for s in stage_plan.stages:
            for b in s.boundaries:
                consumer[b.upstream] = (s, b)
        outputs: Dict[int, list] = {}
        #: producer output mode per stage: "mat" (partition list),
        #: "shuffled" (map receipts — per-worker OR per-mesh streams),
        #: "collective" (per-partition lists from an intra-mesh exchange)
        out_mode: Dict[int, str] = {}
        use_shuffle = self._shuffle_enabled()
        topo = WorkerTopology.detect(self.manager.worker_ids) \
            if use_shuffle else None
        # runtime re-planning (round 20, DAFT_TORCH_ADAPTIVE): boundary
        # actuals fold back into not-yet-dispatched stages — estimate
        # rewrites, combine gating, broadcast demotion, exchange rung —
        # disabled under the chaos-determinism contract
        rp = replan.StageReplanner(stage_plan,
                                   planner=self._aqe_planner) \
            if replan.adaptive_enabled() else None
        for stage in stage_plan.stages:
            if rp is not None:
                rp.before_stage(stage, consumer.get(stage.id), outputs,
                                out_mode)
            # this stage's output mode: the placement layer picks the
            # exchange path for its consumer boundary (collective /
            # hierarchical / flight), flight shuffles out when the
            # consumer can fan out over the hash partitions
            shuffle_out = None
            exch_path = None
            cons = consumer.get(stage.id)
            if use_shuffle and cons is not None:
                cstage, b = cons
                if b.num_partitions > 1 and b.kind == "hash" \
                        and all(ob.kind in ("hash", "gather")
                                for ob in cstage.boundaries):
                    inputs_mat = all(
                        out_mode.get(ob.upstream, "mat") == "mat"
                        for ob in stage.boundaries)
                    if stage_plan.collective_safe(cstage, b):
                        exch_path = self._plan_exchange_path(
                            topo, stage, b, inputs_mat, rp)
                    if exch_path in (None, "flight") and (
                            stage_plan.fanout_safe(cstage, b)
                            or stage_plan.split_for_fanout(cstage, b)
                            is not None):
                        exch_path = "flight"
                        shuffle_out = ShuffleOutSpec(b.num_partitions,
                                                     tuple(b.by))
                        combo = self._plan_combine(stage_plan, cstage, b,
                                                   stage, rp)
                        if combo is not None:
                            shuffle_out.combine_aggs, \
                                shuffle_out.combine_by = combo
            fetch_srcs: Dict[int, list] = {}
            fetch_n: Dict[int, int] = {}
            coll_inputs: Dict[int, list] = {}
            mat_inputs: Dict[int, List[MicroPartition]] = {}
            first_exchanged: Optional[Boundary] = None
            for b in stage.boundaries:
                up_out = outputs.pop(b.upstream)
                mode = out_mode.get(b.upstream, "mat")
                if mode == "shuffled":
                    fetch_srcs[b.upstream] = [(r.address, r.shuffle_id)
                                              for r in up_out]
                    fetch_n[b.upstream] = b.num_partitions
                    first_exchanged = first_exchanged or b
                elif mode == "collective":
                    coll_inputs[b.upstream] = up_out
                    first_exchanged = first_exchanged or b
                else:
                    mat_inputs[b.upstream] = self._apply_exchange(b, up_out)
            if exch_path == "hierarchical":
                # two-level exchange replaces the stage run entirely: the
                # producer's map tasks execute per mesh group, each
                # group's output repartitions intra-mesh and serves as
                # ONE stream (decision gated on all-materialized inputs)
                outputs[stage.id] = self._run_hierarchical_producer(
                    stage, mat_inputs, cons[1], topo)
                out_mode[stage.id] = "shuffled"
                continue
            if fetch_srcs or coll_inputs:
                ns = set(fetch_n.values()) \
                    | {len(pl) for pl in coll_inputs.values()}
                if len(ns) > 1:
                    # boundaries disagree on partition count — no shared
                    # fan-out exists; materialize driver-side instead
                    for up, srcs in fetch_srcs.items():
                        mat_inputs[up] = self._driver_fetch_resilient(
                            srcs, fetch_n[up], up)
                    for up, plists in coll_inputs.items():
                        mat_inputs[up] = [p for pl in plists for p in pl]
                    result = self._run_stage(stage, mat_inputs,
                                             shuffle_out)
                else:
                    result = self._run_shuffled_stage(
                        stage_plan, stage, fetch_srcs, coll_inputs,
                        mat_inputs, next(iter(ns)), first_exchanged,
                        shuffle_out)
                self._cleanup_shuffles(fetch_srcs)
            else:
                result = self._run_stage(stage, mat_inputs, shuffle_out)
            if exch_path == "collective":
                outputs[stage.id] = self._collective_repartition(
                    stage, result, cons[1])
                out_mode[stage.id] = "collective"
            else:
                outputs[stage.id] = result
                out_mode[stage.id] = "shuffled" \
                    if shuffle_out is not None else "mat"
            if rp is not None:
                rp.after_stage(stage, outputs[stage.id],
                               out_mode.get(stage.id, "mat"))
        yield from outputs[stage_plan.root.id]

    def _plan_combine(self, stage_plan: StagePlan, cstage: Stage,
                      b: Boundary, up_stage: Stage, rp=None):
        """Decide the map-side combine for one hash boundary: structural
        eligibility comes from the stage planner
        (``StagePlan.combine_for_boundary`` — the boundary must feed a
        final grouped aggregation whose aggs are all self-merges), then
        the cost model prices the modeled wire savings against the extra
        map-side agg pass (``costmodel.shuffle_combine_wins`` over the
        planner's row/NDV evidence). With the runtime re-planner active
        (round 20) the pricing uses the producing stage's MEASURED rows
        and — when affordable — the EXACT key NDV instead of footer
        estimates; a decision the static evidence would have gotten
        wrong is counted as a ``combine_flip``.
        ``DAFT_TORCH_SHUFFLE_COMBINE=1`` forces it, ``0`` is the escape
        hatch, default ``auto``."""
        from .. import knobs
        mode = knobs.env_str("DAFT_TORCH_SHUFFLE_COMBINE").lower()
        if mode in ("0", "off", "false", "none"):
            return None
        combo = stage_plan.combine_for_boundary(cstage, b, up_stage)
        if combo is None:
            return None
        combine_aggs, combine_by, agg_node = combo
        if mode not in ("1", "on", "force", "true"):
            from ..device import costmodel
            from ..physical import adaptive
            rows = getattr(agg_node, "group_rows_est", None)
            groups = getattr(agg_node, "group_ndv", None)
            n_cols = len(combine_aggs) + len(combine_by)
            ev = rp.combine_evidence(up_stage) if rp is not None else None
            e_rows, e_groups, exact = rows, groups, False
            if ev is not None:
                m_rows, m_ndv, m_exact = ev
                e_rows = m_rows
                if m_ndv is not None:
                    e_groups, exact = m_ndv, m_exact
            decision = costmodel.shuffle_combine_wins(
                e_rows, e_groups, b.num_partitions, n_cols=n_cols,
                exact_groups=exact)
            if rp is not None and ev is not None:
                static = costmodel.combine_wins_pure(
                    rows, groups, b.num_partitions, n_cols=n_cols)
                if static != decision:
                    adaptive.count("combine_flips")
                    rp.planner.record_replan(
                        f"stage s{up_stage.id}: map-side combine "
                        f"{'enabled' if decision else 'declined'} from "
                        f"measured evidence (rows={e_rows} "
                        f"groups={e_groups} exact={exact}; static said "
                        f"{'combine' if static else 'no combine'})",
                        int(e_rows or 0))
            if not decision:
                return None
        return combine_aggs, combine_by

    # -------------------------------------- mesh-aware exchange paths
    def _plan_exchange_path(self, topo: WorkerTopology, stage: Stage,
                            b: Boundary, inputs_mat: bool,
                            rp=None) -> str:
        """Placement decision for one structurally-eligible hash
        boundary (consumer whole-stage fanout-safe): collective /
        hierarchical / flight per the topology decision ladder
        (``topology.plan_exchange_path``). Hierarchical additionally
        requires the producer's own inputs to be driver-materialized —
        its map tasks re-dispatch per mesh group, which the shuffled
        input bindings don't survive. With the runtime re-planner
        active, the ladder prices from the producing stage's MEASURED
        rows and row widths instead of the evidence-free default-accept;
        a rung the evidence changed is counted ``exchange_repicks``.
        Every decision is counted in the shuffle data plane
        (``exchange_path_*``)."""
        from ..physical import adaptive
        from . import topology as tp
        from .shuffle_service import shuffle_count
        ev = rp.exchange_evidence(stage) if rp is not None else None
        if ev is not None:
            rows_est, row_bytes = ev
            path = tp.plan_exchange_path(topo, b.num_partitions,
                                         rows_est=rows_est,
                                         row_bytes=row_bytes)
            # evidence-free, the auto ladder default-accepts the
            # collective family on structural grounds alone — a flip to
            # flight here is the measured evidence talking
            structural = "collective" if topo.single_mesh() else (
                "hierarchical" if topo.multi_worker_groups() >= 1
                else "flight")
            forced = tp._path_setting() in tp.PATHS
            if not forced and path != structural \
                    and structural != "flight":
                adaptive.count("exchange_repicks")
                rp.planner.record_replan(
                    f"stage s{stage.id}: exchange rung "
                    f"{structural}→{path} from measured rows="
                    f"{int(rows_est)} row_bytes={row_bytes:.1f}",
                    int(rows_est))
        else:
            path = tp.plan_exchange_path(topo, b.num_partitions)
        if path == "hierarchical" and not inputs_mat:
            path = "flight"
        shuffle_count(f"exchange_path_{path}")
        return path

    def _collective_repartition(self, stage: Stage, parts: list,
                                b: Boundary) -> list:
        """Execute one hash boundary as an intra-mesh collective: the
        stage's output repartitions through the device mesh
        (``sharded_hash_repartition`` — memoized, shape-bucketed) with a
        host hash fanout as the admission fallback, and NEVER touches
        the Flight wire. Returns per-partition partition lists the
        consumer's reduce tasks bind directly."""
        from . import topology as tp
        from .. import tracing
        key = stage.task_key(0, "cx")
        lease = tp.acquire_collective(key)
        try:
            with tracing.span("exchange:collective",
                              key=f"exchange:{key}",
                              attrs={"partitions": b.num_partitions},
                              lane="shuffle") as sp:
                return self._intra_mesh_repartition(
                    parts, list(b.by), b.num_partitions, sp)
        finally:
            tp.release_collective(lease)

    def _intra_mesh_repartition(self, parts: list, by: list, n: int,
                                sp=None) -> list:
        """One hash repartition that stays inside the mesh: the mesh
        collective program when the admission gate prices it in
        (``mesh.mesh_admits`` over the exact bytes), else a host hash
        fanout of the same pid chain — both agree with
        ``partition_by_hash``, so every path is bit-co-partitioned.
        → n bucket lists."""
        from ..execution.executor import LocalExecutor
        parts = [p for p in parts if len(p)]
        rows = sum(len(p) for p in parts)
        mesh_out = None
        if parts:
            # a planned decline (no mesh, admission, dtypes) returns None
            # and the host fanout below runs; a failure inside the
            # collective itself propagates
            mesh_out = LocalExecutor(_task_device())._mesh_hash_repartition(
                list(parts), list(by), n)
        if sp is not None:
            from ..device import costmodel
            sp.set("rows", rows)
            sp.set("bytes", sum(p.size_bytes() for p in parts))
            sp.set("ici", mesh_out is not None)
            if mesh_out is not None:
                sp.set("ici_bps", int(costmodel.ici_bps()))
        if mesh_out is not None:
            return [[p] for p in mesh_out]
        buckets: List[list] = [[] for _ in range(n)]
        for mp in parts:
            for i, piece in enumerate(mp.partition_by_hash(list(by), n)):
                if len(piece):
                    buckets[i].append(piece)
        # one combined morsel per bucket — the binding a reduce task
        # receives must look exactly like a fetched+concatenated flight
        # partition (a multi-piece binding would execute the consumer
        # fragment per piece, not per partition)
        return [[b0[0].concat(b0[1:])] if len(b0) > 1 else b0
                for b0 in buckets]

    def _run_hierarchical_producer(self, stage: Stage,
                                   stage_inputs: Dict[int, list],
                                   b: Boundary, topo: WorkerTopology
                                   ) -> list:
        """Two-level hierarchical exchange, map side: the stage's tasks
        split across mesh groups; each group's outputs repartition
        intra-mesh (the collective leg) and register as ONE shuffle
        stream per mesh — the wire carries one stream per mesh instead
        of one per worker. Each per-mesh stream is an ALL-OR-NOTHING
        lineage unit: its producer is the whole exchange group
        (``topology.CollectiveExchangeGroup``), so losing the stream
        recomputes every member map task plus the collective, never one
        map task."""
        import concurrent.futures as cf
        import dataclasses as dc

        from . import topology as tp
        from .. import tracing
        from .resilience import active_fault_plan
        from .shuffle_service import shuffle_count
        tasks = self._make_tasks(stage, stage_inputs, None)
        groups = topo.groups
        lineage = self._resilience().lineage
        work = []  # (gi, group, its tasks) — deterministic split
        for gi, g in enumerate(groups):
            # round-robin tasks over groups; WITHIN a group spread over
            # its workers by group-local position (indexing by the raw
            # task_idx would alias with the group split whenever g.size
            # divides the group count, pinning a whole mesh to one
            # worker)
            gtasks = [dc.replace(
                t, preferred_worker=g.workers[
                    (t.task_idx // len(groups)) % g.size])
                for t in tasks if t.task_idx % len(groups) == gi]
            if gtasks:
                work.append((gi, g, gtasks))
        # meshes exchange CONCURRENTLY (the flight path dispatches every
        # map task at once — serializing per mesh would cost sum-of-mesh
        # walls instead of the max); fault-plan runs stay sequential so
        # injected-fault attempt counters advance in one total order
        if len(work) > 1 and active_fault_plan() is None:
            tctx = tracing.current()
            with cf.ThreadPoolExecutor(
                    max_workers=len(work),
                    thread_name_prefix="daft-torch-meshgrp") as pool:
                futs = [pool.submit(tracing.run_attached, tctx,
                                    self._run_one_mesh_group, stage, b,
                                    gi, g, gtasks)
                        for gi, g, gtasks in work]
                done = [f.result() for f in futs]  # group order
        else:
            done = [self._run_one_mesh_group(stage, b, gi, g, gtasks)
                    for gi, g, gtasks in work]
        receipts = []
        for (gi, g, gtasks), (receipt, rebuild) in zip(work, done):
            lineage.register(receipt, tp.CollectiveExchangeGroup(
                fault_key=stage.task_key(gi, "g"),
                group_tasks=list(gtasks), rebuild=rebuild))
            receipts.append(receipt)
        shuffle_count("hierarchical_streams", len(receipts))
        return receipts

    def _run_one_mesh_group(self, stage: Stage, b: Boundary, gi: int,
                            g, gtasks: list):
        """Run ONE mesh group's map tasks and build its merged per-mesh
        stream → (receipt, rebuild). The group lease spans the whole
        exchange; the rebuild closure is the lineage recovery recipe."""
        from . import topology as tp
        from .. import tracing
        gkey = stage.task_key(gi, "g")
        rebuild = self._group_receipt_builder(b, gkey)
        lease = tp.acquire_collective(gkey)
        try:
            with tracing.span("exchange:collective",
                              key=f"exchange:{gkey}",
                              attrs={"mesh": g.name,
                                     "tasks": len(gtasks),
                                     "partitions": b.num_partitions},
                              lane="shuffle"):
                outs = self._collect(gtasks)
                return rebuild(outs), rebuild
        finally:
            tp.release_collective(lease)

    def _group_receipt_builder(self, b: Boundary, gkey: str):
        """→ rebuild(task outputs) → per-mesh ShuffleResult. A closure so
        lineage recovery re-derives the receipt the same deterministic
        way the first run did (same boundary keys, same partition
        count)."""
        by = list(b.by)
        n = b.num_partitions

        def rebuild(outs: list):
            from .shuffle_service import (ShuffleCache,
                                          get_local_shuffle_server)
            from .worker import ShuffleResult
            parts: List[MicroPartition] = []
            for res in outs:
                parts.extend(res if isinstance(res, list) else [res])
            buckets = self._intra_mesh_repartition(parts, by, n)
            cache = ShuffleCache()
            rows = 0
            try:
                for i, plist in enumerate(buckets):
                    for p in plist:
                        rows += len(p)
                        cache.push(i, p.combined().to_arrow_table())
                server = get_local_shuffle_server()
                server.register(cache)
            except BaseException:
                cache.cleanup()
                raise
            _, nbytes, _ = cache.stats()
            return ShuffleResult(server.address, cache.shuffle_id, n,
                                 rows, nbytes=nbytes)

        return rebuild

    def _cleanup_shuffles(self, fetch_srcs: Dict[int, list]) -> None:
        """Best-effort release of consumed map outputs when the consuming
        stage completes, addressed straight to each serving host through
        the shuffle transport (the address is part of the map receipt —
        one call per shuffle id). Recovered outputs are released through
        their whole lineage translation chain (the recomputed replacement
        lives at a different address than the receipt)."""
        from .shuffle_service import unregister_remote
        lineage = self._resilience().lineage
        for srcs in fetch_srcs.values():
            for src in srcs:
                for address, shuffle_id in lineage.chain(tuple(src)):
                    try:
                        unregister_remote(address, shuffle_id)
                    except Exception:
                        pass

    # ------------------------------------------------------------------
    def _make_tasks(self, stage: Stage,
                    stage_inputs: Dict[int, List[MicroPartition]],
                    shuffle_out: Optional[ShuffleOutSpec] = None
                    ) -> List[StageTask]:
        """Shard a map-like scan stage across workers (contiguous chunks —
        preserves partition order); everything else is one task."""
        n_workers = len(self.manager.worker_ids)
        src = stage.scan_source()
        if n_workers > 1 and src is not None and len(src.tasks) > 1 \
                and stage.is_map_like():
            k = min(n_workers, len(src.tasks))
            per = (len(src.tasks) + k - 1) // k
            tasks = []
            for i in range(k):
                chunk = src.tasks[i * per:(i + 1) * per]
                if not chunk:
                    continue
                tasks.append(StageTask(stage.id, stage.with_scan_tasks(chunk),
                                       stage_inputs, task_idx=i,
                                       shuffle_out=shuffle_out,
                                       fault_key=stage.task_key(i)))
            return tasks
        return [StageTask(stage.id, stage.plan, stage_inputs,
                          shuffle_out=shuffle_out,
                          fault_key=stage.task_key(0))]

    def _run_stage(self, stage: Stage,
                   stage_inputs: Dict[int, List[MicroPartition]],
                   shuffle_out: Optional[ShuffleOutSpec] = None) -> list:
        tasks = self._make_tasks(stage, stage_inputs, shuffle_out)
        return self._collect(tasks)

    def _run_shuffled_stage(self, stage_plan: StagePlan, stage: Stage,
                            fetch_srcs: Dict[int, list],
                            coll_inputs: Dict[int, list],
                            mat_inputs: Dict[int, List[MicroPartition]],
                            n: int, b: Boundary,
                            shuffle_out: Optional[ShuffleOutSpec]) -> list:
        """Stage with shuffle- or collective-backed inputs: fan the whole
        fragment out when it is partition-local; otherwise fan out its
        safe frontier (e.g. the merge-agg under a Sort) and run the
        global remainder as one task; if neither applies, fetch
        partitions onto the driver."""
        # replicating a driver-materialized input to every reduce task is
        # only sound for GATHER boundaries (broadcast-by-design, join-type
        # gated at translate time). A materialized hash/range/split input
        # replicated beside a partitioned side would duplicate non-inner
        # join results — fall back to the driver for the whole stage.
        replication_ok = all(
            ob.kind == "gather" for ob in stage.boundaries
            if ob.upstream in mat_inputs)
        exchanged = set(fetch_srcs) | set(coll_inputs)
        if replication_ok and stage_plan.fanout_safe(stage, b) and all(
                stage_plan.fanout_safe(stage, ob)
                for ob in stage.boundaries if ob.upstream in exchanged):
            return self._run_reduce_fanout(stage, fetch_srcs, mat_inputs,
                                           n, shuffle_out, coll_inputs)
        if coll_inputs:
            # defensive: a collective input reaching a fanout-unsafe
            # consumer materializes EVERYTHING driver-side — a
            # hash-partitioned input must never replicate beside a
            # partitioned sibling (same rule as mat hash inputs above)
            for up, plists in coll_inputs.items():
                mat_inputs[up] = [p for pl in plists for p in pl]
            for up, srcs in fetch_srcs.items():
                mat_inputs[up] = self._driver_fetch_resilient(srcs, n, up)
            return self._run_stage(stage, mat_inputs, shuffle_out)
        split = stage_plan.split_for_fanout(stage, b) if replication_ok \
            else None
        if split is not None:
            sub, remainder, pid = split
            if all(StagePlan._contains_input(sub, up)
                   for up in fetch_srcs):
                sub_stage = Stage(stage.id, sub, [])
                sort_node = _sort_fragment_root(remainder, pid)
                if sort_node is not None and shuffle_out is None \
                        and self._shuffle_enabled():
                    return self._range_sort_remainder(
                        sub_stage, remainder, pid, sort_node,
                        fetch_srcs, mat_inputs, n)
                parts = self._run_reduce_fanout(sub_stage, fetch_srcs,
                                                mat_inputs, n, None)
                rest = Stage(stage.id, remainder, [])
                bindings: Dict[int, object] = {pid: parts}
                bindings.update(mat_inputs)
                return self._run_stage(rest, bindings, shuffle_out)
        # defensive fallback: materialize the shuffled inputs driver-side
        for up, srcs in fetch_srcs.items():
            mat_inputs[up] = self._driver_fetch_resilient(srcs, n, up)
        return self._run_stage(stage, mat_inputs, shuffle_out)

    def _range_sort_remainder(self, sub_stage: Stage, remainder, pid: int,
                              sort_node, fetch_srcs: Dict[int, list],
                              mat_inputs: Dict[int, List[MicroPartition]],
                              n: int) -> Optional[list]:
        """Distributed global sort with rows never touching the driver
        (the r2 verdict's scale ceiling: every range/sort boundary funneled
        through the driver). Three worker-side phases:

        1. the partition-local sub-fragment runs per hash partition with
           ``store`` shuffle-out: outputs stay in worker shuffle caches,
           each task returns a sort-key SAMPLE with its receipt;
        2. the driver computes range boundaries from the samples alone
           (KB, not rows) and dispatches per-receipt ``range`` repartition
           tasks — rows move worker→worker through the shuffle transport;
        3. one reduce task per range sorts its partition locally; the
           driver concatenates results in partition order, which IS the
           global order (ranges are disjoint and ordered).

        Shape gating happens in ``_sort_fragment_root`` BEFORE this is
        called; failures inside the protocol abort the query (same
        contract as the hash-shuffle path)."""
        from ..context import get_context
        from ..execution.executor import sample_boundaries
        from .worker import FetchSpec, ShuffleOutSpec, StageTask, _ipc_bytes
        cfg = get_context().execution_config
        by = list(sort_node.sort_by)
        desc = list(sort_node.descending)
        nf = list(sort_node.nulls_first)

        store = ShuffleOutSpec(1, tuple(by), kind="store",
                               sample_k=cfg.sample_size_for_sort)
        receipts = self._run_reduce_fanout(sub_stage, fetch_srcs,
                                           mat_inputs, n, store)
        try:
            from ..recordbatch import RecordBatch
            from .worker import _ipc_table
            samples = [RecordBatch.from_arrow_table(
                _ipc_table(r.samples_ipc))
                for r in receipts if r.samples_ipc]
            k = max(len(receipts), 1)
            names = [e.name() for e in by]
            boundaries = sample_boundaries(samples, names, desc, nf, k) \
                if samples else None
            if boundaries is None or k == 1:
                # no keys to sample or single partition: one sort task
                # reading every stored output through the shuffle service
                rest = Stage(sub_stage.id, remainder, [])
                bindings: Dict[int, object] = {pid: FetchSpec(
                    [(r.address, r.shuffle_id) for r in receipts], 0,
                    keys=[sub_stage.task_key(j, "p1")
                          for j in range(len(receipts))])}
                bindings.update(mat_inputs)
                return self._run_stage(rest, bindings, None)
            bipc = _ipc_bytes(boundaries.to_arrow_table())
            range_spec = ShuffleOutSpec(k, tuple(by), kind="range",
                                        descending=tuple(desc),
                                        boundaries_ipc=bipc)
            phase2 = [StageTask(
                sub_stage.id, pp.StageInput(pid, sort_node.schema()),
                {pid: FetchSpec([(r.address, r.shuffle_id)], 0,
                                keys=[sub_stage.task_key(j, "p1")])},
                task_idx=j, shuffle_out=range_spec,
                fault_key=sub_stage.task_key(j, "p2"))
                for j, r in enumerate(receipts)]
            receipts2 = self._collect(phase2)
        finally:
            self._cleanup_shuffles(
                {0: [(r.address, r.shuffle_id) for r in receipts]})
        srcs2 = [(r.address, r.shuffle_id) for r in receipts2]
        keys2 = [sub_stage.task_key(j, "p2") for j in range(len(receipts2))]
        try:
            tasks = []
            for i in range(k):
                bindings = {pid: FetchSpec(srcs2, i, keys=keys2)}
                bindings.update(mat_inputs)
                tasks.append(StageTask(sub_stage.id, remainder, bindings,
                                       task_idx=i,
                                       fault_key=sub_stage.task_key(i,
                                                                    "p3")))
            return self._collect(tasks)
        finally:
            self._cleanup_shuffles({0: srcs2})

    @staticmethod
    def _driver_fetch(srcs: list, n: int, keys: Optional[list] = None,
                      partition: Optional[int] = None
                      ) -> List[MicroPartition]:
        """Fetch partitions [0, n) — or just ``partition`` — from every
        source onto the driver."""
        from .worker import resolve_stage_inputs
        parts = range(n) if partition is None else [partition]
        out: List[MicroPartition] = []
        for i in parts:
            out.extend(resolve_stage_inputs(
                {0: FetchSpec(srcs, i, keys=keys)})[0])
        return out

    def _driver_fetch_resilient(self, srcs: list, n: int, up: int
                                ) -> List[MicroPartition]:
        """Driver-side materialization with the same fetch-failure
        handling the worker-side reduce tasks get (one shared
        ``FetchRetryState`` policy): a backed-off refetch first, lineage
        recomputation of the producing map task when the same source
        fails twice (its data is gone). Retries are per-partition, so
        one flaky fetch never refetches the whole boundary."""
        import time
        ctx = self._resilience()
        keys = [f"s{up}.m{j}" for j in range(len(srcs))]
        out: List[MicroPartition] = []
        for i in range(n):
            state = FetchRetryState(ctx.policy)
            while True:
                cur = [ctx.lineage.resolve(tuple(s)) for s in srcs]
                try:
                    out.extend(self._driver_fetch(cur, n, keys,
                                                  partition=i))
                    break
                except ShuffleFetchError as exc:
                    if state.should_recover(exc) \
                            and not self._supervisor().recover_source(
                                (exc.address, exc.shuffle_id), exc):
                        raise
                    count("retries")
                    time.sleep(ctx.policy.backoff_s(f"s{up}.p{i}",
                                                    state.attempts))
        return out

    def _run_reduce_fanout(self, stage: Stage, fetch_srcs: Dict[int, list],
                           mat_inputs: Dict[int, List[MicroPartition]],
                           n: int, shuffle_out: Optional[ShuffleOutSpec],
                           coll_inputs: Optional[Dict[int, list]] = None
                           ) -> list:
        """One reduce task per hash partition: task i binds each shuffled
        input to FetchSpec(partition=i) and each collective input to its
        already-exchanged partition-i bucket; driver-materialized
        bindings (broadcast/gather sides) replicate to every task. Fetch
        sources carry stable ``s<upstream>.m<map_idx>`` keys so injected
        faults replay identically across runs (the shuffle uuid does
        not)."""
        tasks = []
        for i in range(n):
            si: Dict[int, object] = {
                up: FetchSpec(srcs, i,
                              keys=[f"s{up}.m{j}"
                                    for j in range(len(srcs))])
                for up, srcs in fetch_srcs.items()}
            for up, plists in (coll_inputs or {}).items():
                si[up] = list(plists[i])
            si.update(mat_inputs)
            tasks.append(StageTask(stage.id, stage.plan, si, task_idx=i,
                                   shuffle_out=shuffle_out,
                                   fault_key=stage.task_key(i, "r")))
        return self._collect(tasks)

    def _collect(self, tasks: List[StageTask]) -> list:
        """Dispatch one batch of tasks through the resilient task
        supervisor (retry/quarantine/lineage/speculation live there) and
        flatten the per-task results in task order. A traced query gets
        one ``stage`` span per batch; the supervisor's per-task spans
        nest under it."""
        from .. import tracing
        sid = tasks[0].stage_id if tasks else -1
        with tracing.span("stage", key=f"stage:s{sid}",
                          attrs={"tasks": len(tasks)}):
            per_task = self._supervisor().run(tasks)
        out: list = []
        for res in per_task:
            out.extend(res if isinstance(res, list) else [res])
        return out

    # ------------------------------------------------------------------
    def _apply_exchange(self, b: Boundary, parts: List[MicroPartition]
                        ) -> List[MicroPartition]:
        """Execute one exchange boundary on the driver: the materializing
        map/reduce transport between stages (mesh-collective exchanges run
        inside stages as DeviceExchangeAgg programs instead)."""
        from ..execution.executor import LocalExecutor
        if not parts:
            return parts
        schema = parts[0].schema
        node = pp.Exchange(pp.InMemorySource(parts, schema), b.kind,
                           b.num_partitions, b.by, b.descending,
                           engine_inserted=b.engine_inserted)
        ex = LocalExecutor(_task_device())
        return list(ex.run(node))
