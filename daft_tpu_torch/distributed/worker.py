"""Worker abstraction for distributed stage execution.

Reference: the flotilla Worker/WorkerManager traits
(``src/daft-distributed/src/scheduling/worker.rs:13-25``) whose first
implementation is a Ray actor per node; here the first implementation is an
in-process worker (one per mesh device group / CPU slice), and the seam is
identical: ``submit`` returns a future of materialized partitions, so a
multi-host gRPC worker drops in without touching the scheduler.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..micropartition import MicroPartition
from ..physical import plan as pp

#: map-side combine: merge buffered per-partition state only once the
#: buffer rivals the state (LSM-style amortization, same rule as the
#: local fused reducer in execution/pipeline.py)
_COMBINE_REAGG_ROWS = 1 << 16


@dataclass
class ShuffleOutSpec:
    """Map-side instruction: partition this task's output into the
    worker-local shuffle cache instead of returning rows.

    ``kind``:
    - ``hash``  — hash-partition by ``by`` into ``num_partitions``.
    - ``store`` — store the whole output as partition 0 and (when
      ``sample_k`` > 0) return a key sample for driver-side boundary
      computation: phase 1 of the distributed range/sort protocol.
    - ``range`` — range-partition by ``by`` against ``boundaries_ipc``
      (arrow-IPC boundary rows): phase 2; rows move worker→worker, the
      driver only ever sees samples, boundaries and receipts.

    ``combine_aggs``/``combine_by`` (hash only) switch on the MAP-SIDE
    COMBINE: each partition's morsels are pre-aggregated to one
    group-state table before ``ShuffleCache.push``, so the wire carries
    group states instead of per-morsel rows (Partial Partial Aggregates).
    The combine exprs are self-merge aggs over the map-output (wire)
    schema and PRESERVE it, so the reduce side is byte-compatible with the
    uncombined plan; the stage planner only attaches them when the
    consumer is a decomposable final aggregation and the cost model prices
    the wire savings above the extra agg pass
    (``stages.combine_for_boundary`` + ``costmodel.shuffle_combine_wins``)."""

    num_partitions: int
    by: tuple  # key Expressions
    kind: str = "hash"
    descending: tuple = ()
    boundaries_ipc: Optional[bytes] = None
    sample_k: int = 0
    combine_aggs: Optional[tuple] = None  # merge exprs over the wire schema
    combine_by: tuple = ()                # combine group keys (boundary keys)


@dataclass
class ShuffleResult:
    """Map-side receipt: where a task's shuffled output is served from
    (flotilla: the shuffle cache registration a reduce task fetches by).

    ``rows``/``nbytes`` are the EXACT pushed cardinality and on-disk
    bytes of this map output, and ``state_rows`` (combine path only) the
    pushed group-state count — an upper bound on the boundary keys' NDV
    this task saw. The runtime re-planner (round 20) folds these actuals
    into downstream stage decisions before dispatching them."""

    address: str
    shuffle_id: str
    num_partitions: int
    rows: int
    samples_ipc: Optional[bytes] = None
    nbytes: int = 0
    state_rows: Optional[int] = None


@dataclass
class FetchSpec:
    """Reduce-side stage input: pull partition ``partition`` from every
    listed (address, shuffle_id) map output and concat. ``keys`` are
    stable per-source identities (stage/map-task derived, NOT the
    run-specific shuffle uuid) so fault-injection decisions replay
    bit-identically across runs."""

    sources: List  # [(address, shuffle_id)]
    partition: int
    keys: Optional[List[str]] = None


@dataclass
class StageTask:
    """One dispatchable unit: an exchange-free plan fragment plus its
    stage-input bindings (flotilla's SwordfishTask shape,
    ``scheduling/task.rs:80``). ``stage_inputs`` values are either
    materialized partition lists or a ``FetchSpec`` the worker resolves
    through the shuffle service."""

    stage_id: int
    plan: pp.PhysicalPlan
    stage_inputs: Dict[int, object]
    task_idx: int = 0
    preferred_worker: Optional[str] = None
    shuffle_out: Optional[ShuffleOutSpec] = None
    # resilience plane: stable task identity for fault injection/lineage
    # (minted by the stage planner) and the dispatch attempt number (set
    # by the task supervisor; travels over the remote-worker wire)
    fault_key: str = ""
    attempt: int = 0
    # tracing plane: (trace_id, run_span_id, parent_span_id) minted by
    # the task supervisor from the stable fault key — the worker records
    # its task-run span under exactly these ids (travels over the
    # remote-worker wire too); None = untraced query
    trace_ctx: Optional[tuple] = None


def _chaos_serialized() -> bool:
    from .. import knobs
    return bool(knobs.env_bool("DAFT_TORCH_CHAOS_SERIALIZE"))


def fetch_parallelism() -> int:
    """Bounded per-source fetch concurrency for a reduce task's stage
    input (``DAFT_TORCH_SHUFFLE_FETCH_PARALLELISM``, default 4).
    ``DAFT_TORCH_CHAOS_SERIALIZE=1`` forces 1 — deterministic sequential
    source order, bit-identical to the pre-parallel fetch path, which is
    what keeps the chaos-replay contract. An ACTIVE FAULT PLAN also
    defaults to 1 (explicit env setting wins): the parallel pool rolls
    EVERY source's injection decision on every attempt — a failing source
    no longer short-circuits the later ones — which multiplies injected
    faults (crash faults really destroy their sources) per retry and
    exhausts retry budgets the resilience plane's chaos scenarios were
    tuned for. Chaos runs measure recovery, not fetch throughput."""
    if _chaos_serialized():
        return 1
    from .. import knobs
    env = knobs.env_raw("DAFT_TORCH_SHUFFLE_FETCH_PARALLELISM")
    if env is not None:
        try:
            return max(int(env), 1)
        except ValueError:
            pass  # unparsable → the fault-plan-aware default below
    from .resilience import active_fault_plan
    return 1 if active_fault_plan() is not None else 4


def _stream_safe(plan: pp.PhysicalPlan, sid: int,
                 has_shuffle_out: bool) -> bool:
    """True when delivering a FetchSpec binding as MULTIPLE morsels (one
    per source, as fetches land) preserves the fragment's semantics:

    - the unique direct consumer of ``StageInput(sid)`` is a final
      grouped/global Aggregate whose aggs are all self-merges — the
      executor's streaming merge-agg re-merges across morsels
      (``LocalExecutor._merge_agg_stream``), so fetch overlaps reduce
      compute; or
    - every node between the root and the StageInput is row-local
      (Project/Filter/Unpivot) AND the task shuffles
      out — the morsels are re-partitioned into the cache, so output
      granularity is invisible downstream.

    Everything else (Dedup, joins, limits, bare passthrough returning
    partitions) gets today's single concatenated morsel."""
    from ..aggs import merge_exprs_for
    parents: List = []
    row_local = (pp.Project, pp.Filter, pp.Unpivot)

    def walk(n, ancestors_row_local):
        for c in n.children:
            if isinstance(c, pp.StageInput) and c.stage_id == sid:
                parents.append((n, ancestors_row_local))
            walk(c, ancestors_row_local and isinstance(n, row_local))

    if isinstance(plan, pp.StageInput) and plan.stage_id == sid:
        return has_shuffle_out  # bare passthrough → repartitioned anyway
    walk(plan, True)
    if len(parents) != 1:
        return False
    parent, chain_row_local = parents[0]
    if isinstance(parent, pp.Aggregate) \
            and merge_exprs_for(parent.aggs, alias_to="out") is not None:
        return True
    return has_shuffle_out and chain_row_local \
        and isinstance(parent, row_local)


class _ParallelFetch:
    """Lazy reduce-side stage-input binding: fans a FetchSpec's per-source
    fetches onto a bounded thread pool the moment the task resolves its
    inputs, and yields the per-source tables IN SOURCE ORDER as morsels —
    fetch overlaps whatever the executor is doing instead of blocking on a
    full ``pa.concat_tables`` barrier.

    - ``streaming=True`` yields one MicroPartition per source (consumers
      vetted by ``_stream_safe``); ``False`` concatenates to a single
      morsel at the end — the sources still fetched concurrently.
    - Failures surface on iteration as ``ShuffleFetchError`` for the first
      failing source in order; ``FetchRetryState`` at the task supervisor
      (or the driver's backed-off fetch) stays the SINGLE retry policy —
      this class adds none of its own.
    - Per-source ``keys`` keep their stable identities, so injected fault
      decisions replay exactly; under ``DAFT_TORCH_CHAOS_SERIALIZE=1`` the
      supervisor resolves inputs eagerly+sequentially instead (see
      ``resolve_stage_inputs``) and this class is never constructed."""

    def __init__(self, spec: FetchSpec, streaming: bool = False):
        from .. import tracing
        self.spec = spec
        self.streaming = streaming
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._futs: Optional[List] = None
        self._cached: Optional[List[MicroPartition]] = None
        self._t0 = time.perf_counter()
        k = min(fetch_parallelism(), max(len(spec.sources), 1))
        if k > 1:
            from .shuffle_service import fetch_partition
            # carry the task thread's span context onto the fetch pool so
            # per-source fetch spans join the query trace
            tctx = tracing.current()
            self._pool = cf.ThreadPoolExecutor(
                max_workers=k, thread_name_prefix="daft-torch-fetch")
            self._futs = [
                self._pool.submit(tracing.run_attached, tctx,
                                  fetch_partition, address, shuffle_id,
                                  spec.partition, fault_key=self._key(j))
                for j, (address, shuffle_id) in enumerate(spec.sources)]

    def _key(self, j: int) -> Optional[str]:
        keys = self.spec.keys
        return keys[j] if keys and j < len(keys) else None

    def __del__(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)

    def _tables(self):
        """Per-source tables in source order (None/empty skipped)."""
        if self._futs is not None:
            try:
                for fut in self._futs:
                    t = fut.result()
                    if t is not None and t.num_rows:
                        yield t
            finally:
                self._pool.shutdown(wait=False, cancel_futures=True)
                self._futs = None
        else:
            from .shuffle_service import fetch_partition
            for j, (address, shuffle_id) in enumerate(self.spec.sources):
                t = fetch_partition(address, shuffle_id,
                                    self.spec.partition,
                                    fault_key=self._key(j))
                if t is not None and t.num_rows:
                    yield t

    def __iter__(self):
        from ..recordbatch import RecordBatch
        from .shuffle_service import shuffle_count
        if self._cached is not None:
            # a plan can reference the same StageInput twice (e.g. a
            # self-join over one shuffled upstream): the second
            # consumption replays the materialized morsels like the
            # pre-parallel list binding did — never refetches (which
            # would double wire traffic AND roll fresh injection
            # decisions mid-task)
            yield from self._cached
            return
        tables = self._tables()
        if not self.streaming:
            import pyarrow as pa
            buf = list(tables)
            tables = iter([pa.concat_tables(buf)]
                          if len(buf) > 1 else buf)
        acc: List[MicroPartition] = []
        try:
            for t in tables:
                mp = MicroPartition.from_recordbatch(
                    RecordBatch.from_arrow_table(t))
                acc.append(mp)
                yield mp
        finally:
            # actual wall the multi-source fetch occupied (overlapped);
            # compare against the per-call fetch_wall_us sum for the
            # parallel-vs-serial evidence
            shuffle_count("fetch_span_us",
                          (time.perf_counter() - self._t0) * 1e6)
        self._cached = acc  # only a fully-drained iteration is replayable


def _fetch_spec_eager(binding: FetchSpec) -> List[MicroPartition]:
    """The pre-parallel fetch path: sequential source order, one fully
    concatenated morsel. Kept verbatim as the DAFT_TORCH_CHAOS_SERIALIZE
    mode so PR 2's replay tests observe bit-identical event sequences."""
    from ..recordbatch import RecordBatch
    from .shuffle_service import fetch_partition
    tables = []
    for j, (address, shuffle_id) in enumerate(binding.sources):
        fkey = binding.keys[j] \
            if binding.keys and j < len(binding.keys) else None
        t = fetch_partition(address, shuffle_id, binding.partition,
                            fault_key=fkey)
        if t is not None and t.num_rows:
            tables.append(t)
    if not tables:
        return []
    import pyarrow as pa
    merged = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
    return [MicroPartition.from_recordbatch(
        RecordBatch.from_arrow_table(merged))]


def resolve_stage_inputs(stage_inputs: Dict[int, object],
                         plan: Optional[pp.PhysicalPlan] = None,
                         shuffle_out: Optional[ShuffleOutSpec] = None
                         ) -> Dict[int, object]:
    """Resolve FetchSpec bindings through the shuffle service.

    Default: each FetchSpec becomes a lazy :class:`_ParallelFetch` whose
    per-source fetches start immediately on a bounded pool; when ``plan``
    shows multi-morsel delivery is safe (``_stream_safe``) the executor
    consumes sources as they land — pipelined fetch. Under
    ``DAFT_TORCH_CHAOS_SERIALIZE=1`` everything degrades to the eager,
    sequential, fully-concatenating path for bit-identical chaos replay."""
    out: Dict[int, object] = {}
    serialized = _chaos_serialized()
    for sid, binding in stage_inputs.items():
        if isinstance(binding, FetchSpec):
            if serialized:
                out[sid] = _fetch_spec_eager(binding)
            else:
                streaming = plan is not None \
                    and len(binding.sources) > 1 \
                    and _stream_safe(plan, sid, shuffle_out is not None)
                out[sid] = _ParallelFetch(binding, streaming=streaming)
        else:
            out[sid] = binding
    return out


def _task_device():
    """The device a stage task's executor runs its fused fragments on:
    this process's query device (``backend.resolve_device``; None = the
    host tier). In-process workers share the driver's; a remote worker
    resolves its own from its environment."""
    from ..device import backend
    return backend.resolve_device()


def _worker_lane() -> str:
    """Trace lane for this worker thread (the InProcessWorker pool names
    threads ``daft-torch-<worker_id>_N``)."""
    name = threading.current_thread().name
    if name.startswith("daft-torch-"):
        name = name[len("daft-torch-"):]
    return f"worker:{name.rsplit('_', 1)[0]}"


def run_task(task: StageTask) -> object:
    """Execute one stage task on the local streaming executor. Returns a
    partition list, or a ShuffleResult when the task shuffles out. A
    traced task (``task.trace_ctx``) records its ``task:run`` span —
    and everything under it (fetches, operators, device dispatches) —
    under the supervisor-minted span ids."""
    import time as _time

    from .. import observability as obs
    from .. import tracing
    rec = span_id = parent_id = None
    if task.trace_ctx is not None:
        trace_id, span_id, parent_id = task.trace_ctx
        rec = tracing.recorder_for(trace_id)
    t0_us = int(_time.time() * 1e6)
    status = "ok"
    try:
        with obs.nested_scope(), \
                tracing.attach(tracing.SpanContext(rec, span_id)
                               if rec is not None else None):
            return _run_task_body(task)
    except BaseException:
        status = "error"
        raise
    finally:
        if rec is not None:
            rec.add("task:run", span_id, parent_id, t0_us,
                    int(_time.time() * 1e6) - t0_us,
                    attrs={"task": task.fault_key
                           or f"s{task.stage_id}.t{task.task_idx}",
                           "attempt": task.attempt},
                    lane=_worker_lane(), status=status)


def _run_task_body(task: StageTask) -> object:
    from ..execution.executor import LocalExecutor
    from .resilience import active_fault_plan
    plan = active_fault_plan()
    if plan is not None:  # injection site 1: task execution
        plan.maybe_fail("task",
                        task.fault_key or f"s{task.stage_id}.t{task.task_idx}",
                        attempt=task.attempt)
    ex = LocalExecutor(_task_device())
    inputs = resolve_stage_inputs(task.stage_inputs, plan=task.plan,
                                  shuffle_out=task.shuffle_out)
    stream = ex.run(task.plan, stage_inputs=inputs)
    if task.shuffle_out is None:
        return list(stream)
    from ..recordbatch import RecordBatch
    from .shuffle_service import ShuffleCache, get_local_shuffle_server
    spec = task.shuffle_out
    by = list(spec.by)
    cache = ShuffleCache()
    rows = 0
    state_rows = None
    samples_ipc = None
    # a failure while draining the stream (task fault, fetch fault on a
    # lazily resolved input, partitioning error) must delete the cache's
    # spill directory NOW: until server.register() below transfers
    # ownership, nothing else will — the orphan TTL sweep only covers
    # crashed processes, so every retried task used to leak a
    # daft_torch_shuffle dir for the process lifetime (found by daft-lint's
    # shuffle-cache-leak flow check)
    try:
        if spec.kind == "hash":
            if spec.combine_aggs:
                rows, state_rows = _hash_shuffle_combined(stream, cache,
                                                          spec, by)
            else:
                # daft-lint: allow(uncancellable-loop) -- the stream is
                # LocalExecutor.run, which checks the task's cancel token
                # before every morsel it yields
                for mp in stream:
                    rows += len(mp)
                    for i, piece in enumerate(
                            mp.partition_by_hash(by, spec.num_partitions)):
                        if len(piece):
                            cache.push(i,
                                       piece.combined().to_arrow_table())
        elif spec.kind == "store":
            sampled = []
            # daft-lint: allow(uncancellable-loop) -- the stream is
            # LocalExecutor.run, which checks the task's cancel token
            # before every morsel it yields
            for mp in stream:
                rows += len(mp)
                if len(mp):
                    rb = mp.combined()
                    cache.push(0, rb.to_arrow_table())
                    if spec.sample_k > 0:
                        s = rb.sample(size=min(spec.sample_k, len(rb)))
                        sampled.append(s.eval_expression_list(by))
            if sampled:
                merged = RecordBatch.concat(sampled)
                if len(merged) > spec.sample_k:
                    merged = merged.sample(size=spec.sample_k)
                samples_ipc = _ipc_bytes(merged.to_arrow_table())
        elif spec.kind == "range":
            boundaries = RecordBatch.from_arrow_table(
                _ipc_table(spec.boundaries_ipc))
            desc = list(spec.descending) or [False] * len(by)
            # daft-lint: allow(uncancellable-loop) -- the stream is
            # LocalExecutor.run, which checks the task's cancel token
            # before every morsel it yields
            for mp in stream:
                rows += len(mp)
                for i, piece in enumerate(
                        mp.combined().partition_by_range(
                            by, boundaries, desc)):
                    if len(piece):
                        cache.push(i, piece.to_arrow_table())
        else:
            raise ValueError(f"shuffle-out kind {spec.kind!r}")
        server = get_local_shuffle_server()
        server.register(cache)
    except BaseException:
        cache.cleanup()
        raise
    _, nbytes, _ = cache.stats()  # sealed by register(): sizes are final
    return ShuffleResult(server.address, cache.shuffle_id,
                         spec.num_partitions, rows, samples_ipc,
                         nbytes=nbytes, state_rows=state_rows)


def _hash_shuffle_combined(stream, cache, spec: ShuffleOutSpec,
                           by: list) -> tuple:
    """Map-side combine (Partial Partial Aggregates): hash-partition every
    morsel, but pre-aggregate each partition's buffered pieces to ONE
    group-state table before pushing — the wire carries group states, not
    per-morsel rows. The combine exprs are self-merge aggs over the wire
    schema (``stages.combine_for_boundary``), so the pushed schema is
    byte-identical to the uncombined path and the reduce side needs no
    changes. Buffers merge LSM-style (only once the buffer rivals the
    state) so re-aggregation stays O(log n) passes; peak residency is
    BUDGET-BOUNDED (round 19): when the summed partition states outgrow
    the breaker budget, the largest state flushes to the (always-on-disk)
    ShuffleCache mid-stream and restarts — pushing a partition's state in
    several pieces is exactly what the uncombined path does with raw
    rows, so the reduce side's merge agg is unchanged and a map task
    over an unbounded-NDV boundary composes with the exchange paths
    instead of holding its whole group state."""
    from ..execution.memory import breaker_budget_bytes, spill_count
    from .shuffle_service import shuffle_count
    n = spec.num_partitions
    budget = breaker_budget_bytes()
    caggs = list(spec.combine_aggs)
    cby = list(spec.combine_by)
    state: List[Optional[MicroPartition]] = [None] * n
    sbytes = [0] * n
    buf: List[List[MicroPartition]] = [[] for _ in range(n)]
    bufrows = [0] * n
    rows = 0
    pushed = 0
    wire_schema = None

    def merge(i: int) -> None:
        if not buf[i]:
            return
        fresh = buf[i][0].concat(buf[i][1:]) if len(buf[i]) > 1 \
            else buf[i][0]
        merged = fresh if state[i] is None else state[i].concat([fresh])
        out = merged.agg(caggs, cby)
        state[i] = out.cast_to_schema(wire_schema) \
            if wire_schema is not None else out
        sbytes[i] = int(state[i].size_bytes() or 0)
        buf[i], bufrows[i] = [], 0

    def flush(i: int) -> None:
        nonlocal pushed
        if state[i] is not None and len(state[i]):
            pushed += len(state[i])
            cache.push(i, state[i].combined().to_arrow_table())
        state[i], sbytes[i] = None, 0

    # daft-lint: allow(uncancellable-loop) -- the stream is
    # LocalExecutor.run, which checks the task's cancel token
    # before every morsel it yields
    for mp in stream:
        rows += len(mp)
        if wire_schema is None and len(mp):
            wire_schema = mp.schema
        for i, piece in enumerate(mp.partition_by_hash(by, n)):
            if len(piece):
                buf[i].append(piece)
                bufrows[i] += len(piece)
                if bufrows[i] >= max(
                        _COMBINE_REAGG_ROWS,
                        0 if state[i] is None else len(state[i])):
                    merge(i)
                    while sum(sbytes) > budget:
                        j = max(range(n), key=lambda x: sbytes[x])
                        if sbytes[j] == 0:
                            break
                        spill_count("combine_state_flushes")
                        flush(j)
    for i in range(n):
        merge(i)
        flush(i)
    shuffle_count("combine_rows_in", rows)
    shuffle_count("combine_rows_out", pushed)
    # → (input rows, pushed group-state rows): the state count rides the
    # receipt as this task's exact boundary-key NDV bound (re-planner
    # evidence; mid-stream budget flushes only ever over-count it)
    return rows, pushed


def _ipc_bytes(table) -> bytes:
    import io

    import pyarrow as pa
    buf = io.BytesIO()
    with pa.ipc.new_stream(buf, table.schema) as w:
        w.write_table(table)
    return buf.getvalue()


def _ipc_table(data: bytes):
    import io

    import pyarrow as pa
    with pa.ipc.open_stream(io.BytesIO(data)) as r:
        return r.read_all()


class Worker:
    """Abstract worker: executes StageTasks, reports capacity."""

    id: str
    num_slots: int

    def submit(self, task: StageTask) -> "cf.Future":
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class InProcessWorker(Worker):
    """Runs stage fragments on a local streaming executor (per-host worker
    in a pod deployment; the only worker type on a single host)."""

    def __init__(self, worker_id: str, num_slots: int = 2):
        self.id = worker_id
        self.num_slots = num_slots
        self._pool = cf.ThreadPoolExecutor(
            max_workers=num_slots, thread_name_prefix=f"daft-torch-{worker_id}")

    def submit(self, task: StageTask) -> "cf.Future":
        return self._pool.submit(run_task, task)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


@dataclass
class WorkerState:
    worker: Worker
    active: int = 0


class WorkerManager:
    """Tracks workers and in-flight load; routes submissions through a
    scheduling policy (reference: ``scheduling/worker.rs`` WorkerManager +
    dispatcher)."""

    def __init__(self, workers: List[Worker]):
        self._lock = threading.Lock()
        self.states: Dict[str, WorkerState] = {
            w.id: WorkerState(w) for w in workers}

    @property
    def worker_ids(self) -> List[str]:
        return list(self.states)

    def snapshot(self) -> List[WorkerState]:
        with self._lock:
            return list(self.states.values())

    def dispatch(self, task: StageTask, worker_id: str
                 ) -> "cf.Future[List[MicroPartition]]":
        with self._lock:
            st = self.states[worker_id]
            st.active += 1
        fut = st.worker.submit(task)

        def _done(_):
            with self._lock:
                st.active -= 1

        fut.add_done_callback(_done)
        return fut

    def shutdown(self) -> None:
        for st in self.snapshot():
            st.worker.shutdown()
