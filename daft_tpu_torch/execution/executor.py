"""Local executor: interprets a physical plan into a stream of
MicroPartitions.

Reference: ``daft_tpu/execution/executor.py`` (the pull-generator
interpreter; the push pipeline, ``execution/pipeline.py``, inherits every
handler from here and only rewires them). The scan source resolves scan
tasks ahead of the one it drains on a pool of its own, each under host
memory admission, and streams each file's batch in task order (the
prefetch-pipelined scan). Pipelined operators run on a shared pool with
an in-order window; the pipeline breakers stream their
input through spill stores under the breaker budget
(``execution/memory.py``): the external sort samples its keys while it
spills, then range-buckets and sorts bucket by bucket; hash, random and
range exchanges fan each morsel into a bucket store; a hash join over two
hash exchanges joins the co-partitioned pairs, and one without them runs
the grace hash join (``execution/out_of_core.py``); the sort-merge join
range-buckets both sides on one sampled boundary set. Every breaker polls
the query's cancel token in its drain loop.

The fused device fragment (``_exec_DeviceFragmentAgg``) takes one
source-file batch per dispatch, through windows of scan tasks served from
the device column cache and the bounded in-flight pipeline
(``device/pipeline.py``); a join's index generation goes to the device per
``joins.py``. A device error propagates; only a batch that is empty or
whose expressions or columns have no device form runs the host chain, and
it is counted.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import queue
import threading
import time
from typing import Callable, Iterator, List, Optional

import numpy as np

from .. import knobs
from ..context import get_context
from ..expressions import Expression, col
from ..micropartition import MicroPartition
from ..physical import plan as pp
from ..recordbatch import RecordBatch
from . import cancellation, memory
from .memory import MemoryManager

_POOL: Optional[cf.ThreadPoolExecutor] = None
_pools_lock = threading.Lock()


def _pool() -> cf.ThreadPoolExecutor:
    global _POOL
    if _POOL is not None:   # hot path: no lock once built
        return _POOL
    with _pools_lock:
        if _POOL is None:
            _POOL = cf.ThreadPoolExecutor(
                max_workers=max(os.cpu_count() or 4, 4),
                thread_name_prefix="daft-torch-exec")
        return _POOL


_SCAN_POOL: Optional[cf.ThreadPoolExecutor] = None


def _scan_pool() -> cf.ThreadPoolExecutor:
    """Dedicated pool for the prefetch-pipelined scan's producers
    (reference ``executor.py:50``). Not the shared pool: a producer
    blocked on its admission would otherwise hold a slot that a
    downstream operator's future needs to drain the very stream the head
    producer feeds (a deadlock once the window reaches the pool's
    size)."""
    global _SCAN_POOL
    if _SCAN_POOL is not None:
        return _SCAN_POOL
    with _pools_lock:
        if _SCAN_POOL is None:
            _SCAN_POOL = cf.ThreadPoolExecutor(
                max_workers=max((os.cpu_count() or 4) * 2, 8),
                thread_name_prefix="daft-torch-scan")
        return _SCAN_POOL


def _ordered_parallel(inputs: Iterator, fn: Callable,
                      width: Optional[int] = None) -> Iterator:
    """Map fn over inputs on the pool, yielding results in order with a
    bounded in-flight window (backpressure)."""
    from .. import observability as obs
    width = width or max((os.cpu_count() or 4), 4) * 2
    pool = _pool()
    pending: List[cf.Future] = []
    it = iter(inputs)
    done = False
    while True:
        while not done and len(pending) < width:
            try:
                x = next(it)
            except StopIteration:
                done = True
                break
            # carry the submitting thread's stats attribution onto the
            # pool worker: plane counters bumped inside fn credit the
            # query this morsel belongs to
            pending.append(pool.submit(
                obs.run_attributed, obs.current_attribution(), fn, x))
        if not pending:
            return
        yield pending.pop(0).result()


def run_plan(builder) -> Iterator[MicroPartition]:
    """Run a logical plan through the runner (optimize, translate, the
    local engine; ``runners/native_runner.py``)."""
    from ..runners.native_runner import get_runner
    return get_runner().run_iter(builder)


class LocalExecutor:
    """Interprets a physical plan into a stream of MicroPartitions.
    ``device`` is the torch device of the fused fragments, or None for the
    host tier."""

    def __init__(self, device=None):
        self.cfg = get_context().execution_config
        self.device = device
        # cooperative cancellation: the caller installs the query's token
        # (cancellation.cancel_scope); captured here, it rides the
        # executor into every stage thread
        self.cancel_token = cancellation.current_token()
        #: admission of the pipeline's slots: the bytes they keep on the
        #: device, held to the device cache's budget
        self.mem = MemoryManager(
            knobs.env_int("DAFT_TORCH_DEVICE_CACHE_BYTES"))
        #: admission of host bytes: scan-task loads and the out-of-core
        #: work units (join bucket pairs), held to DAFT_TORCH_MEMORY_LIMIT
        self.host_mem = MemoryManager(memory.memory_limit_bytes())
        #: stage-input bindings (``StageInput``): the distributed stage
        #: runner's partition lists or lazy shuffle fetches
        self.stage_inputs: dict = {}
        self._aqe_planner = None
        self._shared: dict = {}
        self._shared_lock = threading.Lock()
        #: the running query's ``observability.RuntimeStatsContext``
        self.stats = None

    def _aqe(self):
        if self._aqe_planner is None:
            from ..physical import adaptive
            self._aqe_planner = adaptive.new_planner(self.cfg)
        return self._aqe_planner

    def _poll_cancel(self) -> None:
        """Cancellation poll for blocking drain loops: a pipeline breaker
        drains its whole child before it yields anything, so the check at
        each yield would not see a cancel until the drain ended."""
        tok = self.cancel_token
        if tok is not None:
            tok.check()

    def run(self, plan: pp.PhysicalPlan,
            stage_inputs=None) -> Iterator[MicroPartition]:
        """The plan's output stream. The query's stats context is made
        now, so it adopts the caller's trace; the profiler capture, the
        progress bar and the per-pull attribution live in the stream,
        and its end publishes the stats (``observability.end_query``)."""
        from .. import observability as obs
        if stage_inputs:
            self.stage_inputs = stage_inputs
        stats = self.stats = obs.new_query_stats()
        stats.plan = plan

        def gen():
            capture = obs.profile_capture(self.device)
            tok = self.cancel_token
            it = None
            try:
                # every pull runs with this query's stats attributed on
                # the consumer thread, so the plane counters credit THIS
                # query even when others run at once
                with obs.attributed(stats):
                    it = obs.wrap_progress(self._exec(plan))
                while True:
                    if tok is not None:
                        tok.check()
                    with obs.attributed(stats):
                        try:
                            item = next(it)
                        except StopIteration:
                            break
                    yield item
            finally:
                # the capture stops and the stats publish even when
                # closing the stream raises
                try:
                    if it is not None:
                        with obs.attributed(stats):
                            it.close()
                finally:
                    obs.end_query(stats, capture)
        return gen()

    def _exec(self, node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        if getattr(node, "shared_consumers", 1) > 1:
            return self._shared_stream(node)
        return self._exec_node(node)

    def _exec_node(self, node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        h = getattr(self, "_exec_" + type(node).__name__, None)
        if h is None:
            raise NotImplementedError(f"executor for {type(node).__name__}")
        from ..analysis import plan_sanitizer
        it = plan_sanitizer.wrap_node(node, h(node))
        if self.stats is not None:
            return self.stats.instrument(node, it)
        return it

    def _shared_stream(self, node) -> Iterator[MicroPartition]:
        """A subplan with several consumers (``translate``) runs ONCE into
        a breaker-budget buffer that every consumer then streams; the last
        consumer to finish closes it (its memory and spill files go at
        once, not at GC). Thread-safe: the push executor's stages race
        here, the first builds and the rest wait."""
        with self._shared_lock:
            ent = self._shared.get(id(node))
            build = ent is None
            if build:
                ent = self._shared[id(node)] = {
                    "done": threading.Event(), "buf": None, "err": None,
                    "remaining": node.shared_consumers}
        if build:
            try:
                ent["buf"] = memory.materialize(
                    self._exec_node(node), memory.breaker_budget_bytes())
            except BaseException as exc:
                ent["err"] = exc
                raise
            finally:
                ent["done"].set()
        else:
            ent["done"].wait()
            if ent["err"] is not None:
                raise ent["err"]

        def serve():
            try:
                yield from iter(ent["buf"])
            finally:
                with self._shared_lock:
                    ent["remaining"] -= 1
                    last = ent["remaining"] <= 0
                    if last:
                        self._shared.pop(id(node), None)
                if last:
                    ent["buf"].close()
        return serve()

    # sources ----------------------------------------------------------
    def _morselize(self, stream: Iterator) -> Iterator:
        """Re-chunk a partition stream to ``default_morsel_size`` rows
        (reference: ``src/daft-local-execution/src/buffer.rs``)."""
        morsel = int(self.cfg.default_morsel_size or 0)
        if morsel <= 0:
            yield from stream
            return
        for p in stream:
            n = len(p)
            if n <= morsel + morsel // 2:
                yield p
                continue
            rb = p.combined()
            for start in range(0, n, morsel):
                yield MicroPartition.from_recordbatch(
                    rb.slice(start, min(start + morsel, n)))

    def _load_task(self, task) -> MicroPartition:
        """Load one scan task whole under host admission (its estimated
        bytes against ``DAFT_TORCH_MEMORY_LIMIT``), after the governor's
        bounded throttle: the scan source at ``DAFT_TORCH_SCAN_PREFETCH=0``
        (reference ``executor.py:266-276``)."""
        from . import governor
        governor.throttle("scan")
        est = task.size_bytes() or 0
        self.host_mem.acquire(est)
        try:
            return _load_with_retry(task)
        finally:
            self.host_mem.release(est)

    def _exec_ScanSource(self, node: pp.ScanSource):
        """One partition per scan task (one file, or several small ones
        merged), in task order: at the default through the
        prefetch-pipelined scan (:meth:`_prefetch_scan`), at
        ``DAFT_TORCH_SCAN_PREFETCH=0`` as whole-task loads on the pool."""
        from ..io import read_planner as rp
        if not node.tasks or rp.scan_sequential_fallback():
            yield from self._morselize(self._whole_tasks(node))
            return
        yield from self._morselize(
            self._prefetch_scan(node.tasks, rp.scan_prefetch_tasks()))

    def _whole_tasks(self, node: pp.ScanSource) -> Iterator[MicroPartition]:
        """One partition per scan task, each loaded whole on the pool, in
        task order."""
        if not node.tasks:
            yield MicroPartition.empty(node.schema())
            return
        yield from _ordered_parallel(iter(node.tasks), self._load_task)

    def _prefetch_scan(self, tasks, window: int):
        """Prefetch-pipelined scan source (reference ``executor.py:282``):
        up to ``window`` upcoming ScanTasks resolve on the scan pool AHEAD
        of the one the consumer is draining, each admission-gated by the
        host memory manager after the governor's throttle (prefetched
        bytes can't blow ``DAFT_TORCH_MEMORY_LIMIT``), and each task's
        batches stream out as its files decode: the first morsel lands
        at first-file completion, not task completion. Output stays in
        task order. ``scan_task_us`` (the producers' summed wall) against
        ``scan_span_us`` (the source's wall) measures the overlap."""
        from .. import observability as obs
        from .. import tracing
        from ..io import read_planner as rp
        from . import governor

        pool = _scan_pool()
        t_span0 = time.perf_counter()

        class _ScanAbandoned(Exception):
            pass

        class _Stream:
            """Per-task batch queue; ``dead`` makes an abandoned consumer
            (early limit, error upstream) stop the producer. UNBOUNDED on
            purpose: memory admission is the loading gate. A bounded queue
            would let a producer block on put() while HOLDING admission
            that the head task's producer waits for: a deadlock the
            consumer, stuck on the head task's queue, could never
            break."""

            def __init__(self):
                self.q = queue.Queue()
                self.dead = threading.Event()

            def put(self, item):
                if self.dead.is_set():
                    raise _ScanAbandoned()
                self.q.put(item)

        def stream(task, st: _Stream, schema, produced: list) -> None:
            for rb in task.stream_batches():
                st.put(("batch", MicroPartition.from_recordbatch(
                    rb.cast_to_schema(schema))))
                produced[0] = True

        def produce(task, st: _Stream, task_idx: int):
            if st.dead.is_set():  # consumer gone before we even started
                return
            t0 = time.perf_counter()
            est = task.size_bytes() or 0
            # governor backpressure BEFORE admission: a bounded throttle
            # that slows the producers while RSS sits above the high mark
            governor.throttle("scan_prefetch")
            # producer span keyed by the task's index; the producer thread
            # carries the query's span context through the attribution the
            # io counters ride
            sp = tracing.span("scan:prefetch", key=f"scan.t{task_idx}",
                              attrs={"est_bytes": est}, lane="scan")
            self.host_mem.acquire(est)
            try:
                with sp:
                    if st.dead.is_set():
                        return
                    schema = task.materialized_schema()
                    produced = [False]
                    try:
                        stream(task, st, schema, produced)
                    except OSError:
                        if produced[0]:
                            raise  # a re-stream would duplicate rows
                        time.sleep(0.2)  # transient IO: one clean retry
                        stream(task, st, schema, produced)
                    if not produced[0]:
                        st.put(("batch", MicroPartition.empty(schema)))
                    st.put(("done", None))
            except _ScanAbandoned:
                pass
            except BaseException as exc:  # noqa: BLE001
                try:
                    st.put(("err", exc))
                except _ScanAbandoned:
                    pass
            finally:
                self.host_mem.release(est)
                rp.scan_count("scan_task_us",
                              (time.perf_counter() - t0) * 1e6)

        inflight = collections.deque()
        it = iter(tasks)
        submitted = [0]

        def refill():
            # fill to the governor's CURRENT window (at most the configured
            # one): under memory pressure the prefetch narrows to one task
            # ahead, and widens again once RSS recovers
            while len(inflight) < governor.prefetch_window(window) + 1:
                t = next(it, None)
                if t is None:
                    return
                st = _Stream()
                pool.submit(obs.run_attributed, obs.current_attribution(),
                            produce, t, st, submitted[0])
                submitted[0] += 1
                inflight.append(st)
                rp.scan_count("prefetch_tasks")

        refill()
        current = None
        try:
            while inflight:
                current = inflight.popleft()
                while True:
                    kind, val = current.q.get()
                    if kind == "batch":
                        yield val
                    elif kind == "err":
                        raise val
                    else:
                        break
                current = None
                refill()
        finally:
            # an abandoned consumer (early limit, downstream error) must
            # unblock every producer, the one being drained included
            if current is not None:
                current.dead.set()
            for st in inflight:
                st.dead.set()
            rp.scan_count("scan_span_us",
                          (time.perf_counter() - t_span0) * 1e6)

    def _exec_InMemorySource(self, node: pp.InMemorySource):
        if not node.partitions:
            yield MicroPartition.empty(node.schema())
            return
        yield from iter(node.partitions)

    def _exec_StageInput(self, node: pp.StageInput):
        """Another stage's output, from ``run``'s bindings (reference
        ``executor.py:436``): a partition list, or a lazy fetch of shuffle
        partitions (``distributed/worker.py``) whose emptiness is known
        only once drained. No binding reads as empty."""
        parts = self.stage_inputs.get(node.stage_id)
        got = False
        for p in parts or ():
            got = True
            yield p
        if not got:
            yield MicroPartition.empty(node.schema())

    # pipelined maps ---------------------------------------------------
    def _exec_Project(self, node: pp.Project):
        child = self._exec(node.children[0])
        yield from _ordered_parallel(
            child, lambda p: p.eval_expression_list(node.exprs))

    def _exec_Filter(self, node: pp.Filter):
        child = self._exec(node.children[0])
        yield from _ordered_parallel(child, lambda p: p.filter(node.predicate))

    def _exec_Sample(self, node: pp.Sample):
        child = self._exec(node.children[0])
        yield from _ordered_parallel(child, _sample_kernel(node))

    def _exec_Unpivot(self, node: pp.Unpivot):
        child = self._exec(node.children[0])
        yield from _ordered_parallel(
            child, lambda p: p.unpivot(node.ids, node.values,
                                       node.variable_name, node.value_name))

    def _exec_Pivot(self, node: pp.Pivot):
        for p in self._exec(node.children[0]):
            yield p.pivot(node.group_by, node.pivot_col, node.value_col,
                          node.names).cast_to_schema(node.schema())

    def _exec_Limit(self, node: pp.Limit):
        remaining = node.limit
        to_skip = node.offset
        for p in self._exec(node.children[0]):
            n = len(p)
            if to_skip:
                if n <= to_skip:
                    to_skip -= n
                    continue
                p = MicroPartition.from_recordbatch(
                    p.combined().slice(to_skip, n))
                to_skip = 0
            if remaining <= 0:
                break
            if len(p) > remaining:
                p = p.head(remaining)
            remaining -= len(p)
            yield p
            if remaining <= 0:
                break

    def _exec_Concat(self, node: pp.Concat):
        yield from self._exec(node.children[0])
        yield from self._exec(node.children[1])

    def _exec_MonotonicallyIncreasingId(self, node: pp.MonotonicallyIncreasingId):
        # ids per partition index of the child's stream, as the reference
        for i, p in enumerate(self._exec(node.children[0])):
            yield p.add_monotonically_increasing_id(i, node.column_name)

    # aggregation ------------------------------------------------------
    def _streamed_agg_input(self, node) -> bool:
        """True when this Aggregate's child is a StageInput bound to a
        STREAMING fetch: the binding yields one morsel per map source (not
        hash-disjoint), so per-morsel aggregation would duplicate groups
        and :meth:`_merge_agg_stream` re-merges instead (the distributed
        worker's multi-source fetch, ``distributed/worker.py``)."""
        ch = node.children[0] if node.children else None
        if not isinstance(ch, pp.StageInput):
            return False
        return getattr(self.stage_inputs.get(ch.stage_id),
                       "streaming", False)

    def _exec_Aggregate(self, node: pp.Aggregate):
        """Per partition: a partial aggregates each morsel; a final or
        single aggregate sits on a hash exchange (every group in one
        partition) or a gather."""
        if self._streamed_agg_input(node):
            yield from self._merge_agg_stream(node,
                                              self._exec(node.children[0]))
            return
        child = self._exec(node.children[0])
        yield from _ordered_parallel(
            child, lambda p: p.agg(node.aggs, node.group_by)
            .cast_to_schema(node.schema()))

    _MERGE_AGG_REAGG_ROWS = 1 << 17

    def _merge_agg_stream(self, node: pp.Aggregate, stream):
        """Streaming merge over a multi-morsel input that is not
        hash-disjoint: aggregate the arriving morsels and merge the states
        with the self-merge table (``aggs.merge_exprs_for``) once the
        buffer rivals the state, emitting ONE state morsel (reference
        ``executor.py:529``)."""
        from ..aggs import merge_exprs_for
        merge_aggs = merge_exprs_for(node.aggs)
        state: Optional[MicroPartition] = None
        buf: List[MicroPartition] = []
        rows = 0

        def merge():
            nonlocal state, buf, rows
            if not buf:
                return
            fresh = buf[0].concat(buf[1:]) if len(buf) > 1 else buf[0]
            fresh = fresh.agg(node.aggs, node.group_by) \
                .cast_to_schema(node.schema())
            state = fresh if state is None else \
                state.concat([fresh]).agg(merge_aggs, node.group_by) \
                .cast_to_schema(node.schema())
            buf, rows = [], 0

        for mp in stream:
            self._poll_cancel()
            buf.append(mp)
            rows += len(mp)
            if rows >= max(self._MERGE_AGG_REAGG_ROWS,
                           0 if state is None else len(state)):
                merge()
        merge()
        yield state if state is not None \
            else MicroPartition.empty(node.schema())

    def _exec_DeviceFragmentAgg(self, node: pp.DeviceFragmentAgg):
        """The reference's shape (``executor.py:580``): over a
        ``ScanSource`` whose groups the link affords
        (:func:`_fragment_groups_affordable`), the task-level path
        (:meth:`_fragment_scan_tasks`: windows of scan tasks, the device
        column cache, one copy per window); over any other child, the
        pipelined morsels (:meth:`_pipelined_fragment_morsels`), or one
        morsel at a time when the window is 0.

        Each batch not already on the device is priced
        (``costmodel.agg_upload_wins``, reference ``executor.py:596-631``)
        at the strategy its dispatch would take (``fragment.gate_strategy``
        with the planner's footer NDV, ``node.group_ndv``), one-shot for a
        morsel and as a cache investment for a scan task whose working set
        fits the device column cache; with the pipeline on, at its
        steady-state overlap; each decision is logged as
        ``fused_agg_upload`` (``_invest`` for a cache investment). An
        explicit ``DAFT_TORCH_DEVICE_MIN_ROWS`` leaves the fused fragment
        unpriced (``runtime.fused_unpriced``: the rule it had before the
        cost model). A batch the price sends to the host, an empty one, one
        with a column or expression without a device form, and one whose
        groups outgrow the link-priced ceiling (``fragment._max_out_cap``)
        run the host chain and count ``host_morsels``."""
        from ..aggs import split_agg_expr
        from ..device import column as dcol, costmodel, fragment
        from ..device import pipeline as dpipe, runtime as drt
        specs = [split_agg_expr(a) for a in node.aggs]
        child_exprs = [(c if c is not None else _lit_true())
                       .alias(f"__v{i}__")
                       for i, (op, c, nm, pr) in enumerate(specs)]
        ops = tuple(s[0] for s in specs)
        agg_cols = [col(s[2]) for s in specs]
        groups = node.group_ndv

        def host_agg(rb: RecordBatch) -> MicroPartition:
            # planning, not a fallback: the host tier was asked for or
            # priced cheaper, or the batch has no device form
            drt.count("host_morsels")
            if node.predicate is not None:
                rb = rb.filter(node.predicate)
            return MicroPartition.from_recordbatch(
                rb.agg(node.aggs, node.group_by)
                .cast_to_schema(node.schema()))

        def program(schema):
            return fragment.get_fused_agg(node.group_by, child_exprs, ops,
                                          node.predicate, schema)

        def morsel_gate(rb: RecordBatch, window: int = 0):
            """The fused program when the device takes this batch, else
            None (host). No device work happens here."""
            if self.device is None or len(rb) == 0:
                return None
            prog = program(rb.schema)
            if prog is None or not all(
                    dcol.has_device_plane(rb.get_column(n))
                    for n in prog.compiled.needs_cols):
                return None
            if drt.fused_unpriced():
                return prog
            # an in-memory batch: the upload is one-shot (no cache
            # identity to invest in), it must beat the host outright
            needs = prog.compiled.needs_cols
            if not costmodel.agg_upload_wins(
                    dcol.encoded_nbytes(rb, needs),
                    fragment.packed_bytes_per_group(prog.nk, len(ops))
                    * fragment._OUT_CAP0, cacheable=False,
                    host_bytes=drt._batch_cols_nbytes(rb, needs),
                    strategy=fragment.gate_strategy(prog, len(rb), groups,
                                                    self.device),
                    window=window, kind="fused_agg_upload"):
                return None
            return prog

        src = node.children[0]
        if isinstance(src, pp.ScanSource) and src.tasks \
                and self.device is not None \
                and _fragment_groups_affordable(node, src):
            prog = program(src.schema())
            if prog is not None:
                yield from self._fragment_scan_tasks(node, prog, src,
                                                     agg_cols, host_agg)
                return
        # a device dispatch takes a whole source file: big morsels amortize
        # the launches, and the kernels are sized for them
        child = self._whole_tasks(src) if isinstance(src, pp.ScanSource) \
            else self._exec(src)
        window = dpipe.inflight_window()
        if window > 0 and self.device is not None:
            yield from self._pipelined_fragment_morsels(
                node, child, morsel_gate, agg_cols, host_agg, window)
            return
        for p in child:
            rb = p.combined()
            prog = morsel_gate(rb)
            out = None if prog is None else fragment.run_fused_agg(
                prog, rb, node.group_by, agg_cols, node.schema(),
                self.device, groups)
            yield host_agg(rb) if out is None else _to_partition(out, node)

    def _pipelined_fragment_morsels(self, node, child, morsel_gate,
                                    agg_cols, host_agg, window: int):
        """The bounded-window pipeline over a morsel stream
        (``device/pipeline.py``; reference ``executor.py:690``). Each
        device morsel's slot admits its encoded footprint on submit and
        releases it on drain; its encode and dispatch run on the slot's
        own stream. Host-routed morsels bypass the window. Order is
        kept."""
        from ..device import column as dcol, fragment, pipeline as dpipe

        def submit(p, seq, gate):
            rb = p.combined()
            prog = morsel_gate(rb, window)
            if prog is None:
                return host_agg(rb)
            est = dcol.encoded_nbytes(rb, prog.compiled.needs_cols)
            slot = dpipe.acquire_slot(gate, seq, self.mem, est)
            try:
                t0 = time.perf_counter()
                with dcol.on_stream(dpipe.slot_stream(gate, self.device,
                                                      seq)):
                    tok = fragment.submit_fused_agg(
                        prog, rb, node.group_by, agg_cols, node.schema(),
                        self.device, node.group_ndv)
                sub_s = time.perf_counter() - t0
            except BaseException:
                dpipe.release_slot(slot)
                raise
            return dpipe.InflightItem(slot, (tok, rb), sub_s=sub_s)

        def drain(ret, seq):
            if not isinstance(ret, dpipe.InflightItem):
                return ret   # a host result, computed on the pool
            tok, rb = ret.token
            out = fragment.drain_fused_agg_tables(tok)[0]
            return host_agg(rb) if out is None else _to_partition(out, node)

        yield from dpipe.run_pipelined(child, submit, drain, window=window)

    def _fragment_scan_tasks(self, node, prog, src, agg_cols, host_agg):
        """Windows of scan tasks (reference ``executor.py:737``). Each task
        of a window resolves to a device table (a cache hit), to a host
        batch (empty, or a column without a device plane) or to a
        candidate; once the window is classified, each candidate is priced
        (``costmodel.agg_upload_wins``: a cache investment when the whole
        scan's working set fits the budget, with the bytes a host rerun
        would decode again, the fetch's round trips shared by the window's
        device tables; unpriced under ``runtime.fused_unpriced``) and
        either goes to the host or is encoded and cached. The window's
        fused programs are dispatched and ALL their results come back in
        one device→host copy; the partitions are emitted in task order. A
        table declined at the link-priced group ceiling is re-read and
        aggregated on the host. With a window above 0, window N+1 loads,
        encodes and dispatches on the submit pool (on its slot's stream)
        while window N's results come back here."""
        import itertools

        from ..device import cache as dcache, column as dcol, costmodel
        from ..device import fragment, pipeline as dpipe, runtime as drt
        device = self.device
        needs = prog.compiled.needs_cols
        schema = src.schema()
        cache = dcache.get_cache()
        n_tasks = len(src.tasks)
        groups = node.group_ndv
        packed_out = fragment.packed_bytes_per_group(
            prog.nk, len(prog.ops)) * fragment._OUT_CAP0
        pwin = dpipe.inflight_window()
        unpriced = drt.fused_unpriced()

        def classify(t):
            """A cache hit is a device table; an empty batch or one with a
            column without a device plane goes to the host; the rest are
            candidates for the price."""
            fp = dcache.task_fingerprint(t, device)
            if fp is not None:
                dt = cache.get_table(fp, needs)
                if dt is not None:
                    return ("dev", dt, t)
            rb = self._load_task(t).combined()
            if len(rb) == 0 or not all(
                    dcol.has_device_plane(rb.get_column(n)) for n in needs):
                return ("host", rb, t)
            return ("cand", rb, t, fp)

        def gate_encode(c, n_sharing):
            """Price a candidate; encode it (and cache it when the whole
            scan's working set fits the budget: a slice of an oversized
            scan would only evict entries other queries still repay) when
            the device wins."""
            _, rb, t, fp = c
            col_bytes = dcol.encoded_nbytes(rb, needs)
            fits = col_bytes * n_tasks <= dcache.budget()
            cacheable = fp is not None and fits
            if not unpriced and not costmodel.agg_upload_wins(
                    col_bytes, packed_out, cacheable=cacheable,
                    round_trips=2.0 / max(1, n_sharing),
                    host_bytes=drt._batch_cols_nbytes(rb, needs),
                    strategy=fragment.gate_strategy(prog, len(rb), groups,
                                                    device),
                    window=pwin,
                    host_rescan_bytes=_task_scan_bytes(t) if cacheable
                    else 0.0, kind="fused_agg_upload"):
                return ("host", rb, t)
            dt = dcol.encode_batch(rb, needs, device)
            drt.count("scan_bytes_up", dt.nbytes())
            if fp is not None and fits:
                cache.put_table(fp, dt)
            return ("dev", dt, t)

        def resolve(window_tasks, stream):
            """Classify the window on the pool, then price and encode its
            candidates on ``stream``, in task order."""
            classified = list(_ordered_parallel(iter(window_tasks),
                                                classify))
            n_sharing = sum(1 for c in classified if c[0] != "host")

            def one(c):
                if c[0] != "cand":
                    return c
                with dcol.on_stream(stream):
                    return gate_encode(c, n_sharing)
            return list(_ordered_parallel(iter(classified), one))

        def emit(resolved, outs):
            di = 0
            for kind, val, t in resolved:
                if kind != "dev":
                    yield host_agg(val)
                    continue
                out = outs[di]
                di += 1
                yield host_agg(self._load_task(t).combined()) \
                    if out is None else _to_partition(out, node)

        def tables(resolved):
            return [v for k, v, _ in resolved if k == "dev"]

        width = max(os.cpu_count() or 4, 4) * 2
        if pwin > 0:
            # enough windows to fill the in-flight ladder: window + 1
            width = max(1, min(width, -(-n_tasks // (pwin + 1))))

        def windows():
            it = iter(src.tasks)
            while True:
                w = list(itertools.islice(it, width))
                if not w:
                    return
                yield w

        if pwin <= 0:
            # the synchronous loop: window N+1 loads after window N's fetch
            for w in windows():
                resolved = resolve(w, None)
                outs = fragment.run_fused_agg_tables(
                    prog, tables(resolved), schema, node.group_by,
                    agg_cols, node.schema(), groups)
                yield from emit(resolved, outs)
            return

        def p_submit(window_tasks, seq, gate):
            t0 = time.perf_counter()
            stream = dpipe.slot_stream(gate, device, seq)
            resolved = resolve(window_tasks, stream)
            est = sum(dt.nbytes() for dt in tables(resolved))
            slot = dpipe.acquire_slot(gate, seq, self.mem, est)
            try:
                with dcol.on_stream(stream):
                    tok = fragment.submit_fused_agg_tables(
                        prog, tables(resolved), schema, node.group_by,
                        agg_cols, node.schema(), groups)
            except BaseException:
                dpipe.release_slot(slot)
                raise
            return dpipe.InflightItem(slot, (resolved, tok),
                                      sub_s=time.perf_counter() - t0)

        def p_drain(ret, seq):
            resolved, tok = ret.token
            outs = fragment.drain_fused_agg_tables(tok)
            dpipe.release_slot(ret.slot)
            return list(emit(resolved, outs))

        for outs in dpipe.run_pipelined(windows(), p_submit, p_drain,
                                        window=pwin, width=pwin + 1):
            yield from outs

    # joins ------------------------------------------------------------
    def _exec_HashJoin(self, node: pp.HashJoin):
        """Reference ``executor.py:1732``: broadcast joins gather one side
        and join it with each morsel of the other; ``sort_merge`` runs
        :meth:`_sort_merge_join`; a hash join over hash exchanges on the
        join keys of both sides joins the co-partitioned pairs (a pair past
        the pair budget re-partitions, ``out_of_core``), else the grace hash
        join streams both sides into rotated-radix stores;
        ``DAFT_TORCH_SPILL_JOIN=0`` materializes both sides and re-fans
        them instead. Under AQE a planned hash join whose measured side
        fits the broadcast threshold is demoted
        (:meth:`_adaptive_hash_join`)."""
        from . import out_of_core as ooc
        how = node.how
        lnode, rnode = node.children
        if node.strategy == "sort_merge":
            yield from self._sort_merge_join(node)
            return
        if node.strategy == "hash" and self.cfg.enable_aqe \
                and getattr(lnode, "join_side", False) \
                and getattr(rnode, "join_side", False):
            yield from self._adaptive_hash_join(node, lnode.children[0],
                                                rnode.children[0])
            return
        if node.strategy == "broadcast_right":
            right = _gather_all_or_empty(self._exec(rnode), rnode.schema())
            yield from _ordered_parallel(
                self._exec(lnode), lambda p: p.hash_join(
                    right, node.left_on, node.right_on, how))
            return
        if node.strategy == "broadcast_left":
            left = _gather_all_or_empty(self._exec(lnode), lnode.schema())
            yield from _ordered_parallel(
                self._exec(rnode), lambda p: left.hash_join(
                    p, node.left_on, node.right_on, how))
            return
        copart = (isinstance(lnode, pp.Exchange) and lnode.kind == "hash"
                  and isinstance(rnode, pp.Exchange) and rnode.kind == "hash"
                  and lnode.num_partitions == rnode.num_partitions
                  # both sides fanned by the join keys' hash chain: only
                  # then do equal partition indices pair up
                  and [e._key() for e in lnode.by]
                  == [e._key() for e in node.left_on]
                  and [e._key() for e in rnode.by]
                  == [e._key() for e in node.right_on])
        if copart:
            # each exchange is a streaming bucket store emitting exactly n
            # partitions in index order: zip and join pairwise, one pair
            # (plus the stores' bounded buffers) resident at a time
            for outs in _ordered_parallel(
                    zip(self._exec(lnode), self._exec(rnode)),
                    lambda lr: ooc.join_copartitioned_pair(
                        self, lr[0], lr[1], node, lnode.schema(),
                        rnode.schema())):
                yield from outs
            return
        if ooc.spill_join_mode(self.cfg) != "0":
            yield from ooc.grace_hash_join(self, node)
            return
        # DAFT_TORCH_SPILL_JOIN=0: materialize both sides, then re-fan
        # (no recursion; an oversized bucket pair loads whole)
        with memory.materialize(self._exec(lnode),
                                memory.breaker_budget_bytes()) as lbuf, \
                memory.materialize(self._exec(rnode),
                                   memory.breaker_budget_bytes()) as rbuf:
            # fanout sized from BOTH sides: a tiny left must not gather an
            # arbitrarily large right
            n = max(self._breaker_fanout(lbuf.total_bytes),
                    self._breaker_fanout(rbuf.total_bytes))
            if n <= 1:
                lall = _gather_all_or_empty(iter(lbuf), lnode.schema())
                rall = _gather_all_or_empty(iter(rbuf), rnode.schema())
                yield lall.hash_join(rall, node.left_on, node.right_on, how)
                return
            n = max(n, min(max(len(lbuf), len(rbuf)), 16))
            lstore = self._key_bucket_store(iter(lbuf),
                                            list(node.left_on), n)
            lbuf.close()
            try:
                rstore = self._key_bucket_store(iter(rbuf),
                                                list(node.right_on), n)
            except BaseException:
                lstore.close()
                raise
            rbuf.close()
            try:
                yield from _ordered_parallel(
                    zip(self._emit_buckets(lstore, lnode.schema()),
                        self._emit_buckets(rstore, rnode.schema())),
                    lambda lr: lr[0].hash_join(lr[1], node.left_on,
                                               node.right_on, how))
            finally:
                lstore.close()
                rstore.close()

    def _sort_merge_join(self, node: pp.HashJoin):
        """Sort-merge join (reference ``executor.py:1684``, the aligned-
        boundary SortMergeJoin): sample BOTH sides' keys while spilling
        each under the breaker budget, derive ONE shared set of range
        boundaries, range-bucket both sides with it (co-ranged, not
        co-hashed), then join bucket pairs — one pair resident at a time.
        The output comes out range-clustered by key."""
        how = node.how
        left_on, right_on = list(node.left_on), list(node.right_on)
        lbuf, lsamp = self._consume_sampling(self._exec(node.children[0]),
                                             left_on)
        try:
            rbuf, rsamp = self._consume_sampling(
                self._exec(node.children[1]), right_on)
        except BaseException:
            lbuf.close()
            raise
        try:
            n = max(self._breaker_fanout(lbuf.total_bytes),
                    self._breaker_fanout(rbuf.total_bytes),
                    min(max(len(lbuf), len(rbuf)), 16))
            names = [e.name() for e in left_on]
            # right-side key names take the left's, so the samples concat
            # into one boundary table (the comparison is positional)
            samples = lsamp + [
                RecordBatch.from_series([c.rename(nm) for c, nm in
                                         zip(rb.columns(), names)])
                for rb in rsamp]
            desc = [False] * len(left_on)
            boundaries = sample_boundaries(samples, names, desc, desc, n) \
                if n > 1 and samples else None
            if boundaries is None:
                lall = _gather_all_or_empty(iter(lbuf),
                                            node.children[0].schema())
                rall = _gather_all_or_empty(iter(rbuf),
                                            node.children[1].schema())
                yield lall.hash_join(rall, left_on, right_on, how)
                return
            yield from _ordered_parallel(
                zip(self._stream_range_buckets(
                        lbuf, left_on, boundaries, desc, desc, n,
                        node.children[0].schema()),
                    self._stream_range_buckets(
                        rbuf, right_on, boundaries, desc, desc, n,
                        node.children[1].schema())),
                lambda lr: lr[0].hash_join(lr[1], left_on, right_on, how))
        finally:
            lbuf.close()
            rbuf.close()

    def _key_bucket_store(self, stream, by, n: int):
        """Drain a stream into an n-bucket store hashed on ``by``. The
        store closes itself when the drain fails; the caller owns it once
        it is returned whole."""
        store = memory.PartitionedSpillStore(n)
        try:
            for mp in stream:
                self._poll_cancel()
                for j, piece in enumerate(mp.partition_by_hash(by, n)):
                    if len(piece):
                        store.push(j, piece.combined())
            store.finalize()
        except BaseException:
            store.close()
            raise
        return store

    def _adaptive_hash_join(self, node: pp.HashJoin, li, ri):
        """AQE join-strategy demotion (reference ``executor.py:1855``;
        AdaptivePlanner re-planning joins from materialized stats,
        ``planner.rs:451-640``): materialize each join input BELOW its
        planned hash exchange, and if the measured bytes of an eligible
        side fit the broadcast threshold, skip both shuffles and broadcast
        it; otherwise fan both materialized sides out as planned."""
        how = node.how
        threshold = self.cfg.broadcast_join_size_bytes_threshold
        with memory.materialize(self._exec(li),
                                memory.breaker_budget_bytes()) as lparts:
            if lparts.total_bytes <= threshold and how in ("inner",
                                                           "right"):
                self._aqe().record_join("hash→broadcast_left",
                                        lparts.total_bytes)
                left = _gather_all_or_empty(iter(lparts), li.schema())
                lparts.close()
                yield from _ordered_parallel(
                    self._exec(ri), lambda p: left.hash_join(
                        p, node.left_on, node.right_on, how))
                return
            with memory.materialize(
                    self._exec(ri),
                    memory.breaker_budget_bytes()) as rparts:
                if rparts.total_bytes <= threshold \
                        and how in ("inner", "left", "semi", "anti"):
                    self._aqe().record_join("hash→broadcast_right",
                                            rparts.total_bytes)
                    right = _gather_all_or_empty(iter(rparts), ri.schema())
                    rparts.close()
                    yield from _ordered_parallel(
                        iter(lparts), lambda p: p.hash_join(
                            right, node.left_on, node.right_on, how))
                    return
                n = node.children[0].num_partitions
                self._aqe().record_join(
                    "hash", lparts.total_bytes + rparts.total_bytes)
                yield from _ordered_parallel(
                    zip(self._refan(lparts, list(node.left_on), n,
                                    li.schema()),
                        self._refan(rparts, list(node.right_on), n,
                                    ri.schema())),
                    lambda lr: lr[0].hash_join(lr[1], node.left_on,
                                               node.right_on, how))

    def _refan(self, parts, by: List[Expression], n: int, schema):
        """Key-hash a (possibly spilled) partition buffer into n buckets
        and emit them in order, one bucket resident at a time."""
        store = self._key_bucket_store(iter(parts), by, n)
        if isinstance(parts, memory.SpillBuffer):
            parts.close()

        def emit():
            try:
                yield from self._emit_buckets(store, schema)
            finally:
                store.close()
        return emit()

    def _exec_CrossJoin(self, node: pp.CrossJoin):
        lnode, rnode = node.children
        rb = _gather_all_or_empty(self._exec(rnode), rnode.schema()) \
            .combined()
        # right names that collide with left ones take the join's prefix
        names = node.schema().column_names[len(lnode.schema()):]
        right = MicroPartition(node.schema().project(names), batches=[
            RecordBatch(node.schema().project(names),
                        [c.rename(n) for c, n in zip(rb.columns(), names)],
                        len(rb))])
        yield from _ordered_parallel(self._exec(lnode),
                                     lambda p: p.cross_join(right))

    # writes -----------------------------------------------------------
    def _exec_Write(self, node: pp.Write):
        """Write the child's partitions (reference ``executor.py:1923``):
        a user sink takes the stream whole; a file write writes each
        partition on the pool (hive directories per partition value) and
        yields one partition of the written paths."""
        info = node.info
        if info.get("kind") == "sink":
            sink = info["sink"]
            sink.start()
            results = list(sink.write(self._exec(node.children[0])))
            yield sink.finalize(results)
            return
        from ..io import writers
        if info.get("mode") == "overwrite":
            writers.overwrite_dir(info["root_dir"])
        child = self._exec(node.children[0])
        outs = list(_ordered_parallel(
            child, lambda p: writers.write_micropartition(
                p, info["kind"], info["root_dir"],
                info.get("partition_cols"), info.get("options"))))
        outs = [o for o in outs if len(o)]
        if not outs:
            yield MicroPartition.empty(node.schema())
            return
        yield MicroPartition.from_recordbatch(
            RecordBatch.concat(outs).cast_to_schema(node.schema()))

    # the device mesh ------------------------------------------------
    def _exec_DeviceExchangeAgg(self, node: pp.DeviceExchangeAgg):
        """Shuffle and final merge as one mesh program (reference
        ``executor.py:1206``): the partial group blocks are sharded over
        the mesh, exchanged by key hash, merged, and decoded as one
        disjoint group block per shard. A planned decline (encoding) runs
        the host exchange and final aggregate translate would have
        emitted."""
        parts = memory.materialize(self._exec(node.children[0]),
                                   memory.breaker_budget_bytes())
        try:
            outs = self._mesh_exchange_agg(node, parts)
            if outs is not None:
                yield from outs
                return
            n = max(min(len(parts),
                        self.cfg.shuffle_aggregation_default_partitions), 1)
            store = self._key_bucket_store(iter(parts),
                                           list(node.group_by), n)
            try:
                yield from _ordered_parallel(
                    self._emit_buckets(store, node.children[0].schema()),
                    lambda p: MicroPartition.from_recordbatch(
                        p.combined().agg(node.aggs, node.group_by)
                        .cast_to_schema(node.schema())))
            finally:
                store.close()
        finally:
            parts.close()

    def _mesh_exchange_agg(self, node, parts
                           ) -> Optional[List[MicroPartition]]:
        """→ one MicroPartition per shard, or None when the columns have
        no plain device plane (the planned decline). A failure inside
        the collective propagates (the reference falls back to the host
        exchange there)."""
        from ..aggs import split_agg_expr
        from ..device import column as dcol
        from ..parallel import exchange, mesh as pmesh
        mesh = pmesh.get_mesh() if self.device is not None else None
        if mesh is None or mesh.size < 2:
            return None
        rb = RecordBatch.concat([p.combined() for p in parts]) \
            if len(parts) > 1 else parts[0].combined()
        if len(rb) == 0:
            return [MicroPartition.from_recordbatch(
                RecordBatch.empty(node.schema()))]
        key_names = [g.name() for g in node.group_by]
        specs = [split_agg_expr(a) for a in node.aggs]
        ops = tuple(sp[0] for sp in specs)
        val_names = [sp[1]._unalias().params[0] for sp in specs]
        out_names = [sp[2] for sp in specs]
        n = mesh.size
        total = len(rb)
        # per-shard capacity padded to a size class, so row counts that
        # differ only in the literal reuse one memoized program
        C = dcol.bucket_capacity((total + n - 1) // n)
        cap = n * C
        encode = _np_plane_encoder(rb, cap)
        kplanes = _encode_plane_lists(encode, key_names)
        vplanes = _encode_plane_lists(encode, val_names)
        if kplanes is None or vplanes is None:
            return None
        keys, kvalids, kdicts = kplanes
        vals, vvalids, vdicts = vplanes
        mask = np.arange(cap) < total
        sb = lambda a: exchange.shard_blocks(mesh, a)  # noqa: E731
        fk, fkv, fv, fvv, gmask = exchange.sharded_grouped_agg(
            mesh, tuple(sb(k) for k in keys),
            tuple(sb(k) for k in kvalids), tuple(sb(v) for v in vals),
            tuple(sb(v) for v in vvalids), sb(mask), ops)
        g = exchange.gather_blocks
        _count_ici_exchange(total, list(keys) + list(vals),
                            list(kvalids) + list(vvalids))
        spec = [(nm, node.schema()[nm].dtype, g(fk[i]), g(fkv[i]),
                 kdicts[i]) for i, nm in enumerate(key_names)]
        spec += [(nm, node.schema()[nm].dtype, g(fv[j]), g(fvv[j]),
                  vdicts[j]) for j, nm in enumerate(out_names)]
        return _decode_mesh_shards(n, g(gmask), spec, node.schema())

    def _mesh_hash_repartition(self, parts, by, n: int
                               ) -> Optional[List[MicroPartition]]:
        """Hash repartition as one all_to_all over the device mesh
        (reference ``executor.py:1294``), when the target partition count
        equals the mesh width and every column either round-trips the
        device encoding bit-exactly or is string/binary (those ride
        dictionary codes shared by every shard, see
        :func:`_np_plane_encoder`). None on a planned decline: no mesh,
        a declined admission, or a dtype that does not round-trip."""
        from ..device import column as dcol
        from ..parallel import exchange, mesh as pmesh
        if self.device is None or n < 2 or n != pmesh.mesh_size():
            return None
        mesh = pmesh.get_mesh()
        parts = list(parts)
        if not parts:
            return None
        rb = RecordBatch.concat([p.combined() for p in parts]) \
            if len(parts) > 1 else parts[0].combined()
        # the cost model prices the exact bytes against the measured
        # shard-to-shard rate (DAFT_TORCH_MESH_MIN_ROWS overrides; 0
        # forces the mesh)
        if not pmesh.mesh_admits(
                len(rb), rb.size_bytes() / max(len(rb), 1)):
            return None
        schema = rb.schema
        for f in schema:
            if not (dcol.is_lossless_device_dtype(f.dtype)
                    or f.dtype.is_string() or f.dtype.is_binary()):
                return None
        if len(rb) == 0:
            return [MicroPartition.from_recordbatch(RecordBatch.empty(schema))
                    for _ in range(n)]
        total = len(rb)
        C = dcol.bucket_capacity((total + n - 1) // n)
        cap = n * C
        # the destination from the SAME xxh64 chain as the host exchange
        # (partition_by_hash), so co-partitioned joins agree across tiers
        key_s = [rb.eval_expression(e) for e in by]
        h = key_s[0].hash()
        for k in key_s[1:]:
            h = k.hash(seed=h)
        pid = (h.to_numpy() % np.uint64(n)).astype(np.int32)
        pid = np.concatenate([pid, np.zeros(cap - total, dtype=np.int32)])
        encode = _np_plane_encoder(rb, cap)
        names = schema.column_names
        enc = _encode_plane_lists(encode, names)
        if enc is None:
            return None
        planes, valids, dicts = enc
        mask = np.arange(cap) < total
        sb = lambda a: exchange.shard_blocks(mesh, a)  # noqa: E731
        op, ov, om = exchange.sharded_hash_repartition(
            mesh, tuple(sb(p) for p in planes),
            tuple(sb(v) for v in valids), sb(mask), sb(pid))
        g = exchange.gather_blocks
        _count_ici_exchange(total, planes, valids)
        spec = [(nm, schema[nm].dtype, g(op[j]), g(ov[j]), dicts[j])
                for j, nm in enumerate(names)]
        return _decode_mesh_shards(n, g(om), spec, schema)

    def _exec_Dedup(self, node: pp.Dedup):
        """Per partition: the hash exchange below puts every duplicate of
        ``on`` in one partition."""
        yield from _ordered_parallel(self._exec(node.children[0]),
                                     lambda p: p.distinct(node.on))

    # exchanges --------------------------------------------------------
    def _exec_Exchange(self, node: pp.Exchange):
        """Streaming shuffles (reference ``executor.py:1505``): hash,
        random and range fan every incoming morsel into an n-bucket
        :class:`memory.PartitionedSpillStore` (RAM under the breaker
        budget, whole-bucket spill past it) — the child is never
        materialized as a unit. gather and split reshape partition
        boundaries by global position, so they drain into a breaker-budget
        SpillBuffer."""
        kind, n = node.kind, node.num_partitions
        algo = self.cfg.shuffle_algorithm
        if algo not in ("auto", "naive", "spill_cache"):
            raise ValueError(
                f"shuffle_algorithm {algo!r}: expected 'auto', 'naive' or "
                f"'spill_cache'")
        if kind == "hash" and n > 1:
            if algo == "spill_cache":
                yield from self._spill_cache_hash_exchange(node, n)
            else:
                yield from self._hash_exchange_streaming(node, n)
            return
        if kind == "random" and n > 1:
            yield from self._fan_exchange_streaming(
                node, n, lambda mp, i: mp.partition_by_random(n, seed=i))
            return
        if kind == "range":
            yield from self._range_exchange_streaming(node, n)
            return
        if kind not in ("gather", "hash", "random", "split"):
            raise NotImplementedError(f"exchange kind {kind}")
        parts = memory.materialize(self._exec(node.children[0]),
                                   memory.breaker_budget_bytes())
        try:
            if len(parts) == 0:
                yield MicroPartition.empty(node.schema())
            elif kind == "split" and n > 1:
                yield from self._split(list(parts), n)
            else:
                # gather, and hash/random/split at n == 1: one partition
                yield _gather_all_or_empty(iter(parts), node.schema())
        finally:
            parts.close()

    def _hash_exchange_streaming(self, node, n: int):
        """Hash exchange (reference ``executor.py:1549``): when the device
        mesh has exactly n shards the whole input repartitions as one
        all_to_all over the mesh (:meth:`_mesh_hash_repartition`);
        otherwise, or when that path declines, every morsel fans into the
        streaming bucket store."""
        from ..parallel import mesh as pmesh
        by = list(node.by)
        if self.device is not None and n >= 2 \
                and n == pmesh.mesh_size():
            # the collective wants a partition list; a decline falls back
            # to the streaming store over the same spill-bounded buffer
            parts = memory.materialize(self._exec(node.children[0]),
                                       memory.breaker_budget_bytes())
            try:
                mesh_out = self._mesh_hash_repartition(list(parts), by, n)
                if mesh_out is not None:
                    yield from mesh_out
                    return
                yield from self._fan_exchange_streaming(
                    node, n, lambda mp, i: mp.partition_by_hash(by, n),
                    stream=iter(parts))
            finally:
                parts.close()
            return
        yield from self._fan_exchange_streaming(
            node, n, lambda mp, i: mp.partition_by_hash(by, n))

    def _fan_exchange_streaming(self, node, n: int, fan, stream=None):
        """Shared streaming fanout: morsel → n pieces → bucket store; under
        AQE an engine-inserted shuffle may coalesce consecutive buckets
        from the measured totals (growing past the planned n would re-hash
        spilled buckets, so adaptation only shrinks)."""
        store = memory.PartitionedSpillStore(n)
        try:
            for i, mp in enumerate(stream if stream is not None
                                   else self._exec(node.children[0])):
                self._poll_cancel()
                for j, piece in enumerate(fan(mp, i)):
                    if len(piece):
                        store.push(j, piece.combined())
            store.finalize()
            groups = None
            if self.cfg.enable_aqe and node.engine_inserted:
                n2 = min(self._aqe().adapt_partition_count(
                    n, sum(store.nbytes), sum(store.rows)), n)
                if n2 < n:
                    bounds = [round(j * n / n2) for j in range(n2 + 1)]
                    groups = [list(range(bounds[j], bounds[j + 1]))
                              for j in range(n2)]
            yield from self._emit_buckets(store, node.schema(), groups)
        finally:
            store.close()

    def _range_exchange_streaming(self, node, n: int):
        by = list(node.by)
        desc = list(node.descending) or [False] * len(by)
        buf, samples = self._consume_sampling(
            self._exec(node.children[0]), by)
        try:
            boundaries = None
            if n > 1 and samples:
                boundaries = sample_boundaries(
                    samples, [e.name() for e in by], desc, desc, n)
            if boundaries is None:
                yield _gather_all_or_empty(iter(buf), node.schema())
                for _ in range(max(n - 1, 0)):
                    yield MicroPartition.empty(node.schema())
                return
            yield from self._stream_range_buckets(buf, by, boundaries,
                                                  desc, desc, n,
                                                  node.schema())
        finally:
            buf.close()

    def _spill_cache_hash_exchange(self, node, n: int):
        """``shuffle_algorithm="spill_cache"``: every morsel's pieces go
        straight to their bucket's spill file (a store with no resident
        budget; reference ``shuffle_cache.rs:14-80``'s map → spill →
        fetch), and the buckets stream back one at a time."""
        by = list(node.by)
        store = memory.PartitionedSpillStore(n, budget=0)
        try:
            for mp in self._exec(node.children[0]):
                self._poll_cancel()
                for i, piece in enumerate(mp.partition_by_hash(by, n)):
                    if len(piece):
                        store.push(i, piece.combined())
            store.finalize()
            yield from self._emit_buckets(store, node.schema())
        finally:
            store.close()

    def _split(self, parts: List[MicroPartition], n: int):
        """Split/coalesce to exactly n partitions, order kept."""
        total = sum(len(p) for p in parts)
        target = max((total + n - 1) // max(n, 1), 1)
        combined = parts[0].concat(parts[1:]) if len(parts) > 1 \
            else parts[0]
        rb = combined.combined()
        start = 0
        for out in range(n):
            end = min(start + target, len(rb)) if out < n - 1 else len(rb)
            yield MicroPartition.from_recordbatch(rb.slice(start, end))
            start = end

    # breaker helpers --------------------------------------------------
    def _consume_sampling(self, stream, by: List[Expression]):
        """Drain a child ONCE into a breaker-budget SpillBuffer while
        sampling ``sample_size_for_sort`` key rows of each morsel."""
        k = self.cfg.sample_size_for_sort
        buf = memory.SpillBuffer(memory.breaker_budget_bytes())
        samples: List[RecordBatch] = []
        try:
            for p in stream:
                self._poll_cancel()
                rb = p.combined()
                if len(rb):
                    s = rb.sample(size=min(k, len(rb)))
                    samples.append(s.eval_expression_list(by))
                buf.append(p)
        except BaseException:
            buf.close()  # a failed drain must not leak the spill files
            raise
        return buf, samples

    def _breaker_fanout(self, total_bytes: int) -> int:
        """Bucket count for a streaming breaker: each bucket must fit
        comfortably in the breaker budget (it is loaded whole at read
        time), and stay near the configured partition size."""
        target = min(self.cfg.target_partition_size_bytes,
                     max(memory.breaker_budget_bytes() // 4, 1))
        return max(1, min(1024, -(-int(total_bytes) // max(target, 1))))

    def _stream_range_buckets(self, buf, by, boundaries, desc, nulls_first,
                              n, schema):
        """Re-stream a spilled buffer, range-fanning each morsel into an
        n-bucket store; emit the buckets in range order."""
        store = memory.PartitionedSpillStore(n)
        try:
            for mp in buf:
                self._poll_cancel()
                for i, piece in enumerate(mp.partition_by_range(
                        by, boundaries, desc, nulls_first)):
                    if len(piece):
                        store.push(i, piece.combined())
            buf.close()  # the input's spill goes before bucket reads begin
            store.finalize()
            yield from self._emit_buckets(store, schema)
        finally:
            store.close()

    def _emit_buckets(self, store, schema, groups=None):
        """One MicroPartition per bucket (or per group of consecutive
        buckets, for AQE-coalesced shuffles). A batch read back from a
        spill file is cast to the declared schema: concat casts to the
        FIRST batch's dtypes, so every batch must match it."""
        for grp in (groups if groups is not None
                    else [[i] for i in range(store.n)]):
            batches = []
            for i in grp:
                batches.extend(store.bucket_batches(i))
            batches = [b if b.schema == schema else b.cast_to_schema(schema)
                       for b in batches if len(b)]
            yield MicroPartition.from_recordbatches(batches, schema) \
                if batches else MicroPartition.empty(schema)

    # windows ----------------------------------------------------------
    def _exec_Window(self, node: pp.Window):
        from ..window_exec import run_window
        child = self._exec(node.children[0])
        yield from _ordered_parallel(
            child, lambda p: MicroPartition.from_recordbatch(
                run_window(p.combined(), node)))

    # fusion regions ---------------------------------------------------
    def _exec_FusedRegion(self, node: pp.FusedRegion):
        """A planner-proposed fusion region (reference ``executor.py:
        927``): the region's operators run as ONE device program per
        morsel (submit = encode and dispatch, drain = one fetch), through
        the pipeline's slots when the window is above 0. A region whose
        program does not lower runs its untouched ``fallback`` subtree
        (``region_declined_lowering``), and so does a join_agg region whose
        largest morsel the cost model declines under ``auto``
        (``region_declined_gate``, :meth:`_largest_morsel_admitted`); a
        morsel the cost model prices
        onto the host (``costmodel.fusion_wins``; ``DAFT_TORCH_FUSION=1``
        admits every one), or whose columns do not encode, or whose
        ladder passes its ceiling, runs the region's host chain
        (``region_declined_gate`` / ``_encode`` / ``_ladder``). An error
        while a region dispatches propagates."""
        from ..physical import fusion as pfusion
        mode = pfusion.fusion_mode(self.cfg)
        if mode == "0" or self.device is None:
            yield from self._exec(node.fallback)
            return
        if node.shape == "join_agg":
            yield from self._exec_region_join_agg(node, mode)
            return
        yield from self._exec_region_chain(node, mode)

    def _region_gate(self, mode: str, rb: RecordBatch, price) -> bool:
        """Admission of one region morsel (reference ``executor.py:
        979``): empty batches and batches under an explicit
        ``DAFT_TORCH_DEVICE_MIN_ROWS`` stay on the host, mode ``1`` admits
        the rest, ``auto`` asks ``price()``."""
        from ..device import runtime as drt
        floor = knobs.env_opt_int("DAFT_TORCH_DEVICE_MIN_ROWS") or 1
        ok = len(rb) >= max(floor, 1) and (mode == "1" or price())
        if not ok:
            drt.count("region_declined_gate")
        return ok

    def _run_region(self, child, gate, device_submit, device_drain,
                    host_run, est_bytes):
        """Drive region morsels through the pipeline (or one at a time
        when the window is 0). ``device_submit(rb)`` → token or None (the
        morsel declines: its host chain runs); ``device_drain(token)`` →
        MicroPartition or None (a ladder past its ceiling)."""
        from ..device import column as dcol, pipeline as dpipe
        from ..device import runtime as drt

        def declined_encode(rb):
            drt.count("region_declined_encode")
            return host_run(rb)

        window = dpipe.inflight_window()
        if window > 0:
            def submit(p, seq, wgate):
                rb = p.combined()
                if not gate(rb, window):
                    return host_run(rb)
                slot = dpipe.acquire_slot(wgate, seq, self.mem,
                                          est_bytes(rb))
                try:
                    t0 = time.perf_counter()
                    with dcol.on_stream(dpipe.slot_stream(
                            wgate, self.device, seq)):
                        tok = device_submit(rb)
                    sub_s = time.perf_counter() - t0
                except BaseException:
                    dpipe.release_slot(slot)
                    raise
                if tok is None:
                    dpipe.release_slot(slot)
                    return declined_encode(rb)
                return dpipe.InflightItem(slot, (tok, rb), sub_s=sub_s)

            def drain(ret, seq):
                if not isinstance(ret, dpipe.InflightItem):
                    return ret
                tok, rb = ret.token
                out = device_drain(tok)
                return out if out is not None else host_run(rb)

            yield from dpipe.run_pipelined(child, submit, drain,
                                           window=window)
            return
        for p in child:
            rb = p.combined()
            if not gate(rb, 0):
                yield host_run(rb)
                continue
            tok = device_submit(rb)
            if tok is None:
                yield declined_encode(rb)
                continue
            out = device_drain(tok)
            yield out if out is not None else host_run(rb)

    def _exec_region_chain(self, node: pp.FusedRegion, mode: str):
        """chain / topk (reference ``executor.py:947``): predicate,
        projection (and for topk the argsort) and a compaction in one
        dispatch, the survivors back in one fetch; a topk's per-morsel
        heads meet in one host merge."""
        from ..device import column as dcol, costmodel, fragment
        from ..device import runtime as drt
        topk = node.shape == "topk"
        prog = fragment.get_fused_region(
            node.exprs, node.predicate, node.source.schema(),
            sort_by=node.sort_by, descending=node.descending,
            nulls_first=node.nulls_first, limit=node.limit,
            fused_ops=node.fused_ops)
        if prog is None:
            drt.count("region_declined_lowering")
            yield from self._exec(node.fallback)
            return
        n_ops = max(len(node.fused_ops) - 1, 2)
        needs = prog.compiled.needs_cols

        def host_run(rb: RecordBatch) -> MicroPartition:
            if node.predicate is not None:
                rb = rb.filter(node.predicate)
            rb = rb.eval_expression_list(node.exprs) \
                .cast_to_schema(node.schema())
            if topk:
                # per-morsel top-k over the output columns (the TopN's
                # sort keys name them); merged below
                rb = rb.top_n(node.fallback.sort_by, node.limit,
                              node.descending, node.nulls_first)
            return MicroPartition.from_recordbatch(rb)

        def gate(rb: RecordBatch, window: int) -> bool:
            def price():
                est_w = dcol.bucket_capacity(max(node.limit or 0, 1)) \
                    if topk else dcol.bucket_capacity(max(len(rb), 1))
                return costmodel.fusion_wins(
                    node.shape, len(rb), dcol.encoded_nbytes(rb, needs),
                    (1 + 2 * prog.nout) * 8 * est_w, n_ops,
                    host_bytes=drt._batch_cols_nbytes(rb, needs),
                    window=window)
            return self._region_gate(mode, rb, price)

        def device_submit(rb: RecordBatch):
            return fragment.submit_region(prog, rb, node.exprs,
                                          node.schema(), self.device)

        def device_drain(tok) -> MicroPartition:
            return _to_partition(fragment.drain_region(tok), node)

        outs = self._run_region(
            self._exec(node.source), gate, device_submit, device_drain,
            host_run, lambda rb: dcol.encoded_nbytes(rb, needs))
        if not topk:
            yield from outs
            return
        merged = _gather_all_or_empty(outs, node.schema())
        yield MicroPartition.from_recordbatch(
            merged.combined().top_n(node.fallback.sort_by, node.limit,
                                    node.descending, node.nulls_first))

    def _largest_morsel_admitted(self, node: pp.FusedRegion, need,
                                 n_planes: int, n_ops: int) -> bool:
        """``auto``, before a join_agg region runs (a port-only step,
        ROADMAP B0b): the price of its largest probe morsel (the source's
        biggest partition, cut to ``default_morsel_size`` as
        :meth:`_morselize` cuts it) against a build of the build subplan's
        source rows, both bounds from above. The fused program's fixed time per dispatch makes a
        smaller morsel no better a bet, so on a decline the region runs
        its ``fallback`` subtree whole, the plan each of whose operators
        keeps its own device decision. True when a size is unknown (each
        morsel's gate decides)."""
        from ..device import column as dcol, costmodel, fragment
        from ..device import pipeline as dpipe
        probe, build = _source_rows(node.source), _source_rows(node.build)
        if not probe or build is None:
            return True
        m = int(self.cfg.default_morsel_size or 0)
        rows = max(n if m <= 0 or n <= m + m // 2 else m for n in probe)
        nbytes = 9.0 * rows * len(need)
        return costmodel.fusion_wins(
            "join_agg", rows, nbytes,
            (1 + 2 * n_planes) * 8 * dcol.bucket_capacity(fragment._OUT_CAP0),
            n_ops, host_bytes=nbytes, window=dpipe.inflight_window(),
            build_rows=sum(build))

    def _exec_region_join_agg(self, node: pp.FusedRegion, mode: str):
        """join_agg (reference ``executor.py:1073``): the broadcast build
        side materializes once on the host and is encoded and key-sorted
        once on the card; each probe morsel then joins, projects and
        partially aggregates in one dispatch. The output is partial group
        blocks, cast to the partial schema the parent final Aggregate
        merges."""
        from ..aggs import split_agg_expr
        from ..device import column as dcol, costmodel, fragment
        from ..device import runtime as drt
        specs = [split_agg_expr(a) for a in node.aggs]
        child_exprs = [(c if c is not None else _lit_true())
                       .alias(f"__v{i}__")
                       for i, (op, c, nm, pr) in enumerate(specs)]
        ops = tuple(s[0] for s in specs)
        agg_cols = [col(s[2]) for s in specs]
        post_pred = node.post_predicate
        prog = fragment.get_fused_join_agg(
            node.group_by, child_exprs, ops, node.predicate, post_pred,
            node.left_on[0].name(), node.right_on[0].name(),
            node.source.schema(), node.build.schema(),
            fused_ops=node.fused_ops)
        if prog is None:
            drt.count("region_declined_lowering")
            yield from self._exec(node.fallback)
            return
        n_ops = max(len(node.fused_ops), 3)
        nk, nv = len(node.group_by), len(ops)
        need = prog.probe_cols()
        if mode == "auto" and not self._largest_morsel_admitted(
                node, need, nk + nv, n_ops):
            drt.count("region_declined_gate")
            yield from self._exec(node.fallback)
            return
        build_rb = _gather_all_or_empty(self._exec(node.build),
                                        node.build.schema()).combined()
        build = fragment.prepare_region_build(prog, build_rb, self.device)
        if build is None:
            drt.count("region_declined_build")
            yield from self._exec(node.fallback)
            return
        # the next morsel's first group bucket: the last drained count
        g_hint = [fragment._OUT_CAP0]

        def host_run(rb: RecordBatch) -> MicroPartition:
            if node.predicate is not None:
                rb = rb.filter(node.predicate)
            joined = rb.hash_join(build_rb, list(node.left_on),
                                  list(node.right_on), "inner")
            if post_pred is not None:
                joined = joined.filter(post_pred)
            return MicroPartition.from_recordbatch(
                joined.agg(list(node.aggs), list(node.group_by))
                .cast_to_schema(node.schema()))

        def gate(rb: RecordBatch, window: int) -> bool:
            return self._region_gate(mode, rb, lambda: costmodel.fusion_wins(
                "join_agg", len(rb), dcol.encoded_nbytes(rb, need),
                (1 + 2 * (nk + nv)) * 8
                * dcol.bucket_capacity(max(g_hint[0], 1)),
                n_ops, host_bytes=drt._batch_cols_nbytes(rb, need),
                window=window, build_rows=len(build_rb)))

        def device_submit(rb: RecordBatch):
            return fragment.submit_join_agg(
                prog, rb, build, node.group_by, agg_cols, node.schema(),
                self.device, start_out_cap=g_hint[0])

        def device_drain(tok) -> Optional[MicroPartition]:
            res = fragment.drain_join_agg(tok)
            if res is None:
                return None
            out, g = res
            g_hint[0] = max(g, fragment._OUT_CAP0)
            return _to_partition(out, node)

        yield from self._run_region(
            self._exec(node.source), gate, device_submit, device_drain,
            host_run, lambda rb: dcol.encoded_nbytes(rb, need))

    # sorts ------------------------------------------------------------
    def _exec_Sort(self, node: pp.Sort):
        """Streaming external sort (reference ``executor.py:1388``, the
        blocking sink of ``sinks/blocking_sink.rs:32-55``): ONE pass over
        the child spills morsels under the breaker budget while sampling
        keys; boundaries from the sample range-fan the spilled stream into
        per-bucket stores; each bucket then sorts on its own — peak memory
        ≈ the breaker budget plus one bucket, never the whole child. The
        range partitioning places nulls by ``nulls_first``, so each bucket
        holds a contiguous run of the sorted order."""
        by = list(node.sort_by)
        desc, nf = list(node.descending), list(node.nulls_first)
        buf, samples = self._consume_sampling(
            self._exec(node.children[0]), by)
        try:
            if len(buf) == 0:
                yield MicroPartition.empty(node.schema())
                return
            n = self._breaker_fanout(buf.total_bytes)
            boundaries = None
            if n > 1 and len(buf) > 1 and samples:
                boundaries = sample_boundaries(
                    samples, [e.name() for e in by], desc, nf, n)
            if boundaries is None:
                yield _gather_all_or_empty(iter(buf), node.schema()).sort(
                    node.sort_by, node.descending, node.nulls_first)
                return
            yield from _ordered_parallel(
                self._stream_range_buckets(buf, by, boundaries, desc, nf, n,
                                           node.schema()),
                lambda p: p.sort(node.sort_by, node.descending,
                                 node.nulls_first))
        finally:
            buf.close()

    def _exec_TopN(self, node: pp.TopN):
        child = self._exec(node.children[0])
        tops = list(_ordered_parallel(
            child, lambda p: MicroPartition.from_recordbatch(
                p.combined().top_n(node.sort_by, node.limit, node.descending,
                                   node.nulls_first))))
        merged = _gather_all_or_empty(iter(tops), node.schema())
        yield MicroPartition.from_recordbatch(
            merged.combined().top_n(node.sort_by, node.limit,
                                    node.descending, node.nulls_first))


def _sample_kernel(node):
    """A ``Sample`` node's per-morsel function (shared with the push
    pipeline's map stage)."""
    if node.fraction is not None:
        return lambda p: p.sample(fraction=node.fraction, size=None,
                                  with_replacement=node.with_replacement,
                                  seed=node.seed)
    return lambda p: p.head(node.size)


def sample_boundaries(sampled_keys: List[RecordBatch],
                      key_names: List[str], descending: List[bool],
                      nulls_first: List[bool], n: int
                      ) -> Optional[RecordBatch]:
    """Concatenated key samples → n-1 range boundaries (sorted, null-free),
    or None when there is nothing to sample (reference
    ``executor.py:2142``)."""
    merged = RecordBatch.concat(sampled_keys)
    by = [col(nm) for nm in key_names]
    merged = merged.filter(~_any_null(by)) if len(merged) else merged
    if len(merged) == 0:
        return None
    merged_sorted = merged.sort(by, descending, nulls_first)
    idx = [min(int(len(merged_sorted) * (i + 1) / n),
               len(merged_sorted) - 1) for i in range(n - 1)]
    return merged_sorted.take(np.asarray(idx, dtype=np.int64))


def _any_null(by: List[Expression]) -> Expression:
    e = col(by[0].name()).is_null()
    for b in by[1:]:
        e = e | col(b.name()).is_null()
    return e


def _to_partition(out: RecordBatch, node) -> MicroPartition:
    return MicroPartition.from_recordbatch(out.cast_to_schema(node.schema()))


def _load_with_retry(task, tries: int = 2) -> MicroPartition:
    """Load a scan task, retrying a transient IO error once (reference
    ``executor.py:2083``: the input is re-readable from storage)."""
    last = None
    for attempt in range(max(tries, 1)):
        mp = MicroPartition.from_scan_task(task)
        try:
            mp._load()
            return mp
        except OSError as exc:
            last = exc
            if attempt + 1 < tries:
                time.sleep(min(0.2 * (2 ** attempt), 2.0))
    raise last


def _task_column_ndv(tasks, name: str) -> Optional[float]:
    """``max - min + 1`` of an int or date column over every task's parquet
    footer (reference ``executor.py:1947``; the ranges of
    ``logical/stats._footer_range``): one file's range would underestimate
    a scan range-partitioned on the key. None when a footer lacks usable
    statistics for it."""
    from ..logical.stats import _footer_range
    lo = hi = None
    seen = set()
    for t in tasks:
        for path, md, _ in t.files():
            # split tasks share a file: one footer per path
            if path in seen:
                continue
            seen.add(path)
            rng = _footer_range(md, name)
            if rng is None:
                return None
            lo = rng[0] if lo is None else min(lo, rng[0])
            hi = rng[1] if hi is None else max(hi, rng[1])
    return None if lo is None else float(hi - lo + 1)


def _task_scan_bytes(task) -> int:
    """Uncompressed bytes of the columns a scan task reads, from its
    footers: what a host scan of it decodes (a task without footers, a
    CSV or JSON one: its file bytes)."""
    names = task.materialized_schema().column_names
    total = 0
    for _, md, groups in task.files():
        if md is None:
            return task.size_bytes() or 0
        idx = {md.schema.column(i).name: i for i in range(md.num_columns)}
        for g in (groups if groups is not None
                  else range(md.num_row_groups)):
            rg = md.row_group(g)
            total += sum(rg.column(idx[n]).total_uncompressed_size
                         for n in names if n in idx)
    return total


def _fragment_groups_affordable(node, src) -> bool:
    """Up-front group-cardinality gate of the fused aggregation (reference
    ``executor.py:1983``): estimate the groups from the footers and refuse
    the device when fetching them would cost more than the host's own
    aggregation of the scan (a non-reductive grouping ships a group block
    rivalling its input). The rule ``fragment._max_out_cap`` applies at
    run time, applied before any upload. A shared-memory link, a computed
    key or a key without statistics (strings) passes."""
    import math

    from ..device import costmodel
    from ..device.fragment import packed_bytes_per_group
    p = costmodel.link_profile()
    if p.down_bps == math.inf:
        return True
    ndvs = []
    for g in node.group_by:
        u = g._unalias()
        if u.op != "col":
            return True
        ndv = _task_column_ndv(src.tasks, u.params[0])
        if ndv is None:
            return True
        ndvs.append(ndv)
    if not ndvs:
        return True   # global aggregation: one scalar row
    est_groups = 1.0
    for n in ndvs:
        est_groups *= n
    rows = sum(t.num_rows() or 0 for t in src.tasks)
    if rows:
        est_groups = min(est_groups, float(rows))
    size = sum(t.size_bytes() or 0 for t in src.tasks)
    host_s = max(size, 1) / costmodel.HOST_AGG_BPS
    return est_groups * packed_bytes_per_group(len(node.group_by),
                                               len(node.aggs)) \
        <= host_s * p.down_bps


def _source_rows(plan) -> Optional[List[int]]:
    """At most the rows of each partition the source under ``plan``'s
    Filters and Projects yields (in-memory partitions; scan tasks' footers,
    before their pushdown filters), all in one partition behind a gather
    exchange (a broadcast side's); None for any other subplan."""
    gather = False
    while isinstance(plan, (pp.Filter, pp.Project, pp.Exchange)):
        if isinstance(plan, pp.Exchange):
            if plan.kind != "gather":
                return None
            gather = True
        plan = plan.children[0]
    if isinstance(plan, pp.InMemorySource):
        rows = [len(p) for p in plan.partitions]
    elif isinstance(plan, pp.ScanSource):
        rows = [t.max_rows() for t in plan.tasks]
        if None in rows:
            return None
    else:
        return None
    return [sum(rows)] if gather else rows


def _lit_true() -> Expression:
    from ..expressions.expressions import lit
    return lit(True)


def _count_ici_exchange(rows: int, planes, valids) -> None:
    """Account one completed mesh exchange in the shuffle data plane: the
    encoded bytes that entered the all_to_all instead of the wire (shown
    per query in ``explain(analyze=True)`` and at ``/metrics``)."""
    from ..distributed.shuffle_service import shuffle_count
    nbytes = sum(int(p.nbytes) for p in planes) \
        + sum(int(v.nbytes) for v in valids)
    shuffle_count("ici_exchanges")
    shuffle_count("ici_rows", rows)
    shuffle_count("ici_bytes", nbytes)


def _encode_plane_lists(encode, names):
    """Encode columns into parallel (values, valids, dictionaries) plane
    lists; None when any column lacks a plain device plane."""
    vals, valids, dicts = [], [], []
    for nm in names:
        enc = encode(nm)
        if enc is None:
            return None
        vals.append(enc[0])
        valids.append(enc[1])
        dicts.append(enc[2])
    return vals, valids, dicts


def _decode_mesh_shards(n: int, live_mask: np.ndarray, cols_spec, schema
                        ) -> List[MicroPartition]:
    """Slice exchanged ``[n*C']`` planes into per-shard MicroPartitions.
    cols_spec: ordered (name, dtype, values, valids, dictionary) tuples,
    the dictionary set for string/binary columns riding codes."""
    from ..device import column as dcol
    shard_len = live_mask.shape[0] // n
    outs = []
    for i in range(n):
        sl = slice(i * shard_len, (i + 1) * shard_len)
        live = live_mask[sl]
        cols = [dcol.decode_np(nm, dtype, v[sl][live], m[sl][live], d)
                for nm, dtype, v, m, d in cols_spec]
        outs.append(MicroPartition.from_recordbatch(
            RecordBatch.from_series(cols).cast_to_schema(schema)))
    return outs


def _np_plane_encoder(rb: RecordBatch, cap: int):
    """Column name → (values, validity, dictionary) numpy planes zero-padded
    to ``cap``, or None when the column has no plain device plane.

    String/binary columns ride dictionary codes. That is sound across
    shards: every mesh path concatenates its partitions into ONE batch
    before encoding, so all shards share one dictionary, and
    ``column._np_encode`` ranks codes over the SORTED dictionary, so code
    order is lexicographic order (min/max on codes is correct)."""
    import pyarrow as pa
    from ..device import column as dcol

    def encode(name):
        try:
            vals, valid, dictionary = dcol._np_encode(rb.get_column(name))
        except (ValueError, TypeError, pa.ArrowInvalid):
            return None
        if len(vals) < cap:
            vals = np.concatenate(
                [vals, np.zeros(cap - len(vals), dtype=vals.dtype)])
            valid = np.concatenate(
                [valid, np.zeros(cap - len(valid), dtype=np.bool_)])
        return vals, valid, dictionary

    return encode


def _gather_all_or_empty(parts: Iterator[MicroPartition],
                         schema) -> MicroPartition:
    ps = list(parts)
    if not ps:
        return MicroPartition.empty(schema)
    return ps[0].concat(ps[1:]) if len(ps) > 1 else ps[0]
