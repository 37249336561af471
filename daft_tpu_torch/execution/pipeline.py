"""Push-based morsel pipeline: per-operator workers over bounded channels.

The port of ``daft_tpu/execution/pipeline.py`` (the reference's local
engine, "Swordfish", ``src/daft-local-execution/src/pipeline.rs:100-830``):
every operator runs as concurrent tasks connected by bounded channels — a
dispatcher distributes input morsels to N workers (``dispatcher.rs:24-60``:
RoundRobin preserves order, Partitioned fans by key), and blocking sinks
consume their whole input through the same channels before emitting
(``sinks/blocking_sink.rs:32-55``). Not to be confused with
``device/pipeline.py``, the bounded in-flight window of device slots one
fused-agg handler drives.

Built on Python threads (Arrow C++ and torch release the GIL, so operator
workers overlap):

- :class:`Channel` — bounded MPMC queue with producer-refcounted close and
  cooperative cancellation.
- :class:`PipelineContext` — per-query thread registry, first-error
  capture, cancellation fan-out.
- :class:`PushExecutor` — a :class:`LocalExecutor` whose ``_exec`` returns
  an iterator over an ACTIVELY-PUSHED output channel:

  * map-shaped operators (Project/Filter/Dedup/Sample/Window/Aggregate)
    become worker stages: one RoundRobin dispatcher thread, N kernel
    workers, one collector thread that restores order; a chain of them
    that feeds only itself runs as one such stage;
  * a final grouped Aggregate over an engine-inserted hash Exchange
    becomes the partitioned-agg stage: the dispatcher hashes each partial
    morsel to one of k reducers, each merging its groups as they arrive
    (or, past the budget, spilling partial states to a rotated-radix
    store and merging each bucket on read);
  * everything else (sources, sorts, joins, exchanges, the device
    fragments and regions, limits) runs its inherited handler inside a
    dedicated driver thread; the handler's child pulls become channel
    reads.

Threads and the card: a kernel wrapper launches on the current stream of
the thread that calls it — each stage thread's default stream, the
device's legacy default stream, which orders launches across threads;
the fused-agg handler's slots keep their own streams and events as in the
interpreter. A driver stage closes its handler when it ends, cancelled or
failed, so the device pipeline's teardown releases every slot it holds.

Stage bodies run on threads kept across queries (:class:`_StageThreads`),
so a query starts no thread once the process has run one as wide.
Cancellation: dropping the output iterator (or an operator error) cancels
the context, which wakes every blocked channel operation of the query at
once; the stages unwind. The first error wins and re-raises at the
consumer.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Callable, Iterator, List, Optional

from ..micropartition import MicroPartition
from ..physical import plan as pp
from .executor import LocalExecutor, _sample_kernel

_REAGG_ROWS = 1 << 17  # partitioned-agg reducer: merge state every N rows


class PipelineCancelled(Exception):
    """Internal unwind signal — never escapes to the user."""


class _StageThreads:
    """Threads for stage bodies, kept across queries: a body runs on an
    idle thread, or on a new one when none is idle (every stage needs a
    thread of its own: stages block on each other's channels, so a fixed
    pool could deadlock). A query's stages so pay no thread start once
    the process has run one as wide; an idle thread waits on its own
    queue, with no polling."""

    #: idle threads kept past this many exit
    MAX_IDLE = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: List[queue.SimpleQueue] = []

    def submit(self, fn: Callable[[], None], name: str) -> threading.Event:
        done = threading.Event()
        with self._lock:
            inbox = self._idle.pop() if self._idle else None
        if inbox is None:
            inbox = queue.SimpleQueue()
            threading.Thread(target=self._loop, args=(inbox,),
                             name=name, daemon=True).start()
        inbox.put((fn, name, done))
        return done

    def _loop(self, inbox: queue.SimpleQueue) -> None:
        me = threading.current_thread()
        while True:
            fn, name, done = inbox.get()
            me.name = name
            try:
                fn()
            finally:
                me.name = "daft-torch-stage-idle"
                done.set()
            with self._lock:
                if len(self._idle) >= self.MAX_IDLE:
                    return
                self._idle.append(inbox)


_STAGE_THREADS = _StageThreads()


class PipelineContext:
    """Per-query registry of stage bodies + first-error capture. A cancel
    (or the first error) wakes every channel of the query at once."""

    def __init__(self):
        self.cancelled = threading.Event()
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._done: List[threading.Event] = []
        self._channels: List["Channel"] = []
        #: the owning query's RuntimeStatsContext, installed on every
        #: stage thread so the plane counters credit this query
        self.stats_ctx = None

    def fail(self, exc: BaseException):
        with self._lock:
            if self.error is None:
                self.error = exc
        self.cancel()

    def cancel(self):
        self.cancelled.set()
        with self._lock:
            channels = list(self._channels)
        for ch in channels:
            ch._wake()

    def _register(self, ch: "Channel") -> None:
        with self._lock:
            self._channels.append(ch)
        if self.cancelled.is_set():
            ch._wake()

    def spawn(self, fn: Callable[[], None], name: str) -> threading.Event:
        done = _STAGE_THREADS.submit(lambda: self._guard(fn), name)
        with self._lock:
            self._done.append(done)
        return done

    def _guard(self, fn):
        from .. import observability as obs
        from .. import tracing
        try:
            # the stage thread outlives the query: attributed() installs
            # this query's stats and span context and restores the
            # thread's own on exit, so nothing leaks into the next query
            # the thread runs
            with obs.attributed(self.stats_ctx):
                # one span per stage body; the thread name is
                # plan-derived, so span ids replay
                name = threading.current_thread().name
                with tracing.span("pipeline:stage", key=f"stage:{name}",
                                  attrs={"thread": name},
                                  lane="pipeline"):
                    fn()
        except PipelineCancelled:
            pass
        except BaseException as exc:  # noqa: BLE001 — first error wins
            self.fail(exc)

    def join(self, timeout: float = 5.0):
        """Wait for every stage body of the query to return."""
        with self._lock:
            done = list(self._done)
        for d in done:
            d.wait(timeout)


_DONE = object()


class Channel:
    """Bounded channel with producer-refcounted close.

    ``producers`` producers must each call :meth:`close`; when the last
    one does, ``consumers`` DONE markers are enqueued so every consumer's
    iteration terminates. A blocked put or get waits on the channel's
    condition, which an item, a free slot or the query's cancel wakes."""

    def __init__(self, ctx: PipelineContext, capacity: int = 4,
                 producers: int = 1, consumers: int = 1):
        self.ctx = ctx
        self._items: collections.deque = collections.deque()
        self._capacity = max(capacity, 1)
        self._cond = threading.Condition()
        self._producers = producers
        self._consumers = consumers
        self._lock = threading.Lock()
        ctx._register(self)

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def put(self, item) -> None:
        cancelled = self.ctx.cancelled
        with self._cond:
            while len(self._items) >= self._capacity \
                    and not cancelled.is_set():
                self._cond.wait()
            if cancelled.is_set():
                raise PipelineCancelled()
            self._items.append(item)
            self._cond.notify_all()

    def close(self) -> None:
        with self._lock:
            self._producers -= 1
            if self._producers > 0:
                return
        for _ in range(self._consumers):
            try:
                self.put(_DONE)
            except PipelineCancelled:
                return

    def __iter__(self) -> Iterator:
        cancelled = self.ctx.cancelled
        while True:
            with self._cond:
                while not self._items and not cancelled.is_set():
                    self._cond.wait()
                if cancelled.is_set():
                    raise PipelineCancelled()
                item = self._items.popleft()
                self._cond.notify_all()
            if item is _DONE:
                return
            yield item


def _default_workers() -> int:
    return max(min((os.cpu_count() or 4), 8), 2)


# map-shaped operators: (node type name) -> kernel factory. Each returns a
# per-morsel function; the stage machinery provides dispatcher / workers /
# in-order collection. Per-partition semantics match executor.py's
# _ordered_parallel bodies (single-sourced there for the interpreter).
def _map_kernel(node) -> Optional[Callable[[MicroPartition], MicroPartition]]:
    name = type(node).__name__
    if name == "Project":
        return lambda p: p.eval_expression_list(node.exprs)
    if name == "Filter":
        return lambda p: p.filter(node.predicate)
    if name == "Dedup":
        return lambda p: p.distinct(node.on)
    if name == "Unpivot":
        return lambda p: p.unpivot(node.ids, node.values,
                                   node.variable_name, node.value_name)
    if name == "Sample":
        return _sample_kernel(node)
    if name == "Pivot":
        return lambda p: p.pivot(node.group_by, node.pivot_col,
                                 node.value_col,
                                 node.names).cast_to_schema(node.schema())
    if name == "Window":
        from ..window_exec import run_window
        return lambda p: MicroPartition.from_recordbatch(
            run_window(p.combined(), node))
    if name == "Aggregate":
        # per-partition agg (partial stage, or final over hash buckets) is
        # map-shaped; the fused device fragment stays a driver stage
        return lambda p: p.agg(node.aggs, node.group_by) \
            .cast_to_schema(node.schema())
    return None


def _map_workers(node) -> int:
    return _default_workers()


# The final-stage agg ops the fused reducer can merge are the associative
# self-merges single-sourced in ``aggs.AGG_DECOMPOSITION``: re-applying the
# op over its own output column merges two partial states correctly, which
# is what makes the reference's Partitioned dispatcher + grouped_aggregate
# sink sound (``dispatcher.rs:24-60``, ``sinks/grouped_aggregate.rs:54-151``).
# The merge expressions come from ``aggs.merge_exprs_for`` (shared with the
# streaming reduce-side merge agg).

#: decline the fused dispatcher when the evidence predicts more groups
#: than this: the spill-bounded exchange path aggregates each bucket
#: exactly once, while the fused reducer's LSM merges cost O(log n) passes
#: over a state it must also hold in RAM. The ceiling is the reference's
#: policy (its crossover lay between TPC-H Q18's 15M and 150M groups, on
#: its own machine; not measured for the port). Evidence, best-first:
#: parquet-footer
#: NDV; else the planner's row estimate (an upper bound on groups — a
#: near-unique-key groupby on a huge in-memory source must not default
#: into the fused reducer's unbounded group state);
#: either way a configured DAFT_TORCH_MEMORY_LIMIT additionally declines
#: predicted group state that cannot fit the budget.
_FUSE_MAX_GROUPS = 32_000_000

#: resident bytes one group row costs the fused reducer (key + agg state
#: columns at ~8B each plus Arrow overhead), times the ~2× LSM headroom —
#: deliberately coarse; only the order of magnitude gates anything
_FUSE_BYTES_PER_GROUP = 16


def _fused_groups_admissible(node) -> bool:
    """Decline-if-huge gate for the fused partitioned-agg dispatcher."""
    ndv = getattr(node, "group_ndv", None)
    if ndv is None:
        ndv = getattr(node, "group_rows_est", None)
    if ndv is None:
        return True
    if ndv > _FUSE_MAX_GROUPS:
        return False
    from .memory import memory_limit_bytes
    budget = memory_limit_bytes()
    if budget is not None:
        est = _est_state_bytes(node)
        if est is not None and est > budget:
            return False
    return True


def _est_state_bytes(node):
    """Predicted resident group-state bytes for this final agg (the
    fused reducer's working set): NDV evidence × row width × the coarse
    per-group cost — None without evidence."""
    ndv = getattr(node, "group_ndv", None)
    if ndv is None:
        ndv = getattr(node, "group_rows_est", None)
    if ndv is None:
        return None
    width = max(1 + len(getattr(node, "group_by", ())
                        ) + len(getattr(node, "aggs", ())), 2)
    return float(ndv) * width * _FUSE_BYTES_PER_GROUP


def _partitioned_agg_info(node, cfg=None):
    """When ``node`` is a final grouped Aggregate over an engine-inserted
    hash Exchange whose final aggs are associative self-merges, return
    (exchange_child, key_exprs, merge_aggs, spill, est_state_bytes) for
    the fused partitioned-agg stage; else None. ``merge_aggs`` re-merge
    two batches of FINAL-schema state: for a final agg
    ``op(col(p)).alias(out)``, the merge is ``op(col(out)).alias(out)``.

    ``spill`` selects the spill-partitioned reducer: a group
    state the budget can't hold streams through a rotated-radix spill
    store and merges per bucket on read (``AGG_DECOMPOSITION`` self-merge
    semantics) — peak RSS ≈ budget + one bucket — instead of declining
    the fusion (``DAFT_TORCH_SPILL_AGG=0`` restores the decline)."""
    from ..aggs import merge_exprs_for
    from . import out_of_core as ooc
    if not (isinstance(node, pp.Aggregate) and node.mode == "final"
            and node.group_by):
        return None
    ch = node.children[0]
    if not (isinstance(ch, pp.Exchange) and ch.kind == "hash"
            and ch.engine_inserted):
        return None
    mode = ooc.spill_agg_mode(cfg)
    est_state = _est_state_bytes(node)
    if _fused_groups_admissible(node):
        spill = mode == "1"
    elif mode == "0":
        return None  # legacy decline → the spill-bounded exchange plan
    else:
        # the in-memory reducer's state would not fit (or NDV evidence
        # is past the fuse ceiling): spill-partitioned reducer
        spill = True
    # shared subplans stream through the executor's shared buffer — the
    # fusion would bypass it
    if getattr(ch, "shared_consumers", 1) > 1 \
            or getattr(node, "shared_consumers", 1) > 1:
        return None
    merge = merge_exprs_for(node.aggs)
    if merge is None:
        return None
    return ch.children[0], list(ch.by), merge, spill, est_state


class PushExecutor(LocalExecutor):
    """Push-dataflow executor: every plan node is an always-running stage.

    Inherits every operator implementation from :class:`LocalExecutor`;
    only the wiring changes — ``_exec`` spawns the node's stage threads and
    returns an iterator over its bounded output channel, so a handler's
    ``self._exec(child)`` transparently becomes a channel subscription and
    the whole plan runs concurrently with backpressure."""

    #: channel capacity between stages, in morsels. Small: backpressure is
    #: the point; each buffered morsel is ~default_morsel_size rows.
    CHANNEL_CAPACITY = 4

    def __init__(self, device=None):
        super().__init__(device)
        self.pipe = PipelineContext()

    # ------------------------------------------------------------- entry
    def run(self, plan: pp.PhysicalPlan,
            stage_inputs=None) -> Iterator[MicroPartition]:
        from .. import observability as obs
        from . import cancellation as _cxl
        if stage_inputs:
            self.stage_inputs = stage_inputs
        # made now, so the stats adopt the caller's trace
        stats = self.stats = obs.new_query_stats()
        stats.plan = plan
        self.pipe.stats_ctx = stats
        tok = self.cancel_token
        if tok is not None:
            # a fired token must unblock EVERY stage (the pipeline's
            # cancel wakes each channel), not just the driver loop
            tok.add_callback(self.pipe.cancel)

        def gen():
            capture = obs.profile_capture(self.device)
            try:
                with obs.attributed(stats):
                    out = obs.wrap_progress(self._exec(plan))
                while True:
                    try:
                        with obs.attributed(stats):
                            mp = next(out)
                    except StopIteration:
                        break
                    except PipelineCancelled:
                        break
                    yield mp
                if tok is not None and tok.is_set():
                    raise _cxl.QueryCancelled(
                        tok.reason or "query cancelled")
                if self.pipe.error is not None:
                    raise self.pipe.error
            finally:
                self.pipe.cancel()
                # the cancel wakes every stage; waiting here makes a
                # query's end the end of its stage bodies (and of the
                # device slots their handlers held)
                self.pipe.join()
                obs.end_query(stats, capture)
        return gen()

    # ------------------------------------------------------------ stages
    # _exec (inherited) routes multi-consumer nodes through the shared
    # buffer; everything else lands here and becomes a stage
    def _exec_node(self, node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        pagg = _partitioned_agg_info(node, self.cfg)
        if pagg is not None:
            out = self._partitioned_agg_stage(node, *pagg)
        elif isinstance(node, pp.Aggregate) \
                and self._streamed_agg_input(node):
            # a streaming stage input yields one morsel per map SOURCE
            # (not hash-disjoint): the per-morsel map kernel would
            # duplicate groups, so the inherited streaming merge-agg
            # handler runs on a driver stage instead
            out = self._driver_stage(node)
        else:
            kernel = _map_kernel(node)
            if kernel is not None:
                bottom, kernel = self._map_chain(node, kernel)
                out = self._map_stage(node, kernel, bottom.children[0])
            else:
                out = self._driver_stage(node)
        if self.stats is not None:
            return self.stats.instrument(node, iter(out))
        return iter(out)

    def _map_chain(self, node, kernel):
        """Extend a map stage down through the map-shaped operators under
        ``node`` that feed only it: the chain runs as ONE stage whose
        workers apply the operators' kernels in turn (per morsel, the same
        functions in the same order), so a Filter/Project chain pays one
        dispatcher, one worker set and one collector instead of one each
        per operator. Returns the chain's lowest node and the composed
        kernel."""
        kernels, bottom = [kernel], node
        while True:
            ch = bottom.children[0]
            if getattr(ch, "shared_consumers", 1) > 1 \
                    or _partitioned_agg_info(ch, self.cfg) is not None \
                    or (isinstance(ch, pp.Aggregate)
                        and self._streamed_agg_input(ch)):
                break
            k = _map_kernel(ch)
            if k is None:
                break
            # the chain's inner operators never cross a channel: their
            # rows are counted where their kernels run
            if self.stats is not None:
                k = self.stats.instrument_kernel(ch, k)
            kernels.append(k)
            bottom = ch
        if len(kernels) == 1:
            return bottom, kernel
        chain = kernels[::-1]   # the lowest operator first

        def composed(p):
            for k in chain:
                p = k(p)
            return p
        return bottom, composed

    def _driver_stage(self, node) -> Channel:
        """One dedicated thread runs the inherited handler generator and
        pushes its output — sources, sinks, joins, exchanges, device tiers
        and limits keep their single-sourced implementations while still
        living inside the push topology."""
        h = getattr(LocalExecutor, "_exec_" + type(node).__name__, None)
        if h is None:
            raise NotImplementedError(f"executor for {type(node).__name__}")
        out = Channel(self.pipe, self.CHANNEL_CAPACITY)

        def drive():
            # fail() BEFORE close(): close enqueues the DONE marker, and a
            # consumer that drains it must already see ctx.error — the
            # reverse order can end a failing query as a clean truncated
            # stream
            gen = h(self, node)
            try:
                for mp in gen:
                    out.put(mp)
            except PipelineCancelled:
                pass
            except BaseException as exc:  # noqa: BLE001
                self.pipe.fail(exc)
            finally:
                # the handler's teardown (spill stores, device slots) runs
                # now, on this thread, not whenever the generator is freed
                try:
                    gen.close()
                except BaseException as exc:  # noqa: BLE001
                    self.pipe.fail(exc)
                out.close()
        self.pipe.spawn(drive, name=f"drv-{type(node).__name__}")
        return out

    def _partitioned_agg_stage(self, node, exchange_child, by,
                               merge_aggs, spill: bool = False,
                               est_state=None) -> Channel:
        """Partitioned-by-hash dispatcher fused with the final grouped
        aggregation (reference ``dispatcher.rs:24-60`` Partitioned +
        ``sinks/grouped_aggregate.rs:54-151``): the dispatcher hashes each
        incoming partial-agg morsel into k slices, worker i streams
        partition i, incrementally merging its state every
        ``_REAGG_ROWS`` buffered rows, and emits its final state at
        close. Replaces Exchange(hash) + per-bucket map agg: no
        materialization barrier, k concurrent reducers, and the final agg
        starts before the child finishes.

        Memory: the un-merged buffer is bounded by
        ``max(_REAGG_ROWS, len(state))`` — the LSM-style amortization lets
        it grow to the current state size, so peak residency is ~2× the
        worker's group cardinality (proportional to the output this
        reducer must materialize anyway). With ``spill`` the
        reducer never holds its state at all: every ``_REAGG_ROWS`` the
        buffer collapses to FINAL-schema partial states that radix-fan
        (rotated — the dispatcher already consumed ``h % k``) into a
        per-reducer spill store, and each bucket self-merges ON READ via
        the ``AGG_DECOMPOSITION`` merge expressions — an unbounded-NDV
        group-by streams in one pass at peak RSS ≈ budget + one bucket,
        recursing (bounded) on a bucket skew redominates.

        k is the default worker count, at most the partitions the planner
        gave the exchange it replaces: a single-partition exchange keeps
        one reducer, one final aggregate (a k-way split of a small state
        pays k aggregates for no parallelism)."""
        k = max(1, min(_default_workers(),
                       node.children[0].num_partitions))
        if self.stats is not None:
            self.stats.register(node).workers = k
        if self.cfg.enable_aqe:
            self._aqe().record_replan(
                f"fused partitioned agg: hash shuffle elided → {k} reducers"
                + (" (spill-partitioned)" if spill else ""))
        child = self._exec(exchange_child)
        in_q = [Channel(self.pipe, 2) for _ in range(k)]
        out = Channel(self.pipe, self.CHANNEL_CAPACITY, producers=k)
        name = type(node).__name__

        def dispatch():
            try:
                for mp in child:
                    for i, part in enumerate(mp.partition_by_hash(by, k)):
                        if len(part):
                            in_q[i].put(part)
            except PipelineCancelled:
                pass
            except BaseException as exc:  # noqa: BLE001
                self.pipe.fail(exc)  # before close — see _driver_stage
            finally:
                for q in in_q:
                    q.close()

        def reducer(i):
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

            try:
                for mp in in_q[i]:
                    buf.append(mp)
                    rows += len(mp)
                    # merge only once the buffer rivals the state (LSM-style
                    # amortization): every row then joins O(log n) merges.
                    # A fixed threshold is quadratic on near-unique keys
                    # (groups ≈ rows): it re-merges the whole state every
                    # _REAGG_ROWS rows
                    if rows >= max(_REAGG_ROWS,
                                   0 if state is None else len(state)):
                        merge()
                merge()
                if state is not None and len(state):
                    out.put(state)
            except PipelineCancelled:
                pass
            except BaseException as exc:  # noqa: BLE001
                self.pipe.fail(exc)
            finally:
                out.close()

        def spill_reducer(i):
            from ..expressions import col as _col
            from . import memory, out_of_core as ooc, spill_io
            skeys = [_col(g.name()) for g in node.group_by]
            m = ooc.agg_state_fanout(est_state, k, self.cfg)
            depth_max = ooc.spill_max_depth(self.cfg)
            bucket_budget = max(ooc.pair_budget_bytes() // k, 16 << 10)
            store = memory.PartitionedSpillStore(
                m, budget=max(memory.breaker_budget_bytes() // k,
                              16 << 10))
            buf: List[MicroPartition] = []
            rows = 0
            # the memory-bounded reducer ran (its store spills only once
            # the partial states outgrow the bucket budget)
            memory.spill_count("agg_reducers_spilling")

            def flush():
                nonlocal buf, rows
                if not buf:
                    return
                fresh = buf[0].concat(buf[1:]) if len(buf) > 1 else buf[0]
                fresh = fresh.agg(node.aggs, node.group_by) \
                    .cast_to_schema(node.schema())
                for j, piece in enumerate(ooc.radix_split(
                        fresh.combined(), skeys, m, 1)):
                    if len(piece):
                        store.push(j, piece)
                buf, rows = [], 0

            try:
                for mp in in_q[i]:
                    buf.append(mp)
                    rows += len(mp)
                    if rows >= _REAGG_ROWS:
                        flush()
                flush()
                store.finalize()
                # bucket reads prefetch-pipelined like the grace join's
                # pair reads: bucket j+1 decodes while j merges
                for batches in spill_io.prefetch_ordered(
                        (lambda j=j: store.bucket_batches(j)
                         for j in range(m)),
                        spill_io.read_prefetch_window(self.cfg)):
                    if not batches:
                        continue
                    for state in ooc.merge_spilled_agg_bucket(
                            batches, merge_aggs, node.group_by,
                            node.schema(), skeys, 1, depth_max,
                            bucket_budget):
                        if len(state):
                            out.put(state)
            except PipelineCancelled:
                pass
            except BaseException as exc:  # noqa: BLE001
                self.pipe.fail(exc)
            finally:
                store.close()
                out.close()

        self.pipe.spawn(dispatch, name=f"dsp-{name}")
        body = spill_reducer if spill else reducer
        for i in range(k):
            self.pipe.spawn(lambda i=i: body(i), name=f"red-{name}-{i}")
        return out

    def _map_stage(self, node, kernel, child_node=None) -> Channel:
        """RoundRobin dispatcher → N kernel workers → in-order collector
        (``dispatcher.rs:38-131``: RR to per-worker channels preserves
        global order when read back round-robin). ``child_node`` (default
        ``node``'s child) is the stage's input: the child of a map chain's
        lowest operator."""
        k = _map_workers(node)
        if self.stats is not None:
            self.stats.register(node).workers = k
        child = self._exec(node.children[0] if child_node is None
                           else child_node)
        in_q = [Channel(self.pipe, 2) for _ in range(k)]
        out_q = [Channel(self.pipe, 2) for _ in range(k)]
        out = Channel(self.pipe, self.CHANNEL_CAPACITY)
        name = type(node).__name__

        def dispatch():
            try:
                i = 0
                for mp in child:
                    in_q[i % k].put(mp)
                    i += 1
            except PipelineCancelled:
                pass
            except BaseException as exc:  # noqa: BLE001
                self.pipe.fail(exc)  # before close — see _driver_stage
            finally:
                for q in in_q:
                    q.close()

        def worker(i):
            try:
                for mp in in_q[i]:
                    out_q[i].put(kernel(mp))
            except PipelineCancelled:
                pass
            except BaseException as exc:  # noqa: BLE001
                self.pipe.fail(exc)
            finally:
                out_q[i].close()

        def collect():
            try:
                iters = [iter(q) for q in out_q]
                alive = list(range(k))
                while alive:
                    nxt = []
                    for i in alive:
                        try:
                            out.put(next(iters[i]))
                            nxt.append(i)
                        except StopIteration:
                            pass
                    alive = nxt
            except PipelineCancelled:
                pass
            except BaseException as exc:  # noqa: BLE001
                self.pipe.fail(exc)
            finally:
                out.close()

        self.pipe.spawn(dispatch, name=f"dsp-{name}")
        for i in range(k):
            self.pipe.spawn(lambda i=i: worker(i), name=f"wrk-{name}-{i}")
        self.pipe.spawn(collect, name=f"col-{name}")
        return out
