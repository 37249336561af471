"""Local executor: interprets a physical plan into a stream of
MicroPartitions.

Reference: ``daft_tpu/execution/executor.py`` (the pull-generator
interpreter). The port runs single-node and synchronously per morsel: a
final aggregate, sort or top-n gathers its whole input, and the fused
device fragment (``_exec_DeviceFragmentAgg``) takes one source-file batch
per dispatch. A hash join gathers both sides and joins once; a broadcast
join gathers one side and joins it against each morsel of the other
(``_exec_HashJoin``; the index generation goes to the device per
``joins.py``). A device error propagates; only a morsel whose expressions
do not compile for the device runs the host chain, and it is counted.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
from typing import Callable, Iterator, List, Optional

from ..context import get_context
from ..expressions import Expression, col
from ..micropartition import MicroPartition
from ..physical import plan as pp
from ..recordbatch import RecordBatch
from ..schema import Schema

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


def _ordered_parallel(inputs: Iterator, fn: Callable,
                      width: Optional[int] = None) -> Iterator:
    """Map fn over inputs on the pool, yielding results in order with a
    bounded in-flight window (backpressure)."""
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
            pending.append(pool.submit(fn, x))
        if not pending:
            return
        yield pending.pop(0).result()


class PartitionSet:
    """Materialized query result: an ordered list of MicroPartitions."""

    def __init__(self, partitions: List[MicroPartition], schema: Schema):
        self.partitions = partitions
        self.schema = schema

    def __len__(self) -> int:
        return sum(len(p) for p in self.partitions)

    def to_recordbatch(self) -> RecordBatch:
        batches = []
        for p in self.partitions:
            batches.extend(p.batches())
        batches = [b for b in batches if len(b)] or batches[:1]
        if not batches:
            return RecordBatch.empty(self.schema)
        return RecordBatch.concat(batches).cast_to_schema(self.schema)


def run_plan(builder) -> Iterator[MicroPartition]:
    """Optimize → translate → execute. The device is resolved here, once
    per query, so a query asked to run on a card that is not there fails
    before it reads anything."""
    from ..device import backend
    from ..physical.translate import translate
    device = backend.resolve_device()
    pplan = translate(builder.optimize().plan)
    return LocalExecutor(device).run(pplan)


class LocalExecutor:
    """Interprets a physical plan into a stream of MicroPartitions.
    ``device`` is the torch device of the fused fragments, or None for the
    host tier."""

    def __init__(self, device=None):
        self.cfg = get_context().execution_config
        self.device = device

    def run(self, plan: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        return self._exec(plan)

    def _exec(self, node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        h = getattr(self, "_exec_" + type(node).__name__, None)
        if h is None:
            raise NotImplementedError(f"executor for {type(node).__name__}")
        return h(node)

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

    def _scan_files(self, node: pp.ScanSource) -> Iterator[MicroPartition]:
        """One partition per scan task (one source file), loaded on the
        pool in task order."""
        if not node.tasks:
            yield MicroPartition.empty(node.schema())
            return

        def load(t) -> MicroPartition:
            mp = MicroPartition.from_scan_task(t)
            mp._load()
            return mp
        yield from _ordered_parallel(iter(node.tasks), load)

    def _exec_ScanSource(self, node: pp.ScanSource):
        yield from self._morselize(self._scan_files(node))

    def _exec_InMemorySource(self, node: pp.InMemorySource):
        if not node.partitions:
            yield MicroPartition.empty(node.schema())
            return
        yield from iter(node.partitions)

    # pipelined maps ---------------------------------------------------
    def _exec_Project(self, node: pp.Project):
        child = self._exec(node.children[0])
        yield from _ordered_parallel(
            child, lambda p: p.eval_expression_list(node.exprs))

    def _exec_Filter(self, node: pp.Filter):
        child = self._exec(node.children[0])
        yield from _ordered_parallel(child, lambda p: p.filter(node.predicate))

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

    # aggregation ------------------------------------------------------
    def _exec_Aggregate(self, node: pp.Aggregate):
        child = self._exec(node.children[0])
        if node.mode == "partial":
            yield from _ordered_parallel(
                child, lambda p: p.agg(node.aggs, node.group_by)
                .cast_to_schema(node.schema()))
            return
        # single node: the final (or single-stage) aggregate sees every
        # partial in one place
        yield _gather_all_or_empty(child, node.children[0].schema()) \
            .agg(node.aggs, node.group_by).cast_to_schema(node.schema())

    def _exec_DeviceFragmentAgg(self, node: pp.DeviceFragmentAgg):
        from ..aggs import split_agg_expr
        from ..device import fragment, runtime as drt
        specs = [split_agg_expr(a) for a in node.aggs]
        child_exprs = [(c if c is not None else _lit_true())
                       .alias(f"__v{i}__")
                       for i, (op, c, nm, pr) in enumerate(specs)]
        ops = tuple(s[0] for s in specs)
        agg_cols = [col(s[2]) for s in specs]

        def run(p: MicroPartition) -> MicroPartition:
            rb = p.combined()
            prog = None
            if self.device is not None and len(rb) > 0:
                prog = fragment.get_fused_agg(node.group_by, child_exprs,
                                              ops, node.predicate, rb.schema)
            if prog is not None and not any(
                    rb.get_column(n).is_pyobject()
                    for n in prog.compiled.needs_cols):
                out = fragment.run_fused_agg(prog, rb, node.group_by,
                                             agg_cols, node.schema(),
                                             self.device)
                return MicroPartition.from_recordbatch(
                    out.cast_to_schema(node.schema()))
            # planning, not a fallback: the host tier was asked for, the
            # morsel is empty, or its expressions have no device lowering
            drt.count("host_morsels")
            if node.predicate is not None:
                rb = rb.filter(node.predicate)
            return MicroPartition.from_recordbatch(
                rb.agg(node.aggs, node.group_by)
                .cast_to_schema(node.schema()))

        src = node.children[0]
        # a device dispatch takes a whole source file: big morsels amortize
        # the launches, and the kernels are sized for them
        stream = self._scan_files(src) if isinstance(src, pp.ScanSource) \
            else self._exec(src)
        for p in stream:
            yield run(p)

    # joins ------------------------------------------------------------
    def _exec_HashJoin(self, node: pp.HashJoin):
        how = node.how
        lnode, rnode = node.children
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
        # hash: single node, so both sides gather and join once
        lall = _gather_all_or_empty(self._exec(lnode), lnode.schema())
        rall = _gather_all_or_empty(self._exec(rnode), rnode.schema())
        yield lall.hash_join(rall, node.left_on, node.right_on, how)

    # sorts ------------------------------------------------------------
    def _exec_Sort(self, node: pp.Sort):
        yield _gather_all_or_empty(self._exec(node.children[0]),
                                   node.schema()).sort(
            node.sort_by, node.descending, node.nulls_first)

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


def _lit_true() -> Expression:
    from ..expressions.expressions import lit
    return lit(True)


def _gather_all_or_empty(parts: Iterator[MicroPartition],
                         schema) -> MicroPartition:
    ps = list(parts)
    if not ps:
        return MicroPartition.empty(schema)
    return ps[0].concat(ps[1:]) if len(ps) > 1 else ps[0]
