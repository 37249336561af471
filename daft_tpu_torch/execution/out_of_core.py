"""Out-of-core execution: grace hash join and spill-partitioned aggregation.

The port of ``daft_tpu/execution/out_of_core.py``. The breaker tier
(``execution/memory.py``) bounds how much a blocking sink *buffers*; this
module bounds the per-partition WORK units — one join bucket pair, one
final-agg bucket — so a bucket that outgrows the budget is a price, not
an OOM:

- **grace hash join** — both sides radix-partition by the join-key hash
  chain into :class:`~.memory.PartitionedSpillStore` buckets, streamed
  straight off the child; bucket PAIRS join one at a time, and a pair
  that still exceeds the pair budget re-partitions with a ROTATED radix
  (rehash of the hash — depth d is decorrelated from depth d-1's
  ``h % n`` residue) up to ``DAFT_TORCH_SPILL_MAX_DEPTH``. Per-pair joins
  go through the ordinary ``hash_join``, so the card takes a pair
  wherever ``costmodel.join_wins`` prices it there (the hash-join
  kernels, ``joins.py``).
- **spill-partitioned aggregation** — the fused partitioned-agg reducer
  (``execution/pipeline.py``) spills overflowing group state as PARTIAL
  state rows into a rotated-radix store and merges each bucket on read
  with the ``AGG_DECOMPOSITION`` self-merge expressions, recursing on a
  bucket that still does not fit.

``DAFT_TORCH_SPILL_JOIN`` / ``DAFT_TORCH_SPILL_AGG`` gate the two paths
(``auto`` prices via ``costmodel.spill_plan_wins``; ``1`` forces
partitioned execution; ``0`` materializes both join sides and re-fans
them, or declines the spilling reducer). Null keys hash consistently on
both sides and never match inside a bucket, so all join types
(inner/left/right/outer/semi/anti) stay bucket-decomposable; group-by
NULL keys co-locate the same way. Depth 0 buckets rows exactly as
``RecordBatch.partition_by_hash`` does (the same hash chain as the
reference, bit for bit).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np

from .. import knobs
from ..micropartition import MicroPartition
from ..recordbatch import RecordBatch
from . import memory

#: default first-level fanout when no planner evidence sizes the input
_DEFAULT_PARTITIONS = 16
#: hard ceiling on any radix fanout (matches the breaker fanout cap)
_MAX_PARTITIONS = 1024
#: sub-partition ceiling per recursion step
_MAX_SUBPARTITIONS = 64


def _mode(raw: Optional[str], cfg_val: str) -> str:
    v = (raw if raw is not None else cfg_val or "auto").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "0"
    if v in ("1", "on", "force", "true", "yes"):
        return "1"
    return "auto"


def _cfg(cfg):
    if cfg is None:
        from ..context import get_context
        cfg = get_context().execution_config
    return cfg


def spill_join_mode(cfg=None) -> str:
    """``DAFT_TORCH_SPILL_JOIN`` → ``auto`` | ``1`` (force partitioned) |
    ``0`` (materialize, then re-fan). The knob overrides
    ``ExecutionConfig.spill_join``."""
    return _mode(knobs.env_raw("DAFT_TORCH_SPILL_JOIN"),
                 _cfg(cfg).spill_join)


def spill_agg_mode(cfg=None) -> str:
    """``DAFT_TORCH_SPILL_AGG`` → ``auto`` | ``1`` | ``0`` for the
    spill-partitioned aggregation reducer."""
    return _mode(knobs.env_raw("DAFT_TORCH_SPILL_AGG"), _cfg(cfg).spill_agg)


def spill_max_depth(cfg=None) -> int:
    """Recursion bound for re-partitioning an oversized bucket. Depth
    exhaustion (an all-duplicate key no radix can split) falls through to
    an in-memory join/merge of the bucket, counted in
    ``depth_exhausted``."""
    v = knobs.env_opt_int("DAFT_TORCH_SPILL_MAX_DEPTH")
    if v is None:
        v = _cfg(cfg).spill_max_depth
    return max(int(v), 0)


def forced_partitions(cfg=None) -> int:
    """``DAFT_TORCH_SPILL_PARTITIONS``: non-zero forces the first-level
    radix fanout; 0 = planner evidence decides."""
    v = knobs.env_opt_int("DAFT_TORCH_SPILL_PARTITIONS")
    if v is None:
        v = _cfg(cfg).spill_partitions
    return max(int(v), 0)


def pair_budget_bytes(budget: Optional[int] = None) -> int:
    """Bytes one resident work unit (a join bucket pair / one agg state
    bucket) may occupy: a quarter of the breaker budget — both sides plus
    the join output must coexist with the stores' own buffers. The floor
    is deliberately tiny so forced-small test budgets exercise real
    recursion. Under governor memory pressure the budget halves
    (``budget_scale``): smaller resident work units are exactly how the
    spill tier gives RSS back."""
    from . import governor
    b = budget if budget is not None else memory.breaker_budget_bytes()
    scale = governor.budget_scale()
    if scale != 1.0:
        b = int(b * scale)
    return max(b // 4, 16 << 10)


def plan_partitions(est_bytes: Optional[float], cfg=None,
                    budget: Optional[int] = None) -> int:
    """First-level radix fanout from planner evidence: enough buckets
    that each is expected to fit the pair budget, with headroom for
    estimate error (2x) — recursion is the safety net when the evidence
    was wrong, not the plan."""
    forced = forced_partitions(cfg)
    if forced:
        return min(forced, _MAX_PARTITIONS)
    if not est_bytes:
        return _DEFAULT_PARTITIONS
    target = pair_budget_bytes(budget)
    n = -(-int(2 * est_bytes) // target)
    return max(2, min(_MAX_PARTITIONS, n))


# ---------------------------------------------------------- rotated radix

def radix_split(rb: RecordBatch, by, n: int, depth: int
                ) -> List[RecordBatch]:
    """Hash-partition ``rb`` into ``n`` pieces on the ``by`` key chain.
    Depth 0 is bit-identical to ``RecordBatch.partition_by_hash`` (the
    hash chain every exchange/co-partition path uses); depth d > 0
    re-hashes the hash d times, so a bucket that was uniform in
    ``h % n`` fans out again instead of landing whole in one sub-bucket
    (gcd(n, m) correlation)."""
    if len(rb) == 0:
        return [rb.slice(0, 0) for _ in range(n)]
    keys = [rb.eval_expression(e) for e in by]
    h = keys[0].hash()
    for k in keys[1:]:
        h = k.hash(seed=h)
    for _ in range(depth):
        h = h.hash()
    pid = (h.to_numpy() % np.uint64(n)).astype(np.int64)
    return rb._split_by_pid(pid, n)


def drain_to_store(stream: Iterator[MicroPartition], by, n: int,
                   depth: int = 0, poll=None,
                   budget: Optional[int] = None
                   ) -> memory.PartitionedSpillStore:
    """Stream morsels into an ``n``-bucket store by rotated radix — the
    out-of-core ingest: a scan child feeds this one source batch at a
    time, so no whole table is ever resident. The store
    closes itself if the drain fails; callers own it once returned."""
    store = memory.PartitionedSpillStore(n, budget=budget)
    try:
        for mp in stream:
            if poll is not None:
                poll()
            for j, piece in enumerate(radix_split(mp.combined(), by, n,
                                                  depth)):
                if len(piece):
                    store.push(j, piece)
        store.finalize()
    except BaseException:
        store.close()
        raise
    return store


def _batches_nbytes(batches: List[RecordBatch]) -> int:
    return sum(int(b.size_bytes() or 0) for b in batches)


def _concat_or_empty(batches: List[RecordBatch], schema) -> RecordBatch:
    batches = [b if b.schema == schema else b.cast_to_schema(schema)
               for b in batches if len(b)]
    if not batches:
        return RecordBatch.empty(schema)
    return RecordBatch.concat(batches)


# ---------------------------------------------------------- grace join

def _join_pair(mem, lbatches: List[RecordBatch],
               rbatches: List[RecordBatch], node, lschema, rschema,
               depth: int, depth_max: int, pair_budget: int,
               poll=None) -> List[MicroPartition]:
    """Join one co-hashed bucket pair, recursing with a rotated radix
    when the pair exceeds the pair budget. The in-memory leaf join
    admits its bytes against the executor's host MemoryManager, so
    cancellation mid-partition (poll before each pair) and concurrent
    pairs stay inside the process budget."""
    if poll is not None:
        poll()
    nbytes = _batches_nbytes(lbatches) + _batches_nbytes(rbatches)
    if nbytes > pair_budget and depth < depth_max:
        memory.spill_count("recursions")
        memory.spill_count(f"recursions_d{depth + 1}")
        m = max(2, min(_MAX_SUBPARTITIONS, -(-int(nbytes) // pair_budget)))
        sub_budget = max(pair_budget, 1)
        with memory.PartitionedSpillStore(m, budget=sub_budget) as ls, \
                memory.PartitionedSpillStore(m, budget=sub_budget) as rs:
            for b in lbatches:
                for j, piece in enumerate(radix_split(
                        b, list(node.left_on), m, depth + 1)):
                    if len(piece):
                        ls.push(j, piece)
            for b in rbatches:
                for j, piece in enumerate(radix_split(
                        b, list(node.right_on), m, depth + 1)):
                    if len(piece):
                        rs.push(j, piece)
            ls.finalize()
            rs.finalize()
            out: List[MicroPartition] = []
            for j in range(m):
                out.extend(_join_pair(
                    mem, ls.bucket_batches(j), rs.bucket_batches(j),
                    node, lschema, rschema, depth + 1, depth_max,
                    pair_budget, poll))
            return out
    if nbytes > pair_budget:
        # bounded depth exhausted (all-duplicate key): join in memory
        # anyway — a price, not a failure — and make it visible
        memory.spill_count("depth_exhausted")
    lmp = _concat_or_empty(lbatches, lschema)
    rmp = _concat_or_empty(rbatches, rschema)
    mem.acquire(nbytes)
    try:
        joined = lmp.hash_join(rmp, node.left_on, node.right_on, node.how)
    finally:
        mem.release(nbytes)
    return [MicroPartition.from_recordbatch(joined)]


def grace_hash_join(ex, node) -> Iterator[MicroPartition]:
    """Spill-partitioned (grace) hash join for a HashJoin with no static
    co-partitioning evidence: stream BOTH children into rotated-radix
    stores (no intermediate whole-side materialize), then either
    gather-join (the observed total fits one pair, priced by
    ``spill_plan_wins``) or join bucket pairs one at a time with
    bounded-depth recursion on any pair the first radix level left
    oversized."""
    from ..device import costmodel
    lnode, rnode = node.children
    cfg = ex.cfg
    budget = memory.breaker_budget_bytes()
    pair_b = pair_budget_bytes(budget)
    est = (getattr(node, "left_bytes_est", None) or 0) \
        + (getattr(node, "right_bytes_est", None) or 0)
    n = plan_partitions(est or None, cfg, budget)
    mode = spill_join_mode(cfg)
    depth_max = spill_max_depth(cfg)
    lstore = drain_to_store(ex._exec(lnode), list(node.left_on), n,
                            poll=ex._poll_cancel, budget=budget // 2)
    try:
        rstore = drain_to_store(ex._exec(rnode), list(node.right_on), n,
                                poll=ex._poll_cancel, budget=budget // 2)
    except BaseException:
        lstore.close()
        raise
    try:
        total = sum(lstore.nbytes) + sum(rstore.nbytes)
        if mode != "1" and not costmodel.spill_plan_wins(total, pair_b):
            # observed total fits one resident pair: a single gathered
            # join keeps the whole-input kernel vectorization
            memory.spill_count("joins_gathered")
            lbat = [b for i in range(n) for b in lstore.bucket_batches(i)]
            rbat = [b for i in range(n) for b in rstore.bucket_batches(i)]
            yield from _join_pair(ex.host_mem, lbat, rbat, node,
                                  lnode.schema(), rnode.schema(),
                                  depth_max, depth_max, pair_b,
                                  ex._poll_cancel)
            return
        memory.spill_count("joins_partitioned")

        # prefetch-pipelined bucket reads: pair i+1's IPC decode resolves
        # on the spill pool while pair i joins; window 0 reads in line
        from . import spill_io

        def read_pair(i):
            def read():
                lb = lstore.bucket_batches(i)
                rb = rstore.bucket_batches(i)
                _grace_pair_check(i, n, node, lb, rb)
                return lb, rb
            return read

        pairs = spill_io.prefetch_ordered(
            (read_pair(i) for i in range(n)),
            spill_io.read_prefetch_window(cfg))

        from .executor import _ordered_parallel
        for outs in _ordered_parallel(
                pairs,
                lambda lr: _join_pair(ex.host_mem, lr[0], lr[1], node,
                                      lnode.schema(), rnode.schema(),
                                      0, depth_max, pair_b,
                                      ex._poll_cancel)):
            yield from outs
    finally:
        lstore.close()
        rstore.close()


def _grace_pair_check(i: int, n: int, node, lbat, rbat) -> None:
    """Plan-sanitizer hook (``DAFT_TORCH_SANITIZE_PLAN=1``): a bucket pair
    read back from the rotated-radix stores must re-hash into its own
    bucket — depth 0 is ``h % n``, bit-identical to ``partition_by_hash``,
    and a spill/IPC dtype drift breaks exactly this. Unarmed, nothing runs;
    armed, a stray row is a counted ``plansan`` violation
    (``plan_sanitizer.check_grace_pair``), never an exception."""
    from ..analysis import plan_sanitizer
    if not plan_sanitizer.is_enabled():
        return
    if lbat:
        plan_sanitizer.check_grace_pair(
            i, n, list(node.left_on),
            MicroPartition.from_recordbatch(lbat[0]))
    if rbat:
        plan_sanitizer.check_grace_pair(
            i, n, list(node.right_on),
            MicroPartition.from_recordbatch(rbat[0]))


def join_copartitioned_pair(ex, lmp: MicroPartition, rmp: MicroPartition,
                            node, lschema, rschema
                            ) -> List[MicroPartition]:
    """Skew guard for statically co-partitioned joins (both children are
    hash exchanges on the join keys): a partition PAIR that exceeds the
    pair budget re-partitions with the rotated radix (depth 1 — the pair
    came from depth 0's ``h % n``) instead of joining whole."""
    pair_b = pair_budget_bytes()
    nbytes = int(lmp.size_bytes() or 0) + int(rmp.size_bytes() or 0)
    if spill_join_mode(ex.cfg) == "0" or nbytes <= pair_b:
        return [lmp.hash_join(rmp, node.left_on, node.right_on, node.how)]
    return _join_pair(ex.host_mem, [lmp.combined()], [rmp.combined()], node,
                      lschema, rschema, 0, spill_max_depth(ex.cfg),
                      pair_b, ex._poll_cancel)


# ------------------------------------------------- spill-partitioned agg

def merge_spilled_agg_bucket(batches: List[RecordBatch], merge_aggs,
                             group_by, schema, key_exprs, depth: int,
                             depth_max: int, bucket_budget: int,
                             poll=None) -> List[MicroPartition]:
    """Merge-on-read for one spilled group-state bucket: the bucket's
    partial-state rows self-merge in ONE agg pass
    (``AGG_DECOMPOSITION``'s merge expressions). A bucket whose raw
    state exceeds the bucket budget re-partitions by a deeper rotated
    radix first — skewed keys that redominate one bucket keep splitting
    until the budget holds or the depth bound trips."""
    if poll is not None:
        poll()
    nbytes = _batches_nbytes(batches)
    if nbytes > bucket_budget and depth < depth_max:
        memory.spill_count("recursions")
        memory.spill_count(f"recursions_d{depth + 1}")
        m = max(2, min(_MAX_SUBPARTITIONS,
                       -(-int(nbytes) // bucket_budget)))
        with memory.PartitionedSpillStore(
                m, budget=max(bucket_budget, 1)) as store:
            for b in batches:
                for j, piece in enumerate(radix_split(b, key_exprs, m,
                                                      depth + 1)):
                    if len(piece):
                        store.push(j, piece)
            store.finalize()
            out: List[MicroPartition] = []
            for j in range(m):
                sub = store.bucket_batches(j)
                if sub:
                    out.extend(merge_spilled_agg_bucket(
                        sub, merge_aggs, group_by, schema, key_exprs,
                        depth + 1, depth_max, bucket_budget, poll))
            return out
    if nbytes > bucket_budget:
        memory.spill_count("depth_exhausted")
    merged = _concat_or_empty(batches, schema)
    if len(merged) == 0:
        return []
    state = merged.agg(merge_aggs, group_by).cast_to_schema(schema)
    memory.spill_count("agg_buckets_merged")
    return [MicroPartition.from_recordbatch(state)]


def agg_state_fanout(est_state_bytes: Optional[float], workers: int,
                     cfg=None) -> int:
    """Sub-bucket count per spilling reducer: enough that one bucket's
    merged state is expected to fit the per-reducer bucket budget."""
    forced = forced_partitions(cfg)
    if forced:
        return min(forced, _MAX_PARTITIONS)
    if not est_state_bytes or not math.isfinite(est_state_bytes):
        return _DEFAULT_PARTITIONS
    per_reducer = est_state_bytes / max(workers, 1)
    target = pair_budget_bytes() / max(workers, 1)
    n = -(-int(2 * per_reducer) // max(int(target), 1 << 20))
    return max(2, min(_MAX_PARTITIONS, n))
