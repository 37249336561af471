"""Fused scan fragments: filter + project + partial aggregation as ONE
torch program per morsel, with one result transfer.

The torch rewrite of ``daft_tpu/device/fragment.py``'s fused-agg family.
``run_planes`` evaluates the compiled filter and projections and reduces
with one of three strategies. :func:`submit_fused_agg_tables` dispatches
every table of a window and starts one device→host copy of all their
output planes (the group counts and every output plane);
:func:`drain_fused_agg_tables` waits for it and decodes, so a window of
partial aggregations costs one copy:

- **dense** (``kernels.grouped_agg_dense_impl``): every group key is a
  dictionary-coded string passthrough and the slot product fits — TPC-H Q1;
- **hash** (``hash_kernels.hash_grouped_agg_impl``, the CUDA table build):
  the key set packs into ≤128 bits and the table fits the slot ceiling;
- **sort** (``kernels.grouped_agg_block_impl``): everything else.

``DAFT_TORCH_KERNEL_GROUPBY`` forces one. Hash against sort is priced by
the cost model (``costmodel.groupby_strategy``) with the planner's footer
NDV (``groups``) as its evidence; dense comes first whenever the
dictionaries fit, as in the reference.

Overflow ladder (the reference's ``drain_fused_agg_tables``): the group
block starts at 128 groups. A sort or dense result carries the true group
count, and a larger one re-dispatches at that bucket with the strategy
asked again. A full hash table only says "at least T groups", so it
re-dispatches on sort, whose count is exact. The window's overflowed
tables climb together, with one copy for each step. The climb stops at
:func:`_max_out_cap`, the link-priced ceiling: a table whose groups would
cost more to fetch than the host's own aggregation of its rows comes back
as None, and the executor aggregates that batch on the host.

Each dispatch is timed by two CUDA events on its stream, read at the
drain (which already waits for the window's copy), and recorded in the
cost model's ledger with its ``mfu`` byte model (:func:`_ledger_grouped`);
its strategy is logged (``costmodel.log_strategy_decision``) once it ran.

The second half holds the fusion-region programs (``physical/fusion.py``;
reference ``fragment.py:820-1397``): chain and topk
(:class:`FusedRegionProgram`) and join_agg (:class:`FusedJoinAggProgram`,
with its once-per-query :class:`RegionBuild`), each a torch program over
the ported kernels with one fetch per dispatch and its overflow ladders.
They are torch programs, not hand-written kernels: ROADMAP B1's rule.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..analysis import retrace_sanitizer
from ..expressions.expressions import Expression
from ..schema import Schema
from . import column as dcol
from . import compiler, costmodel, hash_kernels, kernels, mfu, runtime

_OUT_CAP0 = 128

#: what compiling a program raises for an expression without a device
#: lowering: the caller runs the host chain (or a region's fallback)
_COMPILE_ERRORS = (compiler.NotCompilable, NotImplementedError, ValueError,
                   TypeError, KeyError, OverflowError)

#: dense-strategy slot ceiling: K = prod(dim + 1) slots per dispatch
DENSE_MAX_SLOTS = 4096


class FusedAggProgram:
    def __init__(self, compiled: compiler.Compiled, nk: int,
                 ops: Tuple[str, ...], has_pred: bool,
                 key_sources: Optional[Tuple[str, ...]]):
        self.compiled = compiled
        self.nk = nk
        self.ops = ops
        self.has_pred = has_pred
        #: source column per group key when EVERY key is a string/binary
        #: passthrough (dictionary-coded) — dense eligibility
        self.key_sources = key_sources
        #: the key set proved wider than the hash budget: stay on sort
        self.hash_unfit = False

    def eval_inputs(self, arrays, valids, row_mask, scalars):
        outs = self.compiled.fn(arrays, valids, row_mask, scalars)
        if self.has_pred:
            pv, pm = outs[-1]
            row_mask = row_mask & pv.to(torch.bool) & pm
            outs = outs[:-1]
        nk = self.nk
        keys = tuple(v for v, _ in outs[:nk])
        kvalids = tuple(m for _, m in outs[:nk])
        vals = tuple(v for v, _ in outs[nk:])
        vvalids = tuple(m for _, m in outs[nk:])
        return keys, kvalids, vals, vvalids, row_mask

    def run_planes(self, arrays, valids, row_mask, scalars, out_cap: int,
                   strategy: str = "sort", dims: Tuple[int, ...] = ()
                   ) -> List[torch.Tensor]:
        """The whole fragment → its output planes on the device. Grouped:
        the group count (one int64), then one [out_cap] plane per key,
        key validity, value, value validity. Keyless: one element per
        value, then per validity."""
        keys, kvalids, vals, vvalids, row_mask = self.eval_inputs(
            arrays, valids, row_mask, scalars)
        if self.nk == 0:
            results = kernels.global_agg_impl(vals, vvalids, row_mask,
                                              self.ops)
            return [v.reshape(1) for v, _ in results] + \
                [m.reshape(1) for _, m in results]
        if strategy == "dense":
            out = kernels.grouped_agg_dense_impl(
                keys, kvalids, vals, vvalids, row_mask, self.ops, out_cap,
                dims)
        elif strategy == "hash":
            out = hash_kernels.hash_grouped_agg_impl(
                keys, kvalids, vals, vvalids, row_mask, self.ops, out_cap)
        else:
            out = kernels.grouped_agg_block_impl(
                keys, kvalids, vals, vvalids, row_mask, self.ops, out_cap)
        ok, okv, ov, ovv, g = out
        head = torch.as_tensor(g, dtype=torch.int64,
                               device=row_mask.device).reshape(1)
        return [head] + list(ok) + list(okv) + list(ov) + list(ovv)

    def key_plane_dtypes(self) -> List[torch.dtype]:
        """Device dtypes of the group-key planes, for the hash width check
        (``runtime.key_plane_dtype``)."""
        return [runtime.key_plane_dtype(f)
                for f in self.compiled.out_fields[:self.nk]]


def get_fused_agg(group_exprs: List[Expression],
                  child_exprs: List[Expression], ops: Tuple[str, ...],
                  predicate: Optional[Expression],
                  schema: Schema) -> Optional[FusedAggProgram]:
    """The fused filter→project→grouped-agg program, compiled once per
    expressions and schema (reference ``get_fused_agg``, memoized the same
    way), or None when an expression has no device lowering (the morsel
    runs on the host)."""
    proj = list(group_exprs) + list(child_exprs) + \
        ([predicate] if predicate is not None else [])
    key = (tuple(e._key() for e in proj), ops, runtime._schema_key(schema))
    hit = _fused_seen.get(key)
    if hit is not None:
        return hit or None
    try:
        c = compiler.compile_projection(proj, schema)
    except _COMPILE_ERRORS:
        _fused_seen[key] = False
        return None
    nk = len(group_exprs)
    srcs = []
    for e, f in zip(group_exprs, c.out_fields[:nk]):
        src = runtime._string_out_source(e) \
            if (f.dtype.is_string() or f.dtype.is_binary()) else None
        if src is None:
            srcs = None
            break
        srcs.append(src)
    prog = FusedAggProgram(c, nk, ops, predicate is not None,
                           tuple(srcs) if srcs else None)
    prog.in_schema = schema
    # two threads compiling one key at once keep the first program
    return _fused_seen.setdefault(key, prog)


#: every fused program compiled so far, by its expressions, ops and schema
#: (False: it does not compile): the memo ``get_fused_agg`` reads, and
#: what ``warmup.warmup_fragments`` launches
_fused_seen: dict = {}


def fused_programs() -> List[FusedAggProgram]:
    return [p for p in _fused_seen.values() if p]


def dense_plan(prog: FusedAggProgram, dt: dcol.DeviceTable, cap_limit: int
               ) -> Optional[Tuple[Tuple[int, ...], int]]:
    """``(dims, out_cap)`` for a dense dispatch, or None when ineligible:
    a key is not a dictionary-coded passthrough, or the slot product
    (pow2-bucketed dictionary sizes, +1 null slot each) exceeds
    :data:`DENSE_MAX_SLOTS` or the capacity. Dense output never
    overflows: the bucket holds every slot."""
    if not prog.key_sources:
        return None
    dims = []
    K = 1
    for src in prog.key_sources:
        col = dt.columns.get(src)
        if col is None or col.dictionary is None:
            return None
        d = len(col.dictionary)
        d = max(1 << (max(d - 1, 0)).bit_length(), 1)  # pow2 ceiling
        dims.append(d)
        K *= d + 1
        if K > DENSE_MAX_SLOTS:
            return None
    out_cap = dcol.bucket_capacity(max(K, _OUT_CAP0))
    if out_cap > cap_limit:
        return None
    return tuple(dims), out_cap


def gate_strategy(prog: FusedAggProgram, rows: int,
                  groups: Optional[float] = None, device=None) -> str:
    """The strategy the upload gates price with (unlogged: decision_counts
    tallies dispatches, not estimates)."""
    if prog.nk == 0 or prog.hash_unfit:
        return "sort"
    return costmodel.groupby_strategy(rows, groups, prog.key_plane_dtypes(),
                                      _OUT_CAP0, log=False,
                                      device=device)[0]


def strategy_for(prog: FusedAggProgram, dt: dcol.DeviceTable, out_cap: int,
                 cap_limit: int, groups: Optional[float] = None
                 ) -> Tuple[str, Tuple[int, ...], int, float]:
    """→ ``(strategy, dims, out_cap, load)`` for one dispatch: dense when
    :func:`dense_plan` accepts (unless ``DAFT_TORCH_KERNEL_GROUPBY`` forces
    hash or sort), else sort for a program whose key set proved
    unpackable, else ``costmodel.groupby_strategy`` over the table's rows
    with the footer NDV ``groups`` as its evidence (unlogged: the
    dispatch logs what ran)."""
    if costmodel.forced_groupby() in ("auto", "dense"):
        plan = dense_plan(prog, dt, cap_limit)
        if plan is not None:
            return "dense", plan[0], plan[1], 0.0
    if prog.hash_unfit:
        return "sort", (), out_cap, 0.0
    s, lf = costmodel.groupby_strategy(dt.row_count, groups,
                                       prog.key_plane_dtypes(), out_cap,
                                       log=False, device=dt.device)
    return s, (), out_cap, lf


def packed_bytes_per_group(nk: int, nops: int) -> int:
    """Bytes one group's row of the fetched result occupies at most: every
    output plane (keys, values, each with validity) is at most 8 bytes wide
    a slot, and the group count amortizes. The executor's gates price the
    download with it."""
    return (1 + 2 * (nk + nops)) * 8


def _max_out_cap(prog: FusedAggProgram, dt: dcol.DeviceTable) -> int:
    """Group-capacity ceiling from the measured link: fetching the groups
    must not cost more than the host's own aggregation of the table's rows
    (a non-reductive grouping makes device partials pure freight). A
    shared-memory link (CPU tensors) is unbounded. Rounded down to a power
    of two, at least :data:`_OUT_CAP0`."""
    import math
    p = costmodel.link_profile()
    full = dcol.bucket_capacity(max(dt.capacity, 1))
    if p.down_bps == math.inf:
        return full
    in_bytes = sum(int(c.data.nbytes) + int(c.validity.nbytes)
                   for c in dt.columns.values())
    host_s = in_bytes / costmodel.HOST_AGG_BPS
    raw = int(host_s * p.down_bps
              // packed_bytes_per_group(prog.nk, len(prog.ops)))
    if raw < _OUT_CAP0:
        return _OUT_CAP0
    return min(1 << (raw.bit_length() - 1), full)


def _ledger_grouped(prog: FusedAggProgram, rows: int, cap: int,
                    out_cap: int, seconds: float, strategy: str,
                    load_factor: float = 0.0) -> None:
    """One fused grouped-agg dispatch into the ledger; the byte model
    follows the strategy that ran."""
    if strategy == "hash":
        words = hash_kernels.hash_pack_words(prog.key_plane_dtypes()) or 2
        flops, nbytes = mfu.hash_agg_models(
            cap, out_cap, hash_kernels.table_capacity(out_cap), words,
            len(prog.ops))
    elif strategy == "dense":
        flops, nbytes = mfu.dense_agg_models(cap, out_cap, max(prog.nk, 1),
                                             len(prog.ops))
    else:
        flops, nbytes = mfu.grouped_agg_models(cap, out_cap,
                                               max(prog.nk, 1),
                                               len(prog.ops))
    costmodel.ledger_record("grouped_agg", rows=rows, nbytes=nbytes,
                            flops=flops, seconds=seconds, strategy=strategy,
                            load_factor=load_factor or None)


class InflightFusedAgg:
    """One table's fused-agg dispatch: its device-side output planes plus
    the ladder state the drain needs to finish."""

    def __init__(self, prog, dt, group_exprs, key_fields, agg_fields,
                 groups: Optional[float] = None):
        self.prog = prog
        self.dt = dt
        self.group_exprs = group_exprs
        self.key_fields = key_fields
        self.agg_fields = agg_fields
        #: the planner's footer NDV estimate of the group count, or None
        self.groups = groups
        self.cap_limit = _max_out_cap(prog, dt) if prog.nk else \
            dcol.bucket_capacity(dt.capacity)
        self.out_cap = min(_OUT_CAP0, self.cap_limit)
        self.strategy: Optional[str] = None
        self.lf = 0.0
        self.dims: Tuple[int, ...] = ()
        self.planes: List[torch.Tensor] = []
        #: per grouped dispatch (strategy, out_cap, load, timer)
        self.timed: list = []


class _Timer:
    """Device time of one dispatch: two CUDA events on the dispatch's
    stream, read once the drain's wait has passed them (the host clock on
    the CPU, where the work is synchronous)."""

    __slots__ = ("e0", "e1", "t0", "s")

    def __init__(self, device: torch.device):
        self.e0 = self.e1 = None
        self.s = 0.0
        if device.type == "cuda":
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.e1 is not None:
            self.e1.record()
        else:
            self.s = time.perf_counter() - self.t0

    def seconds(self) -> float:
        if self.e1 is not None:
            return self.e0.elapsed_time(self.e1) / 1e3
        return self.s


def _dispatch(tok: InflightFusedAgg) -> None:
    """Run the current ladder rung (asks the strategy when unset) on the
    current stream."""
    prog, dt = tok.prog, tok.dt
    arrays = {n: c.data for n, c in dt.columns.items()}
    valids = {n: c.validity for n, c in dt.columns.items()}
    scalars = runtime._prep_scalars(prog.compiled, dt)
    if prog.nk == 0:
        with retrace_sanitizer.dispatch_scope(
                "fragment.fused_agg",
                (id(prog), dt.capacity, "global", _OUT_CAP0)):
            tok.planes = prog.run_planes(arrays, valids, dt.row_mask,
                                         scalars, _OUT_CAP0)
        runtime.count("global")
        return
    while True:
        if tok.strategy is None:
            tok.strategy, tok.dims, tok.out_cap, tok.lf = strategy_for(
                prog, dt, tok.out_cap, tok.cap_limit, tok.groups)
        timer = _Timer(dt.device)
        try:
            with retrace_sanitizer.dispatch_scope(
                    "fragment.fused_agg",
                    (id(prog), dt.capacity, tok.strategy, tok.out_cap)):
                tok.planes = prog.run_planes(
                    arrays, valids, dt.row_mask, scalars, tok.out_cap,
                    tok.strategy, tok.dims)
        except hash_kernels.HashKeyWidthError:
            # the exact width check, raised before any launch: route this
            # program to sort for good. Any other error propagates.
            prog.hash_unfit = True
            tok.strategy, tok.lf = "sort", 0.0
            continue
        timer.stop()
        tok.timed.append((tok.strategy, tok.out_cap, tok.lf, timer))
        runtime.count(tok.strategy)
        costmodel.log_strategy_decision(
            "groupby_strategy", tok.strategy, rows=dt.row_count,
            out_cap=tok.out_cap, load_factor=tok.lf)
        return


def _climb(tok: InflightFusedAgg, g: int) -> bool:
    """One overflow-ladder step for a result of ``g`` groups past the
    bucket: grow the bucket to hold them; a full hash table's count is
    only a lower bound, so it climbs on sort, whose count is exact;
    otherwise the grown bucket asks the strategy again. False when ``g``
    passes the link-priced ceiling (:func:`_max_out_cap`): the table is
    declined."""
    if g > tok.cap_limit:
        return False
    saturated = tok.strategy == "hash" and \
        g >= hash_kernels.table_capacity(tok.out_cap)
    tok.out_cap = min(dcol.bucket_capacity(max(g, _OUT_CAP0)), tok.cap_limit)
    tok.strategy = "sort" if saturated else None
    return True


class InflightFusedAggBatch:
    """A window's fused-agg dispatches, one per DeviceTable, with ONE
    device→host copy of all their output planes in flight."""

    def __init__(self, items: List[InflightFusedAgg], stream, fetch):
        self.items = items
        #: the stream the dispatches ran on (None on the CPU): the
        #: overflow retries run there too
        self.stream = stream
        self.fetch = fetch


def _fetch_all(items: List[InflightFusedAgg]):
    return dcol.fetch_host_async([p for it in items for p in it.planes])


def submit_fused_agg_tables(prog: FusedAggProgram, tables, in_schema: Schema,
                            group_exprs, agg_exprs, out_schema: Schema,
                            groups: Optional[float] = None
                            ) -> InflightFusedAggBatch:
    """Dispatch every table's fused program on the current stream (each
    table asks its own strategy: its dictionaries size the dense plan;
    ``groups`` is the planner's footer NDV estimate) and start one
    device→host copy of all their output planes. No wait."""
    key_fields = [e.to_field(in_schema) for e in group_exprs]
    agg_fields = [out_schema[e.name()] for e in agg_exprs]
    items = []
    for dt in tables:
        dcol.use_on_current_stream(dt)
        it = InflightFusedAgg(prog, dt, group_exprs, key_fields, agg_fields,
                              groups)
        _dispatch(it)
        items.append(it)
    dev = tables[0].device if tables else None
    stream = torch.cuda.current_stream(dev) \
        if dev is not None and dev.type == "cuda" else None
    return InflightFusedAggBatch(items, stream, _fetch_all(items))


def drain_fused_agg_tables(tok: InflightFusedAggBatch) -> list:
    """Wait for the window's one copy and decode every table's partial
    groups (a list parallel to the tables; None for a table declined at
    the link-priced ceiling). The tables whose group count outgrew their
    bucket climb the ladder together: one dispatch each and one copy for
    all of them, until every table fits. Then each grouped dispatch goes
    into the ledger with its device time."""
    results: list = [None] * len(tok.items)
    todo = list(range(len(tok.items)))
    fetch = tok.fetch
    while todo:
        host = fetch.wait()
        retry, off = [], 0
        for i in todo:
            it = tok.items[i]
            n = len(it.planes)
            rows, off = host[off:off + n], off + n
            if it.prog.nk == 0:
                results[i] = _decode_global(it, rows)
                continue
            g = int(rows[0][0])
            if g <= it.out_cap:
                results[i] = _decode_grouped(it, rows[1:], g)
                continue
            if _climb(it, g):
                retry.append(i)
        todo = retry
        if todo:
            with dcol.on_stream(tok.stream):
                for i in todo:
                    _dispatch(tok.items[i])
                fetch = _fetch_all([tok.items[i] for i in todo])
    for it in tok.items:
        # the copies completed before the first fetch did
        it.dt.staging = None
        for n, (strategy, out_cap, lf, timer) in enumerate(it.timed):
            # the table's rows count once, at the dispatch that finished
            _ledger_grouped(it.prog, it.dt.row_count
                            if n == len(it.timed) - 1 else 0,
                            it.dt.capacity, out_cap, timer.seconds(),
                            strategy, lf)
        it.timed = []
    return results


def run_fused_agg_tables(prog: FusedAggProgram, tables, in_schema: Schema,
                         group_exprs, agg_exprs, out_schema: Schema,
                         groups: Optional[float] = None) -> list:
    """Submit then drain: every table's partial groups, with one copy for
    the window's results (and one per ladder climb)."""
    return drain_fused_agg_tables(submit_fused_agg_tables(
        prog, tables, in_schema, group_exprs, agg_exprs, out_schema,
        groups))


def _decode_global(tok: InflightFusedAgg, host: List[np.ndarray]):
    from ..recordbatch import RecordBatch
    nv = len(tok.agg_fields)
    return RecordBatch.from_series([
        dcol.decode_np(f.name, f.dtype, host[i],
                       host[nv + i].astype(np.bool_))
        for i, f in enumerate(tok.agg_fields)])


def _decode_grouped(tok: InflightFusedAgg, rows: List[np.ndarray], g: int):
    from ..recordbatch import RecordBatch
    nk, nv = tok.prog.nk, len(tok.agg_fields)
    cols = []
    for i, (e, f) in enumerate(zip(tok.group_exprs, tok.key_fields)):
        cols.append(dcol.decode_np(f.name, f.dtype, rows[i][:g],
                                   rows[nk + i][:g].astype(np.bool_),
                                   runtime.key_dictionary(e, f, tok.dt)))
    for i, f in enumerate(tok.agg_fields):
        cols.append(dcol.decode_np(f.name, f.dtype, rows[2 * nk + i][:g],
                                   rows[2 * nk + nv + i][:g]
                                   .astype(np.bool_)))
    return RecordBatch.from_series(cols)


def submit_fused_agg(prog: FusedAggProgram, batch, group_exprs, agg_exprs,
                     out_schema: Schema, device: torch.device,
                     groups: Optional[float] = None
                     ) -> InflightFusedAggBatch:
    """Encode one RecordBatch onto ``device`` and submit the fused program
    (reference ``fragment.py:237``); drain with
    :func:`drain_fused_agg_tables`."""
    dt = dcol.encode_batch(batch, prog.compiled.needs_cols, device)
    return submit_fused_agg_tables(prog, [dt], batch.schema, group_exprs,
                                   agg_exprs, out_schema, groups)


def run_fused_agg(prog: FusedAggProgram, batch, group_exprs, agg_exprs,
                  out_schema: Schema, device: torch.device,
                  groups: Optional[float] = None):
    """Encode one RecordBatch onto ``device``, run the fused program and
    return its partial groups as a RecordBatch (None: declined at the
    link-priced ceiling)."""
    return drain_fused_agg_tables(submit_fused_agg(
        prog, batch, group_exprs, agg_exprs, out_schema, device,
        groups))[0]


# ---------------------------------------------------------------------------
# fusion-region programs (``physical/fusion.py``; reference
# ``daft_tpu/device/fragment.py:820-1397``)
#
# - chain: predicate + projection + a stable compaction (``kernels.
#   compaction_perm``); the survivors come back at a power-of-two width
#   bucket, and a count past it re-dispatches at the grown bucket;
# - topk: the same, with the packed argsort (``kernels._packed_argsort``
#   over ``_sort_codes``) in place of the compaction; only the static
#   ``bucket_capacity(limit)`` head comes back;
# - join_agg: the broadcast build side is encoded and key-sorted ONCE per
#   query (``kernels.join_sort_impl``) and stays on the card; each probe
#   morsel runs predicate → searchsorted join → gather of the joined
#   planes → post projection → partial grouped agg (the sort strategy) as
#   one dispatch, with two overflow ladders read from its head: the pair
#   width W from the join's true total, the group bucket from the count.
#
# Each dispatch's output is a list of planes, head first (the live count;
# for join_agg the group count and the pair total), fetched in ONE
# device→host copy (``column.fetch_host_async``).

_region_cache: dict = {}
_region_lock = threading.Lock()

#: join pair-width ceiling: past this the joined planes cost more device
#: memory than the morsel itself, and the host join is the right tool
_REGION_MAX_W = 1 << 22


class FusedRegionProgram:
    """One chain or topk region program."""

    def __init__(self, shape: str, compiled: compiler.Compiled, nout: int,
                 has_pred: bool, fused_ops: Tuple[str, ...], limit: int,
                 descending: Tuple[bool, ...],
                 nulls_first: Tuple[bool, ...], in_schema: Schema):
        self.shape = shape              # chain | topk
        self.compiled = compiled
        self.nout = nout
        self.has_pred = has_pred
        self.fused_ops = fused_ops
        self.limit = limit
        self.descending = descending
        self.nulls_first = nulls_first
        self.in_schema = in_schema
        #: per input capacity, the survivor bucket of the last drain: the
        #: ladder's learned first rung (a race costs at most one climb)
        self.w_hint: dict = {}

    def run_planes(self, arrays, valids, row_mask, scalars, out_w: int
                   ) -> List[torch.Tensor]:
        """The region over one table → ``[live count]``, then ``out_w``
        rows of each output value plane, then of each validity plane."""
        outs = self.compiled.fn(arrays, valids, row_mask, scalars)
        if self.has_pred:
            pv, pm = outs[-1]
            row_mask = row_mask & pv.to(torch.bool) & pm
            outs = outs[:-1]
        C = row_mask.shape[0]
        n = self.nout
        live = row_mask.sum()
        if self.shape == "topk":
            skeys = tuple(v for v, _ in outs[n:])
            svalids = tuple(m for _, m in outs[n:])
            perm = kernels._packed_argsort(kernels._sort_codes(
                skeys, svalids, row_mask, self.descending,
                self.nulls_first), C)
            live = torch.clamp(live, max=self.limit)
            outs = outs[:n]
        else:
            perm = kernels.compaction_perm(row_mask)
        w = min(out_w, C)
        idx = perm[:w]
        sel = torch.arange(w, device=row_mask.device) < live
        return [live.to(torch.int64).reshape(1)] \
            + [v[idx] for v, _ in outs] + [m[idx] & sel for _, m in outs]


def get_fused_region(exprs, predicate, schema: Schema, sort_by=(),
                     descending=(), nulls_first=(),
                     limit: Optional[int] = None,
                     fused_ops: Tuple[str, ...] = ()
                     ) -> Optional[FusedRegionProgram]:
    """Compile (or fetch) a chain/topk region program; None when an
    expression has no device lowering (the executor runs the region's
    fallback subtree)."""
    shape = "topk" if sort_by else "chain"
    key = ("region", shape, tuple(e._key() for e in exprs),
           predicate._key() if predicate is not None else None,
           tuple(e._key() for e in sort_by), tuple(descending),
           tuple(nulls_first), limit, runtime._schema_key(schema))
    with _region_lock:
        hit = _region_cache.get(key)
    if hit is not None:
        return hit if isinstance(hit, FusedRegionProgram) else None
    proj = list(exprs) + list(sort_by) + \
        ([predicate] if predicate is not None else [])
    try:
        c = compiler.compile_projection(proj, schema)
    except _COMPILE_ERRORS:
        prog = False
    else:
        prog = FusedRegionProgram(
            shape, c, len(exprs), predicate is not None, tuple(fused_ops),
            int(limit or 0), tuple(bool(d) for d in descending),
            tuple(bool(x) for x in nulls_first), schema)
    return _cache_region(key, prog)


def _cache_region(key, prog):
    """Store a compiled program (False: it does not lower) unless another
    thread stored one first → the cached program, or None."""
    with _region_lock:
        return _region_cache.setdefault(key, prog) or None


def region_start_w(prog: FusedRegionProgram, dt: dcol.DeviceTable) -> int:
    """The first width rung. Top-k fetches its static k bucket; an
    unfiltered chain cannot shrink, so it fetches whole; a filtered chain
    bets on a quarter of the rows, or the rung its last drain at this
    capacity learned (one climb costs a dispatch, not a scan)."""
    if prog.shape == "topk":
        return min(dcol.bucket_capacity(max(prog.limit, 1)), dt.capacity)
    if not prog.has_pred:
        return dt.capacity
    hint = prog.w_hint.get(dt.capacity)
    if hint is not None:
        return min(hint, dt.capacity)
    return min(dcol.bucket_capacity(
        max(min(dt.capacity, dt.row_count) // 4, _OUT_CAP0)), dt.capacity)


class InflightRegion:
    """One chain/topk dispatch in flight: its planes, its fetch, and the
    ladder state a climb needs."""

    def __init__(self, prog, dt, exprs, fields, out_w, stream):
        self.prog = prog
        self.dt = dt
        self.exprs = exprs
        self.fields = fields
        self.out_w = out_w
        self.stream = stream
        self.timers: list = []
        self.fetch = None


def _current_stream(device: torch.device):
    return torch.cuda.current_stream(device) \
        if device.type == "cuda" else None


def _dispatch_region(tok: InflightRegion) -> None:
    prog, dt = tok.prog, tok.dt
    arrays = {n: c.data for n, c in dt.columns.items()}
    valids = {n: c.validity for n, c in dt.columns.items()}
    scalars = runtime._prep_scalars(prog.compiled, dt)
    timer = _Timer(dt.device)
    with retrace_sanitizer.dispatch_scope(
            "fragment.region", (id(prog), dt.capacity, tok.out_w)):
        planes = prog.run_planes(arrays, valids, dt.row_mask, scalars,
                                 tok.out_w)
    timer.stop()
    tok.timers.append(timer)
    tok.fetch = dcol.fetch_host_async(planes)


def submit_region(prog: FusedRegionProgram, batch, exprs, out_schema: Schema,
                  device: torch.device) -> Optional[InflightRegion]:
    """Encode one morsel and dispatch the region on the current stream; no
    wait. None when a needed column has no device plane or its encode
    fails: the region declines this morsel (the executor runs its host
    chain). An error in the dispatch itself propagates."""
    needs = prog.compiled.needs_cols
    if not all(dcol.has_device_plane(batch.get_column(n)) for n in needs):
        return None
    try:
        dt = dcol.encode_batch(batch, needs, device)
    except (ValueError, TypeError):
        return None
    dcol.use_on_current_stream(dt)
    fields = [out_schema[e.name()] for e in exprs]
    tok = InflightRegion(prog, dt, exprs, fields, region_start_w(prog, dt),
                         _current_stream(dt.device))
    _dispatch_region(tok)
    runtime.count("region_" + prog.shape)
    return tok


def drain_region(tok: InflightRegion):
    """Wait for the dispatch's one copy and decode the survivors into a
    RecordBatch, climbing the width ladder (one dispatch and one copy a
    step) while the live count outgrows the bucket."""
    from ..recordbatch import RecordBatch
    prog = tok.prog
    while True:
        host = tok.fetch.wait()
        live = int(host[0][0])
        w = min(tok.out_w, tok.dt.capacity)
        if live <= w:
            break
        tok.out_w = min(dcol.bucket_capacity(live), tok.dt.capacity)
        runtime.count("region_w_climbs")
        with dcol.on_stream(tok.stream):
            _dispatch_region(tok)
    n = prog.nout
    cols = []
    for i, (e, f) in enumerate(zip(tok.exprs, tok.fields)):
        cols.append(dcol.decode_np(
            f.name, f.dtype, host[1 + i][:live],
            host[1 + n + i][:live].astype(np.bool_),
            runtime.key_dictionary(e, f, tok.dt)))
    out = RecordBatch.from_series(cols)
    if prog.has_pred and prog.shape != "topk":
        prog.w_hint[tok.dt.capacity] = min(
            dcol.bucket_capacity(max(live, _OUT_CAP0)), tok.dt.capacity)
    tok.dt.staging = None
    n_ops = max(len(prog.fused_ops), 2)
    costmodel.ledger_record(
        "region", rows=tok.dt.row_count,
        nbytes=(1 + 2 * n) * 8 * w,
        seconds=sum(t.seconds() for t in tok.timers),
        dispatches=len(tok.timers), fused_ops=n_ops,
        round_trips_saved=n_ops - 1,
        fusion_serial_seconds=costmodel.fusion_serial_estimate(
            tok.dt.row_count, n_ops))
    return out


class FusedJoinAggProgram:
    """One join_agg region program: probe predicate → searchsorted join
    against the key-sorted build side → gather of the joined planes →
    post projection → partial grouped agg, in one dispatch."""

    def __init__(self, c_pred, c_post, lkey: str, rkey: str, probe_needs,
                 build_needs, nk: int, ops: Tuple[str, ...],
                 has_post_pred: bool, fused_ops: Tuple[str, ...],
                 src_schema: Schema, build_schema: Schema):
        self.c_pred = c_pred            # probe-side predicate (or None)
        self.c_post = c_post            # joined-namespace projection
        self.lkey = lkey
        self.rkey = rkey
        self.probe_needs = probe_needs  # probe planes the gather feeds
        self.build_needs = build_needs
        self.nk = nk
        self.ops = ops
        self.has_post_pred = has_post_pred
        self.fused_ops = fused_ops
        self.src_schema = src_schema
        self.build_schema = build_schema

    def probe_cols(self) -> List[str]:
        """The probe columns one dispatch encodes."""
        return list(dict.fromkeys(
            [self.lkey] + list(self.probe_needs)
            + list(self.c_pred.needs_cols if self.c_pred is not None
                   else ())))

    def run_planes(self, p_arrays, p_valids, p_mask, p_scalars, build,
                   post_scalars, W: int, out_cap: int
                   ) -> List[torch.Tensor]:
        """One probe table → ``[group count, pair total]``, then one
        ``[out_cap]`` plane per key, key validity, value, value
        validity."""
        b = build.dt
        if self.c_pred is not None:
            pv, pm = self.c_pred.fn(p_arrays, p_valids, p_mask,
                                    p_scalars)[-1]
            p_mask = p_mask & pv.to(torch.bool) & pm
        counts, starts, total = kernels.join_count_impl(
            p_arrays[self.lkey], p_valids[self.lkey], p_mask,
            build.sorted_key, build.live_count)
        owner, ridx, pair_valid = kernels.join_expand_impl(
            counts, starts, build.perm, W)
        owner, ridx = owner.long(), ridx.long()
        j_arrays, j_valids = {}, {}
        for nm in self.probe_needs:
            j_arrays[nm] = p_arrays[nm][owner]
            j_valids[nm] = p_valids[nm][owner] & pair_valid
        for nm in self.build_needs:
            c = b.columns[nm]
            j_arrays[nm] = c.data[ridx]
            j_valids[nm] = c.validity[ridx] & pair_valid
        outs = self.c_post.fn(j_arrays, j_valids, pair_valid, post_scalars)
        mask = pair_valid
        if self.has_post_pred:
            qv, qm = outs[-1]
            mask = mask & qv.to(torch.bool) & qm
            outs = outs[:-1]
        nk = self.nk
        ok, okv, ov, ovv, g = kernels.grouped_agg_block_impl(
            tuple(v for v, _ in outs[:nk]), tuple(m for _, m in outs[:nk]),
            tuple(v for v, _ in outs[nk:]), tuple(m for _, m in outs[nk:]),
            mask, self.ops, out_cap)
        head = torch.stack([torch.as_tensor(g, device=mask.device)
                            .to(torch.int64).reshape(()),
                            total.to(torch.int64).reshape(())])
        return [head] + list(ok) + list(okv) + list(ov) + list(ovv)


class RegionBuild:
    """The join_agg build side, encoded and key-sorted once per query;
    every probe dispatch reads these planes."""

    __slots__ = ("dt", "sorted_key", "perm", "live_count")

    def __init__(self, dt, sorted_key, perm, live_count):
        self.dt = dt
        self.sorted_key = sorted_key
        self.perm = perm
        self.live_count = live_count


def prepare_region_build(prog: FusedJoinAggProgram, build_rb,
                         device: torch.device) -> Optional[RegionBuild]:
    """Encode the broadcast build side and sort its key plane, one
    dispatch for the whole query. None when a needed column has no device
    plane, its encode fails, or it does not fit the card: the region
    declines (the executor runs its fallback subtree)."""
    cols = list(dict.fromkeys([prog.rkey] + list(prog.build_needs)))
    if not all(dcol.has_device_plane(build_rb.get_column(n)) for n in cols):
        return None
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if dcol.encoded_nbytes(build_rb, cols) * 3 > free:
            return None
    try:
        dt = dcol.encode_batch(build_rb, cols, device)
    except (ValueError, TypeError):
        return None
    dcol.use_on_current_stream(dt)
    k = dt.columns[prog.rkey]
    sorted_key, perm, live = kernels.join_sort_impl(k.data, k.validity,
                                                    dt.row_mask)
    runtime.count("region_builds")
    return RegionBuild(dt, sorted_key, perm, live)


def get_fused_join_agg(group_exprs, child_exprs, ops: Tuple[str, ...],
                       probe_pred, post_pred, lkey: str, rkey: str,
                       src_schema: Schema, build_schema: Schema,
                       fused_ops: Tuple[str, ...] = ()
                       ) -> Optional[FusedJoinAggProgram]:
    """Compile (or fetch) the join_agg region program; None when it does
    not lower (the executor runs the region's fallback subtree)."""
    key = ("region_ja", tuple(e._key() for e in group_exprs),
           tuple(e._key() for e in child_exprs), ops,
           probe_pred._key() if probe_pred is not None else None,
           post_pred._key() if post_pred is not None else None,
           lkey, rkey, runtime._schema_key(src_schema),
           runtime._schema_key(build_schema))
    with _region_lock:
        hit = _region_cache.get(key)
    if hit is not None:
        return hit if isinstance(hit, FusedJoinAggProgram) else None
    from ..schema import Field
    src_names = set(src_schema.column_names)
    joined_schema = Schema(
        [Field(f.name, f.dtype) for f in src_schema]
        + [Field(f.name, f.dtype) for f in build_schema])
    proj = list(group_exprs) + list(child_exprs) + \
        ([post_pred] if post_pred is not None else [])
    try:
        c_post = compiler.compile_projection(proj, joined_schema)
        c_pred = compiler.compile_projection([probe_pred], src_schema) \
            if probe_pred is not None else None
    except _COMPILE_ERRORS:
        prog = False
    else:
        prog = FusedJoinAggProgram(
            c_pred, c_post, lkey, rkey,
            tuple(nm for nm in c_post.needs_cols if nm in src_names),
            tuple(nm for nm in c_post.needs_cols if nm not in src_names),
            len(group_exprs), tuple(ops), post_pred is not None,
            tuple(fused_ops), src_schema, build_schema)
    return _cache_region(key, prog)


class InflightJoinAgg:
    """One join_agg dispatch in flight, with both ladders' state."""

    def __init__(self, prog, dt, build, group_exprs, key_fields, agg_fields,
                 W, out_cap, stream):
        self.prog = prog
        self.dt = dt
        self.build = build
        self.group_exprs = group_exprs
        self.key_fields = key_fields
        self.agg_fields = agg_fields
        self.W = W
        self.out_cap = out_cap
        self.stream = stream
        self.timers: list = []
        self.fetch = None


def _prep_scalars_joined(c: compiler.Compiled, p_dt: dcol.DeviceTable,
                         b_dt: dcol.DeviceTable):
    """Scalar prep over the joined namespace: each spec's dictionary comes
    from whichever side encoded its column."""
    import pyarrow as pa
    scalars = []
    for spec in c.scalar_specs:
        src = p_dt.columns.get(spec.col) or b_dt.columns.get(spec.col)
        d = src.dictionary if src is not None else None
        if d is None:
            d = pa.array([], type=pa.large_string())
        scalars.append(torch.as_tensor(spec.fn(d), device=p_dt.device))
    return tuple(scalars)


def _dispatch_join_agg(tok: InflightJoinAgg) -> None:
    prog, dt, build = tok.prog, tok.dt, tok.build
    p_arrays = {n: c.data for n, c in dt.columns.items()}
    p_valids = {n: c.validity for n, c in dt.columns.items()}
    p_scalars = runtime._prep_scalars(prog.c_pred, dt) \
        if prog.c_pred is not None else ()
    post_scalars = _prep_scalars_joined(prog.c_post, dt, build.dt)
    timer = _Timer(dt.device)
    with retrace_sanitizer.dispatch_scope(
            "fragment.join_agg", (id(prog), dt.capacity, tok.W, tok.out_cap)):
        planes = prog.run_planes(p_arrays, p_valids, dt.row_mask,
                                 p_scalars, build, post_scalars, tok.W,
                                 tok.out_cap)
    timer.stop()
    tok.timers.append(timer)
    tok.fetch = dcol.fetch_host_async(planes)


def submit_join_agg(prog: FusedJoinAggProgram, batch, build: RegionBuild,
                    group_exprs, agg_exprs, out_schema: Schema,
                    device: torch.device, start_out_cap: int = _OUT_CAP0
                    ) -> Optional[InflightJoinAgg]:
    """Encode one probe morsel and dispatch on the current stream; no
    wait. None when a needed column has no device plane or its encode
    fails (the morsel's host chain runs). An error in the dispatch
    propagates."""
    need = prog.probe_cols()
    if not all(dcol.has_device_plane(batch.get_column(n)) for n in need):
        return None
    try:
        dt = dcol.encode_batch(batch, need, device)
    except (ValueError, TypeError):
        return None
    dcol.use_on_current_stream(dt)
    key_fields = [out_schema[e.name()] for e in group_exprs]
    agg_fields = [out_schema[e.name()] for e in agg_exprs]
    # at most one build match per probe row (a foreign-key join) starts
    # the pair bucket at the probe capacity; the head's total grows it
    W = dt.capacity
    tok = InflightJoinAgg(
        prog, dt, build, group_exprs, key_fields, agg_fields, W,
        min(dcol.bucket_capacity(max(start_out_cap, _OUT_CAP0)),
            dcol.bucket_capacity(W)), _current_stream(dt.device))
    _dispatch_join_agg(tok)
    runtime.count("region_join_agg")
    return tok


def drain_join_agg(tok: InflightJoinAgg):
    """Wait for the dispatch's one copy and decode the partial groups →
    ``(RecordBatch, group count)``, climbing both ladders (pair width W,
    group bucket) while the head says a bucket overflowed. None when W
    would pass :data:`_REGION_MAX_W` or the groups the probe's capacity
    (the morsel's host chain runs)."""
    from ..recordbatch import RecordBatch
    prog = tok.prog
    while True:
        host = tok.fetch.wait()
        g, total = int(host[0][0]), int(host[0][1])
        grown = False
        if total > tok.W:
            if total > _REGION_MAX_W:
                runtime.count("region_declined_ladder")
                return None
            tok.W = dcol.bucket_capacity(total)
            runtime.count("region_join_agg_w_climbs")
            grown = True
        if g > tok.out_cap:
            cap_limit = dcol.bucket_capacity(max(tok.W, tok.dt.capacity))
            if g > cap_limit:
                runtime.count("region_declined_ladder")
                return None
            tok.out_cap = min(dcol.bucket_capacity(g), cap_limit)
            runtime.count("region_join_agg_group_climbs")
            grown = True
        if not grown:
            break
        with dcol.on_stream(tok.stream):
            _dispatch_join_agg(tok)
    nk, nv = prog.nk, len(tok.agg_fields)
    rows = host[1:]
    cols = []
    for i, f in enumerate(tok.key_fields):
        cols.append(dcol.decode_np(f.name, f.dtype, rows[i][:g],
                                   rows[nk + i][:g].astype(np.bool_)))
    for i, f in enumerate(tok.agg_fields):
        cols.append(dcol.decode_np(f.name, f.dtype, rows[2 * nk + i][:g],
                                   rows[2 * nk + nv + i][:g]
                                   .astype(np.bool_)))
    out = RecordBatch.from_series(cols)
    tok.dt.staging = None
    n_ops = max(len(prog.fused_ops), 3)
    costmodel.ledger_record(
        "region", rows=tok.dt.row_count,
        nbytes=(1 + 2 * (nk + nv)) * 8 * tok.out_cap,
        seconds=sum(t.seconds() for t in tok.timers),
        dispatches=len(tok.timers), fused_ops=n_ops,
        round_trips_saved=n_ops - 1,
        fusion_serial_seconds=costmodel.fusion_serial_estimate(
            tok.dt.row_count, n_ops))
    return out, g


def fused_region_programs() -> list:
    """Every region program compiled so far: what
    ``warmup.warmup_regions`` launches."""
    with _region_lock:
        return [p for p in _region_cache.values()
                if isinstance(p, (FusedRegionProgram, FusedJoinAggProgram))]
