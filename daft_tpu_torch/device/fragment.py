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
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..expressions.expressions import Expression
from ..schema import Schema
from . import column as dcol
from . import compiler, costmodel, hash_kernels, kernels, mfu, runtime

_OUT_CAP0 = 128

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
    """Compile the fused filter→project→grouped-agg program, or None when
    an expression has no device lowering (the morsel runs on the host)."""
    proj = list(group_exprs) + list(child_exprs) + \
        ([predicate] if predicate is not None else [])
    try:
        c = compiler.compile_projection(proj, schema)
    except (compiler.NotCompilable, NotImplementedError, ValueError,
            TypeError, KeyError, OverflowError):
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
    _fused_seen[(tuple(e._key() for e in proj), ops,
                 runtime._schema_key(schema))] = prog
    return prog


#: every fused program compiled so far, by its expressions and schema (the
#: latest of each): what ``warmup.warmup_fragments`` launches
_fused_seen: dict = {}


def fused_programs() -> List[FusedAggProgram]:
    return list(_fused_seen.values())


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
        tok.planes = prog.run_planes(arrays, valids, dt.row_mask, scalars,
                                     _OUT_CAP0)
        runtime.count("global")
        return
    while True:
        if tok.strategy is None:
            tok.strategy, tok.dims, tok.out_cap, tok.lf = strategy_for(
                prog, dt, tok.out_cap, tok.cap_limit, tok.groups)
        timer = _Timer(dt.device)
        try:
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
