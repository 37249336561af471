"""Device dispatch: the dispatch counters, the per-batch scalar
preparation shared with the fused fragments, and the per-operator device
paths — projection, predicate, argsort and aggregation outside a fused
fragment — that ``RecordBatch`` and ``aggs.agg_recordbatch`` try before
their Arrow host tier.

The torch rewrite of ``daft_tpu/device/runtime.py``. Each ``try_*``
returns None (the caller runs the host tier) in the cases where the
reference declines: no device (``backend.resolve_device()`` is None), a
projection that does not compile, an output that cannot be decoded, a
Python-object column, an aggregation outside :data:`_DEVICE_AGGS` — and
where the cost model prices the host cheaper: ``costmodel.row_output_op_wins``
for projections and predicates, ``argsort_wins``, and for aggregations
``groupby_strategy`` then ``agg_upload_wins`` at the strategy the dispatch
would take. An explicit ``DAFT_TORCH_DEVICE_MIN_ROWS`` replaces the
pricing with its row floor (the reference's ``_min_rows_override``), and
``DAFT_TORCH_DEVICE_FORCE`` trumps both. A per-operator call that goes to
the host by floor or price counts ``host_ops``. Nothing else is caught: an
error in a device path propagates. Each dispatch records its work in the
cost model's ledger (``costmodel.ledger_record``, the ``mfu`` byte
models, the host wall to the fetched result).

A projection's decoded columns register their device planes in the
pipeline's residency registry (``pipeline.note_decoded``), so a later
encode of the same Series reuses them (``column.encode_batch``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from .. import knobs
from ..analysis import retrace_sanitizer
from ..expressions.expressions import Expression
from ..schema import Schema
from ..series import Series
from . import column as dcol
from .backend import resolve_device

#: what type inference raises for an expression it cannot type: the
#: operator then runs on the host, where the same error surfaces
_TYPE_ERRORS = (ValueError, TypeError, KeyError, NotImplementedError)

_DEVICE_AGGS = {"sum", "mean", "min", "max", "count", "stddev", "var",
                "any_value", "bool_and", "bool_or"}

_counters_lock = threading.Lock()
_counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Bump a dispatch counter: ``dense`` / ``hash`` / ``sort`` /
    ``global`` per fused dispatch by strategy, ``host_morsels`` per morsel
    a DeviceFragmentAgg ran on the host; ``join_hash`` / ``join_sort`` per
    device join dispatch by strategy (an overflow re-dispatch counts
    again), ``host_joins`` per equi-join index generation on the host;
    ``projection`` / ``predicate`` / ``argsort`` and ``agg_hash`` /
    ``agg_sort`` / ``agg_global`` per per-operator device dispatch,
    ``host_ops`` per per-operator call the row floor sent to the host, and
    ``op_bytes_up`` for the bytes those dispatches encoded onto the
    device; ``bytes_up`` / ``h2d_copies`` for every encode's bytes (the
    pinned host→device copies on a card) and ``bytes_down`` /
    ``d2h_copies`` for every fetch."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The dispatch and transfer counters, and beside them those of the
    pipeline (``pipeline_*``, :func:`pipeline.counters_snapshot`), the
    device column cache (``cache_*``: hits, misses, puts, evictions,
    refused, bytes_put, bytes_evicted) and the residency registry
    (``residency_*``: hits, misses, evictions) — each since the last
    :func:`reset_counters`, and only where it is not 0. What the cache and
    the registry hold now is ``cache.get_cache().stats()`` and
    ``pipeline.residency_counters()``."""
    from . import cache, pipeline
    with _counters_lock:
        out = dict(_counters)
    for prefix, vals in (("pipeline_", pipeline.counters_snapshot()),
                         ("cache_", cache.get_cache().stats()),
                         ("residency_", pipeline.residency_counters())):
        out.update({prefix + k: v for k, v in vals.items()
                    if v and k not in ("entries", "bytes")})
    return out


def reset_counters() -> None:
    """Zero every counter (the cache's and the registry's contents
    stay)."""
    from . import cache, pipeline
    with _counters_lock:
        _counters.clear()
    pipeline.reset_counters()
    pipeline.reset_residency_counters()
    cache.get_cache().reset_counters()


def fused_unpriced() -> bool:
    """True when an explicit ``DAFT_TORCH_DEVICE_MIN_ROWS`` puts the fused
    fragment back on the rule it had before the cost model: every
    non-empty batch whose columns have device planes runs on the card,
    unpriced (the floor itself applies to the per-operator paths only).
    ``DAFT_TORCH_DEVICE_FORCE`` trumps it: the pricing reads the force."""
    return knobs.env_opt_int("DAFT_TORCH_DEVICE_MIN_ROWS") is not None \
        and knobs.env_raw("DAFT_TORCH_DEVICE_FORCE") is None


def _min_rows_override(n_rows: int) -> Optional[bool]:
    """An explicit ``DAFT_TORCH_DEVICE_MIN_ROWS`` keeps its documented
    meaning (the device runs at or above that many rows) and replaces the
    pricing; ``DAFT_TORCH_DEVICE_FORCE`` trumps it. None: no override,
    consult the cost model."""
    env = knobs.env_opt_int("DAFT_TORCH_DEVICE_MIN_ROWS")
    if env is None or knobs.env_raw("DAFT_TORCH_DEVICE_FORCE") is not None:
        return None
    return n_rows >= max(env, 1)


def _gate(ok: bool) -> bool:
    """Count ``host_ops`` for a per-operator call sent to the host."""
    if not ok:
        count("host_ops")
    return ok


def _series_nbytes(s: Series) -> int:
    return int(s.to_arrow().nbytes)


def _batch_cols_nbytes(batch, cols) -> int:
    """Arrow bytes a host pass over these columns touches."""
    return sum(_series_nbytes(batch.get_column(c)) for c in cols)


def _row_output_profitable(batch, needs_cols, n_outputs: int,
                           out_bytes_per_row: int = 8) -> bool:
    """The gate of ops whose output is row-shaped (projection values,
    predicate masks): the explicit floor when set, else
    ``costmodel.row_output_op_wins`` (encoded bytes up, the outputs down,
    against a host vector pass over the Arrow bytes)."""
    from . import costmodel
    n_rows = len(batch)
    ov = _min_rows_override(n_rows)
    if ov is not None:
        return ov
    return costmodel.row_output_op_wins(
        dcol.encoded_nbytes(batch, needs_cols),
        n_rows * out_bytes_per_row * max(n_outputs, 1),
        host_bytes=_batch_cols_nbytes(batch, needs_cols))


# ------------------------------------------------- projection compile cache

_projection_cache: Dict[Tuple, object] = {}
# single-flight: concurrent identical compiles (the executor's pool
# threads run one projection over many morsels at once) produce ONE
# compile, the others wait on the winner
_compile_lock = threading.Lock()
# One per-operator device section at a time, across the four paths
# (projection, predicate, argsort, agg), as a join's
# (``joins._device_lock``): the encode and its upload, the launches and
# the one fetch. The executor's threads, and concurrent queries under the
# serving scheduler, share the card's stream, where their launches would
# only interleave; run concurrently, their allocations peak as the
# threads happen to overlap, so a repeat of a query could need new device
# memory at a signature its first run warmed. One lock for the four
# paths, not one each: a projection overlapping an agg peaks as much as
# two aggs do. The gate before the section and the decode after it run
# in parallel.
_op_device_lock = threading.Lock()
_compile_inflight: Dict[Tuple, threading.Event] = {}
_compile_counters: Dict[str, int] = {"hits": 0, "misses": 0, "compiles": 0,
                                     "waits": 0}


def compile_cache_counters() -> Dict[str, int]:
    """Process-wide projection-compile cache counters."""
    with _compile_lock:
        out = dict(_compile_counters)
        out["entries"] = len(_projection_cache)
    return out


def _schema_key(schema: Schema) -> Tuple:
    return tuple((f.name, hash(f.dtype)) for f in schema)


def _get_compiled(exprs: List[Expression], schema: Schema):
    """The compiled program of ``exprs`` over ``schema``, or None when it
    does not compile (failures are not cached)."""
    from . import compiler
    key = (tuple(e._key() for e in exprs), _schema_key(schema))
    while True:
        with _compile_lock:
            hit = _projection_cache.get(key)
            if hit is not None:
                _compile_counters["hits"] += 1
                return hit
            ev = _compile_inflight.get(key)
            if ev is None:
                _compile_inflight[key] = threading.Event()
                _compile_counters["misses"] += 1
                break
            _compile_counters["waits"] += 1
        ev.wait()
    try:
        try:
            c = compiler.compile_projection(exprs, schema)
        except (compiler.NotCompilable, NotImplementedError, ValueError,
                TypeError, KeyError, OverflowError):
            return None
        with _compile_lock:
            _projection_cache[key] = c
            _compile_counters["compiles"] += 1
        return c
    finally:
        with _compile_lock:
            ev2 = _compile_inflight.pop(key, None)
        if ev2 is not None:
            ev2.set()


# ------------------------------------------------------------ shared helpers

def _string_out_source(e: Expression) -> Optional[str]:
    """If expr output is a passthrough of a column, its source name."""
    inner = e._unalias()
    return inner.params[0] if inner.op == "col" else None


def _prep_scalars(c, dt: dcol.DeviceTable):
    """Per-batch scalar arguments (string-literal ranks) of a compiled
    program, on the table's device."""
    scalars = []
    for spec in c.scalar_specs:
        d = dt.columns[spec.col].dictionary
        if d is None:
            d = pa.array([], type=pa.large_string())
        scalars.append(torch.as_tensor(spec.fn(d), device=dt.device))
    return tuple(scalars)


def key_dictionary(e: Expression, field, dt: dcol.DeviceTable
                   ) -> Optional[pa.Array]:
    """The dictionary a string output decodes through: its source
    column's."""
    if field.dtype.is_string() or field.dtype.is_binary():
        return dt.columns[_string_out_source(e)].dictionary
    return None


def _decodable(e: Expression, field) -> bool:
    """An output decodes when it has a device plane; a string one only as
    a passthrough of a column (its dictionary)."""
    if field.dtype.is_string() or field.dtype.is_binary():
        return _string_out_source(e) is not None
    return field.dtype.device_repr() is not None


def _host_only(batch, names) -> bool:
    """Some named column has no device plane (:func:`dcol.has_device_plane`)."""
    return not all(dcol.has_device_plane(batch.get_column(n)) for n in names)


def encode_for(c, batch, device: torch.device):
    """Encode a batch's needed columns for a compiled program → (table,
    arrays, valids, scalars)."""
    dt = dcol.encode_batch(batch, c.needs_cols, device)
    count("op_bytes_up", dcol.encoded_nbytes(batch, c.needs_cols))
    arrays = {n: col.data for n, col in dt.columns.items()}
    valids = {n: col.validity for n, col in dt.columns.items()}
    return dt, arrays, valids, _prep_scalars(c, dt)


def _run_compiled(c, batch, device: torch.device):
    """Encode the inputs and run the program → (table, per-expr
    ``(values, validity)`` outputs)."""
    dt, arrays, valids, scalars = encode_for(c, batch, device)
    return dt, c.fn(arrays, valids, dt.row_mask, scalars)


# ----------------------------------------------------- per-operator paths

def try_eval_projection(batch, exprs: List[Expression]):
    """A whole projection on the device → RecordBatch, or None (host)."""
    from ..recordbatch import RecordBatch
    device = resolve_device()
    if device is None:
        return None
    schema = batch.schema
    try:
        out_fields = [e.to_field(schema) for e in exprs]
    except _TYPE_ERRORS:
        return None
    if not all(_decodable(e, f) for e, f in zip(exprs, out_fields)):
        return None
    c = _get_compiled(exprs, schema)
    if c is None or _host_only(batch, c.needs_cols) \
            or not _gate(_row_output_profitable(batch, c.needs_cols,
                                                len(exprs))):
        return None
    from . import costmodel
    with _op_device_lock, retrace_sanitizer.dispatch_scope(
            "runtime.projection",
            (id(c), dcol.bucket_capacity(len(batch)))):
        t0 = time.perf_counter()  # the ledger times the section, not its wait
        dt, outs = _run_compiled(c, batch, device)
        count("projection")
        named = [(f.name, dcol.DeviceColumn(v, m, f.dtype,
                                            key_dictionary(e, f, dt)))
                 for e, f, (v, m) in zip(exprs, out_fields, outs)]
        # one device→host copy for every output plane
        host = dcol.fetch_columns(named, len(batch))
    out = RecordBatch.from_series(
        dcol.decode_fetched(named, host, len(batch)))
    n = len(batch)
    costmodel.ledger_record(
        "projection", rows=n,
        nbytes=dcol.encoded_nbytes(batch, c.needs_cols)
        + n * 8 * max(len(exprs), 1),
        seconds=time.perf_counter() - t0)
    return out


def try_eval_predicate(batch, predicate: Expression) -> Optional[np.ndarray]:
    """A predicate on the device → host boolean mask, or None (host)."""
    device = resolve_device()
    if device is None:
        return None
    c = _get_compiled([predicate], batch.schema)
    if c is None or _host_only(batch, c.needs_cols) \
            or not _gate(_row_output_profitable(batch, c.needs_cols, 1,
                                                out_bytes_per_row=1)):
        return None
    with _op_device_lock, retrace_sanitizer.dispatch_scope(
            "runtime.predicate",
            (id(c), dcol.bucket_capacity(len(batch)))):
        _, outs = _run_compiled(c, batch, device)
        count("predicate")
        val, valid = outs[0]
        mask = (val.to(torch.bool) & valid)[:len(batch)]
        host = dcol.fetch_host([mask])[0]
    return host.astype(bool)


def try_argsort(key_series: List[Series], descending: List[bool],
                nulls_first: List[bool]) -> Optional[np.ndarray]:
    """A multi-key sort permutation on the device, or None (host)."""
    from . import costmodel, kernels, mfu
    if not key_series:
        return None
    device = resolve_device()
    n = len(key_series[0])
    if device is None or n < 2:
        return None
    for s in key_series:
        if not dcol.has_device_plane(s):
            return None
        dt = s.datatype()
        if not (dt.is_device_representable() or dt.is_string()):
            return None
    floor = _min_rows_override(n)
    if not _gate(floor if floor is not None else costmodel.argsort_wins(
            n, sum(_series_nbytes(s) for s in key_series),
            len(key_series))):
        return None
    cap = dcol.bucket_capacity(n)
    with _op_device_lock, retrace_sanitizer.dispatch_scope(
            "runtime.argsort",
            (cap, tuple(s.datatype() for s in key_series),
             tuple(descending), tuple(nulls_first))):
        try:
            cols = [dcol.encode_series(s, cap, device) for s in key_series]
        except (ValueError, pa.ArrowInvalid):
            return None
        t0 = time.perf_counter()
        count("op_bytes_up", sum(c.data.nbytes + c.validity.nbytes
                                 for c in cols))
        mask = torch.arange(cap, device=device) < n
        perm = kernels.argsort_kernel(
            tuple(c.data for c in cols), tuple(c.validity for c in cols),
            mask, tuple(bool(d) for d in descending),
            tuple(bool(x) for x in nulls_first))
        count("argsort")
        host = dcol.fetch_host([perm[:n]])[0]
    out = host.astype(np.int64)
    costmodel.ledger_record(
        "argsort", rows=n,
        nbytes=mfu.argsort_bytes_model(cap, [c.data.dtype for c in cols]),
        seconds=time.perf_counter() - t0)
    return out


def key_plane_dtype(field) -> torch.dtype:
    """The device dtype of a group key's plane, estimated from its field
    before any encode (strings ride int32 dictionary codes), for the gates
    that price the hash width before the planes exist."""
    if field.dtype.is_string() or field.dtype.is_binary():
        return torch.int32
    rep = dcol.device_np_dtype(field.dtype.device_repr())
    return torch.from_numpy(np.zeros(0, rep)).dtype


def try_agg(batch, to_agg: List[Expression], group_by: List[Expression]):
    """Grouped or global aggregation on the device → RecordBatch, or None
    (host). Keyless: ``kernels.global_agg_impl``. Grouped: the hash table
    (``hash_kernels.hash_grouped_agg_impl``) or the sort strategy's
    scatter form (``kernels.grouped_agg_impl``) by
    ``costmodel.groupby_strategy``, either at a group budget of the whole
    capacity, so it never overflows. The gate: the explicit floor when
    set (the port's documented meaning of ``DAFT_TORCH_DEVICE_MIN_ROWS``,
    trumped by ``DAFT_TORCH_DEVICE_FORCE``), else
    ``costmodel.agg_upload_wins`` for a one-shot upload (an in-memory batch
    has no cache identity) at the strategy estimated from the key fields;
    the dispatch takes the strategy of the compiled key planes."""
    from ..aggs import split_agg_expr
    from ..recordbatch import RecordBatch
    from . import costmodel, hash_kernels, kernels, mfu
    from .fragment import _OUT_CAP0, packed_bytes_per_group
    device = resolve_device()
    if device is None:
        return None
    schema = batch.schema
    try:
        specs = [split_agg_expr(e) for e in to_agg]
    except ValueError:
        return None
    for op, child, name, params in specs:
        if op not in _DEVICE_AGGS:
            return None
        if op == "count" and params and params[0] != "valid":
            return None
    try:
        out_fields = [e.to_field(schema) for e in to_agg]
        key_fields = [e.to_field(schema) for e in group_by]
    except _TYPE_ERRORS:
        return None
    if not all(_decodable(e, f) for e, f in zip(group_by, key_fields)):
        return None
    for (op, child, _, _), f in zip(specs, out_fields):
        if f.dtype.is_string() or f.dtype.is_binary():
            if child is None or _string_out_source(child) is None:
                return None
        elif f.dtype.device_repr() is None:
            return None
    # keys and agg children compile as one projection
    child_exprs = [(child if child is not None else Expression._lit(True))
                   .alias(f"__in{i}__")
                   for i, (_, child, _, _) in enumerate(specs)]
    proj = list(group_by) + child_exprs
    c = _get_compiled(proj, schema)
    if c is None or _host_only(batch, c.needs_cols) \
            or not _gate(len(batch) >= 1):
        return None
    # the gate prices the kernel the dispatch would take, estimated from
    # the key fields' plane dtypes (unlogged: the dispatch logs what ran)
    nk = len(group_by)
    cap = dcol.bucket_capacity(len(batch))
    est = "sort" if nk == 0 else costmodel.groupby_strategy(
        len(batch), None, [key_plane_dtype(f) for f in key_fields], cap,
        log=False, device=device)[0]
    floor = _min_rows_override(len(batch))
    if not _gate(floor if floor is not None else costmodel.agg_upload_wins(
            dcol.encoded_nbytes(batch, c.needs_cols),
            packed_bytes_per_group(nk, len(to_agg)) * _OUT_CAP0,
            cacheable=False,
            host_bytes=_batch_cols_nbytes(batch, c.needs_cols),
            strategy=est)):
        return None
    return _agg_dispatch(c, batch, device, specs, out_fields, key_fields,
                         group_by, nk, cap)


def _agg_dispatch(c, batch, device, specs, out_fields, key_fields,
                  group_by, nk: int, cap: int):
    """The per-operator agg's dispatch: encode, the kernel of the
    strategy and one fetch under the device lock and the retrace scope,
    then the decode."""
    from ..recordbatch import RecordBatch
    from . import costmodel, hash_kernels, kernels, mfu
    with _op_device_lock, \
            retrace_sanitizer.dispatch_scope("runtime.agg", (id(c), cap)):
        t0 = time.perf_counter()  # the ledger times the section, not its wait
        dt, outs = _run_compiled(c, batch, device)
        ops = tuple(s[0] for s in specs)
        keys = tuple(v for v, _ in outs[:nk])
        kvalids = tuple(m for _, m in outs[:nk])
        vals = tuple(v for v, _ in outs[nk:])
        vvalids = tuple(m for _, m in outs[nk:])
        if nk == 0:
            results = kernels.global_agg_impl(vals, vvalids, dt.row_mask,
                                              ops)
            count("agg_global")
            # one device→host copy for every scalar
            host = dcol.fetch_host([x.reshape(1) for r in results
                                    for x in r])
        else:
            # the dispatch's strategy from the compiled key planes
            strategy, load_factor = costmodel.groupby_strategy(
                len(batch), None, [k.dtype for k in keys], cap, log=False,
                device=device)
            if strategy == "hash":
                out = hash_kernels.hash_grouped_agg_impl(
                    keys, kvalids, vals, vvalids, dt.row_mask, ops,
                    out_cap=dt.capacity)
            else:
                out = kernels.grouped_agg_impl(keys, kvalids, vals,
                                               vvalids, dt.row_mask, ops)
            count("agg_" + strategy)
            ok, okv, ov, ovv, g_t = out
            planes = [g_t.reshape(1)] + [x for pair in zip(ok, okv)
                                         for x in pair] \
                + [x for pair in zip(ov, ovv) for x in pair]
            host = dcol.fetch_host(planes)
    if nk == 0:
        return RecordBatch.from_series([
            _decode_scalar(name, f.dtype, host[2 * i], host[2 * i + 1])
            for i, ((_, _, name, _), f) in enumerate(zip(specs,
                                                         out_fields))])
    costmodel.log_strategy_decision("groupby_strategy", strategy,
                                    rows=len(batch), out_cap=cap,
                                    load_factor=load_factor)
    g = int(host[0][0])
    if strategy == "hash":
        words = hash_kernels.hash_pack_words([k.dtype for k in keys]) or 2
        _, nbytes = mfu.hash_agg_models(
            dt.capacity, dt.capacity,
            hash_kernels.table_capacity(dt.capacity), words, len(ops))
    else:
        _, nbytes = mfu.grouped_agg_models(dt.capacity, dt.capacity, nk,
                                           len(ops))
    costmodel.ledger_record("grouped_agg", rows=len(batch), nbytes=nbytes,
                            seconds=time.perf_counter() - t0,
                            strategy=strategy,
                            load_factor=load_factor or None)
    cols = []
    for i, (e, f) in enumerate(zip(group_by, key_fields)):
        cols.append(dcol.decode_np(f.name, f.dtype, host[1 + 2 * i][:g],
                                   host[2 + 2 * i][:g],
                                   key_dictionary(e, f, dt)))
    base = 1 + 2 * nk
    for i, ((_, child, name, _), f) in enumerate(zip(specs, out_fields)):
        # a string min/max/any_value decodes through its child's dictionary
        cols.append(dcol.decode_np(name, f.dtype, host[base + 2 * i][:g],
                                   host[base + 2 * i + 1][:g],
                                   key_dictionary(child, f, dt)))
    return RecordBatch.from_series(cols)


def _decode_scalar(name: str, dtype, v: np.ndarray, m: np.ndarray
                   ) -> Series:
    """One already-fetched global-agg result → a one-row Series."""
    return dcol.decode_np(name, dtype, v.reshape(1),
                          m.reshape(1).astype(np.bool_))
