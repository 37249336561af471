"""Fused scan fragments: filter + project + partial aggregation as ONE
torch program per morsel, with one packed result transfer.

The torch rewrite of ``daft_tpu/device/fragment.py``'s fused-agg family.
``run_packed`` evaluates the compiled filter and projections, reduces with
one of three strategies, and packs every output lane bit-preservingly into
one int64 matrix, so a partial aggregation costs one device→host copy:

- **dense** (``kernels.grouped_agg_dense_impl``): every group key is a
  dictionary-coded string passthrough and the slot product fits — TPC-H Q1;
- **hash** (``hash_kernels.hash_grouped_agg_impl``, the CUDA table build):
  the key set packs into ≤128 bits and the table fits the slot ceiling;
- **sort** (``kernels.grouped_agg_block_impl``): everything else.

``DAFT_TORCH_KERNEL_GROUPBY`` forces one. The reference prices hash against
sort with a byte model (``costmodel.groupby_strategy``); that model, and the
link-priced group-capacity ceiling, wait for the port's cost model.

Overflow ladder (the reference's ``drain_fused_agg_table``): the group
block starts at 128 groups. A sort or dense result carries the true group
count, and a larger one re-dispatches at that bucket with the strategy
asked again. A full hash table only says "at least T groups", so it
re-dispatches on sort, whose count is exact.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..expressions.expressions import Expression
from ..schema import Schema
from .. import knobs
from . import column as dcol
from . import compiler, hash_kernels, kernels, runtime

_OUT_CAP0 = 128

#: dense-strategy slot ceiling: K = prod(dim + 1) slots per dispatch
DENSE_MAX_SLOTS = 4096

_NP_OF = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
          torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.float32: np.float32,
          torch.float64: np.float64}


def _pack_i64(x: torch.Tensor) -> torch.Tensor:
    """Bit-preserving lowering of any output lane to int64."""
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    return x.to(torch.int64)


def _unpack_i64(row: np.ndarray, dtype) -> np.ndarray:
    """Host-side inverse of :func:`_pack_i64`."""
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return row != 0
    if dt == np.float32:
        return (row & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    if dt == np.float64:
        return row.view(np.float64)
    return row.astype(dt)


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

    def run_packed(self, arrays, valids, row_mask, scalars, out_cap: int,
                   strategy: str = "sort", dims: Tuple[int, ...] = ()
                   ) -> Tuple[torch.Tensor, List[torch.dtype]]:
        """The whole fragment → (packed int64 matrix, lane dtypes).
        Grouped: row 0 holds the group count at [0, 0], then one
        [out_cap] row per key, key validity, value, value validity.
        Keyless: one column of values then validities."""
        keys, kvalids, vals, vvalids, row_mask = self.eval_inputs(
            arrays, valids, row_mask, scalars)
        if self.nk == 0:
            results = kernels.global_agg_impl(vals, vvalids, row_mask,
                                              self.ops)
            flat = [v for v, _ in results] + [m for _, m in results]
            return torch.stack([_pack_i64(x.reshape(())) for x in flat]), \
                [x.dtype for x in flat]
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
        flat = list(ok) + list(okv) + list(ov) + list(ovv)
        head = torch.zeros(out_cap, dtype=torch.int64, device=row_mask.device)
        head[0] = g
        rows = [head] + [_pack_i64(x) for x in flat]
        return torch.stack(rows), [x.dtype for x in flat]

    def key_plane_dtypes(self) -> List[torch.dtype]:
        """Device dtypes of the group-key planes, for the hash width check
        (strings ride int32 dictionary codes). The kernel's own packing
        is the exact check and raises if this estimate was too narrow."""
        out = []
        for f in self.compiled.out_fields[:self.nk]:
            if f.dtype.is_string() or f.dtype.is_binary():
                out.append(torch.int32)
                continue
            rep = dcol.device_np_dtype(f.dtype.device_repr())
            out.append(torch.from_numpy(np.zeros(0, rep)).dtype)
        return out


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
    return FusedAggProgram(c, nk, ops, predicate is not None,
                           tuple(srcs) if srcs else None)


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


def strategy_for(prog: FusedAggProgram, dt: dcol.DeviceTable, out_cap: int,
                 cap_limit: int) -> Tuple[str, Tuple[int, ...], int]:
    """→ ``(strategy, dims, out_cap)`` for one dispatch: dense when
    :func:`dense_plan` accepts, else hash when the key set packs into the
    hash budget and the table fits the slot ceiling, else sort.
    ``DAFT_TORCH_KERNEL_GROUPBY`` forces one (a forced dense that cannot
    apply, or a forced hash over an unpackable key set, takes the rule)."""
    forced = knobs.env_str("DAFT_TORCH_KERNEL_GROUPBY").lower()
    if forced not in ("auto", "dense", "hash", "sort"):
        raise ValueError(f"DAFT_TORCH_KERNEL_GROUPBY={forced!r}")
    if forced in ("auto", "dense"):
        plan = dense_plan(prog, dt, cap_limit)
        if plan is not None:
            return "dense", plan[0], plan[1]
    if forced == "sort" or prog.hash_unfit \
            or hash_kernels.hash_pack_words(prog.key_plane_dtypes()) is None:
        return "sort", (), out_cap
    if forced == "hash" or hash_kernels.table_capacity(out_cap) \
            <= hash_kernels.max_table_slots():
        return "hash", (), out_cap
    return "sort", (), out_cap


class InflightFusedAgg:
    """One dispatched fused-agg morsel: the device-side packed result plus
    the ladder state the drain needs to finish."""

    def __init__(self, prog, dt, group_exprs, key_fields, agg_fields):
        self.prog = prog
        self.dt = dt
        self.group_exprs = group_exprs
        self.key_fields = key_fields
        self.agg_fields = agg_fields
        self.cap_limit = dcol.bucket_capacity(dt.capacity)
        self.out_cap = min(_OUT_CAP0, self.cap_limit)
        self.strategy: Optional[str] = None
        self.dims: Tuple[int, ...] = ()
        self.packed: Optional[torch.Tensor] = None
        self.dtypes: List[torch.dtype] = []


def _dispatch(tok: InflightFusedAgg) -> None:
    """Run the current ladder rung (asks the strategy when unset)."""
    prog, dt = tok.prog, tok.dt
    arrays = {n: c.data for n, c in dt.columns.items()}
    valids = {n: c.validity for n, c in dt.columns.items()}
    scalars = runtime._prep_scalars(prog.compiled, dt)
    if prog.nk == 0:
        tok.packed, tok.dtypes = prog.run_packed(arrays, valids, dt.row_mask,
                                                 scalars, _OUT_CAP0)
        runtime.count("global")
        return
    while True:
        if tok.strategy is None:
            tok.strategy, tok.dims, tok.out_cap = strategy_for(
                prog, dt, tok.out_cap, tok.cap_limit)
        try:
            tok.packed, tok.dtypes = prog.run_packed(
                arrays, valids, dt.row_mask, scalars, tok.out_cap,
                tok.strategy, tok.dims)
        except hash_kernels.HashKeyWidthError:
            # the exact width check, raised before any launch: route this
            # program to sort for good. Any other error propagates.
            prog.hash_unfit = True
            tok.strategy = "sort"
            continue
        runtime.count(tok.strategy)
        return


def submit_fused_agg_table(prog: FusedAggProgram, dt: dcol.DeviceTable,
                           in_schema: Schema, group_exprs, agg_exprs,
                           out_schema: Schema) -> InflightFusedAgg:
    """Dispatch the first ladder rung; no host fetch."""
    key_fields = [e.to_field(in_schema) for e in group_exprs]
    agg_fields = [out_schema[e.name()] for e in agg_exprs]
    tok = InflightFusedAgg(prog, dt, group_exprs, key_fields, agg_fields)
    _dispatch(tok)
    return tok


def drain_fused_agg_table(tok: InflightFusedAgg):
    """Fetch the packed result (one transfer) and decode it, climbing the
    overflow ladder while the group count outgrows the bucket."""
    from ..recordbatch import RecordBatch
    prog = tok.prog
    if prog.nk == 0:
        packed = tok.packed.cpu().numpy()
        nv = len(tok.agg_fields)
        cols = []
        for i, f in enumerate(tok.agg_fields):
            v = _unpack_i64(packed[i:i + 1], _NP_OF[tok.dtypes[i]])
            m = _unpack_i64(packed[nv + i:nv + i + 1],
                            _NP_OF[tok.dtypes[nv + i]]).astype(np.bool_)
            cols.append(dcol.decode_np(f.name, f.dtype, v, m))
        return RecordBatch.from_series(cols)
    while True:
        packed = tok.packed.cpu().numpy()
        g = int(packed[0, 0])
        if g <= tok.out_cap:
            return _decode_grouped(tok, packed, g)
        if g > tok.cap_limit:
            raise RuntimeError(f"group count {g} exceeds the morsel "
                               f"capacity {tok.cap_limit}")
        saturated = tok.strategy == "hash" and \
            g >= hash_kernels.table_capacity(tok.out_cap)
        tok.out_cap = min(dcol.bucket_capacity(max(g, _OUT_CAP0)),
                          tok.cap_limit)
        # a full table's count is only a lower bound: sort counts exactly;
        # otherwise the grown bucket re-asks the strategy
        tok.strategy = "sort" if saturated else None
        _dispatch(tok)


def _decode_grouped(tok: InflightFusedAgg, packed: np.ndarray, g: int):
    from ..recordbatch import RecordBatch
    nk, nv = tok.prog.nk, len(tok.agg_fields)
    dts = [_NP_OF[d] for d in tok.dtypes]
    rows = packed[1:]
    cols = []
    for i, (e, f) in enumerate(zip(tok.group_exprs, tok.key_fields)):
        kv = _unpack_i64(rows[i][:g], dts[i])
        km = _unpack_i64(rows[nk + i][:g], dts[nk + i]).astype(np.bool_)
        cols.append(dcol.decode_np(f.name, f.dtype, kv, km,
                                   runtime.key_dictionary(e, f, tok.dt)))
    for i, f in enumerate(tok.agg_fields):
        vv = _unpack_i64(rows[2 * nk + i][:g], dts[2 * nk + i])
        vm = _unpack_i64(rows[2 * nk + nv + i][:g],
                         dts[2 * nk + nv + i]).astype(np.bool_)
        cols.append(dcol.decode_np(f.name, f.dtype, vv, vm))
    return RecordBatch.from_series(cols)


def run_fused_agg(prog: FusedAggProgram, batch, group_exprs, agg_exprs,
                  out_schema: Schema, device: torch.device):
    """Encode one RecordBatch onto ``device``, run the fused program and
    return its partial groups as a RecordBatch."""
    dt = dcol.encode_batch(batch, prog.compiled.needs_cols, device)
    return drain_fused_agg_table(submit_fused_agg_table(
        prog, dt, batch.schema, group_exprs, agg_exprs, out_schema))
