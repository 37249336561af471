"""Aggregation kernels (host tier).

Reference capability: ``src/daft-recordbatch/src/ops/agg.rs:12-29``
(agg/agg_global/agg_groupby). Grouped aggregation rides Arrow C++
``TableGroupBy`` (native hash aggregation). The torch device tier runs
aggregations inside the executor's fused fragments
(``device/fragment.py``), which merge their partial states through
:data:`AGG_DECOMPOSITION`, and per operator where
``device/runtime.try_agg`` takes the batch (:func:`agg_recordbatch`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .datatype import DataType
from .expressions import Expression, col
from .series import Series


def split_agg_expr(e: Expression) -> Tuple[str, Expression, str, Tuple]:
    """alias(agg(child)) -> (agg_op, child_expr, out_name, agg_params)."""
    name = e.name()
    inner = e._unalias()
    if not inner.op.startswith("agg."):
        raise ValueError(f"expected aggregation expression, got {inner.op}")
    child = inner.args[0] if inner.args else None
    return inner.op[4:], child, name, inner.params


_PA_AGGS = {
    "sum": "sum", "mean": "mean", "min": "min", "max": "max",
    "count_distinct": "count_distinct", "stddev": "stddev", "var": "variance",
    "list": "list", "any_value": "first", "bool_and": "all", "bool_or": "any",
    "approx_count_distinct": "count_distinct", "set": "distinct",
}


# ----------------------------------------------- partial/merge decomposition

#: How each aggregation decomposes across a shuffle/pipeline boundary:
#: ``op -> (partial-state ops over the input, merge op over each state
#: column)``. Single-sourced on purpose — three layers read it:
#: the planner's partial/final split (``physical/translate._split_aggs``),
#: the local fused partitioned-agg reducer (``execution/pipeline``), and
#: the distributed map-side shuffle combine
#: (``distributed/stages.combine_for_boundary`` → ``worker.run_task``).
#: An op absent here (see :data:`NON_DECOMPOSABLE_AGGS`) aggregates in a
#: single stage over gathered/co-partitioned rows.
AGG_DECOMPOSITION: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "sum": (("sum",), "sum"),
    "count": (("count",), "sum"),
    "min": (("min",), "min"),
    "max": (("max",), "max"),
    "any_value": (("any_value",), "any_value"),
    "bool_and": (("bool_and",), "bool_and"),
    "bool_or": (("bool_or",), "bool_or"),
    "list": (("list",), "concat"),
    "concat": (("concat",), "concat"),
    "mean": (("sum", "count"), "sum"),
    "stddev": (("sum", "count", "sumsq"), "sum"),
    "var": (("sum", "count", "sumsq"), "sum"),
}

#: merge-stage ops that are associative SELF-merges: re-applying the op
#: over its own output column correctly merges two batches of state
#: (derived from the table above — every merge op is one)
SELF_MERGE_OPS = frozenset(m for _, m in AGG_DECOMPOSITION.values())


def merge_exprs_for(aggs: List[Expression], alias_to: str = "out"
                    ) -> Optional[List[Expression]]:
    """For merge/final-stage aggs shaped ``op(col(p)).alias(out)`` whose
    ops are all self-merges, the expressions that merge two batches of
    aggregated state (reference ``aggs.merge_exprs_for``):

    - ``alias_to="out"`` — merge batches of FINAL-schema state:
      ``op(col(out)).alias(out)`` (the partitioned-agg reducer's shape,
      ``execution/pipeline.py``);
    - ``alias_to="source"`` — merge batches of WIRE-schema partial
      columns: ``op(col(p)).alias(p)`` (the distributed map-side
      combine: the combined output keeps the map output's schema).

    None when any agg is not a single-column self-merge, or (``source``)
    when two aggs merge one wire column with different ops."""
    out: List[Expression] = []
    seen: Dict[str, str] = {}
    for a in aggs:
        u = a._unalias()
        if not u.op.startswith("agg.") or u.op[4:] not in SELF_MERGE_OPS \
                or len(u.args) != 1 or u.args[0]._unalias().op != "col":
            return None
        if alias_to == "out":
            out.append(Expression(u.op, (col(a.name()),), u.params)
                       .alias(a.name()))
            continue
        src = u.args[0]._unalias().name()
        prev = seen.get(src)
        if prev is not None:
            if prev != u.op:
                return None
            continue
        seen[src] = u.op
        out.append(Expression(u.op, (col(src),), u.params).alias(src))
    return out


def agg_recordbatch(batch, to_agg: List[Expression], group_by: List[Expression]):
    from .device import runtime as device_runtime
    out = device_runtime.try_agg(batch, to_agg, group_by)
    if out is not None:
        return out
    specs = [split_agg_expr(e) for e in to_agg]
    if not group_by:
        return _agg_global(batch, specs)
    return _agg_groupby(batch, specs, group_by)


def _eval_child(batch, child: Optional[Expression], i: int) -> Series:
    if child is None:
        return Series.from_pylist([True] * len(batch), f"__in{i}__")
    return batch.eval_expression(child).rename(f"__in{i}__")


def _agg_global(batch, specs):
    from .recordbatch import RecordBatch
    out_cols = []
    for i, (op, child, name, params) in enumerate(specs):
        s = _eval_child(batch, child, i)
        out_cols.append(_global_one(op, s, name, params))
    return RecordBatch.from_series(out_cols)


def _global_one(op: str, s: Series, name: str, params) -> Series:
    in_dtype = s.datatype()
    if op == "count":
        mode = params[0] if params else "valid"
        if mode == "all" or s.is_pyobject():
            v = len(s) if mode == "all" else \
                sum(1 for x in s.to_pylist() if x is not None)
        elif mode == "null":
            v = s.null_count()
        else:
            v = len(s) - s.null_count()
        return Series.from_pylist([v], name, dtype=DataType.uint64())
    arr = s.to_arrow()
    if op == "sum":
        out_dt = _sum_dtype(in_dtype)
        v = pc.sum(arr).as_py()
        return Series.from_pylist([v], name, dtype=out_dt)
    if op == "mean":
        v = pc.mean(arr).as_py() if len(arr) else None
        return Series.from_pylist([v], name, dtype=DataType.float64())
    if op in ("min", "max"):
        v = (pc.min if op == "min" else pc.max)(arr).as_py() if len(arr) else None
        return Series.from_pylist([v], name, dtype=in_dtype)
    if op in ("count_distinct", "approx_count_distinct"):
        v = pc.count_distinct(arr, mode="only_valid").as_py()
        return Series.from_pylist([v], name, dtype=DataType.uint64())
    if op == "any_value":
        vals = [x for x in arr.to_pylist() if x is not None] or [None]
        return Series.from_pylist([vals[0]], name, dtype=in_dtype)
    if op == "list":
        return Series.from_pylist([arr.to_pylist()], name,
                                  dtype=DataType.list(in_dtype))
    if op == "set":
        seen, out = set(), []
        for x in arr.to_pylist():
            if x is not None and x not in seen:
                seen.add(x)
                out.append(x)
        return Series.from_pylist([out], name, dtype=DataType.list(in_dtype))
    if op == "concat":
        if in_dtype.is_string():
            vals = [x for x in arr.to_pylist() if x is not None]
            return Series.from_pylist(["".join(vals) if vals else None], name)
        out = []
        for v in arr.to_pylist():
            if v is not None:
                out.extend(v)
        return Series.from_pylist([out], name, dtype=in_dtype)
    if op == "stddev":
        v = pc.stddev(arr, ddof=0).as_py() if len(arr) else None
        return Series.from_pylist([v], name, dtype=DataType.float64())
    if op == "var":
        v = pc.variance(arr, ddof=0).as_py() if len(arr) else None
        return Series.from_pylist([v], name, dtype=DataType.float64())
    if op == "skew":
        v = _skew(arr.to_numpy(zero_copy_only=False))
        return Series.from_pylist([v], name, dtype=DataType.float64())
    if op in ("bool_and", "bool_or"):
        fn = pc.all if op == "bool_and" else pc.any
        v = fn(arr.cast(pa.bool_())).as_py()
        return Series.from_pylist([v], name, dtype=DataType.bool())
    if op == "approx_percentiles":
        ps = list(params[0])
        v = pc.tdigest(arr, q=ps).to_pylist()
        return Series.from_pylist(
            [v], name, dtype=DataType.fixed_size_list(DataType.float64(), len(ps)))
    raise NotImplementedError(f"global agg {op}")


def _skew(v: np.ndarray) -> Optional[float]:
    v = v[~np.isnan(v.astype(np.float64))].astype(np.float64)
    if len(v) == 0:
        return None
    m = v.mean()
    s2 = ((v - m) ** 2).mean()
    if s2 == 0:
        return 0.0
    return float(((v - m) ** 3).mean() / s2 ** 1.5)


def _sum_dtype(d: DataType) -> DataType:
    if d.is_signed_integer() or d.is_boolean():
        return DataType.int64()
    if d.is_unsigned_integer():
        return DataType.uint64()
    return d


def _agg_groupby(batch, specs, group_by: List[Expression]):
    from .recordbatch import RecordBatch

    key_series = [batch.eval_expression(e) for e in group_by]
    key_names = [f"__k{i}__" for i in range(len(key_series))]
    cols = {kn: ks.to_arrow() for kn, ks in zip(key_names, key_series)}

    pa_aggs = []
    post: List[Tuple[str, str, DataType, str]] = []  # (pa_out_name, out_name, dtype, op)
    py_specs = []
    for i, (op, child, name, params) in enumerate(specs):
        s = _eval_child(batch, child, i)
        in_name = f"__in{i}__"
        if op == "count":
            mode = params[0] if params else "valid"
            cols[in_name] = s.not_null().to_arrow() if not s.is_pyobject() else \
                pa.array([x is not None for x in s.to_pylist()])
            pa_mode = {"valid": "sum", "all": "count", "null": None}.get(mode, "sum")
            if mode == "null":
                cols[in_name] = pc.invert(cols[in_name])
                pa_mode = "sum"
            pa_aggs.append((in_name, pa_mode))
            post.append((f"{in_name}_{pa_mode}", name, DataType.uint64(), op))
        elif op in _PA_AGGS and not s.is_pyobject():
            cols[in_name] = s.to_arrow()
            pa_op = _PA_AGGS[op]
            opts = None
            if op in ("stddev", "var"):
                opts = pc.VarianceOptions(ddof=0)
            pa_aggs.append((in_name, pa_op, opts) if opts else (in_name, pa_op))
            out_dt = _agg_out_dtype(op, s.datatype())
            post.append((f"{in_name}_{pa_op}", name, out_dt, op))
        else:
            py_specs.append((i, op, s, name, params))
            post.append((None, name, None, op))

    tbl = pa.table(cols)
    g = tbl.group_by(key_names, use_threads=False)
    aggd = g.aggregate(pa_aggs)

    # row indices per group for python-side aggs (NaN-safe group keys)
    def _norm_key(x):
        if isinstance(x, float) and x != x:
            return "__nan__"
        return x

    if py_specs:
        idx_tbl = pa.table({**{k: cols[k] for k in key_names},
                            "__row__": pa.array(np.arange(len(batch)))})
        rows = idx_tbl.group_by(key_names, use_threads=False) \
            .aggregate([("__row__", "list")])
        row_lists = {tuple(_norm_key(rows.column(k)[i].as_py())
                           for k in key_names):
                     rows.column("__row___list")[i].as_py()
                     for i in range(rows.num_rows)}

    out_cols: List[Series] = []
    for ki, (kn, ke) in enumerate(zip(key_names, group_by)):
        out_cols.append(Series.from_arrow(aggd.column(kn), ke.name())
                        .cast(key_series[ki].datatype()))
    for (pa_out, name, out_dt, op) in post:
        if pa_out is not None:
            s_out = Series.from_arrow(aggd.column(pa_out), name)
            if op == "concat":
                pass
            out_cols.append(s_out.cast(out_dt) if out_dt is not None else s_out)
        else:
            i, op2, s, name2, params = next(p for p in py_specs if p[3] == name)
            group_keys = [tuple(_norm_key(aggd.column(k)[r].as_py())
                                for k in key_names)
                          for r in range(aggd.num_rows)]
            vals = []
            for gk in group_keys:
                ridx = row_lists[gk]
                sub = s.take(np.asarray(ridx))
                vals.append(_global_one(op2, sub, name2, params).to_pylist()[0])
            dt = _agg_out_dtype(op2, s.datatype())
            out_cols.append(Series.from_pylist(vals, name2, dtype=dt))
    return RecordBatch.from_series(out_cols)


def _agg_out_dtype(op: str, in_dtype: DataType) -> DataType:
    if op == "sum":
        return _sum_dtype(in_dtype)
    if op in ("mean", "stddev", "var", "skew"):
        return DataType.float64()
    if op in ("count", "count_distinct", "approx_count_distinct"):
        return DataType.uint64()
    if op in ("min", "max", "any_value"):
        return in_dtype
    if op in ("list", "set"):
        return DataType.list(in_dtype)
    if op == "concat":
        return in_dtype if in_dtype.is_list() or in_dtype.is_string() \
            else DataType.list(in_dtype)
    if op in ("bool_and", "bool_or"):
        return DataType.bool()
    if op == "approx_percentiles":
        return None  # set by caller
    return in_dtype


def pivot_recordbatch(batch, group_by: List[Expression], pivot_col: Expression,
                      value_col: Expression, names: List[str]):
    """One row per group, one column per pivot name holding the group's
    value at that pivot (null where the group has none). The input is
    pre-aggregated to one row per (group, pivot), so ``first`` picks that
    row's value. Reference: ``daft_tpu/aggs.py:pivot_recordbatch``
    (``src/daft-recordbatch/src/ops/pivot.rs``)."""
    from .recordbatch import RecordBatch
    keys = [batch.eval_expression(e) for e in group_by]
    pv = batch.eval_expression(pivot_col)
    vv = batch.eval_expression(value_col)
    tbl = pa.table({**{f"__k{i}__": k.to_arrow() for i, k in enumerate(keys)},
                    "__p__": pv.to_arrow(), "__v__": vv.to_arrow()})
    knames = [f"__k{i}__" for i in range(len(keys))]
    g = tbl.group_by(knames + ["__p__"], use_threads=False) \
        .aggregate([("__v__", "first")])
    # the groups in their first-seen order, each with its pivot values
    group_rows: Dict[Tuple, Dict] = {}
    order: List[Tuple] = []
    for r in range(g.num_rows):
        gk = tuple(g.column(k)[r].as_py() for k in knames)
        if gk not in group_rows:
            group_rows[gk] = {}
            order.append(gk)
        group_rows[gk][g.column("__p__")[r].as_py()] = \
            g.column("__v___first")[r].as_py()
    out_cols = []
    for i, (k, e) in enumerate(zip(keys, group_by)):
        out_cols.append(Series.from_pylist([gk[i] for gk in order], e.name(),
                                           dtype=k.datatype()))
    for nm in names:
        key = nm
        if pv.datatype().is_integer():
            try:
                key = int(nm)
            except ValueError:
                key = nm
        out_cols.append(Series.from_pylist(
            [group_rows[gk].get(key) for gk in order], str(nm),
            dtype=vv.datatype()))
    return RecordBatch.from_series(out_cols)
