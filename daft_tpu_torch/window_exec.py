"""Window function execution.

The port's copy of ``daft_tpu/window_exec.py`` (after the four window sinks
of ``src/daft-local-execution/src/sinks/window_*.rs`` and their running
states, ``ops/window_states/``): per-partition-batch evaluation — group
rows by the window's partition keys, order within groups, compute the
rank family / lag / lead / aggregate values (full-frame, running, or an
explicit rows or range frame), scatter back to row order. Vectorized with
numpy over group segments. The one sort goes through
``RecordBatch.argsort``, so the card takes it where the cost model
(``costmodel.argsort_wins``) prices it there.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .datatype import DataType
from .expressions import Expression
from .schema import Field, Schema
from .series import Series


def window_field(e: Expression, schema: Schema) -> Field:
    out_name = e.name()
    w = e._unalias()
    assert w.op == "window"
    base = w.args[0]._unalias()
    if base.op in ("winfn.row_number", "winfn.rank", "winfn.dense_rank"):
        return Field(out_name if e.op == "alias" else base.op[6:],
                     DataType.uint64())
    f = base.to_field(schema)
    return Field(out_name if e.op == "alias" else f.name, f.dtype)


def _expr_of(e: Expression) -> Expression:
    """The window node's inner computation (unaliased)."""
    return e.args[0] if e.op == "window" else e


def run_window(rb, node):
    """Evaluate node.window_exprs over one (already partition-clustered)
    RecordBatch; appends output columns in row order."""
    n = len(rb)
    if n == 0:
        from .recordbatch import RecordBatch
        extra = [Series.empty(e.name(), window_field(e, rb.schema).dtype)
                 for e in node.window_exprs]
        return RecordBatch.from_series(rb.columns() + extra) if rb.columns() \
            else RecordBatch.empty(node.schema())
    schema = rb.schema
    # sort rows by (partition keys, order keys) once; remember inverse perm
    part_keys = list(node.partition_by)
    order_keys = list(node.order_by)
    sort_keys = part_keys + order_keys
    if sort_keys:
        desc = [False] * len(part_keys) + list(node.descending)
        nf = [False] * len(part_keys) + list(node.nulls_first)
        perm = rb.argsort(sort_keys, desc, nf)
    else:
        perm = np.arange(n)
    # pre-clustered input (window after an engine sort on the same keys —
    # the TPC-DS q47/q63/q89 shape): the permutation is the identity, so
    # skip the full-batch Arrow take AND the inverse-scatter on every
    # output column
    if np.array_equal(perm, np.arange(n)):
        inv = None
        sorted_rb = rb
    else:
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        sorted_rb = rb.take(perm)

    # segment ids over partition keys in sorted order
    if part_keys:
        keys = [sorted_rb.eval_expression(e) for e in part_keys]
        seg = _segment_ids(keys)
    else:
        seg = np.zeros(n, dtype=np.int64)
    seg_starts = np.flatnonzero(np.diff(np.concatenate([[-1], seg])))
    starts_per_row = seg_starts[seg]  # first row index of each row's group

    # order-key change flags (peer-run boundaries) in sorted order
    order_vals = None
    if order_keys:
        okeys = [sorted_rb.eval_expression(e) for e in order_keys]
        oseg = _segment_ids(okeys)
        order_change = np.zeros(n, dtype=bool)
        if n:
            order_change[0] = True
            order_change[1:] = np.diff(oseg) != 0
        if not okeys[0].is_pyobject():
            ov = okeys[0].to_numpy()
            if ov.dtype != object and ov.dtype.kind in "iuf":
                order_vals = ov.astype(np.float64)
    else:
        order_change = np.zeros(n, dtype=bool)

    out_cols: List[Series] = []
    for we in node.window_exprs:
        spec_expr = we._unalias()
        assert spec_expr.op == "window"
        inner = spec_expr.args[0]._unalias()
        name = we.name()
        frame = node.frame
        has_order = bool(order_keys)
        out = _eval_window_fn(inner, sorted_rb, seg, starts_per_row, n,
                              has_order, frame, name, order_change, order_vals)
        out_cols.append((out if inv is None else out.take(inv)).rename(name))
    from .recordbatch import RecordBatch
    return RecordBatch.from_series(rb.columns() + out_cols)


def _segment_ids(keys: List[Series]) -> np.ndarray:
    n = len(keys[0])
    change = np.zeros(n, dtype=bool)
    change[0] = True
    for k in keys:
        vals = k.to_numpy()
        if vals.dtype == object:
            cur = np.array([v != w for v, w in zip(vals[1:], vals[:-1])],
                           dtype=bool)
        else:
            a, b = vals[1:], vals[:-1]
            with np.errstate(invalid="ignore"):
                cur = a != b
                isnan = (a != a) & (b != b)
                cur = np.where(isnan, False, cur)
        change[1:] |= cur
        nulls = np.asarray(k.is_null().to_numpy())
        change[1:] |= nulls[1:] != nulls[:-1]
    return np.cumsum(change) - 1


def _eval_window_fn(inner: Expression, sorted_rb, seg, starts_per_row, n,
                    has_order, frame, name, order_change,
                    order_vals=None) -> Series:
    import pyarrow as pa
    pos_in_group = np.arange(n) - starts_per_row

    if inner.op == "winfn.row_number":
        return Series.from_arrow(pa.array((pos_in_group + 1).astype(np.uint64)),
                                 name)
    if inner.op in ("winfn.rank", "winfn.dense_rank"):
        new_run = order_change | (pos_in_group == 0)
        if inner.op == "winfn.rank":
            # rank = 1-based position of the first row of the peer run
            rank = _segment_carry(pos_in_group + 1, new_run)
            return Series.from_arrow(pa.array(rank.astype(np.uint64)), name)
        flags = new_run.astype(np.int64)
        cums = np.cumsum(flags)
        seg_firsts = np.flatnonzero(pos_in_group == 0)
        base_vals = cums[seg_firsts] - 1
        dense = cums - base_vals[seg]
        return Series.from_arrow(pa.array(dense.astype(np.uint64)), name)
    if inner.op in ("winfn.lag", "winfn.lead"):
        offset = inner.params[0]
        child = sorted_rb.eval_expression(inner.args[0])
        default = None
        if len(inner.args) > 1:
            default = sorted_rb.eval_expression(inner.args[1])
        shift = offset if inner.op == "winfn.lag" else -offset
        idx = np.arange(n) - shift
        valid = (idx >= 0) & (idx < n)
        if len(seg):
            valid &= np.where((idx >= 0) & (idx < n),
                              seg[np.clip(idx, 0, n - 1)] == seg, False)
        import pyarrow as pa2
        ia = pa2.array(np.clip(idx, 0, max(n - 1, 0)), mask=~valid)
        out = child.to_arrow().take(ia) if not child.is_pyobject() else None
        if out is None:
            vals = child.to_pylist()
            out_l = [vals[i] if v else None for i, v in zip(np.clip(idx, 0, n - 1), valid)]
            s = Series.from_pylist(out_l, name, dtype=child.datatype())
        else:
            s = Series(name, child.datatype(), arrow=out)
        if default is not None:
            fill = default.broadcast(n) if len(default) == 1 else default
            import pyarrow.compute as pc
            s = Series(name, s.datatype(), arrow=pc.if_else(
                pa.array(valid), s.to_arrow(),
                fill.cast(s.datatype()).to_arrow()))
        return s
    if inner.op.startswith("agg."):
        return _eval_window_agg(inner, sorted_rb, seg, starts_per_row, n,
                                has_order, frame, name, order_vals)
    raise NotImplementedError(f"window function {inner.op}")


def _segment_carry(values: np.ndarray, flags: np.ndarray) -> np.ndarray:
    """For each row, the value at the last index where flags was True."""
    idx = np.where(flags, np.arange(len(values)), 0)
    idx = np.maximum.accumulate(idx)
    return values[idx]


def _eval_window_agg(inner, sorted_rb, seg, starts_per_row, n, has_order,
                     frame, name, order_vals=None) -> Series:
    import pyarrow as pa
    op = inner.op[4:]
    child = inner.args[0] if inner.args else None
    vals_s = sorted_rb.eval_expression(child) if child is not None else None
    out_dtype = inner.to_field(sorted_rb.schema).dtype

    if vals_s is not None and not vals_s.is_pyobject():
        v = vals_s.to_numpy()
        valid = np.asarray(vals_s.not_null().to_numpy())
        if v.dtype == object or v.dtype.kind in "mM":
            v = None
    else:
        v = None
    if v is None:
        # generic python fallback per group
        return _py_window_agg(inner, sorted_rb, seg, n, has_order, frame, name,
                              out_dtype, vals_s)

    vf = np.where(valid, v, 0).astype(np.float64)
    ones = valid.astype(np.float64)
    nseg = int(seg[-1]) + 1 if n else 0

    if frame is not None:
        return _frame_agg(op, vf, v, valid, seg, starts_per_row, n,
                          frame, name, out_dtype, order_vals)

    if has_order and op in ("sum", "mean", "count", "min", "max"):
        # running aggregate (default SQL frame: unbounded preceding→current)
        csum = _seg_cumsum(vf, seg)
        ccnt = _seg_cumsum(ones, seg)
        if op == "count":
            out = ccnt
        elif op == "sum":
            out = csum
        elif op == "mean":
            with np.errstate(invalid="ignore"):
                out = csum / np.where(ccnt == 0, np.nan, ccnt)
        elif op in ("min", "max"):
            x = np.where(valid, v.astype(np.float64),
                         np.inf if op == "min" else -np.inf)
            out = _seg_cummin(x, seg) if op == "min" else -_seg_cummin(-x, seg)
            out = np.where(ccnt > 0, out, np.nan)
        mask = (ccnt == 0) if op != "count" else np.zeros(n, dtype=bool)
        return _np_to_series(out, mask, name, out_dtype)

    # full-partition aggregate
    sums = np.bincount(seg, weights=vf, minlength=nseg)
    cnts = np.bincount(seg, weights=ones, minlength=nseg)
    if op == "count":
        out = cnts[seg]
        return _np_to_series(out, np.zeros(n, dtype=bool), name, out_dtype)
    if op == "sum":
        out = sums[seg]
        return _np_to_series(out, cnts[seg] == 0, name, out_dtype)
    if op == "mean":
        with np.errstate(invalid="ignore"):
            m = sums / np.where(cnts == 0, np.nan, cnts)
        return _np_to_series(m[seg], cnts[seg] == 0, name, out_dtype)
    if op in ("min", "max"):
        x = np.where(valid, v.astype(np.float64),
                     np.inf if op == "min" else -np.inf)
        red = np.full(nseg, np.inf if op == "min" else -np.inf)
        np.minimum.at(red, seg, x) if op == "min" else \
            np.maximum.at(red, seg, x)
        return _np_to_series(red[seg], cnts[seg] == 0, name, out_dtype)
    if op in ("stddev", "var"):
        s2 = np.bincount(seg, weights=vf * vf, minlength=nseg)
        with np.errstate(invalid="ignore"):
            mean = sums / np.where(cnts == 0, np.nan, cnts)
            var = s2 / np.where(cnts == 0, np.nan, cnts) - mean * mean
            var = np.maximum(var, 0)
            out = np.sqrt(var) if op == "stddev" else var
        return _np_to_series(out[seg], cnts[seg] == 0, name, out_dtype)
    return _py_window_agg(inner, sorted_rb, seg, n, has_order, frame, name,
                          out_dtype, vals_s)


def _frame_agg(op, vf, v, valid, seg, starts_per_row, n, frame, name,
               out_dtype, order_vals=None):
    kind, start, end = frame[0], frame[1], frame[2]
    min_periods = frame[3] if len(frame) > 3 else 1
    # end index (exclusive) of each row's segment
    last = np.flatnonzero(np.diff(np.concatenate([seg, [-2]])))
    seg_end_per_seg = last + 1
    seg_ends = seg_end_per_seg[seg]
    i = np.arange(n)
    if kind == "rows":
        lo = starts_per_row if start == "unbounded_preceding" else \
            np.clip(i + int(start), starts_per_row, seg_ends)
        hi = seg_ends if end == "unbounded_following" else \
            np.clip(i + int(end) + 1, starts_per_row, seg_ends)
    else:  # range frame over the first (numeric) order key
        if order_vals is None:
            raise NotImplementedError(
                "range_between requires one numeric order_by key")
        lo = np.empty(n, dtype=np.int64)
        hi = np.empty(n, dtype=np.int64)
        for s_start in np.flatnonzero(
                np.diff(np.concatenate([[-1], seg]))):
            s_end = seg_end_per_seg[seg[s_start]]
            block = order_vals[s_start:s_end]
            cur = block
            if start == "unbounded_preceding":
                lo[s_start:s_end] = s_start
            else:
                lo[s_start:s_end] = s_start + np.searchsorted(
                    block, cur + float(start), side="left")
            if end == "unbounded_following":
                hi[s_start:s_end] = s_end
            else:
                hi[s_start:s_end] = s_start + np.searchsorted(
                    block, cur + float(end), side="right")
    hi = np.maximum(hi, lo)
    cs = np.concatenate([[0.0], np.cumsum(vf)])
    cn = np.concatenate([[0.0], np.cumsum(valid.astype(np.float64))])
    s = cs[hi] - cs[lo]
    c = cn[hi] - cn[lo]
    null_out = c < max(min_periods, 1)
    if op == "count":
        return _np_to_series(c, null_out & (min_periods > 1), name, out_dtype)
    if op == "sum":
        return _np_to_series(s, null_out, name, out_dtype)
    if op == "mean":
        with np.errstate(invalid="ignore"):
            return _np_to_series(s / np.where(c == 0, np.nan, c), null_out,
                                 name, out_dtype)
    if op in ("min", "max"):
        # O(n·w) fallback for min/max frames
        x = np.where(valid, v.astype(np.float64),
                     np.inf if op == "min" else -np.inf)
        out = np.empty(n)
        for j in range(n):
            w = x[lo[j]:hi[j]]
            out[j] = (w.min() if op == "min" else w.max()) if len(w) else np.nan
        return _np_to_series(out, null_out, name, out_dtype)
    raise NotImplementedError(f"frame window agg {op}")


def _py_window_agg(inner, sorted_rb, seg, n, has_order, frame, name,
                   out_dtype, vals_s):
    from .aggs import _global_one
    out = []
    nseg = int(seg[-1]) + 1 if n else 0
    op = inner.op[4:]
    for g in range(nseg):
        idx = np.flatnonzero(seg == g)
        sub = vals_s.take(idx) if vals_s is not None else None
        r = _global_one(op, sub, name, inner.params).to_pylist()[0]
        out.extend([r] * len(idx))
    return Series.from_pylist(out, name, dtype=out_dtype)


def _seg_cumsum(x: np.ndarray, seg: np.ndarray) -> np.ndarray:
    cs = np.cumsum(x)
    seg_firsts = np.flatnonzero(np.diff(np.concatenate([[-1], seg])))
    base = np.concatenate([[0.0], cs[seg_firsts[1:] - 1]]) if len(seg_firsts) \
        else np.zeros(0)
    return cs - base[seg]


def _seg_cummin(x: np.ndarray, seg: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    seg_firsts = np.flatnonzero(np.diff(np.concatenate([[-1], seg])))
    for si, start in enumerate(seg_firsts):
        end = seg_firsts[si + 1] if si + 1 < len(seg_firsts) else len(x)
        out[start:end] = np.minimum.accumulate(x[start:end])
    return out


def _np_to_series(out: np.ndarray, null_mask: np.ndarray, name: str,
                  dtype: DataType) -> Series:
    import pyarrow as pa
    arr = pa.array(out, mask=null_mask | np.isnan(out)
                   if out.dtype.kind == "f" and not dtype.is_floating()
                   else null_mask)
    s = Series.from_arrow(arr, name)
    return s.cast(dtype)
