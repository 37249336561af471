"""Host expression evaluation over Arrow C++ compute.

This is the complete-coverage tier; the torch device tier
(``daft_tpu_torch.device.compiler``) compiles the device-representable
subset inside fused fragments.
Reference capability: ``eval_expression_list``
(``src/daft-recordbatch/src/lib.rs:755``).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..datatype import DataType
from ..schema import Schema
from ..series import Series
from .expressions import Expression


def eval_expression(e: Expression, columns: Dict[str, Series], length: int) -> Series:
    """Evaluate ``e`` against named input columns; result broadcast to ``length``."""
    s = _eval(e, columns, length)
    out_name = e.name()
    if s.name() != out_name:
        s = s.rename(out_name)
    if len(s) == 1 and length != 1:
        s = s.broadcast(length)
    return s


def _arrow(s: Series) -> pa.Array:
    return s.to_arrow()


def _bin_numeric(op, l: Series, r: Series, out_dtype: DataType) -> Series:
    if len(l) == 1 and len(r) != 1:
        l = l.broadcast(len(r))
    if len(r) == 1 and len(l) != 1:
        r = r.broadcast(len(l))
    la, ra = l.to_arrow(), r.to_arrow()
    fn = {"add": pc.add, "sub": pc.subtract, "mul": pc.multiply,
          "div": pc.divide, "pow": pc.power}[op]
    if op == "div":
        la = la.cast(pa.float64())
        ra = ra.cast(pa.float64())
    out = fn(la, ra)
    res = Series.from_arrow(out, l.name())
    return res.cast(out_dtype) if res.datatype() != out_dtype else res


_CMP = {"lt": pc.less, "le": pc.less_equal, "gt": pc.greater,
        "ge": pc.greater_equal, "eq": pc.equal, "neq": pc.not_equal}


def _interval_shift(s: Series, months: int, days: int, nanos: int) -> Series:
    """Shift a date/timestamp series by a calendar interval. Month shifts
    clamp to month length (SQL calendar arithmetic); day/nano-only shifts
    over columns run vectorized — the interpreted loop only survives for
    the month-shift-over-column case (rare; literals are 1-row)."""
    import calendar
    import datetime as _dt
    if months == 0 and len(s) > 1:
        arr = s.to_arrow()
        td = pa.scalar(_dt.timedelta(days=days, microseconds=nanos // 1000))
        if pa.types.is_date32(arr.type) or pa.types.is_date64(arr.type):
            out = pc.add(arr.cast(pa.timestamp("us")), td).cast(arr.type)
        else:
            out = pc.add(arr, td)
        return Series.from_arrow(out, s.name())
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        if months:
            y = v.year + (v.month - 1 + months) // 12
            m = (v.month - 1 + months) % 12 + 1
            d = min(v.day, calendar.monthrange(y, m)[1])
            v = v.replace(year=y, month=m, day=d)
        if days:
            v = v + _dt.timedelta(days=days)
        if nanos:
            v = v + _dt.timedelta(microseconds=nanos // 1000)
        out.append(v)
    return Series.from_pylist(out, s.name(), dtype=s.datatype())


def _eval(e: Expression, cols: Dict[str, Series], n: int) -> Series:
    op = e.op

    if op == "col":
        name = e.params[0]
        if name not in cols:
            raise ValueError(f"unresolved column {name!r}; "
                             f"available: {list(cols.keys())}")
        return cols[name]
    if op == "lit":
        v = e.params[0]
        if isinstance(v, Series):
            return v
        dt = DataType.null() if v is None else None
        return Series.from_pylist([v], "literal", dtype=dt)
    if op == "alias":
        return _eval(e.args[0], cols, n).rename(e.params[0])
    if op == "cast":
        return _eval(e.args[0], cols, n).cast(e.params[0])
    if op in ("add", "sub") and any(a.op == "lit_interval" for a in e.args):
        # date/timestamp ± INTERVAL: calendar-aware shift (months clamp to
        # month length per SQL, days/nanos are exact)
        iv = next(a for a in e.args if a.op == "lit_interval")
        other = next(a for a in e.args if a.op != "lit_interval")
        base = _eval(other, cols, n)
        months, days, nanos = iv.params
        sign = 1 if op == "add" else -1
        return _interval_shift(base, sign * months, sign * days,
                               sign * nanos)

    # evaluate children
    kids = [_eval(a, cols, n) for a in e.args]
    # broadcast scalars to the non-scalar operand length (0-length included)
    max_len = next((len(k) for k in kids if len(k) != 1), 1)

    def b(s: Series) -> Series:
        return s.broadcast(max_len) if len(s) == 1 and max_len != 1 else s

    schema = Schema([c.field() for c in cols.values()])
    out_field = e.to_field(schema)

    if op in ("add", "sub", "mul", "div", "pow"):
        l, r = kids
        if op == "add" and l.datatype().is_string():
            return Series.from_arrow(
                pc.binary_join_element_wise(
                    b(l).to_arrow().cast(pa.large_string()),
                    b(r).to_arrow().cast(pa.large_string()),
                    pa.scalar("", type=pa.large_string())), l.name())
        if l.datatype().is_temporal() or r.datatype().is_temporal():
            return _temporal_arith(op, b(l), b(r), out_field.dtype)
        return _bin_numeric(op, l, r, out_field.dtype)
    if op == "floordiv":
        l, r = b(kids[0]), b(kids[1])
        la, ra = l.to_arrow().cast(pa.float64()), r.to_arrow().cast(pa.float64())
        out = pc.floor(pc.divide(la, ra))
        return Series.from_arrow(out, l.name()).cast(out_field.dtype)
    if op == "mod":
        l, r = b(kids[0]), b(kids[1])
        lv, rv = l.to_numpy(), r.to_numpy()
        valid = ~(pd_isnull(lv) | pd_isnull(rv))
        with np.errstate(all="ignore"):
            res = np.where(valid, np.mod(np.nan_to_num(lv.astype(np.float64)),
                                         np.where(rv == 0, 1, rv).astype(np.float64)),
                           np.nan)
        arr = pa.array(res, from_pandas=True)
        return Series.from_arrow(arr, l.name()).cast(out_field.dtype)

    if op in _CMP:
        l, r = b(kids[0]), b(kids[1])
        la, ra = l.to_arrow(), r.to_arrow()
        if la.type != ra.type:
            st = DataType.from_arrow_type(la.type) if not l.datatype().is_null() \
                else r.datatype()
            try:
                from .typing import supertype
                stt = supertype(l.datatype(), r.datatype()).to_arrow()
                la, ra = la.cast(stt), ra.cast(stt)
            except Exception:
                pass
        return Series.from_arrow(_CMP[op](la, ra), l.name())
    if op == "eq_null_safe":
        l, r = b(kids[0]), b(kids[1])
        eqv = pc.equal(l.to_arrow(), r.to_arrow())
        both_null = pc.and_(pc.is_null(l.to_arrow()), pc.is_null(r.to_arrow()))
        either_null = pc.or_(pc.is_null(l.to_arrow()), pc.is_null(r.to_arrow()))
        filled = pc.fill_null(eqv, False)
        out = pc.if_else(either_null, both_null, filled)
        return Series.from_arrow(out, l.name())

    if op in ("and", "or", "xor"):
        l, r = b(kids[0]), b(kids[1])
        if l.datatype().is_integer():
            fn = {"and": pc.bit_wise_and, "or": pc.bit_wise_or,
                  "xor": pc.bit_wise_xor}[op]
            return Series.from_arrow(fn(l.to_arrow(), r.to_arrow()), l.name())
        fn = {"and": pc.and_kleene, "or": pc.or_kleene, "xor": pc.xor}[op]
        return Series.from_arrow(fn(l.to_arrow().cast(pa.bool_()),
                                    r.to_arrow().cast(pa.bool_())), l.name())
    if op == "not":
        return Series.from_arrow(pc.invert(kids[0].to_arrow().cast(pa.bool_())),
                                 kids[0].name())
    if op == "negate":
        return Series.from_arrow(pc.negate(kids[0].to_arrow()), kids[0].name())
    if op == "abs":
        return Series.from_arrow(pc.abs(kids[0].to_arrow()), kids[0].name())
    if op == "is_null":
        return kids[0].is_null()
    if op == "not_null":
        return kids[0].not_null()
    if op == "fill_null":
        l, r = kids
        if len(r) == 1:
            return Series.from_arrow(
                pc.fill_null(l.to_arrow(), r.to_arrow()[0]), l.name()) \
                if not l.datatype().is_null() else b(r).rename(l.name())
        return Series.from_arrow(
            pc.if_else(pc.is_valid(l.to_arrow()), l.to_arrow(),
                       b(r).to_arrow().cast(l.to_arrow().type)), l.name())
    if op == "is_in":
        l = kids[0]
        items = kids[1:]
        if len(items) == 1 and items[0].datatype().is_list():
            vals = items[0].to_pylist()[0]
            value_set = pa.array(vals)
        else:
            value_set = pa.array([i.to_pylist()[0] for i in items])
        try:
            value_set = value_set.cast(l.to_arrow().type)
        except Exception:
            pass
        raw = pc.is_in(l.to_arrow(), value_set=value_set)
        out = pc.if_else(pc.is_valid(l.to_arrow()), raw,
                         pa.nulls(len(l), type=pa.bool_()))
        return Series.from_arrow(out, l.name())
    if op == "between":
        v, lo, hi = b(kids[0]), b(kids[1]), b(kids[2])
        out = pc.and_(pc.greater_equal(v.to_arrow(), lo.to_arrow()),
                      pc.less_equal(v.to_arrow(), hi.to_arrow()))
        return Series.from_arrow(out, v.name())
    if op == "if_else":
        pred, t, f = b(kids[0]), b(kids[1]), b(kids[2])
        if t.is_pyobject() or f.is_pyobject():
            pm = pred.to_pylist()
            tv, fv = t.to_pylist(), f.to_pylist()
            return Series.from_pyobjects(
                [tv[i] if pm[i] else (fv[i] if pm[i] is not None else None)
                 for i in range(max_len)], t.name())
        target = out_field.dtype.to_arrow()
        return Series.from_arrow(
            pc.if_else(pred.to_arrow(),
                       t.to_arrow().cast(target), f.to_arrow().cast(target)),
            t.name())
    if op == "coalesce":
        cur = b(kids[0]).cast(out_field.dtype)
        for k in kids[1:]:
            ka = b(k).cast(out_field.dtype)
            cur = Series.from_arrow(
                pc.if_else(pc.is_valid(cur.to_arrow()), cur.to_arrow(),
                           ka.to_arrow()), cur.name())
        return cur

    if op in ("ceil", "floor", "sign"):
        fn = {"ceil": pc.ceil, "floor": pc.floor, "sign": pc.sign}[op]
        out = fn(kids[0].to_arrow())
        return Series.from_arrow(out, kids[0].name()).cast(out_field.dtype)
    if op == "round":
        return Series.from_arrow(
            pc.round(kids[0].to_arrow(), ndigits=e.params[0]),
            kids[0].name()).cast(out_field.dtype)
    if op == "clip":
        v = b(kids[0]).to_numpy().astype(np.float64)
        lo = kids[1].to_pylist()[0] if len(kids) > 1 else None
        hi = kids[2].to_pylist()[0] if len(kids) > 2 else None
        out = np.clip(v, -np.inf if lo is None else lo, np.inf if hi is None else hi)
        return Series.from_arrow(pa.array(out, from_pandas=True),
                                 kids[0].name()).cast(out_field.dtype)
    if op in ("sqrt", "cbrt", "exp", "log2", "log10", "ln", "sin", "cos", "tan",
              "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "degrees",
              "radians", "log", "arcsinh", "arccosh", "arctanh", "cot", "csc",
              "sec", "expm1", "log1p"):
        v = kids[0].to_numpy().astype(np.float64)
        npfn = {"sqrt": np.sqrt, "cbrt": np.cbrt, "exp": np.exp, "log2": np.log2,
                "log10": np.log10, "ln": np.log, "sin": np.sin, "cos": np.cos,
                "tan": np.tan, "arcsin": np.arcsin, "arccos": np.arccos,
                "arctan": np.arctan, "sinh": np.sinh, "cosh": np.cosh,
                "tanh": np.tanh, "degrees": np.degrees, "radians": np.radians,
                "arcsinh": np.arcsinh, "arccosh": np.arccosh,
                "arctanh": np.arctanh, "expm1": np.expm1, "log1p": np.log1p,
                "cot": lambda x: 1.0 / np.tan(x),
                "csc": lambda x: 1.0 / np.sin(x),
                "sec": lambda x: 1.0 / np.cos(x)}
        with np.errstate(all="ignore"):
            if op == "log":
                out = np.log(v) / math.log(e.params[0])
            else:
                out = npfn[op](v)
        return Series.from_arrow(pa.array(out, from_pandas=True), kids[0].name())
    if op == "arctan2":
        l, r = b(kids[0]), b(kids[1])
        out = np.arctan2(l.to_numpy().astype(np.float64),
                         r.to_numpy().astype(np.float64))
        return Series.from_arrow(pa.array(out), l.name())
    if op in ("shift_left", "shift_right"):
        fn = pc.shift_left if op == "shift_left" else pc.shift_right
        return Series.from_arrow(fn(b(kids[0]).to_arrow(), b(kids[1]).to_arrow()),
                                 kids[0].name())
    if op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        fn = {"bitwise_and": pc.bit_wise_and, "bitwise_or": pc.bit_wise_or,
              "bitwise_xor": pc.bit_wise_xor}[op]
        return Series.from_arrow(fn(b(kids[0]).to_arrow(), b(kids[1]).to_arrow()),
                                 kids[0].name())
    if "." in op:
        from .fn_host import eval_function
        return eval_function(op, e, kids, b, out_field)

    raise NotImplementedError(f"host eval for expression op {op!r}")


def pd_isnull(v: np.ndarray) -> np.ndarray:
    if v.dtype == object:
        return np.array([x is None for x in v])
    if v.dtype.kind == "f":
        return np.isnan(v)
    return np.zeros(len(v), dtype=bool)


def _temporal_arith(op: str, l: Series, r: Series, out_dtype: DataType) -> Series:
    la, ra = l.to_arrow(), r.to_arrow()
    if op == "add":
        return Series.from_arrow(pc.add(la, ra), l.name()).cast(out_dtype)
    if op == "sub":
        out = pc.subtract(la, ra)
        return Series.from_arrow(out, l.name()).cast(out_dtype)
    raise NotImplementedError(f"temporal {op}")
