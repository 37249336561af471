"""Host implementations of the namespaced scalar functions (``dt.*``,
``float.*`` and the ``str.*`` functions TPC-H reaches), over Arrow C++
compute.

Capability mirror of the reference's ``src/daft-functions-temporal``,
float and utf8 functions; the other function families come with the
slices that need them.
"""

from __future__ import annotations

from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from ..datatype import DataType
from ..schema import Field
from ..series import Series


def eval_function(op: str, e, kids: List[Series], b, out_field: Field) -> Series:
    ns, fn = op.split(".", 1)
    s = kids[0]
    name = s.name()

    if ns == "str":
        return _str_fn(fn, e, kids, b)
    if ns == "dt":
        return _dt_fn(fn, e, kids, b, out_field)
    if ns == "float":
        arr = s.to_arrow()
        if fn == "is_nan":
            return Series.from_arrow(pc.is_nan(arr), name)
        if fn == "is_inf":
            return Series.from_arrow(pc.is_inf(arr), name)
        if fn == "not_nan":
            return Series.from_arrow(pc.invert(pc.is_nan(arr)), name)
        if fn == "fill_nan":
            fill = b(kids[1]).cast(s.datatype())
            mask = pc.fill_null(pc.is_nan(arr), False)
            return Series.from_arrow(
                pc.if_else(mask, fill.to_arrow(), arr), name)
    raise NotImplementedError(f"host function {op}")


def _str_fn(fn, e, kids, b) -> Series:
    """The ported ``str`` functions (reference:
    ``daft_tpu/expressions/fn_host.py:_str_fn``). A pattern, prefix or
    width argument is a literal; ``concat``, ``repeat``, ``substr`` and
    the pads take a column or a literal."""
    s = kids[0]
    name = s.name()
    arr = s.to_arrow().cast(pa.large_string())

    def arg(i):
        return kids[i].to_pylist()[0]

    if fn == "contains":
        return Series.from_arrow(pc.match_substring(arr, arg(1)), name)
    if fn == "startswith":
        return Series.from_arrow(pc.starts_with(arr, arg(1)), name)
    if fn == "endswith":
        return Series.from_arrow(pc.ends_with(arr, arg(1)), name)
    if fn == "match":
        return Series.from_arrow(pc.match_substring_regex(arr, arg(1)), name)
    if fn == "concat":
        other = b(kids[1]).to_arrow().cast(pa.large_string())
        return Series.from_arrow(pc.binary_join_element_wise(
            arr, other, pa.scalar("", type=pa.large_string())), name)
    if fn == "length":
        return Series.from_arrow(pc.utf8_length(arr), name) \
            .cast(DataType.uint64())
    simple = {"lower": pc.utf8_lower, "upper": pc.utf8_upper,
              "lstrip": pc.utf8_ltrim_whitespace,
              "rstrip": pc.utf8_rtrim_whitespace,
              "strip": pc.utf8_trim_whitespace,
              "reverse": pc.utf8_reverse, "capitalize": pc.utf8_capitalize}
    if fn in simple:
        return Series.from_arrow(simple[fn](arr), name)
    if fn == "left":
        return Series.from_arrow(pc.utf8_slice_codeunits(arr, 0, arg(1)),
                                 name)
    if fn == "right":
        n = arg(1)
        return Series.from_pylist(
            [None if v is None else v[-n:] if n else ""
             for v in arr.to_pylist()], name)
    if fn == "repeat":
        return Series.from_pylist(
            [None if v is None or c is None else v * c
             for v, c in zip(arr.to_pylist(), b(kids[1]).to_pylist())], name)
    if fn == "replace":
        fnc = pc.replace_substring_regex if e.params[0] \
            else pc.replace_substring
        return Series.from_arrow(
            fnc(arr, pattern=arg(1), replacement=arg(2)), name)
    if fn == "find":
        return Series.from_arrow(pc.find_substring(arr, arg(1)), name) \
            .cast(DataType.int64())
    if fn in ("rpad", "lpad"):
        out = []
        for v, L, p in zip(arr.to_pylist(), b(kids[1]).to_pylist(),
                           b(kids[2]).to_pylist()):
            if v is None or L is None or p is None:
                out.append(None)
            elif len(v) >= L:
                out.append(v[:L])
            else:
                pad = (p * L)[: L - len(v)]
                out.append(v + pad if fn == "rpad" else pad + v)
        return Series.from_pylist(out, name)
    if fn == "substr":
        starts = b(kids[1]).to_pylist()
        lens = b(kids[2]).to_pylist() if len(kids) > 2 \
            else [None] * len(arr)
        out = []
        for v, st, ln in zip(arr.to_pylist(), starts, lens):
            if v is None or st is None:
                out.append(None)
            else:
                out.append(v[st:] if ln is None else v[st:st + ln])
        return Series.from_pylist(out, name)
    raise NotImplementedError(f"str.{fn}")


def _dt_fn(fn, e, kids, b, out_field) -> Series:
    s = kids[0]
    name = s.name()
    arr = s.to_arrow()
    if fn == "date":
        return Series.from_arrow(arr.cast(pa.date32()), name)
    simple = {"day": pc.day, "hour": pc.hour, "minute": pc.minute,
              "second": pc.second, "millisecond": pc.millisecond,
              "microsecond": pc.microsecond, "nanosecond": pc.nanosecond,
              "month": pc.month, "quarter": pc.quarter, "year": pc.year,
              "day_of_year": pc.day_of_year}
    if fn in simple:
        out = simple[fn](arr)
        return Series.from_arrow(out, name).cast(out_field.dtype)
    if fn == "day_of_week":
        return Series.from_arrow(pc.day_of_week(arr), name).cast(out_field.dtype)
    if fn == "week_of_year":
        return Series.from_arrow(pc.iso_week(arr), name).cast(out_field.dtype)
    if fn == "time":
        return Series.from_arrow(arr.cast(pa.time64("us")), name)
    if fn == "truncate":
        interval = e.params[0]
        qty, unit = interval.split(" ", 1) if " " in interval else ("1", interval)
        unit = unit.rstrip("s")
        mapping = {"day": "day", "hour": "hour", "minute": "minute",
                   "second": "second", "week": "week", "month": "month",
                   "year": "year", "millisecond": "millisecond",
                   "microsecond": "microsecond"}
        out = pc.floor_temporal(arr, multiple=int(qty), unit=mapping[unit])
        return Series.from_arrow(out, name)
    if fn == "to_unix_epoch":
        tu = e.params[0]
        ts = arr.cast(pa.timestamp("us")) if not pa.types.is_timestamp(arr.type) else arr
        us = ts.cast(pa.int64())
        div = {"s": 1_000_000, "ms": 1_000, "us": 1, "ns": 1}[tu]
        if tu == "ns":
            out = pc.multiply(us, 1000)
        else:
            out = pc.divide(us, div)
        return Series.from_arrow(out, name).cast(DataType.int64())
    if fn == "strftime":
        fmt = e.params[0] or ("%Y-%m-%d" if pa.types.is_date(arr.type)
                              else "%Y-%m-%d %H:%M:%S.%f")
        return Series.from_arrow(pc.strftime(arr, format=fmt), name)
    if fn == "total_seconds":
        dur = arr.cast(pa.duration("us")).cast(pa.int64())
        return Series.from_arrow(pc.divide(dur, 1_000_000), name)
    raise NotImplementedError(f"dt.{fn}")
