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
        return _str_fn(fn, kids)
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


def _str_fn(fn, kids) -> Series:
    """``str.contains`` / ``startswith`` / ``endswith`` / ``match`` (a
    regular expression) / ``left``; the second argument is a literal."""
    s = kids[0]
    arr = s.to_arrow().cast(pa.large_string())
    arg = kids[1].to_pylist()[0]
    if fn == "contains":
        out = pc.match_substring(arr, arg)
    elif fn == "startswith":
        out = pc.starts_with(arr, arg)
    elif fn == "endswith":
        out = pc.ends_with(arr, arg)
    elif fn == "match":
        out = pc.match_substring_regex(arr, arg)
    elif fn == "left":
        out = pc.utf8_slice_codeunits(arr, 0, arg)
    else:
        raise NotImplementedError(f"str.{fn}")
    return Series.from_arrow(out, s.name())


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
