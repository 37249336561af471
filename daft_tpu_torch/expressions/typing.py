"""Expression type inference: Expr × Schema → Field.

Mirrors the reference's ``Expr::to_field`` (``src/daft-dsl/src/expr/mod.rs``)
and its type-promotion matrix (``daft-schema`` ``try_get_supertype``).
"""

from __future__ import annotations

import datetime
from typing import Optional

from ..datatype import DataType, TimeUnit
from ..schema import Field, Schema

_INT_ORDER = ["int8", "int16", "int32", "int64"]
_UINT_ORDER = ["uint8", "uint16", "uint32", "uint64"]
_FLOAT_ORDER = ["float32", "float64"]


def supertype(a: DataType, b: DataType) -> DataType:
    """Smallest common supertype for binary ops (reference: try_get_supertype)."""
    if a == b:
        return a
    if a.is_null():
        return b
    if b.is_null():
        return a
    ks, ko = a.kind, b.kind
    if a.is_numeric() and b.is_numeric():
        if a.is_decimal() or b.is_decimal():
            return DataType.float64()
        if a.is_floating() or b.is_floating():
            if "float64" in (ks, ko):
                return DataType.float64()
            # int64/uint64 + float32 -> float64 to preserve magnitude
            for t in (a, b):
                if t.is_integer() and t.kind in ("int64", "uint64", "int32", "uint32"):
                    return DataType.float64()
            return DataType.float32()
        if a.is_signed_integer() and b.is_signed_integer():
            return DataType(
                a._kind if _INT_ORDER.index(ks) >= _INT_ORDER.index(ko) else b._kind)
        if a.is_unsigned_integer() and b.is_unsigned_integer():
            return DataType(
                a._kind if _UINT_ORDER.index(ks) >= _UINT_ORDER.index(ko) else b._kind)
        # mixed signedness: smallest signed type that holds both, capped at int64
        u, s = (a, b) if a.is_unsigned_integer() else (b, a)
        idx = max(_UINT_ORDER.index(u.kind) + 1, _INT_ORDER.index(s.kind))
        return [DataType.int8, DataType.int16, DataType.int32,
                DataType.int64][min(idx, 3)]()
    if a.is_boolean() and b.is_numeric():
        return b
    if b.is_boolean() and a.is_numeric():
        return a
    if (a.is_string() and b.is_numeric()) or (b.is_string() and a.is_numeric()):
        return DataType.string()
    if a.is_temporal() and b.is_temporal():
        if "timestamp" in (ks, ko):
            ts = a if ks == "timestamp" else b
            return ts
        return a
    raise TypeError(f"no supertype for {a!r} and {b!r}")


def _lit_field(value) -> Field:
    if value is None:
        return Field("literal", DataType.null())
    if isinstance(value, bool):
        return Field("literal", DataType.bool())
    if isinstance(value, int):
        return Field("literal", DataType.int32()
                     if -(2**31) <= value < 2**31 else DataType.int64())
    if isinstance(value, float):
        return Field("literal", DataType.float64())
    if isinstance(value, str):
        return Field("literal", DataType.string())
    if isinstance(value, bytes):
        return Field("literal", DataType.binary())
    if isinstance(value, datetime.datetime):
        return Field("literal", DataType.timestamp(TimeUnit.us))
    if isinstance(value, datetime.date):
        return Field("literal", DataType.date())
    if isinstance(value, datetime.time):
        return Field("literal", DataType.time(TimeUnit.us))
    if isinstance(value, datetime.timedelta):
        return Field("literal", DataType.duration(TimeUnit.us))
    from ..series import Series
    if isinstance(value, Series):
        return Field("literal", value.datatype())
    try:
        return Field("literal", DataType.infer_from_pylist([value]))
    except Exception:
        return Field("literal", DataType.python())


def infer_field(e, schema: Schema) -> Field:
    op = e.op
    if op == "col":
        name = e.params[0]
        if name not in schema:
            raise ValueError(
                f"unresolved column {name!r}; available: {schema.column_names}")
        return schema[name]
    if op == "outer_col":
        raise ValueError(
            f"outer_col({e.params[0]!r}): a correlated outer-scope "
            "reference escaped its subquery's WHERE clause — only "
            "equality correlation in WHERE is supported")
    if op in ("subquery", "in_subquery", "exists"):
        raise ValueError(
            f"{op} expression must be unnested into a join before execution "
            "(logical/subquery.py apply_where); it reached evaluation "
            "unsupported — e.g. a subquery in a SELECT list or HAVING")
    if op == "lit":
        return _lit_field(e.params[0])
    if op == "lit_interval":
        return Field("literal", DataType.interval())
    if op == "alias":
        inner = infer_field(e.args[0], schema)
        return Field(e.params[0], inner.dtype)
    if op == "cast":
        inner = infer_field(e.args[0], schema)
        return Field(inner.name, e.params[0])

    child_fields = [infer_field(a, schema) for a in e.args]
    name = child_fields[0].name if child_fields else op

    if op in ("add", "sub", "mul", "div", "floordiv", "mod", "pow"):
        l, r = child_fields[0].dtype, child_fields[1].dtype
        if op == "add" and l.is_string() and r.is_string():
            return Field(name, DataType.string())
        # temporal arithmetic
        if l.is_temporal() or r.is_temporal():
            return Field(name, _temporal_arith(op, l, r))
        st = supertype(l, r)
        if op == "div":
            st = DataType.float64() if st.kind == "float64" or \
                (st.is_integer() and st.kind in ("int64", "uint64")) else \
                (st if st.is_floating() else DataType.float64())
        return Field(name, st)
    if op in ("lt", "le", "gt", "ge", "eq", "neq", "eq_null_safe", "is_in",
              "between", "and", "or", "xor", "not", "is_null", "not_null"):
        if op in ("and", "or", "xor") and child_fields[0].dtype.is_integer():
            return Field(name, supertype(child_fields[0].dtype, child_fields[1].dtype))
        return Field(name, DataType.bool())
    if op in ("negate", "abs"):
        return Field(name, child_fields[0].dtype)
    if op in ("ceil", "floor", "round", "clip", "sign"):
        return Field(name, child_fields[0].dtype)
    if op in ("sqrt", "cbrt", "exp", "log", "log2", "log10", "ln", "sin", "cos",
              "tan", "arcsin", "arccos", "arctan", "arctan2", "sinh", "cosh",
              "tanh", "degrees", "radians", "arcsinh", "arccosh", "arctanh",
              "cot", "csc", "sec", "expm1", "log1p"):
        d = child_fields[0].dtype
        return Field(name, DataType.float32() if d.kind == "float32"
                     else DataType.float64())
    if op in ("shift_left", "shift_right", "bitwise_and", "bitwise_or",
              "bitwise_xor"):
        return Field(name, child_fields[0].dtype)
    if op in ("deserialize", "try_deserialize"):
        return Field(name, e.params[1])
    if op == "fill_null":
        base = child_fields[0].dtype
        if base.is_null():
            return Field(name, child_fields[1].dtype)
        return Field(name, base)
    if op == "if_else":
        if child_fields[1].dtype.is_null():
            return Field(child_fields[1].name, child_fields[2].dtype)
        if child_fields[2].dtype.is_null():
            return Field(child_fields[1].name, child_fields[1].dtype)
        return Field(child_fields[1].name,
                     supertype(child_fields[1].dtype, child_fields[2].dtype))
    if op == "coalesce":
        dt = child_fields[0].dtype
        for f in child_fields[1:]:
            dt = f.dtype if dt.is_null() else supertype(dt, f.dtype)
        return Field(name, dt)
    if op == "hash":
        return Field(name, DataType.uint64())
    if op == "udf":
        u = e.params[0]
        nm = child_fields[0].name if child_fields else u.name
        return Field(nm, u.return_dtype)
    if op == "window":
        from ..window_exec import window_field
        return window_field(e, schema)
    if op in ("winfn.row_number", "winfn.rank", "winfn.dense_rank"):
        return Field(op[6:], DataType.uint64())
    if op in ("winfn.lag", "winfn.lead"):
        return Field(child_fields[0].name, child_fields[0].dtype)
    if op == "minhash":
        return Field(name, DataType.fixed_size_list(DataType.uint32(), e.params[0]))
    if op == "py_apply":
        return Field(name, e.params[1])
    if op == "explode":
        d = child_fields[0].dtype
        return Field(name, d.inner if d.is_list() else d)
    if op == "list":
        dt = DataType.null()
        for f in child_fields:
            dt = f.dtype if dt.is_null() else supertype(dt, f.dtype)
        return Field("list", DataType.list(dt))
    if op == "struct_make":
        return Field("struct", DataType.struct(
            {f.name: f.dtype for f in child_fields}))

    # aggregations -------------------------------------------------------
    if op.startswith("agg."):
        return _agg_field(op[4:], e, child_fields[0] if child_fields else None)

    # namespaced functions ----------------------------------------------
    if "." in op:
        return _function_field(op, e, child_fields, schema)

    raise NotImplementedError(f"type inference for {op}")


def _temporal_arith(op: str, l: DataType, r: DataType) -> DataType:
    if op == "sub":
        if l.kind == "date" and r.kind == "date":
            return DataType.duration(TimeUnit.s)
        if l.kind == "timestamp" and r.kind == "timestamp":
            return DataType.duration(l.timeunit)
        if l.is_temporal() and r.kind == "duration":
            return l
        if l.kind == "date" and r.is_integer():
            return l
    if op == "add":
        if l.kind == "duration" and r.is_temporal():
            return r
        if l.is_temporal() and r.kind == "duration":
            return l
        if l.kind == "date" and r.is_integer():
            return l
        if l.is_integer() and r.kind == "date":
            return r
        if l.kind == "duration" and r.kind == "duration":
            return l
    if l.kind == "interval" or r.kind == "interval":
        return l if r.kind == "interval" else r
    raise TypeError(f"invalid temporal arithmetic: {l!r} {op} {r!r}")


def _agg_field(agg: str, e, f: Optional[Field]) -> Field:
    if agg == "count":
        return Field(f.name if f else "count", DataType.uint64())
    if agg in ("count_distinct", "approx_count_distinct"):
        return Field(f.name, DataType.uint64())
    if agg == "sum":
        d = f.dtype
        if d.is_signed_integer() or d.is_boolean():
            return Field(f.name, DataType.int64())
        if d.is_unsigned_integer():
            return Field(f.name, DataType.uint64())
        return Field(f.name, d)
    if agg in ("mean", "stddev", "var", "skew"):
        return Field(f.name, DataType.float64())
    if agg in ("min", "max", "any_value"):
        return Field(f.name, f.dtype)
    if agg in ("list", "set"):
        return Field(f.name, DataType.list(f.dtype))
    if agg == "concat":
        d = f.dtype
        return Field(f.name, d if d.is_list() or d.is_string() else DataType.list(d))
    if agg in ("bool_and", "bool_or"):
        return Field(f.name, DataType.bool())
    if agg == "approx_percentiles":
        ps = e.params[0]
        return Field(f.name, DataType.fixed_size_list(DataType.float64(), len(ps)))
    raise NotImplementedError(f"agg type inference for {agg}")


def _function_field(op: str, e, child_fields, schema: Schema) -> Field:
    ns, fn = op.split(".", 1)
    f = child_fields[0]
    name = f.name
    if ns == "str":
        if fn in ("contains", "startswith", "endswith", "match"):
            return Field(name, DataType.bool())
        if fn in ("length", "length_bytes", "find"):
            return Field(name, DataType.uint64() if fn != "find" else DataType.int64())
        if fn in ("split", "extract_all"):
            return Field(name, DataType.list(DataType.string()))
        if fn == "to_date":
            return Field(name, DataType.date())
        if fn == "to_datetime":
            return Field(name, DataType.timestamp(TimeUnit.us, e.params[1]))
        if fn == "count_matches":
            return Field(name, DataType.uint64())
        if fn == "tokenize_encode":
            return Field(name, DataType.list(DataType.uint32()))
        if fn == "tokenize_decode":
            return Field(name, DataType.string())
        return Field(name, DataType.string())
    if ns == "dt":
        if fn in ("day", "hour", "minute", "second", "month", "quarter",
                  "day_of_week", "day_of_year", "week_of_year", "millisecond",
                  "microsecond", "nanosecond"):
            return Field(name, DataType.uint32())
        if fn == "year":
            return Field(name, DataType.int32())
        if fn == "date":
            return Field(name, DataType.date())
        if fn == "time":
            return Field(name, DataType.time(TimeUnit.us))
        if fn == "truncate":
            return Field(name, f.dtype)
        if fn in ("to_unix_epoch", "total_seconds"):
            return Field(name, DataType.int64())
        if fn == "strftime":
            return Field(name, DataType.string())
        raise NotImplementedError(f"dt.{fn}")
    if ns == "float":
        if fn in ("is_nan", "is_inf", "not_nan"):
            return Field(name, DataType.bool())
        return Field(name, f.dtype)
    if ns == "list":
        d = f.dtype
        if fn in ("length", "count"):
            return Field(name, DataType.uint64())
        if fn == "join":
            return Field(name, DataType.string())
        if fn in ("get",):
            return Field(name, d.inner)
        if fn in ("slice", "chunk", "sort", "distinct"):
            return Field(name, DataType.list(d.inner) if fn != "chunk"
                         else DataType.list(DataType.list(d.inner)))
        if fn in ("sum", "mean", "min", "max"):
            inner = d.inner
            if fn == "mean":
                return Field(name, DataType.float64())
            return Field(name, inner)
        if fn in ("bool_and", "bool_or"):
            return Field(name, DataType.bool())
        if fn == "value_counts":
            return Field(name, DataType.map(d.inner, DataType.uint64()))
        raise NotImplementedError(f"list.{fn}")
    if ns == "struct":
        if fn == "get":
            fld = e.params[0]
            return Field(fld, f.dtype.fields[fld])
    if ns == "map":
        if fn == "get":
            return Field("value", f.dtype._params[1])
    if ns == "embedding":
        if fn == "cosine_distance":
            return Field(name, DataType.float64())
    if ns == "image":
        if fn == "decode":
            mode = e.params[1]
            return Field(name, DataType.image(mode))
        if fn == "encode":
            return Field(name, DataType.binary())
        if fn == "resize":
            d = f.dtype
            if d.kind == "fixed_shape_image":
                m = d.image_mode
                return Field(name, DataType.fixed_shape_image(m, e.params[1], e.params[0]))
            return Field(name, d)
        if fn in ("crop", "to_mode"):
            if fn == "to_mode":
                return Field(name, DataType.image(e.params[0]))
            return Field(name, DataType.image(f.dtype.image_mode
                                              if f.dtype.is_image() else None))
    if ns == "binary":
        if fn == "length":
            return Field(name, DataType.uint64())
        if fn in ("encode", "try_encode"):
            # utf-8 "encodes" bytes→text in the reference's codec table
            return Field(name, DataType.binary())
        if fn in ("decode", "try_decode"):
            # both aliases map to Codec::Utf8 → Utf8 in the reference
            from .fn_host import norm_codec
            codec = norm_codec(e.params[0])
            return Field(name, DataType.string() if codec in ("utf-8", "utf8")
                         else DataType.binary())
        return Field(name, DataType.binary())
    if ns == "json":
        if fn == "query":
            return Field(name, DataType.string())
    if ns == "url":
        if fn == "download":
            return Field(name, DataType.binary())
        if fn == "upload":
            return Field(name, DataType.string())
        if fn == "parse":
            return Field(name, DataType.struct({
                "scheme": DataType.string(), "host": DataType.string(),
                "port": DataType.int32(), "path": DataType.string(),
                "query": DataType.string(), "fragment": DataType.string()}))
    if ns == "partitioning":
        if fn in ("days",):
            return Field(name, DataType.date())
        if fn in ("hours", "months", "years", "iceberg_bucket"):
            return Field(name, DataType.int32())
        if fn == "iceberg_truncate":
            return Field(name, f.dtype)
    raise NotImplementedError(f"type inference for {op}")
