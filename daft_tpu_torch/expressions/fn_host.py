"""Host implementations of the namespaced scalar functions (``str``,
``dt``, ``float``, ``list``, ``struct``, ``map``, ``embedding``,
``binary``, ``json``, ``url``, ``partitioning``), over Arrow C++ compute
and numpy (reference: ``daft_tpu/expressions/fn_host.py``).

Capability mirror of the reference's function crates
(``src/daft-functions-utf8``, ``-temporal``, ``-list``, ``-binary``,
``-json``, ``-uri``). Where the reference loops over rows in Python, the
port computes the same values with Arrow kernels for the functions a
large text pipeline reaches (``str.normalize`` on ASCII text,
``list.get``). ``image`` runs in ``functions/image.py`` (the batched
resize on the card), ``str.tokenize_*`` in ``functions/tokenize.py``.
"""

from __future__ import annotations

import datetime
import re
from typing import List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..datatype import DataType, TimeUnit
from ..schema import Field
from ..series import Series


def _sa(s: Series) -> pa.Array:
    return s.to_arrow().cast(pa.large_string())


def eval_function(op: str, e, kids: List[Series], b, out_field: Field) -> Series:
    ns, fn = op.split(".", 1)
    s = kids[0]
    name = s.name()

    if ns == "str":
        return _str_fn(fn, e, kids, b, out_field)
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
    if ns == "list":
        return _list_fn(fn, e, kids, b, out_field)
    if ns == "struct":
        if fn == "get":
            sa = s.to_arrow()
            child = sa.field(e.params[0])
            return Series.from_arrow(child, e.params[0])
    if ns == "map":
        if fn == "get":
            key = kids[1].to_pylist()[0]
            out = []
            for m in s.to_pylist():
                if m is None:
                    out.append(None)
                else:
                    d = dict(m) if not isinstance(m, dict) else m
                    out.append(d.get(key))
            return Series.from_pylist(out, "value", dtype=out_field.dtype)
    if ns == "embedding":
        if fn == "cosine_distance":
            a = s.to_numpy().astype(np.float64)
            o = b(kids[1]).to_numpy().astype(np.float64)
            if o.ndim == 1:
                o = np.broadcast_to(o[None, :], a.shape)
            num = (a * o).sum(axis=1)
            den = np.linalg.norm(a, axis=1) * np.linalg.norm(o, axis=1)
            with np.errstate(all="ignore"):
                out = 1.0 - num / den
            return Series.from_arrow(pa.array(out), name)
    if ns == "image":
        from ..functions.image import eval_image_fn
        return eval_image_fn(fn, e, kids, out_field)
    if ns == "partitioning":
        return _partitioning_fn(fn, e, s, out_field)
    if ns == "binary":
        return _binary_fn(fn, e, kids, b, out_field)
    if ns == "json":
        return _json_fn(fn, e, s, out_field)
    if ns == "url":
        return _url_fn(fn, e, kids, b, out_field)
    raise NotImplementedError(f"host function {op}")


def _binary_fn(fn, e, kids, b, out_field) -> Series:
    """Reference: ``src/daft-functions-binary`` (concat/slice/encode/decode)."""
    s = kids[0]
    name = s.name()
    arr = s.to_arrow().cast(pa.large_binary())
    if fn == "concat":
        other = b(kids[1]).to_arrow().cast(pa.large_binary())
        return Series.from_arrow(
            pc.binary_join_element_wise(
                arr, other, pa.scalar(b"", type=pa.large_binary())), name)
    if fn == "length":
        return Series.from_arrow(pc.binary_length(arr).cast(pa.uint64()), name)
    if fn == "slice":
        start = b(kids[1]).to_pylist()
        length = b(kids[2]).to_pylist() if len(kids) > 2 else [None] * len(s)
        out = []
        for v, st, ln in zip(s.to_pylist(), start, length):
            if v is None or st is None:
                out.append(None)
            else:
                end = None if ln is None else st + ln
                out.append(bytes(v)[st:end])
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    if fn in ("encode", "decode", "try_encode", "try_decode"):
        codec = e.params[0]
        lenient = fn.startswith("try_")
        decode = "decode" in fn
        out = []
        for v in s.to_pylist():
            if v is None:
                out.append(None)
                continue
            try:
                out.append(_codec_apply(bytes(v), codec, decode))
            except Exception:
                if lenient:
                    out.append(None)
                else:
                    raise
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    raise NotImplementedError(f"binary.{fn}")


def norm_codec(codec) -> str:
    """Canonical codec spelling — shared by typing (typing.py binary rules)
    and evaluation so schema and execution never disagree."""
    return str(codec).lower().replace("_", "-")


def _codec_apply(data: bytes, codec: str, decode: bool):
    codec = norm_codec(codec)
    import base64
    import gzip
    import zlib
    if codec == "base64":
        return (base64.b64decode(data, validate=True) if decode
                else base64.b64encode(data))
    if codec == "hex":
        return bytes.fromhex(data.decode()) if decode else data.hex().encode()
    if codec == "gzip":
        return gzip.decompress(data) if decode else gzip.compress(data)
    if codec == "zlib":
        return zlib.decompress(data) if decode else zlib.compress(data)
    if codec == "deflate":
        if decode:
            return zlib.decompress(data, wbits=-zlib.MAX_WBITS)
        c = zlib.compressobj(wbits=-zlib.MAX_WBITS)
        return c.compress(data) + c.flush()
    if codec in ("utf-8", "utf8"):
        return data.decode("utf-8") if decode else data
    raise ValueError(f"unsupported codec {codec!r}")


def _json_fn(fn, e, s: Series, out_field) -> Series:
    """jq-style path queries (reference: ``src/daft-functions-json`` via jaq).

    Supported filter subset: ``.``, ``.field``, ``.field1.field2``,
    ``.field[idx]``, ``.[idx]``, ``.field[]`` (array iteration → JSON array),
    and pipes ``f1 | f2``.
    """
    import json as _json
    if fn != "query":
        raise NotImplementedError(f"json.{fn}")
    query = e.params[0]
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        try:
            doc = _json.loads(v)
            results, iterated = _jq_apply(doc, query)
        except Exception:
            out.append(None)
            continue
        if iterated:
            # array iteration contract: always a JSON array, even for 0/1 hits
            out.append(_json.dumps(results))
        elif not results:
            out.append(None)
        else:
            r = results[0]
            out.append(r if isinstance(r, str)
                       else (None if r is None else _json.dumps(r)))
    return Series.from_pylist(out, s.name(), dtype=out_field.dtype)


def _jq_apply(doc, query: str):
    values = [doc]
    iterated = "[]" in query
    for stage in (p.strip() for p in query.split("|")):
        if stage in (".", ""):
            continue
        next_vals = []
        for val in values:
            next_vals.extend(_jq_stage(val, stage))
        values = next_vals
    return values, iterated


def _jq_stage(val, stage: str):
    # tokenize a path like .a.b[0].c[] into steps
    steps = re.findall(r"\.(?:[A-Za-z_][A-Za-z0-9_]*)?|\[-?\d*\]", stage)
    cur = [val]
    for step in steps:
        nxt = []
        for v in cur:
            if v is None:
                nxt.append(None)
            elif step == ".":
                nxt.append(v)
            elif step.startswith("."):
                key = step[1:]
                nxt.append(v.get(key) if isinstance(v, dict) else None)
            elif step == "[]":
                if isinstance(v, list):
                    nxt.extend(v)
            else:
                idx = int(step[1:-1])
                nxt.append(v[idx] if isinstance(v, list)
                           and -len(v) <= idx < len(v) else None)
        cur = nxt
    return cur


def _url_fn(fn, e, kids, b, out_field) -> Series:
    """Reference: ``src/daft-functions-uri`` — async multi-get through
    daft-io inside expression eval. Host equivalent: IOClient + thread pool
    bounded at ``max_connections``."""
    import concurrent.futures as cf
    import urllib.parse as _up

    from ..io.object_io import get_io_client

    s = kids[0]
    name = s.name()
    if fn == "parse":
        out = []
        for v in s.to_pylist():
            if v is None:
                out.append(None)
                continue
            try:
                p = _up.urlparse(v)
                out.append({"scheme": p.scheme, "host": p.hostname,
                            "port": p.port, "path": p.path,
                            "query": p.query, "fragment": p.fragment})
            except ValueError:  # e.g. non-numeric port — null the row
                out.append(None)
        return Series.from_pylist(out, name, dtype=out_field.dtype)

    max_conn, on_error, io_config = e.params[0], e.params[1], e.params[2]
    client = get_io_client(io_config)

    if fn == "download":
        urls = s.to_pylist()

        def fetch(u):
            if u is None:
                return None
            try:
                return client.get(u)
            except Exception:
                if on_error == "null":
                    return None
                raise

        with cf.ThreadPoolExecutor(max_workers=max(1, max_conn)) as pool:
            out = list(pool.map(fetch, urls))
        return Series.from_pylist(out, name, dtype=out_field.dtype)

    if fn == "upload":
        data = s.to_pylist()
        locations = b(kids[1]).to_pylist()

        import uuid

        def push(args):
            i, (blob, loc) = args
            if blob is None or loc is None:
                return None
            if isinstance(blob, str):
                blob = blob.encode()
            # uuid per row: unique across partitions/workers (the reference
            # names uploaded objects the same way)
            path = loc.rstrip("/") + f"/{uuid.uuid4().hex}"
            try:
                client.put(path, bytes(blob))
            except Exception:
                if on_error == "null":
                    return None
                raise
            return path

        with cf.ThreadPoolExecutor(max_workers=max(1, max_conn)) as pool:
            out = list(pool.map(push, enumerate(zip(data, locations))))
        return Series.from_pylist(out, name, dtype=out_field.dtype)

    raise NotImplementedError(f"url.{fn}")


def _str_fn(fn, e, kids, b, out_field) -> Series:
    s = kids[0]
    name = s.name()
    if fn in ("tokenize_encode", "tokenize_decode"):
        from ..functions.tokenize import eval_tokenize
        return eval_tokenize(fn, e, kids, out_field)
    arr = _sa(s)
    if fn == "contains":
        pat = kids[1].to_pylist()[0]
        return Series.from_arrow(pc.match_substring(arr, pat), name)
    if fn == "startswith":
        return Series.from_arrow(pc.starts_with(arr, kids[1].to_pylist()[0]), name)
    if fn == "endswith":
        return Series.from_arrow(pc.ends_with(arr, kids[1].to_pylist()[0]), name)
    if fn == "concat":
        other = b(kids[1])
        return Series.from_arrow(
            pc.binary_join_element_wise(arr, _sa(other),
                                        pa.scalar("", type=pa.large_string())),
            name)
    if fn == "length":
        return Series.from_arrow(pc.utf8_length(arr), name).cast(DataType.uint64())
    if fn == "length_bytes":
        return Series.from_arrow(pc.binary_length(arr), name).cast(DataType.uint64())
    if fn == "lower":
        return Series.from_arrow(pc.utf8_lower(arr), name)
    if fn == "upper":
        return Series.from_arrow(pc.utf8_upper(arr), name)
    if fn == "lstrip":
        return Series.from_arrow(pc.utf8_ltrim_whitespace(arr), name)
    if fn == "rstrip":
        return Series.from_arrow(pc.utf8_rtrim_whitespace(arr), name)
    if fn == "strip":
        return Series.from_arrow(pc.utf8_trim_whitespace(arr), name)
    if fn == "reverse":
        return Series.from_arrow(pc.utf8_reverse(arr), name)
    if fn == "capitalize":
        return Series.from_arrow(pc.utf8_capitalize(arr), name)
    if fn == "left":
        n = kids[1].to_pylist()[0]
        return Series.from_arrow(pc.utf8_slice_codeunits(arr, 0, n), name)
    if fn == "right":
        n = kids[1].to_pylist()[0]
        vals = arr.to_pylist()
        return Series.from_pylist(
            [None if v is None else v[-n:] if n else "" for v in vals], name)
    if fn == "repeat":
        n = b(kids[1]).to_pylist()
        vals = arr.to_pylist()
        return Series.from_pylist(
            [None if v is None or c is None else v * c
             for v, c in zip(vals, n)], name)
    if fn == "split":
        pat = kids[1].to_pylist()[0]
        regex = e.params[0]
        out = (pc.split_pattern_regex if regex else pc.split_pattern)(arr, pat)
        return Series.from_arrow(out, name)
    if fn == "match":
        return Series.from_arrow(
            pc.match_substring_regex(arr, kids[1].to_pylist()[0]), name)
    if fn == "extract":
        pat, idx = kids[1].to_pylist()[0], e.params[0]
        rx = re.compile(pat)
        out = []
        for v in arr.to_pylist():
            if v is None:
                out.append(None)
                continue
            m = rx.search(v)
            out.append(m.group(idx) if m else None)
        return Series.from_pylist(out, name, dtype=DataType.string())
    if fn == "extract_all":
        pat, idx = kids[1].to_pylist()[0], e.params[0]
        rx = re.compile(pat)
        out = []
        for v in arr.to_pylist():
            if v is None:
                out.append(None)
            else:
                out.append([(m.group(idx)) for m in rx.finditer(v)])
        return Series.from_pylist(out, name, dtype=DataType.list(DataType.string()))
    if fn == "replace":
        pat, rep = kids[1].to_pylist()[0], kids[2].to_pylist()[0]
        regex = e.params[0]
        fnc = pc.replace_substring_regex if regex else pc.replace_substring
        return Series.from_arrow(fnc(arr, pattern=pat, replacement=rep), name)
    if fn == "find":
        sub = kids[1].to_pylist()[0]
        return Series.from_arrow(pc.find_substring(arr, sub), name) \
            .cast(DataType.int64())
    if fn in ("rpad", "lpad"):
        length = b(kids[1]).to_pylist()
        pad = b(kids[2]).to_pylist()
        vals = arr.to_pylist()
        out = []
        for v, L, p in zip(vals, length, pad):
            if v is None or L is None or p is None:
                out.append(None)
            elif len(v) >= L:
                out.append(v[:L])
            else:
                padstr = (p * L)[: L - len(v)]
                out.append(v + padstr if fn == "rpad" else padstr + v)
        return Series.from_pylist(out, name)
    if fn == "substr":
        start = b(kids[1]).to_pylist()
        lens = b(kids[2]).to_pylist() if len(kids) > 2 else [None] * len(arr)
        vals = arr.to_pylist()
        out = []
        for v, st, ln in zip(vals, start, lens):
            if v is None or st is None:
                out.append(None)
            else:
                out.append(v[st:] if ln is None else v[st:st + ln])
        return Series.from_pylist(out, name)
    if fn == "to_date":
        fmt = e.params[0]
        out = pc.strptime(arr, format=fmt, unit="us", error_is_null=True)
        return Series.from_arrow(out, name).cast(DataType.date())
    if fn == "to_datetime":
        fmt, tz = e.params
        out = pc.strptime(arr, format=fmt, unit="us", error_is_null=True)
        s2 = Series.from_arrow(out, name)
        return s2.cast(DataType.timestamp(TimeUnit.us, tz))
    if fn == "normalize":
        remove_punct, lowercase, nfd_unicode, white_space = e.params
        if pc.all(pc.string_is_ascii(arr)).as_py() is not False:
            return Series.from_arrow(_normalize_ascii(
                arr, remove_punct, lowercase, white_space), name)
        import string as _string
        import unicodedata
        vals = arr.to_pylist()
        out = []
        for v in vals:
            if v is None:
                out.append(None)
                continue
            if nfd_unicode:
                v = unicodedata.normalize("NFD", v)
            if lowercase:
                v = v.lower()
            if remove_punct:
                v = v.translate(str.maketrans("", "", _string.punctuation))
            if white_space:
                v = " ".join(v.split())
            out.append(v)
        return Series.from_pylist(out, name)
    if fn == "count_matches":
        pats, whole_words, case_sensitive = e.params
        flags = 0 if case_sensitive else re.IGNORECASE
        parts = [re.escape(p) for p in pats]
        pat = "|".join(rf"\b(?:{p})\b" if whole_words else f"(?:{p})" for p in parts)
        rx = re.compile(pat, flags)
        out = [None if v is None else len(rx.findall(v)) for v in arr.to_pylist()]
        return Series.from_pylist(out, name, dtype=DataType.uint64())
    raise NotImplementedError(f"str.{fn}")


_EPOCH = datetime.date(1970, 1, 1)


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


def _list_fn(fn, e, kids, b, out_field) -> Series:
    s = kids[0]
    name = s.name()
    arr = s.to_arrow()
    if fn == "length":
        return Series.from_arrow(pc.list_value_length(arr), name) \
            .cast(DataType.uint64())
    if fn == "count":
        mode = e.params[0]
        vals = arr.to_pylist()
        out = []
        for v in vals:
            if v is None:
                out.append(0 if mode != "null" else 0)
            elif mode == "valid":
                out.append(sum(1 for x in v if x is not None))
            elif mode == "null":
                out.append(sum(1 for x in v if x is None))
            else:
                out.append(len(v))
        return Series.from_pylist(out, name, dtype=DataType.uint64())
    if fn == "join":
        delim = b(kids[1]).to_pylist()
        vals = arr.to_pylist()
        out = []
        for v, d in zip(vals, delim if len(delim) == len(vals) else delim * len(vals)):
            if v is None or d is None:
                out.append(None)
            else:
                out.append(d.join(x for x in v if x is not None))
        return Series.from_pylist(out, name)
    if fn == "get":
        default = kids[2].to_pylist()[0] if len(kids) > 2 and len(kids[2]) else None
        got = _list_get(arr, b(kids[1]), default)
        if got is not None:
            return Series.from_arrow(got, name).cast(out_field.dtype)
        idx = b(kids[1]).to_pylist()
        vals = arr.to_pylist()
        if len(idx) == 1:
            idx = idx * len(vals)
        out = []
        for v, i in zip(vals, idx):
            if v is None or i is None:
                out.append(default)
            elif -len(v) <= i < len(v):
                out.append(v[i])
            else:
                out.append(default)
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    if fn == "slice":
        start = b(kids[1]).to_pylist()
        end = b(kids[2]).to_pylist() if len(kids) > 2 else None
        vals = arr.to_pylist()
        if len(start) == 1:
            start = start * len(vals)
        out = []
        for i, v in enumerate(vals):
            if v is None:
                out.append(None)
                continue
            st = start[i]
            en = end[i] if end is not None and end[i] is not None else len(v)
            out.append(v[st:en])
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    if fn == "chunk":
        size = e.params[0]
        vals = arr.to_pylist()
        out = []
        for v in vals:
            if v is None:
                out.append(None)
            else:
                out.append([v[i:i + size] for i in range(0, len(v) - size + 1, size)])
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    if fn in ("sum", "mean", "min", "max", "bool_and", "bool_or"):
        vals = arr.to_pylist()
        out = []
        for v in vals:
            xs = [x for x in (v or []) if x is not None]
            if not xs:
                out.append(None)
            elif fn == "sum":
                out.append(sum(xs))
            elif fn == "mean":
                out.append(sum(xs) / len(xs))
            elif fn == "min":
                out.append(min(xs))
            elif fn == "max":
                out.append(max(xs))
            elif fn == "bool_and":
                out.append(all(xs))
            else:
                out.append(any(xs))
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    if fn == "sort":
        desc, nulls_first = e.params
        vals = arr.to_pylist()
        nf = nulls_first if nulls_first is not None else desc
        out = []
        for v in vals:
            if v is None:
                out.append(None)
                continue
            nn = sorted((x for x in v if x is not None), reverse=bool(desc))
            nulls = [None] * (len(v) - len(nn))
            out.append(nulls + nn if nf else nn + nulls)
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    if fn == "distinct":
        vals = arr.to_pylist()
        out = []
        for v in vals:
            if v is None:
                out.append(None)
                continue
            seen, d = set(), []
            for x in v:
                if x is not None and x not in seen:
                    seen.add(x)
                    d.append(x)
            out.append(d)
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    if fn == "value_counts":
        vals = arr.to_pylist()
        out = []
        for v in vals:
            counts = {}
            for x in (v or []):
                if x is not None:
                    counts[x] = counts.get(x, 0) + 1
            out.append(list(counts.items()))
        return Series.from_pylist(out, name, dtype=out_field.dtype)
    raise NotImplementedError(f"list.{fn}")


def _normalize_ascii(arr, remove_punct, lowercase, white_space):
    """``str.normalize`` over an all-ASCII array with Arrow kernels: the
    values of the reference's per-row ``lower`` / ``translate`` /
    ``" ".join(v.split())`` (NFD leaves ASCII as it is)."""
    import string as _string
    if lowercase:
        arr = pc.ascii_lower(arr)
    if remove_punct:
        arr = pc.replace_substring_regex(
            arr, pattern="[" + "".join("\\" + c for c in _string.punctuation)
            + "]", replacement="")
    if white_space:
        # str.split()'s ASCII separators: \t \n \x0b \x0c \r \x1c-\x1f space
        arr = pc.replace_substring_regex(
            arr, pattern="[\\t\\n\\x0b\\x0c\\r\\x1c-\\x1f ]+",
            replacement=" ")
        arr = pc.utf8_trim(arr, characters=" ")
    return arr


def _list_get(arr, idx: Series, default):
    """``list.get`` with Arrow kernels: element ``idx`` (negative from the
    end) of each list, ``default`` where the list is null or too short or
    the index null. None when ``arr`` is not a list array."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    if pa.types.is_fixed_size_list(arr.type):
        width = arr.type.list_size
        starts = (np.arange(n, dtype=np.int64) + arr.offset) * width
        lens = np.full(n, width, dtype=np.int64)
    elif pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type):
        offs = np.asarray(arr.offsets.to_numpy(zero_copy_only=False),
                          dtype=np.int64)
        starts, lens = offs[:-1], np.diff(offs)
    else:
        return None
    values = arr.values
    ia = idx.to_arrow()
    if len(ia) == 1:
        ia = pa.repeat(ia[0], n) if ia[0].is_valid \
            else pa.nulls(n, pa.int64())
    ok = np.asarray(pc.is_valid(arr).to_numpy(zero_copy_only=False),
                    dtype=np.bool_) & np.asarray(
        pc.is_valid(ia).to_numpy(zero_copy_only=False), dtype=np.bool_)
    i = pc.fill_null(ia.cast(pa.int64()), 0).to_numpy(
        zero_copy_only=False).astype(np.int64)
    ok &= (i >= -lens) & (i < lens)
    pos = np.where(ok, starts + np.where(i < 0, lens + i, i), 0)
    out = values.take(pa.array(pos, mask=~ok)) if len(values) \
        else pa.nulls(n, values.type)
    if default is not None and not ok.all():
        out = pc.if_else(pa.array(ok), out,
                         pa.scalar(default).cast(values.type))
    return out


def _partitioning_fn(fn, e, s: Series, out_field) -> Series:
    name = s.name()
    arr = s.to_arrow()
    if fn == "days":
        return Series.from_arrow(arr.cast(pa.date32()), name)
    if fn == "hours":
        us = arr.cast(pa.timestamp("us")).cast(pa.int64())
        return Series.from_arrow(pc.divide(us, 3600 * 1_000_000), name) \
            .cast(DataType.int32())
    if fn == "months":
        y = pc.year(arr)
        m = pc.month(arr)
        out = pc.add(pc.multiply(pc.subtract(y, 1970), 12), pc.subtract(m, 1))
        return Series.from_arrow(out, name).cast(DataType.int32())
    if fn == "years":
        return Series.from_arrow(pc.subtract(pc.year(arr), 1970), name) \
            .cast(DataType.int32())
    if fn == "iceberg_bucket":
        n = e.params[0]
        h = s.hash().to_numpy()
        return Series.from_arrow(pa.array((h % np.uint64(n)).astype(np.int32)), name)
    if fn == "iceberg_truncate":
        w = e.params[0]
        if s.datatype().is_string():
            vals = [None if v is None else v[:w] for v in arr.to_pylist()]
            return Series.from_pylist(vals, name)
        v = s.to_numpy()
        return Series.from_arrow(pa.array(v - (v % w)), name)
    raise NotImplementedError(f"partitioning.{fn}")
