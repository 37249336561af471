"""Format readers over Arrow C++ (pyarrow): parquet / csv / json / warc.

The port's copy of ``daft_tpu/io/readers.py``.

Reference capabilities: ``src/daft-parquet`` (bulk reads, row-group pruning
via statistics ``statistics/``, byte-range coalescing), ``src/daft-csv`` /
``src/daft-json`` (schema inference, projection/limit pushdown). The pruning
and projection logic lives here; decode is Arrow C++.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pyarrow.parquet as pq

from ..expressions import Expression
from ..recordbatch import RecordBatch
from ..schema import Schema
from ..series import Series
from .scan import Pushdowns, ScanTask, _is_remote


def _open_ranged(path: str, io_config=None):
    """Path (local) or a seekable ranged reader (remote) — parquet footer /
    row-group reads become range requests over the object store."""
    if not _is_remote(path):
        return path
    from . import read_planner as rp
    from .object_io import get_io_client
    from .s3 import S3ReadableFile
    client = get_io_client(io_config)
    return pa.PythonFile(S3ReadableFile(client.source_for(path), path,
                                        stats=rp.SCAN_STATS),
                         mode="r")


def _open_full(path: str, io_config=None):
    """Path (local) or an in-memory buffer of the whole object (remote) —
    the whole-object fallback for single-pass formats (csv/json)."""
    if not _is_remote(path):
        return path
    from . import read_planner as rp
    from .object_io import get_io_client
    client = get_io_client(io_config)
    return pa.BufferReader(client.get(path, None, rp.SCAN_STATS))


def _open_stream(path: str, io_config=None):
    """Path (local) or a chunked streaming reader (remote) — single-pass
    formats (csv/json) parse as chunks arrive instead of buffering the
    whole object: resident memory is chunk-sized and the parser overlaps
    the remaining fetches."""
    if not _is_remote(path):
        return path
    from . import read_planner as rp
    from .object_io import get_io_client
    client = get_io_client(io_config)
    src = client.source_for(path)
    try:
        reader = rp.ChunkedObjectReader(src, path, stats=rp.SCAN_STATS)
    except Exception:  # no size probe on this source → buffer whole
        return _open_full(path, io_config)
    return pa.PythonFile(reader, mode="r")


def read_footer(path: str, io_config=None):
    """The parquet footer of ``path``, through the ranged open (a remote
    file costs its tail range GETs only)."""
    return pq.ParquetFile(_open_ranged(path, io_config)).metadata


def _head_range_schema(path: str, file_format: str,
                       options: Dict[str, Any], io_config) -> Optional[Schema]:
    """Schema from a bounded head-range read of a remote CSV/JSON object
    (truncated at the last complete line); None → caller falls back to the
    whole object (tiny budget, no newline in the head, or parse failure —
    e.g. one record larger than the head budget).

    CSV inference was first-block-bounded before this path too
    (``pacsv.open_csv`` infers from its first ~1MB block), so only JSON
    trades tail visibility for the bounded read: a column whose type only
    widens past the head (int head, string tail) now surfaces at read
    time instead of inference time. ``DAFT_TORCH_IO_INFER_BYTES=0``
    restores whole-object inference."""
    from . import read_planner as rp
    from .object_io import get_io_client
    budget = rp.infer_head_bytes()
    if budget <= 0:
        return None
    src = get_io_client(io_config).source_for(path)
    try:
        size = src.get_size(path)
    except Exception:
        return None
    if size <= 0:
        return None
    if size <= budget:
        data = src.get(path, None, rp.SCAN_STATS)
    else:
        data = src.get(path, (0, budget), rp.SCAN_STATS)
        nl = data.rfind(b"\n")
        if nl <= 0:
            return None
        data = data[:nl + 1]
    try:
        if file_format == "csv":
            ropts, popts, copts = _csv_options(options)
            with pacsv.open_csv(pa.BufferReader(data), read_options=ropts,
                                parse_options=popts,
                                convert_options=copts) as rdr:
                return Schema.from_arrow(rdr.schema)
        t = pajson.read_json(pa.BufferReader(data))
        return Schema.from_arrow(t.schema)
    except Exception:
        rp.scan_count("infer_head_fallbacks")
        return None


def infer_schema(path: str, file_format: str,
                 options: Dict[str, Any], io_config=None) -> Schema:
    if file_format == "parquet":
        return Schema.from_arrow(pq.read_schema(_open_ranged(path, io_config)))
    if file_format == "csv":
        if _is_remote(path):
            s = _head_range_schema(path, "csv", options, io_config)
            if s is not None:
                return s
        ropts, popts, copts = _csv_options(options)
        with pacsv.open_csv(_open_full(path, io_config), read_options=ropts,
                            parse_options=popts,
                            convert_options=copts) as rdr:
            return Schema.from_arrow(rdr.schema)
    if file_format == "json":
        if _is_remote(path):
            s = _head_range_schema(path, "json", options, io_config)
            if s is not None:
                return s
        t = pajson.read_json(_open_full(path, io_config))
        return Schema.from_arrow(t.schema)
    if file_format == "warc":
        from .warc import WARC_SCHEMA
        return WARC_SCHEMA
    raise ValueError(f"unknown format {file_format}")


def _csv_options(options: Dict[str, Any]):
    ropts = pacsv.ReadOptions(
        column_names=options.get("column_names"),
        autogenerate_column_names=not options.get("has_headers", True)
        and options.get("column_names") is None)
    popts = pacsv.ParseOptions(
        delimiter=options.get("delimiter") or ",",
        quote_char=options.get("quote") or '"',
        escape_char=options.get("escape_char") or False,
        newlines_in_values=options.get("allow_variable_columns", False))
    copts = pacsv.ConvertOptions()
    if options.get("schema") is not None:
        sch: Schema = options["schema"]
        copts.column_types = {f.name: f.dtype.to_arrow() for f in sch}
    return ropts, popts, copts


def make_scan_tasks(path: str, file_format: str, schema: Schema,
                    pushdowns: Pushdowns, options: Dict[str, Any],
                    partition_values: Dict[str, Any],
                    io_config=None) -> List[ScanTask]:
    """Per-file scan tasks, with parquet row-group pruning; the footer read
    here rides the task (``ScanTask.metadata``), so neither the split nor
    the read fetches it again."""
    if file_format == "parquet":
        try:
            md = read_footer(path, io_config)
        except Exception:
            md = None
        if md is not None:
            groups = _prune_row_groups(md, pushdowns.filters, schema)
            keep = groups if groups is not None \
                else range(md.num_row_groups)
            return [ScanTask(
                [path], schema, pushdowns,
                sum(md.row_group(g).num_rows for g in keep),
                sum(md.row_group(g).total_byte_size for g in keep),
                [groups] if groups is not None else None, [md],
                file_format="parquet", format_options=options,
                partition_values=partition_values, io_config=io_config)]
    if _is_remote(path):
        try:
            from .object_io import get_io_client
            size = get_io_client(io_config).source_for(path).get_size(path)
        except Exception:
            size = None
    else:
        size = os.path.getsize(path) if os.path.exists(path) else None
    return [ScanTask([path], schema, pushdowns, None, size,
                     file_format=file_format, format_options=options,
                     partition_values=partition_values, io_config=io_config)]


def _prune_row_groups(md, filters: Optional[Expression],
                      schema: Schema) -> Optional[List[int]]:
    """Zone-map pruning: drop row groups whose min/max can't satisfy the
    filter (reference: ``daft-parquet/src/statistics``). Conservative — only
    simple ``col <op> literal`` conjuncts are used."""
    if filters is None:
        return None
    bounds = _extract_bounds(filters)
    if not bounds:
        return None
    keep = []
    name_to_idx = None
    for g in range(md.num_row_groups):
        rg = md.row_group(g)
        if name_to_idx is None:
            name_to_idx = {rg.column(i).path_in_schema: i
                           for i in range(rg.num_columns)}
        ok = True
        for (cname, op, lit) in bounds:
            ci = name_to_idx.get(cname)
            if ci is None:
                continue
            stats = rg.column(ci).statistics
            if stats is None:
                continue
            if op in ("is_null", "not_null"):
                # null_count statistics: a group with zero nulls can't
                # satisfy is_null; an all-null group can't satisfy not_null
                if not getattr(stats, "has_null_count", False):
                    continue
                if op == "is_null" and stats.null_count == 0:
                    ok = False
                elif op == "not_null" and stats.null_count >= rg.num_rows:
                    ok = False
                if not ok:
                    break
                continue
            if not stats.has_min_max:
                continue
            mn, mx = stats.min, stats.max
            try:
                if op == "lt" and not (mn < lit):
                    ok = False
                elif op == "le" and not (mn <= lit):
                    ok = False
                elif op == "gt" and not (mx > lit):
                    ok = False
                elif op == "ge" and not (mx >= lit):
                    ok = False
                elif op == "eq" and not (mn <= lit <= mx):
                    ok = False
                elif op == "is_in" and not any(mn <= v <= mx for v in lit):
                    ok = False
            except TypeError:
                continue
            if not ok:
                break
        if ok:
            keep.append(g)
    return keep


_LIT_TYPES = (int, float, str, bytes)


def _extract_bounds(e: Expression):
    """Top-level AND conjuncts of form col <cmp> lit, plus
    col.is_null()/not_null() (null_count pruning) and
    col.is_in([literals]) (min/max containment pruning)."""
    import datetime
    out = []

    def walk(x: Expression):
        if x.op == "and":
            walk(x.args[0])
            walk(x.args[1])
            return
        if x.op in ("is_null", "not_null"):
            c = x.args[0]._unalias()
            if c.op == "col":
                out.append((c.params[0], x.op, None))
            return
        if x.op == "is_in":
            c = x.args[0]._unalias()
            if c.op != "col":
                return
            vals = []
            for a in x.args[1:]:
                if a.op == "lit" and isinstance(
                        a.params[0],
                        _LIT_TYPES + (datetime.date, datetime.datetime)) \
                        and not isinstance(a.params[0], bool):
                    vals.append(a.params[0])
                else:
                    return  # non-literal member → no static bound
            if vals:
                out.append((c.params[0], "is_in", tuple(vals)))
            return
        if x.op in ("lt", "le", "gt", "ge", "eq"):
            l, r = x.args
            flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
            if l.op == "lit" and r._unalias().op == "col":
                l, r = r, l
                op = flip[x.op]
            else:
                op = x.op
            li = l._unalias()
            if li.op == "col" and r.op == "lit":
                v = r.params[0]
                if isinstance(v, (datetime.date, datetime.datetime)):
                    # parquet stats for date32 come back as datetime.date
                    out.append((li.params[0], op, v))
                elif isinstance(v, (int, float, str, bytes)):
                    out.append((li.params[0], op, v))
    walk(e)
    return out


def _planned_parquet_read(path: str, md, rg: Optional[List[int]],
                          phys_cols: Optional[List[str]], io_config):
    """The scan fast path's parquet read: plan the exact byte ranges for
    (pruned row groups × projected columns) off the footer, coalesce them
    into few large requests, fetch concurrently over the source's pool,
    and decode from the in-memory RangeCache — pyarrow sends no GET
    of its own (planner misses fall back per-read and are counted)."""
    from . import read_planner as rp
    from .object_io import get_io_client
    src = get_io_client(io_config).source_for(path)
    if md is None:
        # footer via the ranged reader: tail + footer range requests only
        md = pq.read_metadata(_open_ranged(path, io_config))
    arrow_schema = md.schema.to_arrow_schema()
    file_cols = None
    if phys_cols is not None:
        names = set(arrow_schema.names)
        file_cols = [c for c in phys_cols if c in names]
    if rg is not None and not rg:
        return arrow_schema.empty_table()
    needed = rp.plan_parquet_ranges(md, rg, file_cols)
    # needed may be empty (0-column projection: pyarrow synthesizes row
    # counts from metadata alone) — the empty cache still serves that,
    # with any surprise read falling back to a counted direct GET
    requests = rp.coalesce_ranges(needed)
    rp.scan_count("ranges_planned", len(needed))
    rp.scan_count("range_requests", len(requests))
    rp.scan_count("bytes_used", sum(e - s for s, e in needed))
    bufs = src.get_ranges(path, requests, rp.SCAN_STATS,
                          rp.range_parallelism())
    for (s, e), b in zip(requests, bufs):
        if len(b) != e - s:
            # a server ignoring Range (200 + whole body) would silently
            # corrupt the cache's offsets — refuse and fall back
            raise ValueError(
                f"range GET [{s}, {e}) returned {len(b)} bytes")
    cache = rp.RangeCache(list(zip(requests, bufs)))
    shim = pa.PythonFile(
        rp.RangeCacheFile(cache, src, path, stats=rp.SCAN_STATS), mode="r")
    f = pq.ParquetFile(shim, metadata=md)
    if rg is None:
        return f.read(columns=file_cols)
    return f.read_row_groups(rg, columns=file_cols)


def _read_parquet_path(task: ScanTask, path: str, i: int,
                       phys_cols: Optional[List[str]], io_config):
    # the footer fetched at scan planning: a remote file then needs only
    # its row-group range requests
    md = task.metadata[i]
    rg = task.row_groups[i] if task.row_groups else None
    if _is_remote(path):
        from . import read_planner as rp
        if rp.planned_reads_enabled():
            try:
                return _planned_parquet_read(path, md, rg, phys_cols,
                                             io_config)
            except Exception:
                rp.scan_count("planned_read_fallbacks")
    f = pq.ParquetFile(_open_ranged(path, io_config), metadata=md)
    file_cols = None
    if phys_cols is not None:
        names = set(f.schema_arrow.names)
        file_cols = [c for c in phys_cols if c in names]
    if rg is None:
        return f.read(columns=file_cols)
    return f.read_row_groups(rg, columns=file_cols) if rg else \
        f.schema_arrow.empty_table()


def iter_scan_task_batches(task: ScanTask) -> Iterator[RecordBatch]:
    """One RecordBatch per source file, yielded as each file decodes —
    the prefetch-pipelined scan consumes morsels off this stream instead
    of waiting for whole-task completion."""
    cols = list(task.pushdowns.columns) if task.pushdowns.columns is not None \
        else None
    phys_cols = None
    if cols is not None:
        phys_cols = [c for c in cols if c not in task.partition_values]
    io_config = task.io_config
    for i, path in enumerate(task.paths):
        if task.file_format == "parquet":
            t = _read_parquet_path(task, path, i, phys_cols, io_config)
        elif task.file_format == "csv":
            ropts, popts, copts = _csv_options(task.format_options)
            if phys_cols is not None:
                copts.include_columns = phys_cols
                copts.include_missing_columns = True
            t = pacsv.read_csv(_open_stream(path, io_config),
                               read_options=ropts,
                               parse_options=popts, convert_options=copts)
        elif task.file_format == "json":
            t = pajson.read_json(_open_stream(path, io_config))
            if phys_cols is not None:
                keep = [c for c in phys_cols if c in t.column_names]
                t = t.select(keep)
        elif task.file_format == "warc":
            from .warc import read_warc_file
            # limit can only pre-apply when no residual filter runs after
            limit = task.pushdowns.limit if task.pushdowns.filters is None \
                else None
            t = read_warc_file(path, limit=limit)
            if phys_cols is not None:
                keep = [c for c in phys_cols if c in t.column_names]
                t = t.select(keep)
        else:
            raise ValueError(f"unknown format {task.file_format}")
        rb = RecordBatch.from_arrow_table(t)
        if task.partition_values:
            n = len(rb)
            extra = []
            for k, v in task.partition_values.items():
                if cols is not None and k not in cols:
                    continue
                if k in rb.schema:
                    continue
                dt = task.schema[k].dtype if k in task.schema else None
                s = Series.from_pylist([v] * n, k)
                if dt is not None:
                    s = s.cast(dt)
                extra.append(s)
            if extra:
                rb = RecordBatch.from_series(rb.columns() + extra)
        yield rb
