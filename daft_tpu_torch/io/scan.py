"""Scan planning and the local parquet reader: Pushdowns, ScanTask,
GlobScanOperator.

Reference: ``src/common/scan-info/src/scan_operator.rs:12-37`` (Pushdowns),
``src/daft-scan/src/lib.rs:417-436`` (ScanTask), ``src/daft-scan/src/glob.rs:28``
(GlobScanOperator with schema inference from the first file) and
``src/daft-parquet/src/statistics`` (row-group pruning). The port reads local
parquet only. Small files merge into one ScanTask and an oversized file splits
into row-group ranges, as in the reference (``scan_tasks_min_size_bytes``,
``scan_tasks_max_size_bytes``); a task streams one RecordBatch per file.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import pyarrow.parquet as pq

from ..expressions import Expression
from ..recordbatch import RecordBatch
from ..schema import Schema


@dataclasses.dataclass(frozen=True)
class Pushdowns:
    """Pushed-down scan constraints (reference: ``pushdowns.rs``)."""

    filters: Optional[Expression] = None
    partition_filters: Optional[Expression] = None
    columns: Optional[Tuple[str, ...]] = None
    limit: Optional[int] = None

    def with_columns(self, columns: Optional[Sequence[str]]) -> "Pushdowns":
        return dataclasses.replace(
            self, columns=tuple(columns) if columns is not None else None)

    def with_limit(self, limit: Optional[int]) -> "Pushdowns":
        return dataclasses.replace(self, limit=limit)

    def with_filters(self, filters: Optional[Expression]) -> "Pushdowns":
        return dataclasses.replace(self, filters=filters)


#: the most files one merged task reads, and the most oversized files a
#: scan splits into row-group ranges (the reference's config defaults,
#: ``max_sources_per_scan_task`` and ``parquet_split_row_groups_max_files``)
MAX_FILES_PER_TASK = 10
SPLIT_MAX_FILES = 10


class ScanTask:
    """One unit of scan work: one or more parquet files (each optionally
    pruned to some row groups) plus the pushdowns to apply while reading
    them. Small adjacent files share a task and an oversized file splits
    into row-group ranges (:func:`merge_scan_tasks`,
    :func:`split_scan_tasks`)."""

    def __init__(self, paths: List[str], schema: Schema, pushdowns: Pushdowns,
                 num_rows: int, size_bytes: int,
                 row_groups: Optional[List[Optional[List[int]]]] = None,
                 metadata: Optional[list] = None):
        self.paths = list(paths)
        #: each file's parquet footer, read once at planning
        self.metadata = metadata if metadata is not None \
            else [None] * len(self.paths)
        self.schema = schema
        self.pushdowns = pushdowns
        self._num_rows = num_rows
        self._size_bytes = size_bytes
        #: per file, the row groups to read (None: all of them); None for
        #: a task that reads every file whole
        self.row_groups = row_groups

    def files(self) -> Iterator[Tuple[str, Any, Optional[List[int]]]]:
        """``(path, footer, row groups or None)`` for each file, in order."""
        for i, p in enumerate(self.paths):
            rg = self.row_groups[i] if self.row_groups is not None else None
            md = self.metadata[i]
            yield p, md if md is not None else pq.ParquetFile(p).metadata, rg

    def materialized_schema(self) -> Schema:
        if self.pushdowns.columns is not None:
            keep = [n for n in self.pushdowns.columns if n in self.schema]
            return self.schema.project(keep)
        return self.schema

    def num_rows(self) -> Optional[int]:
        if self.pushdowns.filters is not None:
            return None
        if self.pushdowns.limit is not None:
            return min(self._num_rows, self.pushdowns.limit)
        return self._num_rows

    def max_rows(self) -> int:
        """The rows the task can yield at most: its footers', or its limit
        (the pushdown filter only removes rows)."""
        if self.pushdowns.limit is not None:
            return min(self._num_rows, self.pushdowns.limit)
        return self._num_rows

    def size_bytes(self) -> int:
        return self._size_bytes

    def stream_batches(self) -> Iterator[RecordBatch]:
        """One RecordBatch per file, with the residual filter applied and
        the limit counted across the files (a satisfied limit reads no
        further file). Yields nothing when every row is filtered out."""
        remaining = self.pushdowns.limit
        for i, path in enumerate(self.paths):
            if remaining is not None and remaining <= 0:
                return
            f = pq.ParquetFile(path)
            cols = None
            if self.pushdowns.columns is not None:
                names = set(f.schema_arrow.names)
                cols = [c for c in self.pushdowns.columns if c in names]
            groups = self.row_groups[i] if self.row_groups is not None \
                else None
            if groups is None:
                t = f.read(columns=cols)
            elif groups:
                t = f.read_row_groups(groups, columns=cols)
            else:
                continue
            b = RecordBatch.from_arrow_table(t)
            if self.pushdowns.filters is not None:
                b = b.filter(self.pushdowns.filters)
            if remaining is not None:
                b = b.head(remaining)
                remaining -= len(b)
            if len(b):
                yield b

    def execute(self) -> List[RecordBatch]:
        out = list(self.stream_batches())
        if not out:
            return [RecordBatch.empty(self.materialized_schema())]
        return out

    def __repr__(self):
        return (f"ScanTask({len(self.paths)} files, rows={self._num_rows}, "
                f"pushdowns={self.pushdowns})")


class GlobScanOperator:
    """Scan over globbed local parquet files, schema from the first file."""

    def __init__(self, paths):
        self._paths = glob_paths(paths)
        self._schema = Schema.from_arrow(pq.read_schema(self._paths[0]))

    def schema(self) -> Schema:
        return self._schema

    def multiline_display(self) -> List[str]:
        return ["GlobScanOperator(parquet)",
                f"paths = {self._paths[:3]}"
                f"{'…' if len(self._paths) > 3 else ''}"]

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        """One task per file, then oversized files split and small ones
        merged to the configured sizes (reference ``io/scan.py:306``)."""
        from ..context import get_context
        cfg = get_context().execution_config
        tasks = []
        for p in self._paths:
            md = pq.ParquetFile(p).metadata
            groups = _prune_row_groups(md, pushdowns.filters)
            keep = groups if groups is not None \
                else range(md.num_row_groups)
            tasks.append(ScanTask(
                [p], self._schema, pushdowns,
                sum(md.row_group(g).num_rows for g in keep),
                sum(md.row_group(g).total_byte_size for g in keep),
                [groups] if groups is not None else None, [md]))
        tasks = split_scan_tasks(tasks, cfg.scan_tasks_max_size_bytes,
                                 SPLIT_MAX_FILES)
        return merge_scan_tasks(tasks, cfg.scan_tasks_min_size_bytes,
                                cfg.scan_tasks_max_size_bytes,
                                MAX_FILES_PER_TASK)


def split_scan_tasks(tasks: List[ScanTask], max_size: int,
                     max_files: int) -> List[ScanTask]:
    """Split a whole-file task above ``max_size`` into row-group-range
    tasks of at most ``max_size`` each (reference ``io/scan.py:327``).
    Only the first ``max_files`` oversized files split; a limit pushdown
    keeps the file whole (the limit is served from its head)."""
    out: List[ScanTask] = []
    budget = max_files
    for t in tasks:
        if (len(t.paths) != 1 or t.pushdowns.limit is not None
                or t.row_groups is not None or t.size_bytes() <= max_size
                or budget <= 0):
            out.append(t)
            continue
        budget -= 1
        path, md, _ = next(t.files())
        if md.num_row_groups <= 1:
            out.append(t)
            continue
        group: List[int] = []
        gsize = grows = 0
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            if group and gsize + rg.total_byte_size > max_size:
                out.append(ScanTask([path], t.schema, t.pushdowns, grows,
                                    gsize, [group], [md]))
                group, gsize, grows = [], 0, 0
            group.append(g)
            gsize += rg.total_byte_size
            grows += rg.num_rows
        if group:
            out.append(ScanTask([path], t.schema, t.pushdowns, grows, gsize,
                                [group], [md]))
    return out


def merge_scan_tasks(tasks: List[ScanTask], min_size: int, max_size: int,
                     max_sources: int) -> List[ScanTask]:
    """Merge small adjacent whole-file tasks until one reaches
    ``min_size``, never past ``max_size`` or ``max_sources`` files
    (reference ``io/scan.py:372``): the scan's partition count follows
    the data's size, not its file count."""
    out: List[ScanTask] = []
    acc: Optional[ScanTask] = None
    acc_size = 0
    for t in tasks:
        sz = t.size_bytes() or max_size  # an empty file stays alone
        limited = t.pushdowns.limit is not None
        if (acc is not None and not limited
                and acc_size + sz <= max_size
                and len(acc.paths) + len(t.paths) <= max_sources
                and acc.row_groups is None and t.row_groups is None):
            acc = ScanTask(acc.paths + t.paths, acc.schema, acc.pushdowns,
                           acc._num_rows + t._num_rows, acc_size + sz, None,
                           acc.metadata + t.metadata)
            acc_size += sz
            if acc_size >= min_size:
                out.append(acc)
                acc, acc_size = None, 0
            continue
        if acc is not None:
            out.append(acc)
            acc, acc_size = None, 0
        if sz >= min_size or limited:
            out.append(t)
        else:
            acc, acc_size = t, sz
    if acc is not None:
        out.append(acc)
    return out


def glob_paths(path_or_paths) -> List[str]:
    """Local / file:// glob expansion (reference ``object_store_glob.rs``).
    Directories expand to their files."""
    paths = [path_or_paths] if isinstance(path_or_paths, str) else list(path_or_paths)
    out: List[str] = []
    for p in paths:
        if p.startswith("file://"):
            p = p[7:]
        if "://" in p:
            raise NotImplementedError(
                f"{p!r}: the port reads local files only")
        if any(ch in p for ch in "*?[]"):
            matches = sorted(_glob.glob(p, recursive=True))
            out.extend(m for m in matches if os.path.isfile(m))
        elif os.path.isdir(p):
            for root, _, files in sorted(os.walk(p)):
                for f in sorted(files):
                    if not f.startswith((".", "_")):
                        out.append(os.path.join(root, f))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files found for {path_or_paths!r}")
    return out


def _prune_row_groups(md, filters: Optional[Expression]
                      ) -> Optional[List[int]]:
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
