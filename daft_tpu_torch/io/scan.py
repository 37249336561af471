"""Scan planning and the local parquet reader: Pushdowns, ScanTask,
GlobScanOperator.

Reference: ``src/common/scan-info/src/scan_operator.rs:12-37`` (Pushdowns),
``src/daft-scan/src/lib.rs:417-436`` (ScanTask), ``src/daft-scan/src/glob.rs:28``
(GlobScanOperator with schema inference from the first file) and
``src/daft-parquet/src/statistics`` (row-group pruning). The port reads local
parquet only: one ScanTask per file, streamed as one RecordBatch per file.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Iterator, List, Optional, Sequence, Tuple

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


class ScanTask:
    """One parquet file (optionally pruned to some row groups) plus the
    pushdowns to apply while reading it."""

    def __init__(self, path: str, schema: Schema, pushdowns: Pushdowns,
                 num_rows: int, size_bytes: int,
                 row_groups: Optional[List[int]] = None):
        self.path = path
        self.schema = schema
        self.pushdowns = pushdowns
        self._num_rows = num_rows
        self._size_bytes = size_bytes
        self.row_groups = row_groups

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

    def size_bytes(self) -> int:
        return self._size_bytes

    def stream_batches(self) -> Iterator[RecordBatch]:
        """The file as one RecordBatch, with the residual filter and limit
        applied. Yields nothing when every row is filtered out."""
        f = pq.ParquetFile(self.path)
        cols = None
        if self.pushdowns.columns is not None:
            names = set(f.schema_arrow.names)
            cols = [c for c in self.pushdowns.columns if c in names]
        if self.row_groups is None:
            t = f.read(columns=cols)
        elif self.row_groups:
            t = f.read_row_groups(self.row_groups, columns=cols)
        else:
            return
        b = RecordBatch.from_arrow_table(t)
        if self.pushdowns.filters is not None:
            b = b.filter(self.pushdowns.filters)
        if self.pushdowns.limit is not None:
            b = b.head(self.pushdowns.limit)
        if len(b):
            yield b

    def execute(self) -> List[RecordBatch]:
        out = list(self.stream_batches())
        if not out:
            return [RecordBatch.empty(self.materialized_schema())]
        return out

    def __repr__(self):
        return (f"ScanTask({self.path}, rows={self._num_rows}, "
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
        tasks = []
        for p in self._paths:
            md = pq.ParquetFile(p).metadata
            groups = _prune_row_groups(md, pushdowns.filters)
            keep = groups if groups is not None \
                else range(md.num_row_groups)
            tasks.append(ScanTask(
                p, self._schema, pushdowns,
                sum(md.row_group(g).num_rows for g in keep),
                sum(md.row_group(g).total_byte_size for g in keep), groups))
        return tasks


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
