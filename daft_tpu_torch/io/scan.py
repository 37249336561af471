"""Scan planning: Pushdowns, ScanTask, the scan operators, glob scans.

The port's copy of ``daft_tpu/io/scan.py``. Reference:
``src/common/scan-info/src/scan_operator.rs:12-37`` (ScanOperator trait and
Pushdowns), ``src/daft-scan/src/lib.rs:417-436`` (ScanTask fields),
``src/daft-scan/src/glob.rs:28`` (GlobScanOperator with schema inference from
the first file, hive partition values from the paths) and
``src/daft-scan/src/scan_task_iters/`` (merge by size, split by row group).
Small files merge into one ScanTask and an oversized file splits into
row-group ranges (``scan_tasks_min_size_bytes``,
``scan_tasks_max_size_bytes``); a task streams one RecordBatch per file
(``readers.iter_scan_task_batches``). Every parquet footer is read once, at
planning, through the ranged open, and rides the task: a remote file's
footer is never fetched twice, and nothing downstream opens a path.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from ..datatype import DataType
from ..expressions import Expression
from ..recordbatch import RecordBatch
from ..schema import Field, Schema


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


def _is_remote(path: str) -> bool:
    return "://" in path and not path.startswith("file://")


class ScanTask:
    """One unit of scan work: one or more files of one format (a parquet
    file optionally pruned to some row groups) plus the pushdowns to apply
    while reading them, or a generator of batches (an in-memory, SQL or
    generator source). Small adjacent files share a task and an oversized
    parquet file splits into row-group ranges (:func:`merge_scan_tasks`,
    :func:`split_scan_tasks`)."""

    def __init__(self, paths: List[str], schema: Schema,
                 pushdowns: Pushdowns = Pushdowns(),
                 num_rows: Optional[int] = None,
                 size_bytes: Optional[int] = None,
                 row_groups: Optional[List[Optional[List[int]]]] = None,
                 metadata: Optional[list] = None, *,
                 file_format: str = "parquet",
                 format_options: Optional[Dict[str, Any]] = None,
                 partition_values: Optional[Dict[str, Any]] = None,
                 generator: Optional[Callable[[], Iterator[RecordBatch]]]
                 = None,
                 io_config: Any = None):
        self.paths = list(paths)
        #: each parquet file's footer, read once at planning (None: not
        #: read yet, or not parquet)
        self.metadata = metadata if metadata is not None \
            else [None] * len(self.paths)
        self.schema = schema
        self.pushdowns = pushdowns
        self._num_rows = num_rows
        self._size_bytes = size_bytes
        #: per file, the row groups to read (None: all of them); None for
        #: a task that reads every file whole
        self.row_groups = row_groups
        self.file_format = file_format
        self.format_options = format_options or {}
        #: hive partition values every row of the task carries
        self.partition_values = partition_values or {}
        self.generator = generator
        self.io_config = io_config

    def files(self) -> Iterator[Tuple[str, Any, Optional[List[int]]]]:
        """``(path, footer, row groups or None)`` for each file, in order:
        the footer cached at planning, else one read through the ranged
        open (a remote file costs its tail GETs, never a local open). The
        footer is None for a file that is not parquet."""
        for i, p in enumerate(self.paths):
            rg = self.row_groups[i] if self.row_groups is not None else None
            md = self.metadata[i]
            if md is None and self.file_format == "parquet" \
                    and self.generator is None:
                from .readers import read_footer
                md = self.metadata[i] = read_footer(p, self.io_config)
            yield p, md, rg

    def materialized_schema(self) -> Schema:
        if self.pushdowns.columns is not None:
            keep = [n for n in self.pushdowns.columns if n in self.schema]
            return self.schema.project(keep)
        return self.schema

    def num_rows(self) -> Optional[int]:
        if self.pushdowns.filters is not None:
            return None
        if self._num_rows is not None and self.pushdowns.limit is not None:
            return min(self._num_rows, self.pushdowns.limit)
        return self._num_rows

    def max_rows(self) -> Optional[int]:
        """The rows the task can yield at most: its footers', or its limit
        (the pushdown filter only removes rows); None when neither is
        known (a CSV or JSON file)."""
        if self.pushdowns.limit is not None:
            return self.pushdowns.limit if self._num_rows is None \
                else min(self._num_rows, self.pushdowns.limit)
        return self._num_rows

    def size_bytes(self) -> Optional[int]:
        return self._size_bytes

    def stream_batches(self) -> Iterator[RecordBatch]:
        """One RecordBatch per file (or per generated batch), with the
        residual filter applied and the limit counted across the files (a
        satisfied limit reads no further file). Yields nothing when every
        row is filtered out (``execute`` adds the empty batch)."""
        from . import readers
        src = self.generator() if self.generator is not None \
            else readers.iter_scan_task_batches(self)
        remaining = self.pushdowns.limit
        while remaining is None or remaining > 0:
            b = next(src, None)
            if b is None:
                return
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

    def _with(self, paths, num_rows, size_bytes, row_groups,
              metadata) -> "ScanTask":
        """A task of the same source and pushdowns over other files."""
        return ScanTask(paths, self.schema, self.pushdowns, num_rows,
                        size_bytes, row_groups, metadata,
                        file_format=self.file_format,
                        format_options=self.format_options,
                        partition_values=self.partition_values,
                        io_config=self.io_config)

    def __repr__(self):
        return (f"ScanTask({self.file_format}, {len(self.paths)} files, "
                f"rows={self._num_rows}, pushdowns={self.pushdowns})")


class ScanOperator:
    """Produces ScanTasks for a source (reference trait:
    scan_operator.rs:12-37)."""

    def schema(self) -> Schema:
        raise NotImplementedError

    def multiline_display(self) -> List[str]:
        return [type(self).__name__]

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        raise NotImplementedError


class GeneratorScanOperator(ScanOperator):
    """Scan over pre-resolved entries, each loaded by a callback (the
    shape the lake-format readers share: their file lists resolve at plan
    time and each entry materializes at execution).

    ``entries``: list of (paths, load_fn) where ``load_fn(pushdowns)``
    yields RecordBatches. ``prune_fn(entry_index, pushdowns)`` → False
    drops an entry at planning (stats pruning)."""

    def __init__(self, schema: Schema, entries, label: str,
                 io_config=None, prune_fn=None, entry_hints=None):
        self._schema = schema
        self._entries = entries
        self._label = label
        self._io_config = io_config
        self._prune_fn = prune_fn
        self._hints = entry_hints or [{} for _ in entries]

    def multiline_display(self) -> List[str]:
        return [self._label]

    def schema(self) -> Schema:
        return self._schema

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        tasks = []
        for i, (paths, load_fn) in enumerate(self._entries):
            if self._prune_fn is not None \
                    and not self._prune_fn(i, pushdowns):
                continue

            def gen(load_fn=load_fn):
                yield from load_fn(pushdowns)
            hint = self._hints[i]
            tasks.append(ScanTask(
                list(paths), self._schema, pushdowns, hint.get("rows"),
                hint.get("size"), file_format=hint.get("format", "parquet"),
                generator=gen, io_config=self._io_config))
        if not tasks:
            schema = self._schema
            tasks.append(ScanTask(
                [], schema, pushdowns, 0,
                generator=lambda: iter([_empty_batch(schema, pushdowns)])))
        return tasks


def _empty_batch(schema: Schema, pushdowns: Pushdowns) -> RecordBatch:
    if pushdowns.columns is not None:
        keep = [n for n in pushdowns.columns if n in schema]
        return RecordBatch.empty(schema.project(keep))
    return RecordBatch.empty(schema)


def glob_paths(path_or_paths, io_config=None) -> List[str]:
    """Local / file:// / remote glob expansion (reference
    ``object_store_glob.rs``). Local directories expand to their files; a
    remote path with a wildcard lists its store (an HTTP store has no
    listing: HTTP reads take explicit URLs)."""
    paths = [path_or_paths] if isinstance(path_or_paths, str) \
        else list(path_or_paths)
    out: List[str] = []
    for p in paths:
        if p.startswith("file://"):
            p = p[7:]
        if _is_remote(p):
            if any(ch in p for ch in "*?[]"):
                from .object_io import get_io_client
                out.extend(get_io_client(io_config).glob(p))
            else:
                out.append(p)
            continue
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


class GlobScanOperator(ScanOperator):
    """Scan over globbed files of one format, the schema inferred from the
    first file unless given (reference: ``glob.rs:28``), plus hive
    partition values from the paths (``hive.rs``)."""

    def __init__(self, paths, file_format: str = "parquet",
                 schema: Optional[Schema] = None,
                 format_options: Optional[Dict[str, Any]] = None,
                 hive_partitioning: bool = False,
                 io_config: Any = None):
        from . import readers
        self._io_config = io_config
        self._paths = glob_paths(paths, io_config)
        self._format = file_format
        self._options = format_options or {}
        self._hive = hive_partitioning
        self._hive_fields: Dict[str, DataType] = {}
        if schema is None:
            schema = readers.infer_schema(self._paths[0], file_format,
                                          self._options, io_config)
        if hive_partitioning:
            # the union of keys and types over ALL paths: the first path
            # alone would drop the partition columns of mixed-key layouts
            values: Dict[str, List[Any]] = {}
            for p in self._paths:
                for k, v in _hive_values(p).items():
                    values.setdefault(k, []).append(v)
            for k, vs in values.items():
                self._hive_fields[k] = DataType.infer_from_pylist(vs)
            schema = schema.non_distinct_union(
                Schema([Field(k, t) for k, t in self._hive_fields.items()]))
        self._schema = schema

    def schema(self) -> Schema:
        return self._schema

    def multiline_display(self) -> List[str]:
        return [f"GlobScanOperator({self._format})",
                f"paths = {self._paths[:3]}"
                f"{'…' if len(self._paths) > 3 else ''}"]

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        """One task per file (footers of remote files fetched on the IO
        pool, in order), then oversized files split and small ones merged
        to the configured sizes (reference ``io/scan.py:281``)."""
        from . import readers
        from ..context import get_context
        cfg = get_context().execution_config

        def plan_one(p: str) -> List[ScanTask]:
            pv = {}
            if self._hive:
                # every task carries the union's keys: a path lacking one
                # still materializes the column (as nulls)
                vals = _hive_values(p)
                pv = {k: vals.get(k) for k in self._hive_fields}
            return readers.make_scan_tasks(
                p, self._format, self._schema, pushdowns, self._options, pv,
                self._io_config)

        if sum(_is_remote(p) for p in self._paths) > 1:
            # a remote footer costs a round trip chain per file: fan them
            # out over the IO pool
            from .object_io import io_pool
            futs = [io_pool().submit(plan_one, p) for p in self._paths]
            groups = [f.result() for f in futs]
        else:
            groups = [plan_one(p) for p in self._paths]
        tasks = [t for g in groups for t in g]
        tasks = split_scan_tasks(tasks, cfg.scan_tasks_max_size_bytes,
                                 SPLIT_MAX_FILES)
        return merge_scan_tasks(tasks, cfg.scan_tasks_min_size_bytes,
                                cfg.scan_tasks_max_size_bytes,
                                MAX_FILES_PER_TASK)


def _hive_values(path: str) -> Dict[str, Any]:
    out = {}
    for part in path.split(os.sep):
        if "=" in part and not part.startswith("."):
            k, _, v = part.partition("=")
            if k and v and "." not in v:
                out[k] = v
    return out


def split_scan_tasks(tasks: List[ScanTask], max_size: int,
                     max_files: int) -> List[ScanTask]:
    """Split a whole-file parquet task above ``max_size`` into
    row-group-range tasks of at most ``max_size`` each (reference
    ``io/scan.py:327``). Only the first ``max_files`` oversized files
    split; a limit pushdown keeps the file whole (the limit is served from
    its head)."""
    out: List[ScanTask] = []
    budget = max_files
    for t in tasks:
        sz = t.size_bytes()
        if (t.file_format != "parquet" or t.generator is not None
                or len(t.paths) != 1 or t.pushdowns.limit is not None
                or t.row_groups is not None or sz is None or sz <= max_size
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
                out.append(t._with([path], grows, gsize, [group], [md]))
                group, gsize, grows = [], 0, 0
            group.append(g)
            gsize += rg.total_byte_size
            grows += rg.num_rows
        if group:
            out.append(t._with([path], grows, gsize, [group], [md]))
    return out


def merge_scan_tasks(tasks: List[ScanTask], min_size: int, max_size: int,
                     max_sources: int) -> List[ScanTask]:
    """Merge small adjacent whole-file tasks of one format and partition
    until one reaches ``min_size``, never past ``max_size`` or
    ``max_sources`` files (reference ``io/scan.py:372``): the scan's
    partition count follows the data's size, not its file count."""
    out: List[ScanTask] = []
    acc: Optional[ScanTask] = None
    acc_size = 0
    for t in tasks:
        sz = t.size_bytes() or max_size  # unknown or empty: stays alone
        limited = t.pushdowns.limit is not None
        if (acc is not None and not limited
                and acc_size + sz <= max_size
                and len(acc.paths) + len(t.paths) <= max_sources
                and acc.file_format == t.file_format
                and acc.generator is None and t.generator is None
                and acc.row_groups is None and t.row_groups is None
                and acc.partition_values == t.partition_values):
            acc = acc._with(acc.paths + t.paths,
                            None if (acc._num_rows is None
                                     or t._num_rows is None)
                            else acc._num_rows + t._num_rows,
                            acc_size + sz, None, acc.metadata + t.metadata)
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


class InMemoryScanOperator(ScanOperator):
    """Scan over already-materialized partitions (cache entries)."""

    def __init__(self, schema: Schema, partitions):
        self._schema = schema
        self._parts = partitions

    def schema(self) -> Schema:
        return self._schema

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        tasks = []
        for p in self._parts:
            def gen(p=p):
                return iter(p.batches())
            tasks.append(ScanTask([], self._schema, pushdowns,
                                  p.metadata_num_rows(),
                                  file_format="memory", generator=gen))
        return tasks
