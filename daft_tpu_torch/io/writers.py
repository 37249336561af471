"""File writers: parquet / csv / json, plain + hive-partitioned.

The port's copy of ``daft_tpu/io/writers.py``. Reference:
``src/daft-writers`` (AsyncFileWriter trait ``lib.rs:57-72``, target-size
batching ``batch.rs``, partitioned writes ``partition.rs``).
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, List, Optional

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq

from ..expressions import Expression
from ..micropartition import MicroPartition
from ..recordbatch import RecordBatch
from ..series import Series


#: the writers' target file sizes and the in-memory/on-disk byte ratio of
#: each format (the reference's config defaults, ``parquet_target_filesize``,
#: ``parquet_inflation_factor``, ``csv_target_filesize`` and
#: ``csv_inflation_factor``)
PARQUET_TARGET_FILESIZE = 512 * 1024 * 1024
PARQUET_INFLATION_FACTOR = 3.0
CSV_TARGET_FILESIZE = 512 * 1024 * 1024
CSV_INFLATION_FACTOR = 0.5


def _new_filename(fmt: str, idx: int = 0) -> str:
    ext = {"parquet": "parquet", "csv": "csv", "json": "json"}[fmt]
    return f"{uuid.uuid4().hex}-{idx}.{ext}"


def _target_row_chunks(rb: RecordBatch, fmt: str) -> List[RecordBatch]:
    """Split a batch so each output file lands near the configured target
    size (reference: ``src/daft-writers/src/batch.rs`` TargetBatchWriter —
    estimated via in-memory bytes over the format's inflation factor)."""
    # inflation factor = in-memory bytes / on-disk bytes for the format, so
    # the in-memory chunk that lands near the file target is target × factor
    if fmt == "parquet":
        target = PARQUET_TARGET_FILESIZE * PARQUET_INFLATION_FACTOR
    elif fmt == "csv":
        target = CSV_TARGET_FILESIZE * CSV_INFLATION_FACTOR
    else:
        target = PARQUET_TARGET_FILESIZE
    nbytes = rb.size_bytes() or 0
    n = len(rb)
    if n == 0 or nbytes <= target:
        return [rb]
    rows_per_file = max(int(n * target / nbytes), 1)
    return [rb.slice(i, min(i + rows_per_file, n))
            for i in range(0, n, rows_per_file)]


def _write_table(t: pa.Table, fmt: str, path: str,
                 options: Optional[Dict[str, Any]] = None) -> int:
    if fmt == "parquet":
        pq.write_table(t, path, compression=(options or {}).get(
            "compression", "snappy"))
    elif fmt == "csv":
        pacsv.write_csv(t, path)
    elif fmt == "json":
        import json
        rows = t.to_pylist()
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r, default=str) + "\n")
    return os.path.getsize(path)


def write_micropartition(mp: MicroPartition, fmt: str, root_dir: str,
                         partition_cols: Optional[List[Expression]] = None,
                         options: Optional[Dict[str, Any]] = None
                         ) -> RecordBatch:
    """Write one partition; returns a RecordBatch of written file paths
    (the reference's write ops also stream back path manifests)."""
    os.makedirs(root_dir, exist_ok=True)
    rb = mp.combined()
    paths: List[str] = []
    part_values_rows: List[Dict[str, Any]] = []
    if partition_cols:
        parts, pvalues = rb.partition_by_value(partition_cols)
        names = pvalues.column_names()
        for i, part in enumerate(parts):
            if len(part) == 0:
                continue
            vals = {n: pvalues.get_column(n).to_pylist()[i] for n in names}
            subdir = os.path.join(
                root_dir, *[f"{k}={_hive_str(v)}" for k, v in vals.items()])
            os.makedirs(subdir, exist_ok=True)
            drop = [c for c in part.column_names() if c in vals]
            for j, chunk in enumerate(_target_row_chunks(part, fmt)):
                p = os.path.join(subdir, _new_filename(fmt, j))
                _write_table(chunk.to_arrow_table().drop_columns(drop),
                             fmt, p, options)
                paths.append(p)
                part_values_rows.append(vals)
    else:
        if len(rb):
            for j, chunk in enumerate(_target_row_chunks(rb, fmt)):
                p = os.path.join(root_dir, _new_filename(fmt, j))
                _write_table(chunk.to_arrow_table(), fmt, p, options)
                paths.append(p)
    cols = [Series.from_pylist(paths, "path")]
    if partition_cols and part_values_rows:
        for n in part_values_rows[0]:
            cols.append(Series.from_pylist(
                [r[n] for r in part_values_rows], n))
    return RecordBatch.from_series(cols)


def _hive_str(v) -> str:
    return "__HIVE_DEFAULT_PARTITION__" if v is None else str(v)


def overwrite_dir(root_dir: str):
    """WriteMode=overwrite: clear prior files (reference: write modes,
    ``tests/io/test_write_modes.py`` behavior)."""
    if os.path.isdir(root_dir):
        for root, dirs, files in os.walk(root_dir):
            for f in files:
                os.unlink(os.path.join(root, f))
