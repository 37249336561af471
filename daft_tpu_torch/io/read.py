"""Public read_* entry points (reference: ``daft/io/_parquet.py`` etc.).

The port's copy of ``daft_tpu/io/read.py``, the lake formats
(``read_deltalake``, ``read_iceberg``, ``read_hudi``, ``read_lance``)
included.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from ..schema import Schema
from .scan import GlobScanOperator


def _df_from_scan(op):
    from ..dataframe import DataFrame
    from ..logical.builder import LogicalPlanBuilder
    return DataFrame(LogicalPlanBuilder.from_scan(op))


def read_parquet(path: Union[str, List[str]],
                 schema: Optional[Dict[str, Any]] = None,
                 hive_partitioning: bool = False,
                 io_config: Any = None,
                 **kwargs):
    """Lazily read Parquet file(s) into a DataFrame
    (reference: ``daft/io/_parquet.py:20``)."""
    sch = Schema.from_pydict(schema) if isinstance(schema, dict) else schema
    return _df_from_scan(GlobScanOperator(
        path, "parquet", schema=sch, hive_partitioning=hive_partitioning,
        io_config=io_config))


def read_csv(path: Union[str, List[str]],
             has_headers: bool = True,
             delimiter: Optional[str] = None,
             schema: Optional[Dict[str, Any]] = None,
             quote: Optional[str] = None,
             escape_char: Optional[str] = None,
             allow_variable_columns: bool = False,
             hive_partitioning: bool = False,
             io_config: Any = None,
             **kwargs):
    sch = Schema.from_pydict(schema) if isinstance(schema, dict) else schema
    opts = {"has_headers": has_headers, "delimiter": delimiter,
            "quote": quote, "escape_char": escape_char,
            "allow_variable_columns": allow_variable_columns,
            "schema": sch}
    return _df_from_scan(GlobScanOperator(
        path, "csv", schema=sch, format_options=opts,
        hive_partitioning=hive_partitioning, io_config=io_config))


def read_json(path: Union[str, List[str]],
              schema: Optional[Dict[str, Any]] = None,
              hive_partitioning: bool = False,
              io_config: Any = None,
              **kwargs):
    sch = Schema.from_pydict(schema) if isinstance(schema, dict) else schema
    return _df_from_scan(GlobScanOperator(
        path, "json", schema=sch, hive_partitioning=hive_partitioning,
        io_config=io_config))


def read_warc(path: Union[str, List[str]],
              io_config: Any = None,
              **kwargs):
    """Lazily read WARC / gzipped-WARC file(s) into a DataFrame with the
    fixed 7-column WARC schema (reference: ``daft/io/_warc.py:20``)."""
    import warnings
    if io_config is not None or kwargs:
        # remote WARC paths (e.g. Common Crawl on S3) are not wired yet —
        # don't let an IOConfig silently degrade to local-glob behavior
        warnings.warn(
            "read_warc currently reads local paths only; io_config and "
            f"extra options {sorted(kwargs) or ''} are ignored",
            stacklevel=2)
    from .warc import WARC_SCHEMA
    return _df_from_scan(GlobScanOperator(path, "warc", schema=WARC_SCHEMA))


def read_deltalake(table_uri, version=None, io_config: Any = None, **kwargs):
    """Delta Lake snapshot read (``io/delta.py``)."""
    from .delta import read_deltalake as _impl
    return _impl(table_uri, version, io_config, **kwargs)


def read_iceberg(table, snapshot_id: Optional[int] = None,
                 io_config: Any = None, **kwargs):
    """Read an Apache Iceberg table (``io/iceberg.py``): ``table`` is a
    warehouse path or metadata JSON URI, or a pyiceberg-style object
    exposing ``metadata_location``."""
    from .iceberg import read_iceberg as _impl
    uri = getattr(table, "metadata_location", table)
    if not isinstance(uri, str):
        raise TypeError(f"read_iceberg expects a table path or an object "
                        f"with .metadata_location, got {type(table)!r}")
    return _impl(uri, snapshot_id=snapshot_id, io_config=io_config)


def read_hudi(table_uri: str, io_config: Any = None,
              query_type: str = "snapshot", **kwargs):
    """Read an Apache Hudi table's latest snapshot (``io/hudi.py``):
    Copy-on-Write, and Merge-on-Read with log-file merging
    (``query_type='read_optimized'`` for base files only)."""
    if kwargs:
        raise TypeError(f"read_hudi: unsupported options {sorted(kwargs)} "
                        f"(incremental options are not implemented)")
    from .hudi import read_hudi as _impl
    return _impl(table_uri, io_config=io_config, query_type=query_type)


def read_lance(uri: str, version: Optional[int] = None,
               io_config=None):
    """Read a Lance dataset (``io/lance.py``): versioned column-page
    datasets with projection, limit and filter pushdown."""
    from .lance import read_lance as _impl
    return _impl(uri, version=version, io_config=io_config)


def read_sql(sql: str, conn, partition_col: Optional[str] = None,
             num_partitions: Optional[int] = None, **kwargs):
    """Read from a SQL database via a user-supplied connection factory
    (reference: ``daft/io/_sql.py`` over connectorx/sqlalchemy). ``conn``
    is a zero-arg callable returning a DB-API connection. With
    ``partition_col`` + ``num_partitions`` the read splits into range
    predicates over the column, fetched lazily per scan task (the
    reference's partitioned-read path)."""
    import pyarrow as pa

    from ..dataframe import DataFrame
    from ..logical.builder import LogicalPlanBuilder
    from ..recordbatch import RecordBatch
    from .scan import Pushdowns, ScanOperator, ScanTask

    if not callable(conn):
        raise TypeError("conn must be a zero-arg callable returning a "
                        "DB-API connection")

    def fetch(query: str) -> "RecordBatch":
        c = conn()
        try:
            cur = c.cursor()
            cur.execute(query)
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            c.close()
        data = {nm: [r[i] for r in rows] for i, nm in enumerate(cols)}
        return RecordBatch.from_arrow_table(pa.table(data))

    # schema from a one-row probe (a zero-row probe would type every
    # column null); full results stay lazy in the scan tasks
    try:
        probe = fetch(f"SELECT * FROM ({sql}) LIMIT 1")
    except Exception:
        probe = fetch(sql)
    schema = probe.schema

    def make_task(query: str, pushdowns: Pushdowns) -> ScanTask:
        return ScanTask([], schema, pushdowns, file_format="sql",
                        generator=lambda q=query: iter([fetch(q)]))

    class _SQLScan(ScanOperator):
        def schema(self):
            return schema

        def multiline_display(self):
            return [f"SQLScanOperator({sql[:40]!r})"]

        def to_scan_tasks(self, pushdowns: Pushdowns):
            if partition_col is None or not num_partitions \
                    or num_partitions <= 1:
                return [make_task(sql, pushdowns)]
            bounds = fetch(f"SELECT MIN({partition_col}), "
                           f"MAX({partition_col}) FROM ({sql})")
            row = bounds.to_arrow_table().to_pylist()[0]
            lo, hi = list(row.values())
            if lo is None or hi is None or lo == hi:
                return [make_task(sql, pushdowns)]
            step = (hi - lo) / num_partitions
            tasks = []
            for i in range(num_partitions):
                a = lo + step * i
                b = lo + step * (i + 1)
                last = i == num_partitions - 1
                cond = (f"{partition_col} >= {a!r} AND "
                        + (f"{partition_col} <= {hi!r}" if last
                           else f"{partition_col} < {b!r}"))
                tasks.append(make_task(
                    f"SELECT * FROM ({sql}) WHERE {cond}", pushdowns))
            return tasks

    return DataFrame(LogicalPlanBuilder.from_scan(_SQLScan()))
