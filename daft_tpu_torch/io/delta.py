"""Native Delta Lake table reader — no SDK required.

The reference reads Delta through the ``deltalake`` Python package
(``daft/io/_deltalake.py``, ``daft/delta_lake/``); this module needs no
SDK: the transaction log is replayed directly (the Delta protocol's
reader path is simple): list ``_delta_log/``, start from the latest
``*.checkpoint.parquet`` (if any), apply newer ``NNNNNNNNNN.json`` commits
in order, accumulate ``add`` actions minus ``remove`` actions, take the
schema from the latest ``metaData`` action, and scan the surviving parquet
files with their partition values (partition columns are not stored in the
data files).

The port's copy of ``daft_tpu/io/delta.py``; host-only (no device work).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import pyarrow.parquet as pq

from ..datatype import DataType
from ..schema import Field, Schema
from .scan import Pushdowns, ScanOperator, ScanTask

_COMMIT_RE = re.compile(r"^(\d{20})\.json$")
_CHECKPOINT_RE = re.compile(r"^(\d{20})\.checkpoint(\.\d+\.\d+)?\.parquet$")

_DELTA_PRIMITIVES = {
    "string": DataType.string, "long": DataType.int64,
    "integer": DataType.int32, "short": DataType.int16,
    "byte": DataType.int8, "float": DataType.float32,
    "double": DataType.float64, "boolean": DataType.bool,
    "binary": DataType.binary, "date": DataType.date,
    "timestamp": lambda: DataType.timestamp("us", "UTC"),
    "timestamp_ntz": lambda: DataType.timestamp("us"),
}


def _delta_type(t) -> DataType:
    if isinstance(t, str):
        if t in _DELTA_PRIMITIVES:
            return _DELTA_PRIMITIVES[t]()
        m = re.match(r"decimal\((\d+),\s*(\d+)\)", t)
        if m:
            return DataType.decimal128(int(m.group(1)), int(m.group(2)))
        raise ValueError(f"unsupported delta type {t!r}")
    kind = t.get("type")
    if kind == "struct":
        return DataType.struct(
            {f["name"]: _delta_type(f["type"]) for f in t["fields"]})
    if kind == "array":
        return DataType.list(_delta_type(t["elementType"]))
    if kind == "map":
        return DataType.map(_delta_type(t["keyType"]),
                            _delta_type(t["valueType"]))
    raise ValueError(f"unsupported delta type {t!r}")


def _schema_from_metadata(meta: Dict[str, Any]) -> Tuple[Schema, List[str]]:
    struct = json.loads(meta["schemaString"])
    fields = [Field(f["name"], _delta_type(f["type"]))
              for f in struct["fields"]]
    return Schema(fields), list(meta.get("partitionColumns") or [])


def _coerce_partition_value(v: Optional[str], dtype: DataType):
    if v is None:
        return None
    if dtype.is_string():
        return v  # "" is a legitimate string partition value, not null
    if v == "":
        return None
    if dtype.is_integer():
        return int(v)
    if dtype.kind in ("float32", "float64"):
        return float(v)
    if dtype.is_boolean():
        return v.lower() == "true"
    return v


class DeltaScanOperator(ScanOperator):
    """Scan over the live ``add`` files of a Delta table snapshot."""

    def __init__(self, table_uri: str, version: Optional[int] = None):
        self._uri = table_uri.rstrip("/")
        log_dir = os.path.join(self._uri, "_delta_log")
        if not os.path.isdir(log_dir):
            raise FileNotFoundError(
                f"not a Delta table (no _delta_log): {table_uri!r}")
        self._version, adds, meta = self._replay(log_dir, version)
        if meta is None:
            raise ValueError(f"Delta log has no metaData action: {log_dir}")
        self._schema, self._partition_cols = _schema_from_metadata(meta)
        self._adds = adds  # path -> partitionValues

    # ------------------------------------------------------------------
    def _replay(self, log_dir: str, want_version: Optional[int]):
        entries = os.listdir(log_dir)
        commits = sorted((int(m.group(1)), f) for f in entries
                         if (m := _COMMIT_RE.match(f)))
        checkpoints = sorted((int(m.group(1)), f) for f in entries
                             if (m := _CHECKPOINT_RE.match(f)))
        if want_version is not None:
            commits = [(v, f) for v, f in commits if v <= want_version]
            checkpoints = [(v, f) for v, f in checkpoints
                           if v <= want_version]
        adds: Dict[str, Dict[str, Any]] = {}
        meta = None
        start = 0
        if checkpoints:
            cv = checkpoints[-1][0]
            # a checkpoint may be multi-part: replay EVERY part at that
            # version (add actions are spread across the parts)
            parts = [f for v, f in checkpoints if v == cv]
            for cf in parts:
                t = pq.read_table(os.path.join(log_dir, cf))
                for row in t.to_pylist():
                    if row.get("metaData") \
                            and row["metaData"].get("schemaString"):
                        meta = row["metaData"]
                    add = row.get("add")
                    if add and add.get("path"):
                        adds[add["path"]] = add.get("partitionValues") or {}
                    rem = row.get("remove")
                    if rem and rem.get("path"):
                        adds.pop(rem["path"], None)
            start = cv + 1
        version = checkpoints[-1][0] if checkpoints else -1
        for v, f in commits:
            if v < start:
                continue
            version = v
            with open(os.path.join(log_dir, f)) as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    action = json.loads(line)
                    if "metaData" in action:
                        meta = action["metaData"]
                    elif "add" in action:
                        adds[action["add"]["path"]] = \
                            action["add"].get("partitionValues") or {}
                    elif "remove" in action:
                        adds.pop(action["remove"]["path"], None)
        return version, adds, meta

    # ------------------------------------------------------------------
    @property
    def version(self) -> int:
        return self._version

    def schema(self) -> Schema:
        return self._schema

    def partitioning_keys(self) -> List[str]:
        return list(self._partition_cols)

    def multiline_display(self) -> List[str]:
        return [f"DeltaScanOperator(v{self._version})",
                f"uri = {self._uri}"]

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        from . import readers
        tasks: List[ScanTask] = []
        for rel_path, pvals in sorted(self._adds.items()):
            path = os.path.join(self._uri, rel_path)
            coerced = {}
            for c in self._partition_cols:
                dt = self._schema[c].dtype
                coerced[c] = _coerce_partition_value(pvals.get(c), dt)
            tasks.extend(readers.make_scan_tasks(
                path, "parquet", self._schema, pushdowns, {}, coerced))
        if not tasks:
            tasks = [ScanTask([], "parquet", self._schema, pushdowns, 0, 0,
                              generator=lambda: iter(()))]
        return tasks


def read_deltalake(table_uri: str, version: Optional[int] = None,
                   io_config: Any = None, **kwargs):
    """Read a Delta Lake table snapshot into a DataFrame (reference API:
    ``daft/io/_deltalake.py``; implementation is the native log replay
    above — local paths only until remote listing is wired)."""
    from ..dataframe import DataFrame
    from ..logical.builder import LogicalPlanBuilder
    return DataFrame(LogicalPlanBuilder.from_scan(
        DeltaScanOperator(table_uri, version)))


# ---------------------------------------------------------------------------
# writer


def _dtype_to_delta(dt: DataType):
    inverse = {"string": "string", "int64": "long", "int32": "integer",
               "int16": "short", "int8": "byte", "float32": "float",
               "float64": "double", "bool": "boolean", "binary": "binary",
               "date": "date"}
    if dt.kind in inverse:
        return inverse[dt.kind]
    if dt.kind == "timestamp":
        return "timestamp"
    if dt.is_decimal():
        p, s = dt._params[0], dt._params[1]
        return f"decimal({p},{s})"
    raise ValueError(f"cannot map {dt!r} to a Delta type")


def write_deltalake(df, table_uri: str, mode: str = "append",
                    io_config: Any = None, **kwargs):
    """Commit a DataFrame to a Delta table (reference API:
    ``DataFrame.write_deltalake``). Creates the table (protocol v1 +
    metaData) on first write; ``overwrite`` removes the previous snapshot's
    files in the same commit. Unpartitioned writes only."""
    import time
    import uuid as _uuid

    from ..recordbatch import RecordBatch

    uri = table_uri.rstrip("/")
    log_dir = os.path.join(uri, "_delta_log")
    os.makedirs(log_dir, exist_ok=True)
    entries = os.listdir(log_dir)
    existing = sorted(
        {int(m.group(1)) for f in entries if (m := _COMMIT_RE.match(f))}
        | {int(m.group(1)) for f in entries
           if (m := _CHECKPOINT_RE.match(f))})
    version = (existing[-1] + 1) if existing else 0
    now_ms = int(time.time() * 1000)

    actions: List[str] = []
    if version > 0 and mode == "error":
        raise FileExistsError(f"Delta table already exists: {uri}")
    if version == 0:
        schema = df.schema()
        schema_string = json.dumps({
            "type": "struct",
            "fields": [{"name": f.name, "type": _dtype_to_delta(f.dtype),
                        "nullable": True, "metadata": {}} for f in schema]})
        actions.append(json.dumps({"protocol": {
            "minReaderVersion": 1, "minWriterVersion": 2}}))
        actions.append(json.dumps({"metaData": {
            "id": _uuid.uuid4().hex, "format": {"provider": "parquet",
                                                "options": {}},
            "schemaString": schema_string, "partitionColumns": [],
            "configuration": {}, "createdTime": now_ms}}))
    elif mode == "overwrite":
        op = DeltaScanOperator(uri)
        for rel in sorted(op._adds):
            actions.append(json.dumps({"remove": {
                "path": rel, "deletionTimestamp": now_ms,
                "dataChange": True}}))

    from ..context import get_context
    parts = get_context().get_or_create_runner().run(df._builder).partitions
    written = 0
    for i, p in enumerate(parts):
        rb = p.combined() if not isinstance(p, RecordBatch) else p
        if len(rb) == 0:
            continue
        rel = f"part-{version:05d}-{i:05d}-{_uuid.uuid4().hex[:8]}.parquet"
        full = os.path.join(uri, rel)
        pq.write_table(rb.to_arrow_table(), full)
        actions.append(json.dumps({"add": {
            "path": rel, "partitionValues": {},
            "size": os.path.getsize(full), "modificationTime": now_ms,
            "dataChange": True}}))
        written += len(rb)
    actions.append(json.dumps({"commitInfo": {
        "timestamp": now_ms, "operation": "WRITE",
        "operationParameters": {"mode": mode}, "engineInfo": "daft-tpu-torch"}}))
    with open(os.path.join(log_dir, f"{version:020d}.json"), "w") as fh:
        fh.write("\n".join(actions) + "\n")
    return {"version": version, "rows_written": written}
