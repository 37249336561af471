"""Native Apache Iceberg table support: metadata/manifest reader + a
v1-format snapshot writer.

The reference reads Iceberg through pyiceberg scan tasks
(``daft/io/_iceberg.py``) and commits through pyiceberg
transactions (``daft/dataframe/dataframe.py`` write_iceberg). This module is
SDK-free: table metadata JSON, Avro manifest lists and manifests are parsed
directly (``avro.py``), and appends write spec-compliant v1 metadata —
so ``read_iceberg``/``write_iceberg`` work against a plain warehouse path
on any supported object store (local/S3/GCS/Azure).

Writes carry Iceberg spec field-ids in the Avro manifest schemas and commit
optimistically: the new ``v(N+1).metadata.json`` is create-exclusive (truly
atomic on local paths; check-then-put on object stores) and the commit is
retried against the refreshed table state on conflict, so concurrent
writers serialize instead of clobbering. Prior snapshots are retained in
the metadata snapshot log on overwrite (time travel). External-engine
interop (pyiceberg/Spark/Trino) is untested.

Unsupported (raises): v2 position/equality delete files, schema evolution
by field-id remapping, partitioned writes.

The port's copy of ``daft_tpu/io/iceberg.py``; host-only (no device work).
"""

from __future__ import annotations

import json
import os
import re
import time
import urllib.parse
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .avro import read_avro, write_avro
from .object_io import IOConfig, get_io_client


# ----------------------------------------------------------------- utils

def _is_remote(uri: str) -> bool:
    return "://" in uri and not uri.startswith("file://")


def _join(base: str, *parts: str) -> str:
    if _is_remote(base):
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(base, *parts)


def _get(uri: str, io_config) -> bytes:
    if _is_remote(uri):
        return get_io_client(io_config).get(uri)
    with open(uri[7:] if uri.startswith("file://") else uri, "rb") as f:
        return f.read()


def _put(uri: str, data: bytes, io_config) -> None:
    if _is_remote(uri):
        get_io_client(io_config).put(uri, data)
        return
    p = uri[7:] if uri.startswith("file://") else uri
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "wb") as f:
        f.write(data)


def _exists(uri: str, io_config) -> bool:
    try:
        _get(uri, io_config)
        return True
    except Exception:
        return False


def _put_if_absent(uri: str, data: bytes, io_config) -> bool:
    """Create-exclusive write for the metadata-commit race. Local paths are
    truly atomic (O_CREAT|O_EXCL); object stores get check-then-put, which
    narrows but cannot eliminate the window without store preconditions."""
    if _is_remote(uri):
        client = get_io_client(io_config)
        try:
            client.source_for(uri).get_size(uri)
            return False  # object already exists (HEAD, not a full GET)
        except FileNotFoundError:
            pass  # transport errors propagate: clobbering a committed
            # metadata file is worse than failing the commit attempt
        client.put(uri, data)
        return True
    p = uri[7:] if uri.startswith("file://") else uri
    os.makedirs(os.path.dirname(p), exist_ok=True)
    try:
        fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return True


# ------------------------------------------------------------- metadata

def _resolve_metadata_path(table_uri: str, io_config) -> str:
    """Table root → current metadata JSON (version-hint, else highest
    vN.metadata.json via glob)."""
    if table_uri.endswith(".metadata.json"):
        return table_uri
    pattern = _join(table_uri, "metadata", "*.metadata.json")
    if _is_remote(table_uri):
        hits = get_io_client(io_config).glob(pattern)
    else:
        import glob as _g
        hits = sorted(_g.glob(pattern))

    def version(p: str) -> Tuple[int, str]:
        m = re.search(r"v?(\d+)[^/]*\.metadata\.json$", p)
        return (int(m.group(1)) if m else -1, p)

    # the hint is a last-writer-wins pointer that a racing committer may
    # not have updated yet — take the max of hint and glob, never trust
    # the hint alone (a stale hint would wedge every later commit)
    best = max(hits, key=version) if hits else None
    hint = _join(table_uri, "metadata", "version-hint.text")
    try:
        v = _get(hint, io_config).decode().strip()
        cand = _join(table_uri, "metadata", f"v{v}.metadata.json")
        if (best is None or version(cand) > version(best)) \
                and _exists(cand, io_config):
            best = cand
    except Exception:
        pass
    if best is None:
        raise FileNotFoundError(
            f"no Iceberg metadata under {table_uri!r}")
    return best


def load_table_metadata(table_uri: str,
                        io_config: Optional[IOConfig] = None) -> dict:
    path = _resolve_metadata_path(table_uri, io_config)
    meta = json.loads(_get(path, io_config))
    meta["_metadata_path"] = path
    return meta


def _current_snapshot(meta: dict, snapshot_id: Optional[int]) -> Optional[dict]:
    snaps = meta.get("snapshots", [])
    if snapshot_id is not None:
        for s in snaps:
            if s["snapshot-id"] == snapshot_id:
                return s
        raise ValueError(f"snapshot {snapshot_id} not found")
    cur = meta.get("current-snapshot-id")
    if cur in (None, -1):
        return None
    for s in snaps:
        if s["snapshot-id"] == cur:
            return s
    return None


def _rewrite_location(uri: str, meta: dict, table_uri: str) -> str:
    """Manifest/data paths are absolute at write time; when a table moved
    (e.g. generated elsewhere, downloaded locally) remap through the
    metadata ``location``."""
    loc = meta.get("location", "")
    if loc and uri.startswith(loc):
        return _join(table_uri, uri[len(loc):].lstrip("/"))
    return uri


def scan_entries(table_uri: str, snapshot_id: Optional[int] = None,
                 io_config: Optional[IOConfig] = None
                 ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]],
                            List[Dict[str, Any]]]:
    """Snapshot scan plan: (data_files, positional_deletes,
    equality_deletes), each entry carrying its v2 sequence number (0 for
    v1) so delete applicability follows the spec (positional deletes apply
    to data sequence ≤ theirs; equality deletes to data sequence strictly
    less)."""
    meta = load_table_metadata(table_uri, io_config)
    snap = _current_snapshot(meta, snapshot_id)
    if snap is None:
        return [], [], []
    data: List[Dict[str, Any]] = []
    pos_dels: List[Dict[str, Any]] = []
    eq_dels: List[Dict[str, Any]] = []
    mlist_uri = _rewrite_location(snap["manifest-list"], meta, table_uri)
    _, manifests = read_avro(_get(mlist_uri, io_config))
    for m in manifests:
        m_uri = _rewrite_location(m["manifest_path"], meta, table_uri)
        m_seq = m.get("sequence_number") or 0
        _, entries = read_avro(_get(m_uri, io_config))
        for e in entries:
            if e.get("status") == 2:  # DELETED
                continue
            df = e["data_file"]
            seq = e.get("sequence_number")
            if seq is None:
                seq = m_seq  # v2 inheritance: null → manifest's sequence
            entry = {
                "path": _rewrite_location(df["file_path"], meta, table_uri),
                "raw_path": df["file_path"],  # delete files reference this
                "format": str(df.get("file_format", "PARQUET")).lower(),
                "records": df.get("record_count", 0),
                "sequence": seq,
            }
            content = df.get("content", 0)
            if content == 0:
                data.append(entry)
            elif content == 1:
                pos_dels.append(entry)
            elif content == 2:
                entry["equality_ids"] = list(df.get("equality_ids") or [])
                eq_dels.append(entry)
            else:
                raise NotImplementedError(
                    f"iceberg data_file content {content}")
    return data, pos_dels, eq_dels


def data_files(table_uri: str, snapshot_id: Optional[int] = None,
               io_config: Optional[IOConfig] = None) -> List[Dict[str, Any]]:
    """Live data-file entries for a snapshot: [{path, format, records}]."""
    data, pos_dels, eq_dels = scan_entries(table_uri, snapshot_id, io_config)
    if pos_dels or eq_dels:
        raise NotImplementedError(
            "snapshot has v2 delete files; use read_iceberg (it applies "
            "them at scan)")
    return data


def read_iceberg(table_uri: str, snapshot_id: Optional[int] = None,
                 io_config: Optional[IOConfig] = None):
    """Iceberg table (warehouse path or metadata JSON path) → DataFrame.

    v2 tables: positional and equality delete files are applied per data
    file at scan (the reference's delete-map,
    ``src/daft-local-execution/src/sources/scan_task.rs:95-147``), and
    columns resolve by FIELD ID against the current schema (renames and
    added columns from schema evolution read correctly; dropped columns
    disappear)."""
    import daft_tpu_torch as dt
    meta = load_table_metadata(table_uri, io_config)
    data, pos_dels, eq_dels = scan_entries(table_uri, snapshot_id, io_config)
    if not data:
        schema = _schema_from_iceberg(meta)
        if schema is None:
            raise ValueError(f"iceberg table {table_uri!r} has no snapshot "
                             "and no schema")
        return _empty_df(schema)
    fmts = {f["format"] for f in data}
    if fmts - {"parquet"}:
        raise NotImplementedError(f"iceberg data file formats {fmts}")
    if not pos_dels and not eq_dels:
        return dt.read_parquet([f["path"] for f in data],
                               io_config=io_config)
    return _read_with_deletes(meta, data, pos_dels, eq_dels, io_config)


def _load_parquet_table(uri: str, io_config):
    import pyarrow.parquet as pq
    if _is_remote(uri):
        import io as io_
        return pq.read_table(io_.BytesIO(_get(uri, io_config)))
    return pq.read_table(uri[7:] if uri.startswith("file://") else uri)


def _field_id_map(meta: dict) -> Dict[int, str]:
    """current schema: field id → current column name."""
    schemas = meta.get("schemas") or ([meta["schema"]] if "schema" in meta
                                      else [])
    sid = meta.get("current-schema-id", 0)
    schema = next((s for s in schemas if s.get("schema-id", 0) == sid),
                  schemas[-1] if schemas else {"fields": []})
    return {f["id"]: f["name"] for f in schema.get("fields", [])}


def _remap_by_field_id(t, id_to_name: Dict[int, str]):
    """Rename a file's columns to the CURRENT schema via the
    ``PARQUET:field_id`` metadata parquet writers attach; files without
    ids keep name-based resolution (our own v1 writer's files)."""
    import pyarrow as pa
    names = []
    changed = False
    for f in t.schema:
        fid = None
        if f.metadata and b"PARQUET:field_id" in f.metadata:
            try:
                fid = int(f.metadata[b"PARQUET:field_id"])
            except ValueError:
                fid = None
        if fid is not None and fid in id_to_name \
                and id_to_name[fid] != f.name:
            names.append(id_to_name[fid])
            changed = True
        else:
            names.append(f.name)
    return t.rename_columns(names) if changed else t


def _read_with_deletes(meta, data, pos_dels, eq_dels, io_config):
    """Generator scan: per data file, drop positionally-deleted rows and
    anti-join equality deletes (sequence-number-aware)."""
    import numpy as np
    import pyarrow as pa

    from ..dataframe import DataFrame
    from ..logical.builder import LogicalPlanBuilder
    from ..recordbatch import RecordBatch
    from .scan import GeneratorScanOperator

    schema = _schema_from_iceberg(meta)
    id_to_name = _field_id_map(meta)

    # positional deletes: data-file path (as WRITTEN, pre-rewrite) → rows
    pos_map: Dict[str, list] = {}
    for d in pos_dels:
        t = _load_parquet_table(d["path"], io_config)
        for fp, pos in zip(t.column("file_path").to_pylist(),
                           t.column("pos").to_pylist()):
            pos_map.setdefault(fp, []).append((d["sequence"], pos))
    eq_tables = []
    for d in eq_dels:
        # delete files may predate schema renames: remap by field id like
        # data files, then resolve equality_ids against the CURRENT names
        t = _remap_by_field_id(_load_parquet_table(d["path"], io_config),
                               id_to_name)
        cols = [id_to_name[i] for i in d["equality_ids"]
                if i in id_to_name and id_to_name[i] in t.column_names]
        if not cols:
            raise NotImplementedError(
                f"iceberg equality delete {d['path']!r}: equality_ids "
                f"{d['equality_ids']} resolve to no current column — "
                "refusing to guess (a wrong guess would delete rows)")
        eq_tables.append((d["sequence"], cols, t.select(cols)))

    def load_entry(entry):
        t = _remap_by_field_id(
            _load_parquet_table(entry["path"], io_config), id_to_name)
        # current-schema projection: dropped columns vanish, added → null
        out_cols = {}
        for f in schema:
            if f.name in t.column_names:
                out_cols[f.name] = t.column(f.name)
            else:
                out_cols[f.name] = pa.nulls(t.num_rows,
                                            type=f.dtype.to_arrow())
        t = pa.table(out_cols)
        keep = np.ones(t.num_rows, dtype=bool)
        for raw_path in (entry.get("raw_path"), entry["path"]):
            for seq, pos in pos_map.get(raw_path, ()):
                if seq >= entry["sequence"] and 0 <= pos < len(keep):
                    keep[pos] = False
        for seq, cols, dt_ in eq_tables:
            if seq <= entry["sequence"] or not cols or not dt_.num_rows:
                continue
            import pyarrow.compute as pc
            keys_have_null = any(dt_.column(c).null_count > 0 for c in cols)
            if len(cols) == 1:
                hit = pc.is_in(t.column(cols[0]),
                               value_set=dt_.column(cols[0])
                               .combine_chunks())
                hit = np.asarray(hit.fill_null(False).combine_chunks())
                if keys_have_null:
                    # iceberg eq-deletes treat null as equal to null
                    hit |= np.asarray(
                        pc.is_null(t.column(cols[0])).combine_chunks())
                keep &= ~hit
            elif not keys_have_null:
                # multi-key: arrow semi join against the (deduped) delete
                # keys instead of a per-row Python probe
                probe = t.select(cols).append_column(
                    "__idx__", pa.array(np.arange(t.num_rows)))
                dedup = dt_.group_by(cols).aggregate([])
                hit = probe.join(dedup, keys=cols, join_type="left semi")
                keep[hit.column("__idx__").to_numpy()] = False
            else:
                # multi-key with NULLs: arrow joins never match nulls, but
                # the spec's null-equals-null semantics must — fall back
                # to the exact set probe for this (rare) delete file
                dead = set(zip(*[dt_.column(c).to_pylist() for c in cols]))
                vals = [t.column(c).to_pylist() for c in cols]
                for i in range(t.num_rows):
                    if tuple(v[i] for v in vals) in dead:
                        keep[i] = False
        if not keep.all():
            t = t.filter(pa.array(keep))
        return RecordBatch.from_arrow_table(t).cast_to_schema(schema)

    def make_loader(entry):
        def load(pushdowns):
            yield load_entry(entry)
        return [entry["path"]], load

    entries = [make_loader(e) for e in data]
    op = GeneratorScanOperator(
        schema, entries,
        f"IcebergScanOperator({len(data)} data files, "
        f"{len(pos_dels)}+{len(eq_dels)} delete files)",
        io_config=io_config)
    return DataFrame(LogicalPlanBuilder.from_scan(op))


def _empty_df(schema):
    import pyarrow as pa

    import daft_tpu_torch as dt
    empty = pa.table({f.name: pa.array([], type=f.dtype.to_arrow())
                      for f in schema})
    return dt.from_arrow(empty)


# --------------------------------------------------------- schema bridge

_ICEBERG_PRIMITIVES = {
    "boolean": "bool", "int": "int32", "long": "int64", "float": "float32",
    "double": "float64", "date": "date", "string": "string",
    "binary": "binary", "timestamp": "timestamp", "timestamptz": "timestamp",
}


def _schema_from_iceberg(meta: dict):
    from ..datatype import DataType
    from ..schema import Field, Schema
    schemas = meta.get("schemas") or ([meta["schema"]] if "schema" in meta
                                      else [])
    if not schemas:
        return None
    sid = meta.get("current-schema-id", 0)
    schema = next((s for s in schemas if s.get("schema-id", 0) == sid),
                  schemas[-1])
    fields = []
    for f in schema.get("fields", []):
        t = f["type"]
        if isinstance(t, str):
            if t.startswith("decimal"):
                m = re.match(r"decimal\((\d+),\s*(\d+)\)", t)
                dt_ = DataType.decimal128(int(m.group(1)), int(m.group(2)))
            else:
                name = _ICEBERG_PRIMITIVES.get(t)
                if name is None:
                    raise NotImplementedError(f"iceberg type {t!r}")
                dt_ = getattr(DataType, name)()
        else:
            raise NotImplementedError(f"nested iceberg type {t!r}")
        fields.append(Field(f["name"], dt_))
    return Schema(fields)


def _iceberg_type(dtype) -> str:
    inv = {"bool": "boolean", "int8": "int", "int16": "int", "int32": "int",
           "int64": "long", "uint8": "int", "uint16": "int", "uint32": "long",
           "uint64": "long", "float32": "float", "float64": "double",
           "date": "date", "string": "string", "binary": "binary",
           "timestamp": "timestamp"}
    k = dtype.kind
    if k == "decimal128":
        return f"decimal({dtype.precision}, {dtype.scale})"
    if k not in inv:
        raise NotImplementedError(f"write_iceberg: dtype {dtype!r}")
    return inv[k]


# ----------------------------------------------------------------- write

# Field-ids per the Iceberg v1 spec's manifest / manifest-list tables
# (spec "Manifests" and "Manifest Lists" sections; the reference relies on
# pyiceberg carrying the same ids).
_MANIFEST_ENTRY_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {"name": "snapshot_id", "type": ["null", "long"], "field-id": 1},
        {"name": "data_file", "field-id": 2, "type": {
            "type": "record", "name": "r2", "fields": [
                {"name": "file_path", "type": "string", "field-id": 100},
                {"name": "file_format", "type": "string", "field-id": 101},
                {"name": "partition", "field-id": 102, "type": {
                    "type": "record", "name": "r102", "fields": []}},
                {"name": "record_count", "type": "long", "field-id": 103},
                {"name": "file_size_in_bytes", "type": "long",
                 "field-id": 104},
                {"name": "block_size_in_bytes", "type": "long",
                 "field-id": 105},
            ]}},
    ]}

_FIELD_SUMMARY_SCHEMA = {
    "type": "record", "name": "field_summary", "fields": [
        {"name": "contains_null", "type": "boolean", "field-id": 509},
        {"name": "lower_bound", "type": ["null", "bytes"], "field-id": 510},
        {"name": "upper_bound", "type": ["null", "bytes"], "field-id": 511},
    ]}

_MANIFEST_FILE_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {"name": "added_snapshot_id", "type": ["null", "long"],
         "field-id": 503},
        {"name": "added_data_files_count", "type": ["null", "int"],
         "field-id": 504},
        {"name": "existing_data_files_count", "type": ["null", "int"],
         "field-id": 505},
        {"name": "deleted_data_files_count", "type": ["null", "int"],
         "field-id": 506},
        {"name": "partitions", "field-id": 507, "type": [
            "null", {"type": "array", "items": _FIELD_SUMMARY_SCHEMA,
                     "element-id": 508}]},
    ]}


def write_iceberg(df, table_uri: str, mode: str = "append",
                  io_config: Optional[IOConfig] = None) -> None:
    """Append the DataFrame as a new Iceberg v1 snapshot (creating the
    table on first write). ``mode="overwrite"`` starts a snapshot whose
    manifest list drops all previous manifests."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    if mode not in ("append", "overwrite"):
        raise ValueError(f"write_iceberg mode {mode!r}")
    table = df.to_arrow()
    snapshot_id = int(uuid.uuid4().int % (1 << 62))

    # 1. data file + its manifest: immutable, content-addressed by uuid —
    # written once, reused across metadata-commit retries.
    import io as _io
    buf = _io.BytesIO()
    pq.write_table(table, buf)
    data_uri = _join(table_uri, f"data/{uuid.uuid4().hex}.parquet")
    _put(data_uri, buf.getvalue(), io_config)
    entry = {"status": 1, "snapshot_id": snapshot_id, "data_file": {
        "file_path": data_uri, "file_format": "PARQUET", "partition": {},
        "record_count": table.num_rows,
        "file_size_in_bytes": buf.getbuffer().nbytes,
        "block_size_in_bytes": 64 * 1024 * 1024}}
    manifest_blob = write_avro(
        _MANIFEST_ENTRY_SCHEMA, [entry],
        metadata={"format-version": "1", "content": "data",
                  "partition-spec-id": "0"})
    manifest_uri = _join(table_uri, f"metadata/{uuid.uuid4().hex}-m0.avro")
    _put(manifest_uri, manifest_blob, io_config)

    schema = df.schema()
    ice_schema = {"type": "struct", "schema-id": 0, "fields": [
        {"id": i + 1, "name": f.name, "required": False,
         "type": _iceberg_type(f.dtype)}
        for i, f in enumerate(schema)]}

    _MLIST_KEYS = ("manifest_path", "manifest_length", "partition_spec_id",
                   "added_snapshot_id", "added_data_files_count",
                   "existing_data_files_count", "deleted_data_files_count",
                   "partitions")

    # 2. optimistic metadata commit: v(N+1) is create-exclusive; on losing
    # the race, re-read the table state and rebuild the manifest list
    # against the new current snapshot.
    for _attempt in range(5):
        try:
            meta = load_table_metadata(table_uri, io_config)
            version = int(re.search(r"v?(\d+)[^/]*\.metadata\.json$",
                                    meta["_metadata_path"]).group(1))
        except FileNotFoundError:
            meta = None
            version = 0
        now_ms = int(time.time() * 1000)

        manifests = [{"manifest_path": manifest_uri,
                      "manifest_length": len(manifest_blob),
                      "partition_spec_id": 0,
                      "added_snapshot_id": snapshot_id,
                      "added_data_files_count": 1,
                      "existing_data_files_count": 0,
                      "deleted_data_files_count": 0,
                      "partitions": None}]
        if meta is not None and mode == "append":
            snap = _current_snapshot(meta, None)
            if snap is not None:
                mlist_uri0 = _rewrite_location(snap["manifest-list"], meta,
                                               table_uri)
                _, prior = read_avro(_get(mlist_uri0, io_config))
                for m in prior:
                    if m.get("content", 0) != 0:
                        raise NotImplementedError(
                            "append to a table with v2 delete manifests "
                            "would silently rewrite them as data manifests")
                carried = [{k: m.get(k) for k in _MLIST_KEYS}
                           for m in prior]
                manifests = carried + manifests
        mlist_blob = write_avro(
            _MANIFEST_FILE_SCHEMA, manifests,
            metadata={"format-version": "1"})
        mlist_uri = _join(
            table_uri,
            f"metadata/snap-{snapshot_id}-1-{uuid.uuid4().hex}.avro")
        _put(mlist_uri, mlist_blob, io_config)

        snapshot = {"snapshot-id": snapshot_id, "timestamp-ms": now_ms,
                    "manifest-list": mlist_uri,
                    "summary": {"operation": "append" if mode == "append"
                                else "overwrite"},
                    "schema-id": 0}
        if meta is None:
            new_meta = {
                "format-version": 1,
                "table-uuid": str(uuid.uuid4()),
                "location": table_uri,
                "last-updated-ms": now_ms,
                "last-column-id": len(schema.fields),
                "schema": ice_schema, "schemas": [ice_schema],
                "current-schema-id": 0,
                "partition-spec": [],
                "partition-specs": [{"spec-id": 0, "fields": []}],
                "default-spec-id": 0,
                "properties": {},
                "current-snapshot-id": snapshot_id,
                "snapshots": [snapshot],
            }
        else:
            new_meta = {k: v for k, v in meta.items()
                        if k != "_metadata_path"}
            # prior snapshots stay in the log either way (time travel);
            # overwrite only changes which manifests the NEW snapshot lists
            new_meta["snapshots"] = (new_meta.get("snapshots", [])
                                     + [snapshot])
            new_meta["current-snapshot-id"] = snapshot_id
            new_meta["last-updated-ms"] = now_ms
        new_version = version + 1
        meta_uri = _join(table_uri, "metadata",
                         f"v{new_version}.metadata.json")
        if _put_if_absent(meta_uri, json.dumps(new_meta, indent=2).encode(),
                          io_config):
            _put(_join(table_uri, "metadata", "version-hint.text"),
                 str(new_version).encode(), io_config)
            return
    raise RuntimeError(
        f"write_iceberg: lost the metadata commit race at {table_uri!r} "
        "5 times (concurrent writers)")
