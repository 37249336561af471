"""Filesystem lake catalog: a warehouse directory as a Catalog.

The port's copy of ``daft_tpu/catalog_fs.py`` (the reference engine's
catalog adapters in ``daft/catalog/`` expose external tables through one
Catalog interface). A warehouse root whose subdirectories are namespaces
and whose table directories are auto-detected as Iceberg
(``metadata/*.metadata.json``), Delta (``_delta_log/``), Hudi
(``.hoodie/``) or plain parquet directories. Attach it to a Session and the
tables are queryable by SQL name::

    sess.attach(FilesystemCatalog("/warehouse", name="lake"))
    sess.sql("SELECT * FROM lake.sales.orders")

Writes go through ``create_table`` (Iceberg format) so round-trips stay
inside the native formats. Format detection is the reference's, so the
two list the same tables and namespaces.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

from .catalog import Catalog, Identifier, NotFoundError, Table


def _detect_format(path: str) -> Optional[str]:
    if os.path.isdir(os.path.join(path, "metadata")) and any(
            f.endswith(".metadata.json")
            for f in os.listdir(os.path.join(path, "metadata"))):
        return "iceberg"
    if os.path.isdir(os.path.join(path, "_delta_log")):
        return "delta"
    if os.path.isdir(os.path.join(path, ".hoodie")):
        return "hudi"
    if os.path.isdir(path) and any(f.endswith(".parquet")
                                   for f in os.listdir(path)):
        return "parquet"
    return None


class LakeTable(Table):
    """One on-disk lake table; ``read()`` dispatches on detected format."""

    def __init__(self, name: str, path: str, fmt: str):
        self._name = name
        self.path = path
        self.format = fmt

    @property
    def name(self) -> str:
        return self._name

    def schema(self):
        return self.read().schema()

    def read(self, **options: Any):
        import daft_tpu_torch as dt
        if self.format == "iceberg":
            return dt.read_iceberg(self.path, **options)
        if self.format == "delta":
            return dt.read_deltalake(self.path, **options)
        if self.format == "hudi":
            return dt.read_hudi(self.path, **options)
        return dt.read_parquet(os.path.join(self.path, "*.parquet"),
                               **options)

    def write(self, df, mode: str = "append", **options: Any) -> None:
        if mode not in ("append", "overwrite"):
            raise ValueError(f"unsupported write mode {mode!r}")
        if self.format == "iceberg":
            df.write_iceberg(self.path, mode=mode)
        elif self.format == "delta":
            df.write_deltalake(self.path, mode=mode)
        elif self.format == "parquet":
            df.write_parquet(self.path, write_mode=mode)
        else:
            raise NotImplementedError(
                f"writes to {self.format} tables are not supported")


class FilesystemCatalog(Catalog):
    """Warehouse directory → namespaces (subdirectories) → lake tables."""

    def __init__(self, root: str, name: str = "lake"):
        self.root = os.path.abspath(root)
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    # ------------------------------------------------------------ paths
    def _path_of(self, ident: Identifier) -> str:
        return os.path.join(self.root, *ident)

    # ------------------------------------------------------------- SPI
    def _create_namespace(self, ident: Identifier) -> None:
        path = self._path_of(ident)
        if os.path.isdir(path):
            raise ValueError(f"namespace {ident} already exists")
        os.makedirs(path)

    def _create_table(self, ident: Identifier, schema,
                      properties=None) -> Table:
        import pyarrow as pa

        import daft_tpu_torch as dt
        path = self._path_of(ident)
        if _detect_format(path):
            raise ValueError(f"table {ident} already exists")
        empty = pa.table({f.name: pa.array([], type=f.dtype.to_arrow())
                          for f in schema})
        dt.from_arrow(empty).write_iceberg(path)
        return LakeTable(ident[-1], path, "iceberg")

    def _drop_table(self, ident: Identifier) -> None:
        import shutil
        path = self._path_of(ident)
        if _detect_format(path) is None:
            raise NotFoundError(f"table {ident} not found")
        shutil.rmtree(path)

    def _drop_namespace(self, ident: Identifier) -> None:
        path = self._path_of(ident)
        if not os.path.isdir(path):
            raise NotFoundError(f"namespace {ident} not found")
        if os.listdir(path):
            raise ValueError(f"namespace {ident} is not empty")
        os.rmdir(path)

    def _get_table(self, ident: Identifier) -> Table:
        path = self._path_of(ident)
        fmt = _detect_format(path)
        if fmt is None:
            raise NotFoundError(f"table {ident} not found under "
                                f"{self.root}")
        return LakeTable(ident[-1], path, fmt)

    def _has_namespace(self, ident: Identifier) -> bool:
        path = self._path_of(ident)
        return os.path.isdir(path) and _detect_format(path) is None

    def _list_namespaces(self, pattern: Optional[str] = None
                         ) -> List[Identifier]:
        out = []
        for dirpath, dirnames, _ in os.walk(self.root):
            keep = []
            for d in sorted(dirnames):
                full = os.path.join(dirpath, d)
                if d.startswith((".", "_")) or _detect_format(full):
                    continue
                keep.append(d)
                rel = os.path.relpath(full, self.root)
                ident = Identifier(*rel.split(os.sep))
                if pattern is None or str(ident).startswith(pattern):
                    out.append(ident)
            dirnames[:] = keep
        return out

    def _list_tables(self, pattern: Optional[str] = None
                     ) -> List[Identifier]:
        out = []
        for dirpath, dirnames, _ in os.walk(self.root):
            keep = []
            for d in sorted(dirnames):
                full = os.path.join(dirpath, d)
                if d.startswith((".", "_")):
                    continue
                if _detect_format(full):
                    rel = os.path.relpath(full, self.root)
                    ident = Identifier(*rel.split(os.sep))
                    if pattern is None or str(ident).startswith(pattern):
                        out.append(ident)
                else:
                    keep.append(d)
            dirnames[:] = keep
        return out
