"""Catalog / Table / Identifier abstractions.

The port's copy of ``daft_tpu/catalog.py`` (parity target: the reference
engine's ``daft/catalog/__init__.py``: ``Catalog`` ABC :74-494,
``Identifier`` :498-611, ``Table`` ABC :613-814). Catalogs only resolve
*names* to lazy DataFrames; all compute stays in the execution tiers. The
port carries the in-memory catalog here, the file-system catalog in
``catalog_fs.py`` and the Unity REST catalog in ``catalog_unity.py``;
``from_iceberg`` and ``from_unity`` raise for their missing SDKs, as in
the reference.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Union


class NotFoundError(Exception):
    """Raised when a catalog object (namespace/table) is not found."""


Properties = Dict[str, Any]


class Identifier(Sequence):
    """A dot-separated, possibly-qualified object name (``cat.ns.table``).

    Reference: ``daft/catalog/__init__.py:498-611``.
    """

    def __init__(self, *parts: str):
        if not parts:
            raise ValueError("Identifier requires at least one part")
        self._parts = tuple(str(p) for p in parts)

    @staticmethod
    def from_str(input: str) -> "Identifier":
        return Identifier(*str(input).split("."))

    @staticmethod
    def from_sql(input: str, normalize: bool = False) -> "Identifier":
        parts = []
        for raw in str(input).split("."):
            if len(raw) >= 2 and raw[0] == '"' and raw[-1] == '"':
                parts.append(raw[1:-1].replace('""', '"'))
            else:
                parts.append(raw.lower() if normalize else raw)
        return Identifier(*parts)

    def drop(self, n: int = 1) -> "Identifier":
        if n >= len(self._parts):
            raise ValueError(f"cannot drop {n} parts from {self}")
        return Identifier(*self._parts[n:])

    @property
    def parts(self) -> tuple:
        return self._parts

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Identifier):
            return self._parts == other._parts
        if isinstance(other, str):
            return str(self) == other
        return NotImplemented

    def __hash__(self):
        return hash(self._parts)

    def __getitem__(self, index):
        return self._parts[index]

    def __len__(self) -> int:
        return len(self._parts)

    def __add__(self, suffix: "Identifier") -> "Identifier":
        return Identifier(*(self._parts + tuple(suffix)))

    def __repr__(self) -> str:
        return f"Identifier('{self}')"

    def __str__(self) -> str:
        return ".".join(self._parts)


def _to_ident(identifier: Union[Identifier, str]) -> Identifier:
    return identifier if isinstance(identifier, Identifier) \
        else Identifier.from_str(identifier)


class Table(ABC):
    """A named, readable (and optionally writable) dataset.

    Reference: ``daft/catalog/__init__.py:613-814``.
    """

    @property
    @abstractmethod
    def name(self) -> str: ...

    @abstractmethod
    def schema(self): ...

    @abstractmethod
    def read(self, **options: Any): ...

    @staticmethod
    def from_pydict(name: str, data: Dict[str, Any]) -> "Table":
        from . import dataframe as _df
        return MemTable(name, _df.from_pydict(data))

    @staticmethod
    def from_df(name: str, dataframe) -> "Table":
        return MemTable(name, dataframe)

    def select(self, *columns):
        return self.read().select(*columns)

    def show(self, n: int = 8) -> None:
        self.read().show(n)

    def write(self, df, mode: str = "append", **options: Any) -> None:
        raise NotImplementedError(f"{type(self).__name__} is read-only")

    def append(self, df, **options: Any) -> None:
        self.write(df, mode="append", **options)

    def overwrite(self, df, **options: Any) -> None:
        self.write(df, mode="overwrite", **options)

    def __repr__(self) -> str:
        return f"Table('{self.name}')"


class MemTable(Table):
    """In-memory table over a (lazy) DataFrame; append/overwrite rebind it."""

    def __init__(self, name: str, df):
        self._name = name
        self._df = df

    @property
    def name(self) -> str:
        return self._name

    def schema(self):
        return self._df.schema()

    def read(self, **options: Any):
        return self._df

    def write(self, df, mode: str = "append", **options: Any) -> None:
        if mode == "overwrite":
            self._df = df
        elif mode == "append":
            self._df = self._df.concat(df)
        else:
            raise ValueError(f"unsupported write mode {mode!r}")


class Catalog(ABC):
    """A named collection of namespaces and tables.

    Reference: ``daft/catalog/__init__.py:74-494`` (``_create_table`` etc.
    underscore-method provider SPI + public convenience verbs).
    """

    @property
    @abstractmethod
    def name(self) -> str: ...

    # -- provider SPI ------------------------------------------------------
    def _create_namespace(self, ident: Identifier) -> None:
        raise NotImplementedError(f"{type(self).__name__}: create_namespace")

    def _create_table(self, ident: Identifier, schema,
                      properties: Optional[Properties] = None) -> Table:
        raise NotImplementedError(f"{type(self).__name__}: create_table")

    def _drop_namespace(self, ident: Identifier) -> None:
        raise NotImplementedError(f"{type(self).__name__}: drop_namespace")

    def _drop_table(self, ident: Identifier) -> None:
        raise NotImplementedError(f"{type(self).__name__}: drop_table")

    @abstractmethod
    def _get_table(self, ident: Identifier) -> Table: ...

    def _has_namespace(self, ident: Identifier) -> bool:
        return any(ns == ident for ns in self._list_namespaces())

    def _has_table(self, ident: Identifier) -> bool:
        try:
            self._get_table(ident)
            return True
        except NotFoundError:
            return False

    def _list_namespaces(self, pattern: Optional[str] = None) -> List[Identifier]:
        raise NotImplementedError(f"{type(self).__name__}: list_namespaces")

    @abstractmethod
    def _list_tables(self, pattern: Optional[str] = None) -> List[Identifier]: ...

    # -- factories ---------------------------------------------------------
    @staticmethod
    def from_pydict(tables: Dict[Union[Identifier, str], Any],
                    name: str = "default") -> "Catalog":
        cat = InMemoryCatalog(name)
        for ident, source in tables.items():
            cat._put(_to_ident(ident), _as_table(_to_ident(ident)[-1], source))
        return cat

    @staticmethod
    def from_iceberg(catalog: Any) -> "Catalog":
        raise ImportError(
            "Iceberg catalogs require the 'pyiceberg' package, which is not "
            "installed")

    @staticmethod
    def from_unity(catalog: Any) -> "Catalog":
        raise ImportError(
            "Unity catalogs require the 'unitycatalog' package, which is not "
            "installed")

    @staticmethod
    def _from_obj(obj: Any) -> "Catalog":
        if isinstance(obj, Catalog):
            return obj
        if isinstance(obj, dict):
            return Catalog.from_pydict(obj)
        raise ValueError(f"cannot construct a Catalog from {type(obj).__name__}")

    # -- public verbs ------------------------------------------------------
    def create_namespace(self, identifier: Union[Identifier, str]) -> None:
        self._create_namespace(_to_ident(identifier))

    def create_namespace_if_not_exists(self, identifier) -> None:
        if not self.has_namespace(identifier):
            self.create_namespace(identifier)

    def create_table(self, identifier, source, properties=None, **kw) -> Table:
        ident = _to_ident(identifier)
        from .schema import Schema
        if isinstance(source, Schema):
            return self._create_table(ident, source, properties)
        # DataFrame source: create from its schema then overwrite with data
        tbl = self._create_table(ident, source.schema(), properties)
        tbl.write(source, mode="overwrite")
        return tbl

    def create_table_if_not_exists(self, identifier, source, **kw) -> Table:
        if self.has_table(identifier):
            return self.get_table(identifier)
        return self.create_table(identifier, source, **kw)

    def has_namespace(self, identifier) -> bool:
        return self._has_namespace(_to_ident(identifier))

    def has_table(self, identifier) -> bool:
        return self._has_table(_to_ident(identifier))

    def drop_namespace(self, identifier) -> None:
        self._drop_namespace(_to_ident(identifier))

    def drop_table(self, identifier) -> None:
        self._drop_table(_to_ident(identifier))

    def get_table(self, identifier) -> Table:
        return self._get_table(_to_ident(identifier))

    def list_namespaces(self, pattern: Optional[str] = None) -> List[Identifier]:
        return self._list_namespaces(pattern)

    def list_tables(self, pattern: Optional[str] = None) -> List[Identifier]:
        return self._list_tables(pattern)

    def read_table(self, identifier, **options):
        return self.get_table(identifier).read(**options)

    def write_table(self, identifier, df, mode: str = "append", **options) -> None:
        self.get_table(identifier).write(df, mode=mode, **options)

    def __repr__(self) -> str:
        return f"Catalog('{self.name}')"


def _as_table(name: str, source: Any) -> Table:
    from .dataframe import DataFrame
    if isinstance(source, Table):
        return source
    if isinstance(source, DataFrame):
        return MemTable(name, source)
    if isinstance(source, dict):
        return Table.from_pydict(name, source)
    raise ValueError(f"cannot make a table from {type(source).__name__}")


class InMemoryCatalog(Catalog):
    """Process-local catalog: dict of Identifier → Table plus namespace set.

    Reference: the Rust in-memory impl in ``src/daft-catalog/src/catalog.rs``.
    """

    def __init__(self, name: str = "default"):
        self._name = name
        self._tables: Dict[Identifier, Table] = {}
        self._namespaces: set = set()

    @property
    def name(self) -> str:
        return self._name

    def _put(self, ident: Identifier, table: Table) -> None:
        self._tables[ident] = table
        if len(ident) > 1:
            self._namespaces.add(Identifier(*ident[:-1]))

    def _create_namespace(self, ident: Identifier) -> None:
        if ident in self._namespaces:
            raise ValueError(f"namespace {ident} already exists")
        self._namespaces.add(ident)

    def _create_table(self, ident: Identifier, schema, properties=None) -> Table:
        if ident in self._tables:
            raise ValueError(f"table {ident} already exists")
        from . import dataframe as _df
        empty = _df.from_pydict(
            {f.name: _empty_column(f.dtype) for f in schema})
        tbl = MemTable(str(ident[-1]), empty)
        self._put(ident, tbl)
        return tbl

    def _drop_namespace(self, ident: Identifier) -> None:
        if ident not in self._namespaces:
            raise NotFoundError(f"namespace {ident} not found")
        # drop the namespace, any child namespaces, and all tables under them
        pfx = tuple(ident)
        self._namespaces = {ns for ns in self._namespaces
                            if tuple(ns[:len(pfx)]) != pfx}
        self._tables = {k: v for k, v in self._tables.items()
                        if tuple(k[:len(pfx)]) != pfx}

    def _drop_table(self, ident: Identifier) -> None:
        if ident not in self._tables:
            raise NotFoundError(f"table {ident} not found")
        del self._tables[ident]

    def _get_table(self, ident: Identifier) -> Table:
        if ident in self._tables:
            return self._tables[ident]
        raise NotFoundError(f"table {ident} not found in catalog {self._name}")

    def _has_namespace(self, ident: Identifier) -> bool:
        return ident in self._namespaces

    def _list_namespaces(self, pattern: Optional[str] = None) -> List[Identifier]:
        out = sorted(self._namespaces, key=str)
        if pattern:
            out = [n for n in out if str(n).startswith(pattern)]
        return out

    def _list_tables(self, pattern: Optional[str] = None) -> List[Identifier]:
        out = sorted(self._tables, key=str)
        if pattern:
            out = [t for t in out if str(t).startswith(pattern)]
        return out


def _empty_column(dtype):
    import pyarrow as pa
    try:
        return pa.array([], type=dtype.to_arrow())
    except Exception:
        return pa.array([], type=pa.null())
