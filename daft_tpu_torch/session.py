"""Session: attached catalogs, temp tables, SQL context.

The port's copy of ``daft_tpu/session.py``. Parity target: the reference's
``daft/session.py`` (``Session`` :49-507 and
module-level verbs on an ambient session :519-703) over ``src/daft-session``.
The session is the name-resolution root for ``session.sql(...)``: temp tables
shadow catalog tables; unqualified names resolve against the current catalog
and namespace; attached UDFs become SQL-callable functions.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .catalog import (
    Catalog, Identifier, InMemoryCatalog, NotFoundError, Table,
    _as_table, _to_ident,
)


class Session:
    def __init__(self) -> None:
        self._catalogs: Dict[str, Catalog] = {}
        self._tables: Dict[str, Table] = {}       # temp tables (session-scoped)
        self._functions: Dict[str, Any] = {}      # attached UDFs
        self._current_catalog: Optional[str] = None
        self._current_namespace: Optional[Identifier] = None

    @staticmethod
    def _from_env() -> "Session":
        return Session()

    # -- sql ---------------------------------------------------------------
    def sql(self, sql: str):
        """Plan+return a DataFrame for a query against this session's names.

        Name resolution is lazy: the planner calls back into
        ``Session.get_table`` per referenced table (temp tables shadow
        catalog tables; unqualified names resolve against the current
        catalog/namespace — reference ``src/daft-session`` semantics).
        """
        from .sql.planner import SQLPlanner
        return SQLPlanner({}, session=self).plan_statement(sql)

    # -- attach / detach ---------------------------------------------------
    def attach(self, object: Any, alias: Optional[str] = None):
        from .udf import UDF
        if isinstance(object, Catalog):
            return self.attach_catalog(object, alias)
        if isinstance(object, Table):
            return self.attach_table(object, alias)
        if isinstance(object, UDF):
            return self.attach_function(object, alias)
        if isinstance(object, dict):
            return self.attach_catalog(object, alias)
        raise ValueError(f"cannot attach {type(object).__name__}")

    def attach_catalog(self, catalog: Any, alias: Optional[str] = None) -> Catalog:
        cat = Catalog._from_obj(catalog)
        name = alias or cat.name
        if name in self._catalogs:
            raise ValueError(f"catalog {name!r} is already attached")
        self._catalogs[name] = cat
        if self._current_catalog is None:
            self._current_catalog = name
        return cat

    def attach_table(self, table: Any, alias: Optional[str] = None) -> Table:
        tbl = table if isinstance(table, Table) else _as_table(alias or "table", table)
        name = alias or tbl.name
        if name in self._tables:
            raise ValueError(f"table {name!r} is already attached")
        self._tables[name] = tbl
        return tbl

    def attach_function(self, function: Any, alias: Optional[str] = None) -> None:
        name = alias or getattr(function, "name", None) \
            or getattr(getattr(function, "fn", None), "__name__", None)
        if not name:
            raise ValueError("cannot infer function alias; pass alias=")
        self._functions[name.lower()] = function

    def detach_catalog(self, alias: str) -> None:
        if alias not in self._catalogs:
            raise NotFoundError(f"catalog {alias!r} is not attached")
        del self._catalogs[alias]
        if self._current_catalog == alias:
            self._current_catalog = next(iter(self._catalogs), None)

    def detach_table(self, alias: str) -> None:
        if alias not in self._tables:
            raise NotFoundError(f"table {alias!r} is not attached")
        del self._tables[alias]

    def detach_function(self, alias: str) -> None:
        if alias.lower() not in self._functions:
            raise NotFoundError(f"function {alias!r} is not attached")
        del self._functions[alias.lower()]

    # -- create / drop -----------------------------------------------------
    def _default_catalog(self) -> Catalog:
        if self._current_catalog is None:
            self.attach_catalog(InMemoryCatalog("default"))
        return self._catalogs[self._current_catalog]

    def create_namespace(self, identifier) -> None:
        self._default_catalog().create_namespace(identifier)

    def create_namespace_if_not_exists(self, identifier) -> None:
        self._default_catalog().create_namespace_if_not_exists(identifier)

    def create_table(self, identifier, source, **properties) -> Table:
        return self._default_catalog().create_table(identifier, source, **properties)

    def create_table_if_not_exists(self, identifier, source, **properties) -> Table:
        return self._default_catalog().create_table_if_not_exists(
            identifier, source, **properties)

    def create_temp_table(self, identifier: str, source) -> Table:
        tbl = _as_table(identifier, source)
        self._tables[identifier] = tbl
        return tbl

    def drop_namespace(self, identifier) -> None:
        self._default_catalog().drop_namespace(identifier)

    def drop_table(self, identifier) -> None:
        ident = _to_ident(identifier)
        if len(ident) == 1 and str(ident) in self._tables:
            del self._tables[str(ident)]
            return
        # catalog-qualified names resolve like get_table does
        if len(ident) > 1 and ident[0] in self._catalogs:
            self._catalogs[ident[0]].drop_table(ident.drop(1))
            return
        self._default_catalog().drop_table(identifier)

    # -- current catalog / namespace --------------------------------------
    def use(self, identifier=None) -> None:
        if identifier is None:
            self._current_catalog = None
            self._current_namespace = None
            return
        ident = _to_ident(identifier)
        self.set_catalog(ident[0])
        self._current_namespace = ident.drop(1) if len(ident) > 1 else None

    def current_catalog(self) -> Optional[Catalog]:
        return self._catalogs.get(self._current_catalog) \
            if self._current_catalog else None

    def current_namespace(self) -> Optional[Identifier]:
        return self._current_namespace

    def set_catalog(self, identifier: Optional[str]) -> None:
        if identifier is None:
            self._current_catalog = None
            return
        if identifier not in self._catalogs:
            raise NotFoundError(f"catalog {identifier!r} is not attached")
        self._current_catalog = identifier

    def set_namespace(self, identifier) -> None:
        self._current_namespace = _to_ident(identifier) \
            if identifier is not None else None

    # -- lookups -----------------------------------------------------------
    def get_catalog(self, identifier: str) -> Catalog:
        if identifier not in self._catalogs:
            raise NotFoundError(f"catalog {identifier!r} is not attached")
        return self._catalogs[identifier]

    def get_table(self, identifier) -> Table:
        ident = _to_ident(identifier)
        if len(ident) == 1 and str(ident) in self._tables:
            return self._tables[str(ident)]
        # fully-qualified: first part names an attached catalog
        if len(ident) > 1 and ident[0] in self._catalogs:
            return self._catalogs[ident[0]].get_table(ident.drop(1))
        cat = self.current_catalog()
        if cat is not None:
            ns = self._current_namespace
            if ns is not None and cat.has_table(ns + ident):
                return cat.get_table(ns + ident)
            return cat.get_table(ident)
        raise NotFoundError(f"table {ident} not found")

    def has_catalog(self, identifier: str) -> bool:
        return identifier in self._catalogs

    def has_namespace(self, identifier) -> bool:
        cat = self.current_catalog()
        return bool(cat) and cat.has_namespace(identifier)

    def has_table(self, identifier) -> bool:
        try:
            self.get_table(identifier)
            return True
        except NotFoundError:
            return False

    def list_catalogs(self, pattern: Optional[str] = None) -> List[str]:
        out = sorted(self._catalogs)
        return [c for c in out if not pattern or c.startswith(pattern)]

    def list_namespaces(self, pattern: Optional[str] = None) -> List[Identifier]:
        cat = self.current_catalog()
        return cat.list_namespaces(pattern) if cat else []

    def list_tables(self, pattern: Optional[str] = None) -> List[Identifier]:
        out = [Identifier(t) for t in sorted(self._tables)]
        cat = self.current_catalog()
        if cat:
            out += cat.list_tables(pattern)
        return [t for t in out if not pattern or str(t).startswith(pattern)]

    def read_table(self, identifier, **options):
        return self.get_table(identifier).read(**options)

    def write_table(self, identifier, df, mode: str = "append", **options) -> None:
        self.get_table(identifier).write(df, mode=mode, **options)


_SESSION: Optional[Session] = None
# two racing first callers used to each build a Session, and attachments
# made through the loser silently vanished (daft-lint
# unguarded-global-mutation find)
_session_lock = threading.Lock()


def _session() -> Session:
    global _SESSION
    if _SESSION is not None:    # hot path: no lock once built
        return _SESSION
    with _session_lock:
        if _SESSION is None:
            _SESSION = Session()
        return _SESSION


def current_session() -> Session:
    return _session()


# module-level verbs over the ambient session (reference session.py:519-703)
def attach(object, alias=None): return _session().attach(object, alias)
def attach_catalog(catalog, alias=None): return _session().attach_catalog(catalog, alias)
def attach_table(table, alias=None): return _session().attach_table(table, alias)
def attach_function(function, alias=None): return _session().attach_function(function, alias)
def detach_catalog(alias): return _session().detach_catalog(alias)
def detach_table(alias): return _session().detach_table(alias)
def detach_function(alias): return _session().detach_function(alias)
def create_namespace(identifier): return _session().create_namespace(identifier)
def create_namespace_if_not_exists(identifier): return _session().create_namespace_if_not_exists(identifier)
def create_table(identifier, source, **p): return _session().create_table(identifier, source, **p)
def create_table_if_not_exists(identifier, source, **p): return _session().create_table_if_not_exists(identifier, source, **p)
def create_temp_table(identifier, source): return _session().create_temp_table(identifier, source)
def drop_namespace(identifier): return _session().drop_namespace(identifier)
def drop_table(identifier): return _session().drop_table(identifier)
def current_catalog(): return _session().current_catalog()
def current_namespace(): return _session().current_namespace()
def get_catalog(identifier): return _session().get_catalog(identifier)
def get_table(identifier): return _session().get_table(identifier)
def has_catalog(identifier): return _session().has_catalog(identifier)
def has_namespace(identifier): return _session().has_namespace(identifier)
def has_table(identifier): return _session().has_table(identifier)
def list_catalogs(pattern=None): return _session().list_catalogs(pattern)
def list_namespaces(pattern=None): return _session().list_namespaces(pattern)
def list_tables(pattern=None): return _session().list_tables(pattern)
def read_table(identifier, **options): return _session().read_table(identifier, **options)
def write_table(identifier, df, mode="append", **options): return _session().write_table(identifier, df, mode=mode, **options)
def set_catalog(identifier): return _session().set_catalog(identifier)
def set_namespace(identifier): return _session().set_namespace(identifier)
def use(identifier=None): return _session().use(identifier)
