"""Unity Catalog adapter over the open REST API.

Reference capability: ``daft/unity_catalog/`` +
``daft/catalog/__init__.py``'s Unity adapter (SDK-based). This one is
SDK-free: the open Unity Catalog REST surface (``/api/2.1/unity-catalog``)
provides schema/table listing and table metadata (storage location + data
source format); reads route through the native Delta/Iceberg/parquet
readers against that location.

Attach to a session like any catalog::

    cat = UnityCatalog("http://localhost:8080", token=..., catalog="unity")
    sess.attach(cat, alias="uc")
    sess.sql("SELECT * FROM uc.sales.orders")

The port's copy of ``daft_tpu/catalog_unity.py``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, List, Optional

from .catalog import Catalog, Identifier, NotFoundError, Table


class UnityTable(Table):
    """One Unity table: reads dispatch on data_source_format against
    storage_location."""

    def __init__(self, name: str, storage_location: str, fmt: str,
                 io_config=None):
        self._name = name
        self.storage_location = storage_location
        self.format = (fmt or "DELTA").upper()
        self._io_config = io_config

    @property
    def name(self) -> str:
        return self._name

    def schema(self):
        return self.read().schema()

    def read(self, **options: Any):
        import daft_tpu_torch as dt
        options.setdefault("io_config", self._io_config)
        if self.format == "DELTA":
            return dt.read_deltalake(self.storage_location, **options)
        if self.format == "ICEBERG":
            return dt.read_iceberg(self.storage_location, **options)
        if self.format == "PARQUET":
            return dt.read_parquet(
                self.storage_location.rstrip("/") + "/**/*.parquet",
                **options)
        raise NotImplementedError(
            f"unity table format {self.format!r}")


class UnityCatalog(Catalog):
    """Read-side Unity Catalog client (list/get; writes go through the
    table's underlying format)."""

    def __init__(self, endpoint: str, token: Optional[str] = None,
                 catalog: str = "unity", name: Optional[str] = None,
                 io_config=None):
        self.endpoint = endpoint.rstrip("/")
        self.token = token
        self.catalog = catalog
        self._name = name or catalog
        self._io_config = io_config

    @property
    def name(self) -> str:
        return self._name

    # ------------------------------------------------------------- REST
    def _request(self, path: str, params: Optional[dict] = None) -> dict:
        url = f"{self.endpoint}/api/2.1/unity-catalog/{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                raise NotFoundError(f"unity: {path} not found") from exc
            raise

    # -------------------------------------------------------------- SPI
    def _get_table(self, ident: Identifier) -> Table:
        if len(ident) == 2:
            full = f"{self.catalog}.{ident[0]}.{ident[1]}"
        elif len(ident) == 3:
            full = str(ident)
        else:
            raise NotFoundError(
                f"unity table names are schema.table (got {ident})")
        doc = self._request(f"tables/{urllib.parse.quote(full, safe='.')}")
        loc = doc.get("storage_location")
        if not loc:
            raise NotFoundError(f"unity table {full} has no storage "
                                f"location")
        return UnityTable(ident[-1], loc,
                          doc.get("data_source_format", "DELTA"),
                          self._io_config)

    def _paged(self, path: str, params: dict, key: str):
        """Drain a paginated Unity list endpoint (next_page_token)."""
        token = None
        while True:
            p = dict(params)
            if token:
                p["page_token"] = token
            doc = self._request(path, p)
            yield from doc.get(key, [])
            token = doc.get("next_page_token")
            if not token:
                return

    def _list_namespaces(self, pattern: Optional[str] = None
                         ) -> List[Identifier]:
        out = [Identifier(s["name"]) for s in
               self._paged("schemas", {"catalog_name": self.catalog},
                           "schemas")]
        return [i for i in out
                if pattern is None or str(i).startswith(pattern)]

    def _list_tables(self, pattern: Optional[str] = None
                     ) -> List[Identifier]:
        out: List[Identifier] = []
        for ns in self._list_namespaces():
            out.extend(Identifier(ns[0], t["name"]) for t in
                       self._paged("tables",
                                   {"catalog_name": self.catalog,
                                    "schema_name": ns[0]}, "tables"))
        return [i for i in out
                if pattern is None or str(i).startswith(pattern)]
