"""Native Azure Blob object source over the Blob REST API.

Capability mirror of the reference's Azure client (``src/daft-io/src/
azure_blob.rs``: SharedKey / SAS / anonymous auth, ranged reads, paged
listing) built on the Blob service REST API with stdlib ``http.client`` +
``hmac`` — no SDK, same stance as the S3 source. URL forms supported:
``az://container/key`` (account from config/env) and
``abfss://container@account.dfs.core.windows.net/key``.
``endpoint_url`` points at Azurite/mock servers in tests.

The port's copy of ``daft_tpu/io/azure.py``.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import http.client
import os
import re
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Tuple

from .object_io import (RETRYABLE_STATUS as _RETRYABLE_STATUS,
                        AzureConfig, IOStatsContext, ObjectSource,
                        parallel_get_ranges, retry_backoff_s)
from .s3 import _ConnectionPool, _glob_regex, _header_val
_API_VERSION = "2021-08-06"


def _parse_az_url(path: str) -> Tuple[Optional[str], str, str]:
    """→ (account_or_None, container, key)."""
    u = urllib.parse.urlparse(path)
    if u.scheme in ("az", "abfs", "abfss"):
        if "@" in u.netloc:  # abfss://container@account.dfs.core.windows.net
            container, host = u.netloc.split("@", 1)
            account = host.split(".", 1)[0]
            return account, container, u.path.lstrip("/")
        return None, u.netloc, u.path.lstrip("/")
    raise ValueError(f"not an azure url: {path!r}")


class AzureBlobSource(ObjectSource):
    scheme = "az"

    def __init__(self, config: AzureConfig = AzureConfig()):
        self.config = config
        self._pool = _ConnectionPool(config.max_connections)
        self._account = config.storage_account \
            or os.environ.get("AZURE_STORAGE_ACCOUNT")
        self._key = config.access_key \
            or os.environ.get("AZURE_STORAGE_KEY")
        self._sas = config.sas_token \
            or os.environ.get("AZURE_STORAGE_SAS_TOKEN")
        self._endpoint = config.endpoint_url \
            or os.environ.get("AZURE_ENDPOINT_URL")

    # ------------------------------------------------------------ transport
    def _locate(self, account: str) -> Tuple[str, int, bool, str]:
        """(host, port, tls, uri_prefix). Emulator endpoints use
        path-style /{account}/..."""
        if self._endpoint:
            u = urllib.parse.urlparse(self._endpoint)
            tls = u.scheme == "https"
            return (u.hostname, u.port or (443 if tls else 80), tls,
                    f"/{account}")
        return f"{account}.blob.core.windows.net", 443, True, ""

    def _sign(self, method: str, account: str, resource: str,
              query: Dict[str, str], headers: Dict[str, str],
              content_length: int) -> None:
        """SharedKey authorization (Blob service)."""
        if self.config.anonymous or not self._key:
            return
        headers["x-ms-date"] = datetime.datetime.now(
            datetime.timezone.utc).strftime("%a, %d %b %Y %H:%M:%S GMT")
        headers["x-ms-version"] = _API_VERSION
        ms_headers = sorted((k.lower(), str(v).strip())
                            for k, v in headers.items()
                            if k.lower().startswith("x-ms-"))
        canonical_headers = "".join(f"{k}:{v}\n" for k, v in ms_headers)
        canonical_resource = f"/{account}{resource}"
        for k in sorted(query):
            canonical_resource += f"\n{k.lower()}:{query[k]}"
        string_to_sign = "\n".join([
            method,
            "",  # Content-Encoding
            "",  # Content-Language
            str(content_length) if content_length else "",
            "",  # Content-MD5
            _header_val(headers, "content-type"),
            "",  # Date (x-ms-date used instead)
            "",  # If-Modified-Since
            "",  # If-Match
            "",  # If-None-Match
            "",  # If-Unmodified-Since
            _header_val(headers, "range"),
        ]) + "\n" + canonical_headers + canonical_resource
        sig = base64.b64encode(hmac.new(
            base64.b64decode(self._key), string_to_sign.encode("utf-8"),
            hashlib.sha256).digest()).decode()
        headers["Authorization"] = f"SharedKey {account}:{sig}"

    def _request(self, method: str, account: str, resource: str,
                 query: Dict[str, str] = None,
                 headers: Dict[str, str] = None, body: bytes = b""
                 ) -> Tuple[int, Dict[str, str], bytes]:
        if not account:
            raise ValueError(
                "azure url without account: set AzureConfig.storage_account "
                "or use abfss://container@account... form")
        host, port, tls, prefix = self._locate(account)
        q = dict(query or {})
        hdrs = dict(headers or {})
        hdrs.setdefault("x-ms-version", _API_VERSION)
        if body:
            hdrs["Content-Length"] = str(len(body))
        self._sign(method, account, resource, q, hdrs, len(body))
        qs = urllib.parse.urlencode(sorted(q.items()))
        if self._sas and not self._key:
            qs = (qs + "&" if qs else "") + self._sas.lstrip("?")
        quoted = urllib.parse.quote(resource, safe="/~._-")
        path = prefix + quoted + (f"?{qs}" if qs else "")

        last_exc: Optional[Exception] = None
        for attempt in range(max(1, self.config.num_tries)):
            conn = self._pool.acquire(host, port, tls)
            try:
                conn.request(method, path, body=body or None, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                rheaders = dict(resp.getheaders())
                self._pool.release(host, port, tls, conn)
            except (OSError, http.client.HTTPException) as exc:
                conn.close()
                last_exc = exc
                time.sleep(retry_backoff_s(path, attempt))
                continue
            if status in _RETRYABLE_STATUS:
                last_exc = RuntimeError(
                    f"azure {method} {path}: HTTP {status}: {data[:200]!r}")
                time.sleep(retry_backoff_s(path, attempt))
                continue
            return status, rheaders, data
        raise last_exc

    def _resolve(self, path: str) -> Tuple[str, str, str]:
        account, container, key = _parse_az_url(path)
        return account or self._account, container, key

    # ------------------------------------------------------- ObjectSource
    def get(self, path, byte_range=None, stats=None) -> bytes:
        account, container, key = self._resolve(path)
        headers = {}
        if byte_range is not None:
            headers["range"] = f"bytes={byte_range[0]}-{byte_range[1] - 1}"
        status, _, data = self._request(
            "GET", account, f"/{container}/{key}", headers=headers)
        if status not in (200, 206):
            raise FileNotFoundError(f"azure GET {path}: HTTP {status}")
        if stats:
            stats.record_get(len(data))
        return data

    def get_ranges(self, path, ranges, stats=None, parallelism=None):
        return parallel_get_ranges(
            self, path, ranges, stats,
            min(parallelism or 8, self.config.max_connections))

    def put(self, path, data, stats=None) -> None:
        account, container, key = self._resolve(path)
        status, _, body = self._request(
            "PUT", account, f"/{container}/{key}",
            headers={"x-ms-blob-type": "BlockBlob",
                     "Content-Type": "application/octet-stream"}, body=data)
        if status not in (200, 201):
            raise IOError(f"azure PUT {path}: HTTP {status}: {body[:200]!r}")
        if stats:
            stats.record_put(len(data))

    def get_size(self, path) -> int:
        account, container, key = self._resolve(path)
        status, headers, _ = self._request("HEAD", account,
                                           f"/{container}/{key}")
        if status != 200:
            raise FileNotFoundError(f"azure HEAD {path}: HTTP {status}")
        lower = {k.lower(): v for k, v in headers.items()}
        return int(lower.get("content-length", 0))

    def _list(self, account: str, container: str, prefix: str,
              stats: Optional[IOStatsContext] = None
              ) -> Iterator[Tuple[str, int]]:
        marker = None
        while True:
            q = {"restype": "container", "comp": "list", "prefix": prefix}
            if marker:
                q["marker"] = marker
            status, _, data = self._request("GET", account, f"/{container}",
                                            query=q)
            if status != 200:
                raise IOError(
                    f"azure LIST {container}/{prefix}: HTTP {status}")
            if stats:
                stats.record_list()
            root = ET.fromstring(data)
            for blob in root.iter("Blob"):
                name = blob.findtext("Name")
                size = int(blob.findtext("Properties/Content-Length") or 0)
                yield name, size
            marker = root.findtext("NextMarker")
            if not marker:
                return

    def glob(self, pattern, stats=None) -> List[str]:
        account, container, keypat = self._resolve(pattern)
        wild = min((keypat.index(ch) for ch in "*?[" if ch in keypat),
                   default=None)
        if wild is None:
            return [pattern]
        prefix = keypat[:wild]
        pat = re.compile(_glob_regex(keypat))
        out = []
        for key, _size in self._list(account, container, prefix,
                                     stats=stats):
            if pat.match(key):
                out.append(f"az://{container}/{key}")
        return sorted(out)

    def ls(self, path) -> Iterator[Tuple[str, int]]:
        account, container, prefix = self._resolve(path)
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        for key, size in self._list(account, container, prefix):
            yield f"az://{container}/{key}", size
