"""Native GCS object source over the JSON API.

Capability mirror of the reference's GCS client (``src/daft-io/src/
google_cloud.rs``: authenticated + anonymous modes, ranged reads, list
pagination) built on the public GCS JSON API with stdlib ``http.client`` —
no SDK, same stance as the S3 source (``s3.py``). Auth is a static OAuth2
bearer token (``GCSConfig.access_token`` / ``GCS_ACCESS_TOKEN`` env);
anonymous works for public buckets. ``endpoint_url`` points at emulators in
tests.

The port's copy of ``daft_tpu/io/gcs.py``.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import time
import urllib.parse
from typing import Dict, Iterator, List, Optional, Tuple

from .object_io import (RETRYABLE_STATUS as _RETRYABLE_STATUS,
                        GCSConfig, IOStatsContext, ObjectSource,
                        parallel_get_ranges, retry_backoff_s)
from .s3 import _ConnectionPool, _glob_regex


def _parse_gs_url(path: str) -> Tuple[str, str]:
    u = urllib.parse.urlparse(path)
    if u.scheme != "gs":
        raise ValueError(f"not a gs url: {path!r}")
    return u.netloc, u.path.lstrip("/")


class GCSSource(ObjectSource):
    scheme = "gs"

    def __init__(self, config: GCSConfig = GCSConfig()):
        self.config = config
        self._pool = _ConnectionPool(config.max_connections)
        self._token = config.access_token \
            or os.environ.get("GCS_ACCESS_TOKEN")
        endpoint = config.endpoint_url \
            or os.environ.get("GCS_ENDPOINT_URL") \
            or "https://storage.googleapis.com"
        u = urllib.parse.urlparse(endpoint)
        self._tls = u.scheme == "https"
        self._host = u.hostname
        self._port = u.port or (443 if self._tls else 80)

    # ------------------------------------------------------------ transport
    def _request(self, method: str, path: str, headers: Dict[str, str] = None,
                 body: bytes = b"") -> Tuple[int, Dict[str, str], bytes]:
        hdrs = dict(headers or {})
        if self._token and not self.config.anonymous:
            hdrs["Authorization"] = f"Bearer {self._token}"
        last_exc: Optional[Exception] = None
        for attempt in range(max(1, self.config.num_tries)):
            conn = self._pool.acquire(self._host, self._port, self._tls)
            try:
                conn.request(method, path, body=body or None, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                rheaders = dict(resp.getheaders())
                self._pool.release(self._host, self._port, self._tls, conn)
            except (OSError, http.client.HTTPException) as exc:
                conn.close()
                last_exc = exc
                time.sleep(retry_backoff_s(path, attempt))
                continue
            if status in _RETRYABLE_STATUS:
                last_exc = RuntimeError(
                    f"gcs {method} {path}: HTTP {status}: {data[:200]!r}")
                time.sleep(retry_backoff_s(path, attempt))
                continue
            return status, rheaders, data
        raise last_exc

    @staticmethod
    def _object_path(bucket: str, key: str, **params) -> str:
        p = f"/storage/v1/b/{bucket}/o/{urllib.parse.quote(key, safe='')}"
        if params:
            p += "?" + urllib.parse.urlencode(params)
        return p

    # ------------------------------------------------------- ObjectSource
    def get(self, path, byte_range=None, stats=None) -> bytes:
        bucket, key = _parse_gs_url(path)
        headers = {}
        if byte_range is not None:
            headers["Range"] = f"bytes={byte_range[0]}-{byte_range[1] - 1}"
        status, _, data = self._request(
            "GET", self._object_path(bucket, key, alt="media"), headers)
        if status not in (200, 206):
            raise FileNotFoundError(f"gcs GET {path}: HTTP {status}")
        if stats:
            stats.record_get(len(data))
        return data

    def get_ranges(self, path, ranges, stats=None, parallelism=None):
        return parallel_get_ranges(
            self, path, ranges, stats,
            min(parallelism or 8, self.config.max_connections))

    def put(self, path, data, stats=None) -> None:
        bucket, key = _parse_gs_url(path)
        p = (f"/upload/storage/v1/b/{bucket}/o?uploadType=media&"
             f"name={urllib.parse.quote(key, safe='')}")
        status, _, body = self._request(
            "POST", p, {"Content-Type": "application/octet-stream"}, data)
        if status not in (200, 201):
            raise IOError(f"gcs PUT {path}: HTTP {status}: {body[:200]!r}")
        if stats:
            stats.record_put(len(data))

    def get_size(self, path) -> int:
        bucket, key = _parse_gs_url(path)
        status, _, data = self._request(
            "GET", self._object_path(bucket, key))
        if status != 200:
            raise FileNotFoundError(f"gcs STAT {path}: HTTP {status}")
        return int(json.loads(data).get("size", 0))

    def _list(self, bucket: str, prefix: str,
              stats: Optional[IOStatsContext] = None
              ) -> Iterator[Tuple[str, int]]:
        token = None
        while True:
            params = {"prefix": prefix}
            if token:
                params["pageToken"] = token
            p = f"/storage/v1/b/{bucket}/o?" + urllib.parse.urlencode(params)
            status, _, data = self._request("GET", p)
            if status != 200:
                raise IOError(f"gcs LIST {bucket}/{prefix}: HTTP {status}")
            if stats:
                stats.record_list()
            payload = json.loads(data)
            for item in payload.get("items", []):
                yield item["name"], int(item.get("size", 0))
            token = payload.get("nextPageToken")
            if not token:
                return

    def glob(self, pattern, stats=None) -> List[str]:
        bucket, keypat = _parse_gs_url(pattern)
        wild = min((keypat.index(ch) for ch in "*?[" if ch in keypat),
                   default=None)
        if wild is None:
            return [pattern]
        prefix = keypat[:wild]
        pat = re.compile(_glob_regex(keypat))
        out = []
        for key, _size in self._list(bucket, prefix, stats=stats):
            if pat.match(key):
                out.append(f"gs://{bucket}/{key}")
        return sorted(out)

    def ls(self, path) -> Iterator[Tuple[str, int]]:
        bucket, prefix = _parse_gs_url(path)
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        for key, size in self._list(bucket, prefix):
            yield f"gs://{bucket}/{key}", size
