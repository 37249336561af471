"""Native S3 object source: SigV4 signing, connection pooling, retries.

Capability mirror of the reference's native S3 client
(``src/daft-io/src/s3_like.rs``: connection pooling, credential handling,
retry policy ``src/daft-io/src/retry.rs``) built directly on the S3 REST
API with stdlib ``http.client``/``hmac`` — no SDK dependency, matching the
reference's no-SDK stance. Supports path-style addressing against custom
endpoints (MinIO / mock servers in tests) and virtual-hosted style against
AWS, ranged GETs, HEAD, PUT, and paginated ListObjectsV2 for glob/ls.

The port's copy of ``daft_tpu/io/s3.py``.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import io
import os
import re
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Tuple

from .object_io import (RETRYABLE_STATUS as _RETRYABLE_STATUS,
                        IOStatsContext, ObjectSource, S3Config,
                        parallel_get_ranges, retry_backoff_s)

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _parse_s3_url(path: str) -> Tuple[str, str]:
    u = urllib.parse.urlparse(path)
    if u.scheme not in ("s3", "s3a"):
        raise ValueError(f"not an s3 url: {path!r}")
    return u.netloc, u.path.lstrip("/")


class _ConnectionPool:
    """Reusable HTTP(S) connections per host (the reference pools via its
    hyper client; ``max_connections`` mirrors S3Config)."""

    def __init__(self, max_connections: int):
        self._lock = threading.Lock()
        self._idle: Dict[Tuple[str, int, bool], List[http.client.HTTPConnection]] = {}
        self.max_connections = max_connections

    def acquire(self, host: str, port: int, tls: bool):
        with self._lock:
            conns = self._idle.get((host, port, tls))
            if conns:
                return conns.pop()
        cls = http.client.HTTPSConnection if tls else http.client.HTTPConnection
        return cls(host, port, timeout=60)

    def release(self, host: str, port: int, tls: bool, conn) -> None:
        with self._lock:
            conns = self._idle.setdefault((host, port, tls), [])
            if len(conns) < self.max_connections:
                conns.append(conn)
                return
        conn.close()


class S3Source(ObjectSource):
    scheme = "s3"

    def __init__(self, config: S3Config = S3Config()):
        self.config = config
        self._pool = _ConnectionPool(config.max_connections)
        self._region = config.region_name \
            or os.environ.get("AWS_REGION") \
            or os.environ.get("AWS_DEFAULT_REGION") or "us-east-1"
        self._key_id = config.key_id or os.environ.get("AWS_ACCESS_KEY_ID")
        self._secret = config.access_key \
            or os.environ.get("AWS_SECRET_ACCESS_KEY")
        self._token = config.session_token \
            or os.environ.get("AWS_SESSION_TOKEN")
        self._endpoint = config.endpoint_url \
            or os.environ.get("AWS_ENDPOINT_URL")

    # ------------------------------------------------------------- signing
    def _sign(self, method: str, host: str, canonical_uri: str,
              query: str, headers: Dict[str, str], payload_hash: str) -> None:
        """AWS Signature Version 4 (header-based)."""
        if self.config.anonymous or not (self._key_id and self._secret):
            return
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash
        if self._token:
            headers["x-amz-security-token"] = self._token
        signed = sorted(k.lower() for k in headers if k.lower() == "host"
                        or k.lower().startswith("x-amz-")
                        or k.lower() == "range")
        canonical_headers = "".join(
            f"{k}:{_header_val(headers, k)}\n" for k in signed)
        signed_headers = ";".join(signed)
        canonical_request = "\n".join([
            method, canonical_uri, query, canonical_headers, signed_headers,
            payload_hash])
        scope = f"{datestamp}/{self._region}/s3/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical_request.encode()).hexdigest()])

        def _hmac(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _hmac(("AWS4" + self._secret).encode(), datestamp)
        k = _hmac(k, self._region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        sig = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self._key_id}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={sig}")

    # ------------------------------------------------------------ transport
    def _locate(self, bucket: str) -> Tuple[str, int, bool, str]:
        """(host, port, tls, uri_prefix) — path-style for custom endpoints,
        virtual-hosted for AWS."""
        if self._endpoint:
            u = urllib.parse.urlparse(self._endpoint)
            tls = u.scheme == "https"
            return (u.hostname, u.port or (443 if tls else 80), tls,
                    f"/{bucket}")
        return (f"{bucket}.s3.{self._region}.amazonaws.com", 443, True, "")

    def _request(self, method: str, bucket: str, key: str,
                 query: Dict[str, str] = None, headers: Dict[str, str] = None,
                 body: bytes = b"") -> Tuple[int, Dict[str, str], bytes]:
        host, port, tls, prefix = self._locate(bucket)
        canonical_uri = prefix + "/" + urllib.parse.quote(key, safe="/~._-")
        qitems = sorted((query or {}).items())
        qs = "&".join(f"{urllib.parse.quote(k, safe='~._-')}="
                      f"{urllib.parse.quote(str(v), safe='~._-')}"
                      for k, v in qitems)
        hdrs = dict(headers or {})
        hdrs["host"] = host if port in (80, 443) else f"{host}:{port}"
        payload_hash = hashlib.sha256(body).hexdigest() if body \
            else _EMPTY_SHA256
        self._sign(method, host, canonical_uri, qs, hdrs, payload_hash)
        path = canonical_uri + (f"?{qs}" if qs else "")

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
                    f"s3 {method} {path}: HTTP {status}: {data[:200]!r}")
                time.sleep(retry_backoff_s(path, attempt))
                continue
            return status, rheaders, data
        raise last_exc

    # ------------------------------------------------------------- ObjectSource
    def get(self, path, byte_range=None, stats=None) -> bytes:
        bucket, key = _parse_s3_url(path)
        headers = {}
        if byte_range is not None:
            headers["range"] = f"bytes={byte_range[0]}-{byte_range[1] - 1}"
        status, _, data = self._request("GET", bucket, key, headers=headers)
        if status not in (200, 206):
            raise FileNotFoundError(f"s3 GET {path}: HTTP {status}")
        if stats:
            stats.record_get(len(data))
        return data

    def get_ranges(self, path, ranges, stats=None, parallelism=None):
        return parallel_get_ranges(
            self, path, ranges, stats,
            min(parallelism or 8, self.config.max_connections))

    def put(self, path, data, stats=None) -> None:
        bucket, key = _parse_s3_url(path)
        status, _, body = self._request("PUT", bucket, key, body=data)
        if status not in (200, 201):
            raise IOError(f"s3 PUT {path}: HTTP {status}: {body[:200]!r}")
        if stats:
            stats.record_put(len(data))

    def get_size(self, path) -> int:
        bucket, key = _parse_s3_url(path)
        status, headers, _ = self._request("HEAD", bucket, key)
        if status != 200:
            raise FileNotFoundError(f"s3 HEAD {path}: HTTP {status}")
        lower = {k.lower(): v for k, v in headers.items()}
        return int(lower.get("content-length", 0))

    def version(self, path):
        # S3 always returns an ETag on HEAD: the object's change signal
        # (a content hash for simple puts, opaque for multipart)
        try:
            bucket, key = _parse_s3_url(path)
            status, headers, _ = self._request("HEAD", bucket, key)
            if status != 200:
                return None
            lower = {k.lower(): v for k, v in headers.items()}
            tag = lower.get("etag") or lower.get("last-modified")
            if not tag:
                return None
            return ("s3", int(lower.get("content-length", 0) or 0), tag)
        except Exception:
            return None

    def _list(self, bucket: str, prefix: str,
              delimiter: Optional[str] = None,
              stats: Optional[IOStatsContext] = None
              ) -> Iterator[Tuple[str, int]]:
        token = None
        while True:
            q = {"list-type": "2", "prefix": prefix}
            if delimiter:
                q["delimiter"] = delimiter
            if token:
                q["continuation-token"] = token
            status, _, data = self._request("GET", bucket, "", query=q)
            if status != 200:
                raise IOError(f"s3 LIST {bucket}/{prefix}: HTTP {status}")
            if stats:
                stats.record_list()
            root = ET.fromstring(data)
            ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") \
                else ""
            for c in root.findall(f"{ns}Contents"):
                key = c.find(f"{ns}Key").text
                size = int(c.find(f"{ns}Size").text or 0)
                yield key, size
            trunc = root.find(f"{ns}IsTruncated")
            if trunc is None or trunc.text != "true":
                return
            nxt = root.find(f"{ns}NextContinuationToken")
            token = nxt.text if nxt is not None else None
            if not token:
                return

    def glob(self, pattern, stats=None) -> List[str]:
        bucket, keypat = _parse_s3_url(pattern)
        wild = min((keypat.index(ch) for ch in "*?[" if ch in keypat),
                   default=None)
        if wild is None:
            return [pattern]
        prefix = keypat[:wild]
        pat = re.compile(_glob_regex(keypat))
        out = []
        for key, _size in self._list(bucket, prefix, stats=stats):
            if pat.match(key):
                out.append(f"s3://{bucket}/{key}")
        return sorted(out)

    def ls(self, path) -> Iterator[Tuple[str, int]]:
        bucket, prefix = _parse_s3_url(path)
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        for key, size in self._list(bucket, prefix, delimiter="/"):
            yield f"s3://{bucket}/{key}", size


def _glob_regex(pat: str) -> str:
    """Glob → regex where ``**`` crosses '/' and ``*``/``?`` do not."""
    out = []
    i = 0
    while i < len(pat):
        ch = pat[i]
        if ch == "*":
            if pat[i:i + 2] == "**":
                out.append(".*")
                i += 2
                if i < len(pat) and pat[i] == "/":
                    i += 1
                continue
            out.append("[^/]*")
        elif ch == "?":
            out.append("[^/]")
        elif ch == "[":
            j = pat.find("]", i)
            if j == -1:
                out.append("\\[")
            else:
                out.append(pat[i:j + 1])
                i = j
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out) + "$"


def _header_val(headers: Dict[str, str], lower_key: str) -> str:
    for k, v in headers.items():
        if k.lower() == lower_key:
            return str(v).strip()
    return ""


class S3ReadableFile(io.RawIOBase):
    """Seekable file-like over ranged S3 GETs — feeds pyarrow readers so
    parquet footer/row-group reads become true range requests (the
    reference's read_planner byte-range model, ``daft-parquet/read_planner``)."""

    def __init__(self, source: S3Source, path: str,
                 stats: Optional[IOStatsContext] = None,
                 size: Optional[int] = None):
        self._src = source
        self._path = path
        self._stats = stats
        self._lazy_size = size  # HEAD deferred until a read/seek needs it
        self._pos = 0

    @property
    def _size(self) -> int:
        if self._lazy_size is None:
            self._lazy_size = self._src.get_size(self._path)
        return self._lazy_size

    def readable(self):
        return True

    def seekable(self):
        return True

    def seek(self, offset, whence=io.SEEK_SET):
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return self._pos

    def tell(self):
        return self._pos

    def read(self, n=-1):
        if n is None or n < 0:
            n = self._size - self._pos
        if n <= 0 or self._pos >= self._size:
            return b""
        end = min(self._pos + n, self._size)
        data = self._src.get(self._path, (self._pos, end), self._stats)
        self._pos += len(data)
        return data

    def size(self):
        return self._size
