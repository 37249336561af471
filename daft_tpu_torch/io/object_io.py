"""Multi-source object IO layer.

The port's copy of ``daft_tpu/io/object_io.py``, itself a capability mirror
of the reference engine's ``src/daft-io`` crate: an
``ObjectSource`` trait (get/put/get_size/glob/ls — ``object_io.rs:177-210``)
with per-scheme implementations, an ``IOClient`` cache keyed by
(scheme, config) and ``IOStatsContext`` byte/request counters
(``src/daft-io/src/stats.rs``). Cloud sources are native no-SDK clients:
S3 (``s3.py``, SigV4), GCS (``gcs.py``, JSON API), Azure Blob
(``azure.py``, SharedKey/SAS). The per-query attribution of IO-pool work
waits for the port's ``observability.py`` (ROADMAP A8): the counters here
and in ``read_planner.py`` are process-wide.
"""

from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import glob as _glob
import hashlib
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple

#: HTTP statuses worth retrying across every object source (throttle +
#: transient server errors); any other 4xx/3xx is deterministic — retrying
#: a 404 just burns the whole retry budget against a missing key
RETRYABLE_STATUS = frozenset({408, 429, 500, 502, 503, 504})


def retry_backoff_s(key: str, attempt: int, base: float = 0.05,
                    cap: float = 2.0) -> float:
    """Bounded exponential backoff with deterministic jitter for object
    source retry loops (same policy shape as the resilience plane's
    ``RetryPolicy.backoff_s`` / ``FetchRetryState``: the jitter hashes
    from (key, attempt), so chaos replays pace identically)."""
    exp = base * (2 ** max(attempt, 0))
    h = int(hashlib.sha256(f"{key}:{attempt}".encode()).hexdigest()[:8], 16)
    return min(exp * (0.5 + h / 0xFFFFFFFF), cap)


_io_pool_lock = threading.Lock()
_io_pool: Optional[_cf.ThreadPoolExecutor] = None


def io_pool() -> _cf.ThreadPoolExecutor:
    """Shared bounded pool for parallel range fetches (the process-wide
    analogue of the reference's tokio IO runtime)."""
    global _io_pool
    with _io_pool_lock:
        if _io_pool is None:
            _io_pool = _cf.ThreadPoolExecutor(
                max_workers=max(min((os.cpu_count() or 4) * 2, 16), 4),
                thread_name_prefix="daft-torch-io")
        return _io_pool


def parallel_get_ranges(source: "ObjectSource", path: str,
                        ranges: List[Tuple[int, int]],
                        stats: Optional["IOStatsContext"] = None,
                        parallelism: Optional[int] = None) -> List[bytes]:
    """Fetch ``ranges`` concurrently on the shared IO pool, bounded by
    ``parallelism`` in-flight requests; results come back in input order.
    The per-scheme sources route ``get_ranges`` here (their connection
    pools make the concurrent GETs reuse sockets)."""
    par = max(parallelism or 1, 1)
    if len(ranges) <= 1 or par <= 1:
        return [source.get(path, r, stats) for r in ranges]
    pool = io_pool()
    out: List[Optional[bytes]] = [None] * len(ranges)
    it = iter(enumerate(ranges))
    pending = {}
    err: List[BaseException] = []

    def submit():
        try:
            i, r = next(it)
        except StopIteration:
            return
        pending[pool.submit(source.get, path, r, stats)] = i

    for _ in range(min(par, len(ranges))):
        submit()
    while pending:
        done, _ = _cf.wait(list(pending),
                           return_when=_cf.FIRST_COMPLETED)
        for f in done:
            i = pending.pop(f)
            try:
                out[i] = f.result()
            except BaseException as exc:  # noqa: BLE001
                err.append(exc)
            if not err:
                submit()
    if err:
        raise err[0]
    return out


# ---------------------------------------------------------------------------
# configs (reference: src/common/io-config)


@dataclasses.dataclass(frozen=True)
class S3Config:
    region_name: Optional[str] = None
    endpoint_url: Optional[str] = None
    key_id: Optional[str] = None
    access_key: Optional[str] = None
    session_token: Optional[str] = None
    anonymous: bool = False
    max_connections: int = 64
    num_tries: int = 5


@dataclasses.dataclass(frozen=True)
class GCSConfig:
    project_id: Optional[str] = None
    anonymous: bool = False
    # static OAuth2 bearer token (service-account flows need a token broker;
    # the reference reads credentials the same lazily-pluggable way)
    access_token: Optional[str] = None
    endpoint_url: Optional[str] = None  # override for emulators/tests
    max_connections: int = 32
    num_tries: int = 5


@dataclasses.dataclass(frozen=True)
class AzureConfig:
    storage_account: Optional[str] = None
    access_key: Optional[str] = None
    sas_token: Optional[str] = None
    anonymous: bool = False
    endpoint_url: Optional[str] = None  # override for Azurite/tests
    max_connections: int = 32
    num_tries: int = 5


@dataclasses.dataclass(frozen=True)
class HTTPConfig:
    user_agent: str = "daft-tpu/0.1"
    bearer_token: Optional[str] = None
    num_tries: int = 3


@dataclasses.dataclass(frozen=True)
class IOConfig:
    s3: S3Config = dataclasses.field(default_factory=S3Config)
    gcs: GCSConfig = dataclasses.field(default_factory=GCSConfig)
    azure: AzureConfig = dataclasses.field(default_factory=AzureConfig)
    http: HTTPConfig = dataclasses.field(default_factory=HTTPConfig)


# ---------------------------------------------------------------------------
# stats


class IOStatsContext:
    """Request/byte counters (reference: ``IOStatsContext``, stats.rs)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self.num_gets = 0
        self.num_puts = 0
        self.num_lists = 0
        self.bytes_read = 0
        self.bytes_written = 0

    def record_get(self, nbytes: int):
        with self._lock:
            self.num_gets += 1
            self.bytes_read += nbytes

    def record_put(self, nbytes: int):
        with self._lock:
            self.num_puts += 1
            self.bytes_written += nbytes

    def record_list(self):
        with self._lock:
            self.num_lists += 1


# ---------------------------------------------------------------------------
# sources


class ObjectSource:
    """Scheme-specific object storage backend (reference trait:
    ``src/daft-io/src/object_io.rs:177-210``)."""

    scheme = ""

    def get(self, path: str, byte_range: Optional[Tuple[int, int]] = None,
            stats: Optional[IOStatsContext] = None) -> bytes:
        raise NotImplementedError

    def get_ranges(self, path: str, ranges: List[Tuple[int, int]],
                   stats: Optional[IOStatsContext] = None,
                   parallelism: Optional[int] = None) -> List[bytes]:
        """Fetch several byte ranges of one object; results in input
        order. Default loops over :meth:`get`; network sources override
        with pooled concurrent requests."""
        return [self.get(path, r, stats) for r in ranges]

    def put(self, path: str, data: bytes,
            stats: Optional[IOStatsContext] = None) -> None:
        raise NotImplementedError

    def get_size(self, path: str) -> int:
        raise NotImplementedError

    def glob(self, pattern: str,
             stats: Optional[IOStatsContext] = None) -> List[str]:
        raise NotImplementedError

    def ls(self, path: str) -> Iterator[Tuple[str, int]]:
        raise NotImplementedError


class LocalSource(ObjectSource):
    scheme = "file"

    @staticmethod
    def _strip(path: str) -> str:
        if path.startswith("file://"):
            return path[len("file://"):]
        return path

    def get(self, path, byte_range=None, stats=None):
        p = self._strip(path)
        with open(p, "rb") as f:
            if byte_range is not None:
                start, end = byte_range
                f.seek(start)
                data = f.read(end - start)
            else:
                data = f.read()
        if stats:
            stats.record_get(len(data))
        return data

    def get_ranges(self, path, ranges, stats=None, parallelism=None):
        # one open + seeks: local disk gains nothing from pooled threads
        out = []
        with open(self._strip(path), "rb") as f:
            for start, end in ranges:
                f.seek(start)
                out.append(f.read(end - start))
        if stats:
            for b in out:
                stats.record_get(len(b))
        return out

    def put(self, path, data, stats=None):
        p = self._strip(path)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
        if stats:
            stats.record_put(len(data))

    def get_size(self, path):
        return os.path.getsize(self._strip(path))

    def glob(self, pattern, stats=None):
        if stats:
            stats.record_list()
        p = self._strip(pattern)
        if os.path.isdir(p):
            p = os.path.join(p, "**")
        hits = sorted(h for h in _glob.glob(p, recursive=True)
                      if os.path.isfile(h))
        return hits

    def ls(self, path):
        p = self._strip(path)
        for entry in sorted(os.listdir(p)):
            full = os.path.join(p, entry)
            yield full, (os.path.getsize(full) if os.path.isfile(full) else 0)


class HTTPSource(ObjectSource):
    scheme = "http"

    def __init__(self, config: HTTPConfig = HTTPConfig()):
        self.config = config

    def _request(self, path: str, byte_range=None):
        headers = {"User-Agent": self.config.user_agent}
        if self.config.bearer_token:
            headers["Authorization"] = f"Bearer {self.config.bearer_token}"
        if byte_range is not None:
            headers["Range"] = f"bytes={byte_range[0]}-{byte_range[1] - 1}"
        return urllib.request.Request(path, headers=headers)

    def get(self, path, byte_range=None, stats=None):
        last_err = None
        tries = max(1, self.config.num_tries)
        for attempt in range(tries):
            try:
                with urllib.request.urlopen(self._request(path, byte_range)) as r:
                    data = r.read()
                if stats:
                    stats.record_get(len(data))
                return data
            except urllib.error.HTTPError as exc:
                # non-transient statuses (404, 403, 400 …) are
                # deterministic: retrying just burns the budget
                if exc.code not in RETRYABLE_STATUS:
                    raise
                last_err = exc
            except Exception as exc:  # transient network errors
                last_err = exc
            if attempt + 1 < tries:
                time.sleep(retry_backoff_s(path, attempt))
        raise last_err

    def get_ranges(self, path, ranges, stats=None, parallelism=None):
        return parallel_get_ranges(self, path, ranges, stats,
                                   parallelism or 8)

    def get_size(self, path):
        req = self._request(path)
        req.get_method = lambda: "HEAD"
        with urllib.request.urlopen(req) as r:
            return int(r.headers.get("Content-Length", 0))


# ---------------------------------------------------------------------------
# client


class IOClient:
    """Caches one ``ObjectSource`` per (scheme, config) — reference:
    ``IOClient`` cache in ``src/daft-io/src/lib.rs``."""

    def __init__(self, config: Optional[IOConfig] = None):
        self.config = config or IOConfig()
        self._sources: Dict[str, ObjectSource] = {}
        self._lock = threading.Lock()

    def source_for(self, path: str) -> ObjectSource:
        scheme = urllib.parse.urlparse(path).scheme or "file"
        if scheme in ("http", "https"):
            scheme = "http"
        if scheme == "s3a":
            scheme = "s3"
        with self._lock:
            src = self._sources.get(scheme)
            if src is None:
                src = self._make(scheme)
                self._sources[scheme] = src
            return src

    def _make(self, scheme: str) -> ObjectSource:
        if scheme == "file":
            return LocalSource()
        if scheme == "http":
            return HTTPSource(self.config.http)
        if scheme in ("s3", "s3a"):
            from .s3 import S3Source
            return S3Source(self.config.s3)
        if scheme == "gs":
            from .gcs import GCSSource
            return GCSSource(self.config.gcs)
        if scheme in ("az", "abfs", "abfss"):
            from .azure import AzureBlobSource
            return AzureBlobSource(self.config.azure)
        if scheme == "hf":
            from .hf import HFSource
            return HFSource(self.config.http)
        raise ValueError(f"unsupported URL scheme {scheme!r}")

    # convenience passthroughs
    def get(self, path, byte_range=None, stats=None) -> bytes:
        return self.source_for(path).get(path, byte_range, stats)

    def get_ranges(self, path, ranges, stats=None,
                   parallelism=None) -> List[bytes]:
        return self.source_for(path).get_ranges(path, ranges, stats,
                                                parallelism)

    def put(self, path, data, stats=None) -> None:
        return self.source_for(path).put(path, data, stats)

    def glob(self, pattern, stats=None) -> List[str]:
        return self.source_for(pattern).glob(pattern, stats)

_default_client: Optional[IOClient] = None
_default_lock = threading.Lock()


def get_io_client(config: Optional[IOConfig] = None) -> IOClient:
    global _default_client
    if config is not None:
        return IOClient(config)
    with _default_lock:
        if _default_client is None:
            _default_client = IOClient()
        return _default_client
