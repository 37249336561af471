"""Inter-host shuffle transport: spill-backed partition server + client.

Reference: the flight shuffle (``src/daft-shuffles``) — the map side
partitions morsels and spills per-partition Arrow IPC files
(``shuffle_cache.rs:14-80``); each node runs an Arrow Flight gRPC server
serving ``do_get(partition_idx)`` (``server/flight_server.rs:17-170``) and
the reduce side fetches over the network. Here the same design has two
transports behind one seam: a ``ShuffleCache`` accumulates map outputs into
per-partition spill files, and a per-host server exposes them — an actual
**Arrow Flight** gRPC server (``FlightShuffleServer``, default when
``pyarrow.flight`` is importable: ``do_get(<shuffle_id>/<partition>)``
streams record batches straight off the spill files) or a stdlib-HTTP
fallback (``ShuffleServer``: ``GET /shuffle/<id>/<partition>``).
``fetch_partition`` dispatches on the address scheme (``grpc://`` vs
``http://``), so the reduce side is transport-blind. Exchanges between
workers that share a device mesh ride the mesh instead
(``parallel/exchange.py``)."""

from __future__ import annotations

import http.server
import io
import os
import threading
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Dict, List, Optional, Tuple

import pyarrow as pa
import pyarrow.ipc as paipc

try:
    import pyarrow.flight as paflight
except ImportError:  # pragma: no cover - flight is baked into this image
    paflight = None


# ------------------------------------------------------- shuffle counters
# Process-wide data-plane accounting, mirroring the device-kernel dispatch
# ledger and the resilience counters: ``RuntimeStatsContext`` snapshots at
# query start and diffs at finish() for the per-query ``shuffle`` block
# (bytes written/fetched, compression ratio, combine reduction, fetch wall
# vs serial-equivalent time).

_shuffle_counters_lock = threading.Lock()
_shuffle_counters: Dict[str, float] = {}


def shuffle_count(name: str, n: float = 1) -> None:
    with _shuffle_counters_lock:
        _shuffle_counters[name] = _shuffle_counters.get(name, 0) + n
    # context-local attribution for the serving plane (overlapping
    # queries each see only their own shuffle traffic)
    from .. import observability as obs
    obs.bump_plane("shuffle", name, n)


def shuffle_counters_snapshot() -> Dict[str, float]:
    with _shuffle_counters_lock:
        return dict(_shuffle_counters)


def shuffle_counters_delta(before: Dict[str, float],
                           after: Optional[Dict[str, float]] = None
                           ) -> Dict[str, float]:
    if after is None:
        after = shuffle_counters_snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


def shuffle_counters_reset() -> None:
    with _shuffle_counters_lock:
        _shuffle_counters.clear()


# ------------------------------------------------------ wire compression

#: spill/wire chunk size: the HTTP handler sends (and the orphan of a
#: partition occupies) at most this much resident memory per partition,
#: regardless of partition size
_CHUNK_BYTES = 1 << 20

#: fetches below this decoded size are RTT-dominated and must not feed
#: the calibrated wire-rate profile
_WIRE_OBS_MIN_BYTES = 256 << 10

_ipc_opts_cache: Dict[str, Tuple[Optional[object], Optional[str]]] = {}


def _ipc_write_options() -> Tuple[Optional["paipc.IpcWriteOptions"],
                                  Optional[str]]:
    """(IPC write options, codec name) for shuffle spill writers.
    ``DAFT_TORCH_SHUFFLE_COMPRESSION=lz4|zstd|none`` (default ``lz4``)
    selects Arrow IPC *buffer* compression — self-describing on the wire,
    so readers (``_spill_streams`` / ``_spill_file_batches`` / the fetch
    path, including the post-seal straggler-append single-write branch)
    need no configuration. Auto-falls back to uncompressed when the codec
    is missing from this pyarrow build."""
    from .. import knobs
    pref = knobs.env_str("DAFT_TORCH_SHUFFLE_COMPRESSION").lower()
    if pref in ("none", "off", "0", ""):
        return None, None
    hit = _ipc_opts_cache.get(pref)
    if hit is not None:
        return hit
    try:
        opts = paipc.IpcWriteOptions(compression=pref)
    except Exception:
        opts = None  # unknown codec / not built in → uncompressed
    out = (opts, pref if opts is not None else None)
    _ipc_opts_cache[pref] = out
    return out


class ShuffleCache:
    """Map-side output accumulator: morsels are hash-partitioned by the
    caller; each partition's batches append to one Arrow IPC spill file
    (reference: InProgressShuffleCache → per-partition writer tasks)."""

    def __init__(self, shuffle_id: Optional[str] = None,
                 dirs: Optional[List[str]] = None):
        from ..execution.memory import spill_dir
        self.shuffle_id = shuffle_id or uuid.uuid4().hex
        self._root = os.path.join((dirs or [spill_dir()])[0],
                                  f"shuffle_{self.shuffle_id}")
        os.makedirs(self._root, exist_ok=True)
        self._lock = threading.Lock()
        self._writers: Dict[int, Tuple[object, object]] = {}
        self._rows: Dict[int, int] = {}
        self._sealed = False

    def _writer(self, partition: int, schema: pa.Schema):
        w = self._writers.get(partition)
        if w is None:
            f = open(self._path(partition), "ab")
            opts, _ = _ipc_write_options()
            w = (paipc.new_stream(f, schema, options=opts), f)
            self._writers[partition] = w
        return w[0]

    def _path(self, partition: int) -> str:
        return os.path.join(self._root, f"part-{partition}.arrow")

    def push(self, partition: int, table: pa.Table) -> None:
        with self._lock:
            if self._sealed:
                # straggler after seal: append one complete, flushed IPC
                # stream in a single write so a concurrent fetch never sees
                # a torn header mid-stream (fetch also tolerates a
                # truncated tail — see _spill_streams)
                buf = io.BytesIO()
                opts, _ = _ipc_write_options()
                with paipc.new_stream(buf, table.schema, options=opts) as w:
                    w.write_table(table)
                payload = buf.getvalue()
                # daft-lint: allow(blocking-under-lock) -- post-seal
                # straggler append must be atomic vs concurrent fetches
                # reading this file; local spill-dir write, rare path
                with open(self._path(partition), "ab") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                shuffle_count("bytes_written", len(payload))
            else:
                # daft-lint: allow(blocking-under-lock) -- per-partition
                # writer state and the sealed check are one atomic unit;
                # the open is a once-per-partition local file create
                self._writer(partition, table.schema).write_table(table)
            self._rows[partition] = self._rows.get(partition, 0) + len(table)
        shuffle_count("rows_pushed", table.num_rows)
        shuffle_count("bytes_pushed_raw", table.nbytes)

    def close(self) -> None:
        with self._lock:
            if self._sealed:
                return
            for w, f in self._writers.values():
                w.close()
                f.close()
            self._writers = {}
            self._sealed = True
            # on-disk == on-wire bytes (the server streams the spill files
            # verbatim); straggler appends are counted at push time
            written = 0
            for p in self._rows:
                try:
                    written += os.path.getsize(self._path(p))
                except OSError:
                    pass
        shuffle_count("bytes_written", written)

    def partition_chunks(self, partition: int, limit: Optional[int] = None,
                         chunk_bytes: int = _CHUNK_BYTES):
        """Yield one partition's spill-file bytes in bounded chunks — the
        serving side's resident memory is ``chunk_bytes``, never the
        partition size. Reads exactly ``limit`` bytes when given (the size
        an HTTP Content-Length was announced from), else the size at open,
        so a concurrent straggler append can't outgrow an announced
        length."""
        p = self._path(partition)
        if limit is None:
            try:
                limit = os.path.getsize(p)
            except OSError:
                return
        try:
            f = open(p, "rb")
        except OSError:
            if limit:
                raise  # announced bytes are gone: fail the serve
            return
        with f:
            remaining = limit
            while remaining > 0:
                chunk = f.read(min(chunk_bytes, remaining))
                if not chunk:
                    return
                remaining -= len(chunk)
                yield chunk

    def partition_size(self, partition: int) -> int:
        try:
            return os.path.getsize(self._path(partition))
        except OSError:
            return 0

    def lost(self, partition: int) -> bool:
        """True when rows were pushed to ``partition`` but its spill file
        is gone: the cache was cleaned up (unregistered, or a crashed
        source) while a fetch was being served. The server must fail that
        fetch, never serve it as an empty partition."""
        return self._rows.get(partition, 0) > 0 \
            and not os.path.exists(self._path(partition))

    def stats(self) -> Tuple[int, int, Dict[int, int]]:
        """(total rows pushed, total on-disk bytes, per-partition rows) —
        the EXACT boundary cardinalities the runtime re-planner consumes
        (they ride back to the driver on the map receipt)."""
        with self._lock:
            part_rows = dict(self._rows)
        rows = sum(part_rows.values())
        nbytes = sum(self.partition_size(p) for p in part_rows)
        return rows, nbytes, part_rows

    def touch(self) -> None:
        """Refresh the spill dir's mtime: an actively-served output must
        never look orphaned to the TTL sweep (the TTL is an IDLE bound,
        not a lifetime bound)."""
        try:
            os.utime(self._root, None)
        except OSError:
            pass

    def partitions(self) -> List[int]:
        return sorted(self._rows)

    def cleanup(self) -> None:
        self.close()
        for f in os.listdir(self._root):
            try:
                os.unlink(os.path.join(self._root, f))
            except OSError:
                pass
        try:
            os.rmdir(self._root)
        except OSError:
            pass


class ShuffleServer:
    """Per-host partition server (reference: per-node Flight server).
    ``host`` is the bind address — pass ``0.0.0.0`` (or set
    ``DAFT_TORCH_SHUFFLE_HOST``) to serve other hosts; ``advertise_host`` is
    what ``address`` reports to peers (defaults to the bind host)."""

    def __init__(self, port: int = 0, host: Optional[str] = None,
                 advertise_host: Optional[str] = None):
        from .. import knobs
        self._host = host or knobs.env_str("DAFT_TORCH_SHUFFLE_HOST")
        self._advertise = advertise_host \
            or knobs.env_str("DAFT_TORCH_SHUFFLE_ADVERTISE") \
            or ("127.0.0.1" if self._host == "0.0.0.0" else self._host)
        self._caches: Dict[str, ShuffleCache] = {}
        self._lock = threading.Lock()
        caches = self._caches
        lock = self._lock

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_DELETE(self):
                # reduce-side release of a consumed map output
                parts = self.path.strip("/").split("/")
                if len(parts) == 2 and parts[0] == "shuffle":
                    with lock:
                        cache = caches.pop(parts[1], None)
                    if cache is not None:
                        cache.cleanup()
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                from .. import tracing
                parts = self.path.strip("/").split("/")
                if len(parts) != 3 or parts[0] != "shuffle":
                    self.send_response(404)
                    self.end_headers()
                    return
                sid, pidx = parts[1], int(parts[2])
                with lock:
                    cache = caches.get(sid)
                if cache is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                cache.touch()
                # serve-side child span when the fetch carried span
                # context headers and the trace lives in this process
                # span key derives from the PARENT (fetch) span id — a
                # stable identity; the shuffle uuid is run-specific and
                # would break bit-identical chaos replay
                tctx = tracing.context_from_headers(self.headers)
                skey = f"serve:{tctx.span_id}" if tctx is not None \
                    else None
                with tracing.attach(tctx), \
                        tracing.span("shuffle:serve", key=skey,
                                     lane="shuffle") as sp:
                    # chunked send off the spill file: resident memory is
                    # one chunk, never the partition (Content-Length comes
                    # from a stat, and partition_chunks sends exactly that
                    # many bytes even under a concurrent straggler append)
                    size = cache.partition_size(pidx)
                    if size == 0 and cache.lost(pidx):
                        # unregistered under this fetch: its data is
                        # gone, which is not an empty partition
                        self.send_response(410)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    sp.set("bytes", size)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/vnd.apache.arrow.stream")
                    self.send_header("Content-Length", str(size))
                    self.end_headers()
                    for chunk in cache.partition_chunks(pidx, limit=size):
                        self.wfile.write(chunk)

        self._server = http.server.ThreadingHTTPServer((self._host, port),
                                                       Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="daft-torch-shuffle").start()

    @property
    def address(self) -> str:
        return f"http://{self._advertise}:{self._server.server_port}"

    def register(self, cache: ShuffleCache) -> None:
        cache.close()  # seal files before serving
        with self._lock:
            self._caches[cache.shuffle_id] = cache
        # one served stream source per registered map output — the
        # stream-count evidence behind the hierarchical exchange (one
        # stream per MESH instead of one per worker)
        shuffle_count("streams_registered")

    def unregister(self, shuffle_id: str) -> None:
        with self._lock:
            cache = self._caches.pop(shuffle_id, None)
        if cache is not None:
            cache.cleanup()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class FlightShuffleServer:
    """Per-host Arrow Flight partition server (the reference's actual
    transport: ``server/flight_server.rs:17-170`` serves ``do_get``; clients
    fetch with ``flight_client.rs``). Tickets are ``<shuffle_id>/<part>``;
    batches stream straight off the spill files, never materializing a
    partition in server memory."""

    def __init__(self, port: int = 0, host: Optional[str] = None,
                 advertise_host: Optional[str] = None):
        if paflight is None:
            raise RuntimeError("pyarrow.flight not available; "
                               "use ShuffleServer (HTTP)")
        from .. import knobs
        self._host = host or knobs.env_str("DAFT_TORCH_SHUFFLE_HOST")
        self._advertise = advertise_host \
            or knobs.env_str("DAFT_TORCH_SHUFFLE_ADVERTISE") \
            or ("127.0.0.1" if self._host == "0.0.0.0" else self._host)
        self._caches: Dict[str, ShuffleCache] = {}
        self._lock = threading.Lock()
        outer = self

        class _Server(paflight.FlightServerBase):
            def do_action(self, context, action):
                if action.type == "unregister":
                    outer.unregister(action.body.to_pybytes().decode())
                    return iter(())
                raise paflight.FlightServerError(
                    f"unknown action {action.type!r}")

            def do_get(self, context, ticket):
                from .. import tracing
                # ticket: <sid>/<part>[/<trace_id>/<parent_span>] — the
                # trailing pair is the span context riding the Flight wire
                fields = ticket.ticket.decode().split("/")
                sid, pidx = fields[0], fields[1]
                if len(fields) >= 4:
                    tctx = tracing.remote_context(fields[2], fields[3])
                    if tctx is not None:
                        # keyed on the stable parent (fetch) span id, not
                        # the run-specific shuffle uuid — replay contract
                        tracing.event("shuffle:serve",
                                      key=f"serve:{fields[3]}",
                                      lane="shuffle", ctx=tctx)
                with outer._lock:
                    cache = outer._caches.get(sid)
                if cache is None:
                    raise paflight.FlightServerError(
                        f"unknown shuffle {sid!r}")
                cache.touch()
                path = cache._path(int(pidx))
                gen = _spill_file_batches(path)
                first = next(gen, None)
                if first is None and cache.lost(int(pidx)):
                    raise paflight.FlightServerError(
                        f"shuffle {sid!r} partition {pidx} was "
                        f"unregistered while it was fetched")
                if first is None:
                    # empty partition: marked-schema sentinel (out-of-band —
                    # a real zero-column partition with rows must survive)
                    empty = pa.schema(
                        [], metadata={b"daft_torch_empty": b"1"})
                    return paflight.GeneratorStream(empty, iter(()))
                schema, batch0 = first

                def batches():
                    yield batch0
                    for _, b in gen:
                        yield b

                opts, _ = _ipc_write_options()
                if opts is not None:
                    try:  # compress the Flight wire like the spill files
                        return paflight.GeneratorStream(schema, batches(),
                                                        options=opts)
                    except TypeError:  # pyarrow without the options kwarg
                        pass
                return paflight.GeneratorStream(schema, batches())

        # the port is bound in __init__ (so .port is valid immediately);
        # serve() blocks until shutdown() — run it on a daemon thread
        self._server = _Server(f"grpc://{self._host}:{port}")
        threading.Thread(target=self._server.serve, daemon=True,
                         name="daft-torch-flight-shuffle").start()

    @property
    def address(self) -> str:
        return f"grpc://{self._advertise}:{self._server.port}"

    def register(self, cache: ShuffleCache) -> None:
        cache.close()  # seal files before serving
        with self._lock:
            self._caches[cache.shuffle_id] = cache
        # stream-count evidence, same as the HTTP server (hierarchical
        # exchanges register one stream per mesh, flight one per worker)
        shuffle_count("streams_registered")

    def unregister(self, shuffle_id: str) -> None:
        with self._lock:
            cache = self._caches.pop(shuffle_id, None)
        if cache is not None:
            cache.cleanup()

    def shutdown(self) -> None:
        self._server.shutdown()


def sweep_orphaned_shuffles(root: Optional[str] = None,
                            ttl_s: Optional[float] = None) -> List[str]:
    """Startup sweep: delete ``shuffle_<id>/`` spill dirs IDLE longer
    than a TTL (``DAFT_TORCH_SHUFFLE_TTL``, seconds, default 86400) — the
    remains of crashed workers that never reached
    ``ShuffleCache.cleanup()``. Serving a partition refreshes the dir's
    mtime, so an actively-fetched output never ages out.
    With no explicit ``root``, sweeps this process's spill dir AND every
    sibling ``daft_torch_spill_*`` root under the tmpdir (a crashed
    process's per-process mkdtemp root is exactly where its orphans
    live). The TTL guards live dirs of concurrent processes. Returns the
    removed paths."""
    import glob
    import shutil
    import tempfile
    import time as _time
    if root is None:
        from ..execution.memory import spill_dir
        roots = [spill_dir()]
        roots += [p for p in glob.glob(os.path.join(
            tempfile.gettempdir(), "daft_torch_spill_*"))
            if p not in roots and os.path.isdir(p)]
    else:
        roots = [root]
    if ttl_s is None:
        from .. import knobs
        ttl_s = knobs.env_float("DAFT_TORCH_SHUFFLE_TTL")
    removed: List[str] = []
    cutoff = _time.time() - ttl_s
    for r in roots:
        try:
            entries = os.listdir(r)
        except OSError:
            continue
        for name in entries:
            if not name.startswith("shuffle_"):
                continue
            path = os.path.join(r, name)
            try:
                if os.path.isdir(path) and os.path.getmtime(path) < cutoff:
                    shutil.rmtree(path, ignore_errors=True)
                    removed.append(path)
            except OSError:
                continue
    return removed


_swept_once = False
_swept_lock = threading.Lock()


def make_shuffle_server(port: int = 0, host: Optional[str] = None):
    """Transport factory: Arrow Flight when available (the reference's
    design), stdlib HTTP otherwise; ``DAFT_TORCH_SHUFFLE_TRANSPORT=http``
    forces the fallback. The first server created in a process also
    sweeps orphaned shuffle dirs crashed processes left behind (once —
    the glob+stat walk is not worth repeating per server)."""
    global _swept_once
    with _swept_lock:
        sweep = not _swept_once
        _swept_once = True
    if sweep:
        try:
            sweep_orphaned_shuffles()
        except Exception:
            pass  # janitorial; must never block serving
    from .. import knobs
    pref = knobs.env_str("DAFT_TORCH_SHUFFLE_TRANSPORT")
    if pref != "http" and paflight is not None:
        return FlightShuffleServer(port, host=host)
    return ShuffleServer(port, host=host)


_local_server = None
_local_server_lock = threading.Lock()


def get_local_shuffle_server():
    """One lazily-started shuffle server per process (each worker host runs
    one, like the reference's per-node flight server)."""
    global _local_server
    with _local_server_lock:
        if _local_server is None:
            _local_server = make_shuffle_server()
        return _local_server


def configure_local_shuffle_server(host: str, advertise_host: str):
    """Eagerly create the process shuffle server with explicit networking
    (worker startup calls this BEFORE any map task can lazily boot a
    loopback-bound one). Conflicting reconfiguration is an error — the
    advertised address is baked into outstanding map receipts."""
    global _local_server
    with _local_server_lock:
        if _local_server is not None:
            current = _local_server.address
            want_host = advertise_host or host
            cur_host = urllib.parse.urlparse(
                current if "://" in current else f"http://{current}").hostname
            if cur_host != want_host.lower():  # urlparse lowercases hostname
                raise RuntimeError(
                    f"shuffle server already running at {current}; cannot "
                    f"re-advertise as {want_host}")
            return _local_server
        _local_server = make_shuffle_server(host=host)
        if advertise_host:
            _local_server._advertise = advertise_host
        return _local_server


def _spill_streams(body: bytes):
    """Yield (schema, batch-list) per concatenated IPC stream in a spill
    file (one stream per writer reopen). A truncated trailing stream — a
    straggler append caught mid-write — is skipped; the dropped tail is
    logged so mid-file corruption (which also truncates everything after
    it) is never silent."""
    if not body:
        return
    buf = pa.BufferReader(body)
    while buf.tell() < buf.size():
        start = buf.tell()
        try:
            with paipc.open_stream(buf) as rd:
                batches = list(rd)
        except pa.ArrowInvalid:
            _log_truncated_tail(start, buf.size())
            return
        yield rd.schema, batches


def _log_truncated_tail(pos: int, size: int) -> None:
    import logging
    logging.getLogger(__name__).warning(
        "shuffle spill file: unreadable IPC stream at byte %d; dropping "
        "%d trailing bytes (torn straggler append, or corruption if not "
        "at the tail)", pos, size - pos)


def _spill_file_batches(path: str):
    """Lazily yield (schema, batch) straight off a spill file, one record
    batch at a time (never materializes the partition in memory). Tolerates
    (and logs) a truncated trailing stream like _spill_streams."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with pa.OSFile(path, "rb") as f:
        while f.tell() < size:
            start = f.tell()
            try:
                rd = paipc.open_stream(f)
            except pa.ArrowInvalid:
                _log_truncated_tail(start, size)
                return
            schema = rd.schema
            while True:
                try:
                    batch = rd.read_next_batch()
                except StopIteration:
                    break
                except pa.ArrowInvalid:
                    _log_truncated_tail(start, size)
                    return
                yield schema, batch


def unregister_remote(address: str, shuffle_id: str) -> None:
    """Release a consumed map output on its serving host (reduce-side
    cleanup; dispatches on the address scheme like fetch_partition)."""
    if address.startswith("grpc://"):
        if paflight is None:
            return
        client = paflight.connect(address)
        try:
            list(client.do_action(
                paflight.Action("unregister", shuffle_id.encode())))
        finally:
            client.close()
        return
    req = urllib.request.Request(f"{address}/shuffle/{shuffle_id}",
                                 method="DELETE")
    with urllib.request.urlopen(req, timeout=30):
        pass


def fetch_partition(address: str, shuffle_id: str, partition: int,
                    fault_key: Optional[str] = None) -> Optional[pa.Table]:
    """Reduce-side fetch: partition bytes → Arrow table (reference:
    flight_client do_get). Dispatches on the address scheme. Any failure
    raises ``ShuffleFetchError`` carrying the (address, shuffle_id)
    identity the scheduler's lineage recovery keys on. ``fault_key`` is
    the stable (run-independent) source identity used for deterministic
    fault injection; it defaults to the shuffle id."""
    from .. import tracing
    from .resilience import ShuffleFetchError, active_fault_plan
    key = fault_key or shuffle_id
    # one span per fetch attempt, keyed by the stable source identity —
    # injected faults and transport failures land as error-status spans
    with tracing.span("shuffle:fetch", key=f"fetch:{key}/p{partition}",
                      attrs={"address": address, "partition": partition},
                      lane="shuffle") as sp:
        plan = active_fault_plan()
        if plan is not None:  # injection site 2: partition fetch
            if plan.decide("crash", f"{key}/p{partition}"):
                # a dead map worker: the served data is really gone —
                # every later fetch of this shuffle fails too, until the
                # scheduler recomputes the producing map task
                try:
                    unregister_remote(address, shuffle_id)
                except Exception:
                    pass
                raise ShuffleFetchError(address, shuffle_id, partition,
                                        detail="injected worker crash",
                                        injected=True)
            if plan.decide("fetch", f"{key}/p{partition}"):
                raise ShuffleFetchError(address, shuffle_id, partition,
                                        detail="injected fetch fault",
                                        injected=True)
        import time as _time
        t0 = _time.perf_counter()
        try:
            out = _fetch_partition_raw(address, shuffle_id, partition)
        except Exception as exc:
            raise ShuffleFetchError(address, shuffle_id, partition,
                                    detail=f"{type(exc).__name__}: "
                                           f"{str(exc)[:200]}") from exc
        elapsed = _time.perf_counter() - t0
        # serial-equivalent fetch time: the per-call sum the parallel
        # fetch's span is compared against in the overlap evidence
        shuffle_count("fetch_wall_us", elapsed * 1e6)
        shuffle_count("fetches")
        # calibration chokepoint (round 20): sizable fetches feed the
        # observed wire rate (tiny partitions measure RTT, not bandwidth)
        if out is not None and out.nbytes >= _WIRE_OBS_MIN_BYTES \
                and elapsed > 1e-3:
            from ..device import calibration
            calibration.observe("SHUFFLE_WIRE_BPS", out.nbytes / elapsed)
        sp.set("rows", out.num_rows if out is not None else 0)
        return out


class _CountingStream:
    """Minimal file-like over an HTTP response: counts wire bytes and
    supports 1-probe pushback so concatenated IPC streams can be read
    incrementally (never buffering the whole body)."""

    def __init__(self, raw):
        self._raw = raw
        self._buf = b""
        self.nread = 0

    def read(self, n=-1):
        if n is None or n < 0:
            out = self._buf + self._raw.read()
            self._buf = b""
        elif self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            if len(out) < n:
                out += self._raw.read(n - len(out))
        else:
            out = self._raw.read(n)
        self.nread += len(out)
        return out

    def push(self, data: bytes) -> None:
        self._buf = data + self._buf
        self.nread -= len(data)

    def readable(self):
        return True

    def seekable(self):
        return False

    def writable(self):
        return False

    @property
    def closed(self):
        return False

    def flush(self):
        pass

    def close(self):
        # pyarrow's PythonFile closes the source when the reader closes;
        # the SAME response must stay readable for the next concatenated
        # stream, so closing is a no-op (the with-block on the response
        # owns the socket)
        pass


def _iter_stream_tables(f: "_CountingStream"):
    """Yield one Table per concatenated IPC stream, read INCREMENTALLY off
    a file-like (the HTTP fetch path: resident memory is the decoded
    batches of the current stream, never the raw body). A truncated
    trailing stream — a torn straggler append — is logged and dropped,
    same contract as ``_spill_streams``."""
    while True:
        head = f.read(1)  # probe: clean EOF between streams?
        if not head:
            return
        f.push(head)
        start = f.nread
        try:
            with paipc.open_stream(f) as rd:
                batches = list(rd)
                schema = rd.schema
        except pa.ArrowInvalid:
            # drain-and-count in chunks: the dropped-tail size for the log
            # without materializing the remaining body (this path must stay
            # as memory-bounded as the happy path)
            rest = 0
            while True:
                chunk = f.read(_CHUNK_BYTES)
                if not chunk:
                    break
                rest += len(chunk)
            _log_truncated_tail(start, f.nread + rest)
            return
        yield pa.Table.from_batches(batches, schema=schema)


def _fetch_partition_raw(address: str, shuffle_id: str, partition: int
                         ) -> Optional[pa.Table]:
    from .. import tracing
    if address.startswith("grpc://"):
        if paflight is None:
            raise RuntimeError(
                f"shuffle peer advertises Flight ({address}) but "
                "pyarrow.flight is unavailable on this host; set "
                "DAFT_TORCH_SHUFFLE_TRANSPORT=http on the serving hosts")
        client = paflight.connect(address)
        try:
            # span context rides the ticket (Flight's header equivalent):
            # <sid>/<part>[/<trace_id>/<parent_span>]
            tstr = f"{shuffle_id}/{partition}"
            tctx = tracing.current()
            if tctx is not None:
                tid, psid = tctx.wire()
                tstr += f"/{tid}/{psid}"
            reader = client.do_get(paflight.Ticket(tstr.encode()))
            t = reader.read_all()
        finally:
            client.close()
        # decoded batch bytes — the flight client API exposes no
        # compressed-frame size; wire compression shows on the WRITE side
        # (bytes_written vs bytes_pushed_raw), which both transports share
        shuffle_count("bytes_fetched", t.nbytes)
        meta = t.schema.metadata or {}
        return None if meta.get(b"daft_torch_empty") == b"1" else t
    url = f"{address}/shuffle/{shuffle_id}/{partition}"
    from .. import knobs
    timeout = knobs.env_float("DAFT_TORCH_SHUFFLE_TIMEOUT")
    try:
        # span context propagates as headers over the HTTP shuffle wire
        r = urllib.request.urlopen(
            urllib.request.Request(url, headers=tracing.wire_headers()),
            timeout=timeout)
    except urllib.error.HTTPError as exc:
        # urlopen raises on every non-200 — surface the status explicitly
        # so ShuffleFetchError.detail carries it (a 404 here usually means
        # the serving worker unregistered/lost the shuffle: lineage
        # recovery's cue)
        raise RuntimeError(
            f"shuffle server returned HTTP {exc.code} for "
            f"{shuffle_id}/p{partition}") from exc
    with r:
        src = _CountingStream(r)
        tables = list(_iter_stream_tables(src))
        shuffle_count("bytes_fetched", max(src.nread, 0))
    if not tables:
        return None
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]
