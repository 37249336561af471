"""Cross-replica cache tier: warm state regardless of landing replica.

The port's copy of ``daft_tpu/fleet/cache_tier.py``. The serving caches
(``serving/caches.py``) are process-local LRUs; with N replicas behind
the router, a repeat query that lands on a different
replica than its first run pays full execution again. This tier adds a
SECOND cache layer the scheduler consults on a local miss, keyed by the
same ``logical/fingerprint.py`` fingerprints — which means the existing
invalidation rules carry over wholesale: source ``(size, mtime_ns)``
version tokens, the ExecutionConfig hash, and the calibration-generation
token are all baked into the key, so a stale entry is simply never
looked up again (no cross-process invalidation protocol needed).

Two deployments:

- :class:`InProcessCacheTier` — a shared hub for in-process replicas
  (tests, the embedded fleet): plans AND results, shared by reference.
- :class:`SidecarCacheTier` — an HTTP client to a :class:`CacheSidecar`
  store process (``python -m daft_tpu_torch.fleet.cache_tier --port
  N``).
  Results cross the wire as Arrow IPC streams; plans stay per-replica
  (a physical plan holds live scan tasks and closures — not portable),
  which session-affinity routing already keeps warm where they're used.

Every path degrades to a miss on any failure — the tier can slow a
repeat query down to normal execution, never break it. No locks are held
across serialization or network calls.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional, Tuple

from .. import knobs
from ..serving.caches import _LRUCache
from . import state_sync

_DEFAULT_TIMEOUT_S = 2.0


def http_server(address, handler):
    """A threading HTTP server for the fleet's planes (this sidecar and a
    replica's control plane), with a listen backlog of 128: the standard
    library's 5 refuses connections when a handful of clients and the
    router's health probes arrive at once, which the router would read as
    a dead replica."""
    from http.server import ThreadingHTTPServer

    class _Server(ThreadingHTTPServer):
        request_queue_size = 128
        daemon_threads = True

    return _Server(address, handler)


def _fp_token(fp) -> str:
    """Process-portable cache token: fingerprint keys are tuples of
    strings/ints whose repr is deterministic across processes."""
    return hashlib.sha256(repr(fp.key).encode()).hexdigest()


# ------------------------------------------------------- serialization

def _result_to_ipc(ps) -> bytes:
    import pyarrow as pa
    t = ps.to_recordbatch().to_arrow_table()
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue().to_pybytes()


def _result_from_ipc(data: bytes):
    import pyarrow as pa

    from ..micropartition import MicroPartition
    from ..runners.runner import PartitionSet
    from ..schema import Schema
    t = pa.ipc.open_stream(pa.py_buffer(data)).read_all()
    mp = MicroPartition.from_arrow_table(t)
    return PartitionSet([mp], Schema.from_arrow(t.schema))


# ------------------------------------------------------------- in-process

class InProcessCacheTier:
    """Shared hub for in-process replicas: each replica's scheduler keeps
    its own local caches and falls through to this one, so the fleet
    tests exercise the exact local-miss → tier-hit → local-promote flow
    the sidecar deployment uses — minus the wire."""

    def __init__(self, result_budget_bytes: int = 256 << 20,
                 plan_budget_bytes: int = 64 << 20):
        self._results = _LRUCache(result_budget_bytes)
        self._plans = _LRUCache(plan_budget_bytes)

    def get_result(self, fp):
        got = self._results.get(fp.key)
        state_sync.count("cache_tier_hits" if got is not None
                         else "cache_tier_misses")
        return got

    def put_result(self, fp, ps) -> None:
        try:
            nbytes = int(ps.size_bytes() or 0)
        except Exception:
            return
        self._results.put(fp.key, ps, nbytes)
        state_sync.count("cache_tier_puts")

    def get_plan(self, fp) -> Optional[Tuple]:
        return self._plans.get(fp.key)

    def put_plan(self, fp, optimized_plan, physical_plan) -> None:
        from ..serving.caches import PlanCache
        nbytes = PlanCache._NODE_COST * (
            PlanCache._tree_size(optimized_plan)
            + PlanCache._tree_size(physical_plan))
        self._plans.put(fp.key, (optimized_plan, physical_plan), nbytes)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {"results": self._results.stats(),
                "plans": self._plans.stats()}


# ---------------------------------------------------------------- sidecar

class SidecarCacheTier:
    """HTTP client to a :class:`CacheSidecar` store. Result-only (see
    module docstring); every failure counts and degrades to a miss."""

    def __init__(self, address: str, timeout_s: float = _DEFAULT_TIMEOUT_S):
        self.address = address.rstrip("/")
        if "://" not in self.address:
            self.address = "http://" + self.address
        self.timeout_s = float(timeout_s)

    def _url(self, fp) -> str:
        return f"{self.address}/result/{_fp_token(fp)}"

    def get_result(self, fp):
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(self._url(fp),
                                        timeout=self.timeout_s) as r:
                data = r.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                state_sync.count("cache_tier_misses")
            else:
                state_sync.count("cache_tier_errors")
            return None
        except Exception:
            state_sync.count("cache_tier_errors")
            return None
        try:
            ps = _result_from_ipc(data)
        except Exception:
            state_sync.count("cache_tier_errors")
            return None
        state_sync.count("cache_tier_hits")
        return ps

    def put_result(self, fp, ps) -> None:
        import urllib.request
        try:
            data = _result_to_ipc(ps)
        except Exception:
            state_sync.count("cache_tier_errors")
            return
        try:
            req = urllib.request.Request(
                self._url(fp), data=data, method="PUT",
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            state_sync.count("cache_tier_puts")
        except Exception:
            state_sync.count("cache_tier_errors")

    def get_plan(self, fp):
        return None  # plans are not portable across processes

    def put_plan(self, fp, optimized_plan, physical_plan) -> None:
        pass

    def stats(self) -> Dict[str, object]:
        import json
        import urllib.request
        try:
            with urllib.request.urlopen(f"{self.address}/stats",
                                        timeout=self.timeout_s) as r:
                return json.loads(r.read().decode())
        except Exception:
            return {}


class CacheSidecar:
    """The store process: a byte-budgeted LRU of opaque result blobs
    behind a tiny HTTP surface (GET/PUT ``/result/<token>``, GET
    ``/stats``). Single-writer semantics are irrelevant — entries are
    immutable (the fingerprint token pins content), so last-put-wins."""

    def __init__(self, budget_bytes: int = 256 << 20, port: int = 0,
                 host: str = "127.0.0.1"):
        self._blobs = _LRUCache(budget_bytes)
        self._host = host
        self._port = port
        self._httpd = None
        self._thread = None

    @property
    def address(self) -> str:
        return f"{self._host}:{self._port}"

    def start(self) -> str:
        from http.server import BaseHTTPRequestHandler
        blobs = self._blobs

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _token(self):
                parts = self.path.strip("/").split("/")
                if len(parts) == 2 and parts[0] == "result":
                    return parts[1]
                return None

            def do_GET(self):
                if self.path == "/stats":
                    import json
                    body = json.dumps(blobs.stats()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                tok = self._token()
                blob = blobs.get((tok,)) if tok else None
                if blob is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_PUT(self):
                tok = self._token()
                n = int(self.headers.get("Content-Length", 0) or 0)
                data = self.rfile.read(n) if n else b""
                if tok and data:
                    blobs.put((tok,), data, len(data))
                self.send_response(204)
                self.end_headers()

        self._httpd = http_server((self._host, self._port), Handler)
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="daft-torch-cache-sidecar", daemon=True)
        self._thread.start()
        return self.address

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


# ------------------------------------------------------- process install

_installed_lock = threading.Lock()
_installed = None


def install(tier) -> None:
    """Install the process's cache tier — what a scheduler built without
    an explicit ``cache_tier`` falls back to. None uninstalls (tests)."""
    global _installed
    with _installed_lock:
        _installed = tier


def installed():
    with _installed_lock:
        return _installed


def tier_from_env():
    """Build the tier the environment asks for: a sidecar client when
    ``DAFT_TORCH_FLEET_SIDECAR`` names a store, else None."""
    addr = knobs.env_str("DAFT_TORCH_FLEET_SIDECAR")
    if addr:
        return SidecarCacheTier(addr)
    return None


def _main() -> int:
    """Sidecar store entrypoint:
    ``python -m daft_tpu_torch.fleet.cache_tier [--port N]``."""
    import argparse
    import time

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args()
    budget = knobs.env_bytes("DAFT_TORCH_FLEET_SIDECAR_BYTES")
    sc = CacheSidecar(budget_bytes=budget, port=args.port, host=args.host)
    addr = sc.start()
    print(f"FLEET_SIDECAR_READY {addr}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        sc.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
