"""Replica subprocess entrypoint: one driver process of the fleet.

The port's copy of ``daft_tpu/fleet/replica.py``.
``python -m daft_tpu_torch.fleet.replica --replica-id r0`` boots:

- the process-shared :class:`~daft_tpu_torch.serving.QueryScheduler`
  wired to this replica's :class:`~daft_tpu_torch.fleet.state_sync.StateStore`
  (its gossip origin) and, when ``DAFT_TORCH_FLEET_SIDECAR`` names a store,
  the sidecar cache tier; queries run on the card unless the environment
  asks for the CPU (``DAFT_TORCH_DEVICE=cpu``);
- the embedded Spark Connect server (query traffic). Where ``grpcio`` or
  ``protobuf`` does not import, the replica starts without it and says
  so: ``/health`` reports ``connect: null`` and the import error as
  ``connect_error``, and the READY line prints ``connect=null`` (the
  reference swallowed any exception and printed an empty address). Any
  other failure of the server's start is the replica's failure;
- its host-card link profile, measured before READY (the replicas of
  one host start one after another: each measures on a quiet link, not
  at its first query under its peers' traffic);
- a control HTTP plane the router drives: ``/health``, ``/status`` (pid,
  device, kernel launches, link profile), ``/gauges``, ``/counters``, ``/sessions``,
  ``/fleet/state`` (GET = export, POST = anti-entropy exchange: ingest the
  peer's snapshots, answer with ours), ``POST /sql``, ``/drain``,
  ``/release_session``, ``/metrics`` (prometheus text);
- a gossip loop (``DAFT_TORCH_FLEET_GOSSIP_S``) that republishes this
  replica's learned state and exchanges with every peer in
  ``DAFT_TORCH_FLEET_PEERS`` (comma-separated control addresses).

On readiness it prints ``FLEET_REPLICA_READY control=<addr>
connect=<addr or null>`` on stdout — the line
:meth:`SubprocessReplica.spawn` waits for. SIGTERM triggers a graceful
drain before exit.
"""

from __future__ import annotations

import json
import threading
from typing import List, Optional

from .. import knobs
from . import cache_tier, state_sync

#: the packages the Connect server needs; only their absence is tolerated
_CONNECT_PACKAGES = ("grpc", "google", "google.protobuf")


def _json_value(v):
    """JSON for the values a result holds that ``json`` has no form for:
    dates and times as ISO text, decimals as their text (the reference's
    ``/sql`` failed on them)."""
    import datetime
    import decimal
    if isinstance(v, (datetime.date, datetime.time)):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return str(v)
    raise TypeError(f"{type(v).__name__} is not JSON serializable")


def _gossip_interval_s() -> float:
    v = knobs.env_opt_float("DAFT_TORCH_FLEET_GOSSIP_S")
    if v is None:
        from ..context import get_context
        v = get_context().execution_config.fleet_gossip_s
    return max(float(v), 0.05)


def _peers() -> List[str]:
    raw = knobs.env_str("DAFT_TORCH_FLEET_PEERS") or ""
    return [p.strip() for p in raw.split(",") if p.strip()]


def start_connect(port: int = 0):
    """``(server, None)``, or ``(None, reason)`` when the Connect server's
    packages (``grpcio``, ``protobuf``) do not import. Any other error
    raises."""
    try:
        from ..connect import start_server
        return start_server(port=port), None
    except ImportError as exc:
        if exc.name not in _CONNECT_PACKAGES:
            raise
        return None, f"{type(exc).__name__}: {exc}"


class ReplicaProcess:
    """The in-process composition of one fleet replica (also usable
    from tests without a subprocess)."""

    def __init__(self, replica_id: str, control_port: int = 0,
                 connect_port: int = 0, with_connect: bool = True):
        from .. import serving
        self.replica_id = replica_id
        self.store = state_sync.StateStore(origin=replica_id)
        state_sync.install(self.store)
        tier = cache_tier.tier_from_env()
        if tier is not None:
            cache_tier.install(tier)
        self.scheduler = serving.shared_scheduler()
        # the host-card link this replica prices with, measured now, while
        # the replicas start one after another, and not at its first
        # priced query under its peers' traffic (read slow there, it sent
        # the group-by's morsels to the host)
        from ..device import costmodel
        self.link = costmodel.link_profile()
        self.connect_server = None
        self.connect_error: Optional[str] = "started with --no-connect"
        if with_connect:
            self.connect_server, self.connect_error = \
                start_connect(connect_port)
        self._httpd = None
        self._control_port = control_port
        self._stop = threading.Event()
        self._gossip_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- control
    @property
    def control_address(self) -> str:
        return f"127.0.0.1:{self._control_port}"

    @property
    def connect_address(self) -> Optional[str]:
        if self.connect_server is None:
            return None
        return f"127.0.0.1:{self.connect_server.port}"

    def start_control(self) -> str:
        from http.server import BaseHTTPRequestHandler
        replica = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code: int = 200):
                body = json.dumps(obj, default=_json_value).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(n) if n else b""
                try:
                    return json.loads(raw.decode()) if raw else {}
                except ValueError:
                    return {}

            def do_GET(self):
                try:
                    if self.path == "/health":
                        self._json(replica.health())
                    elif self.path == "/status":
                        self._json(replica.status())
                    elif self.path == "/gauges":
                        self._json(replica.scheduler.gauges())
                    elif self.path == "/counters":
                        self._json(replica.counters())
                    elif self.path == "/sessions":
                        self._json({"sessions": replica.sessions()})
                    elif self.path == "/fleet/state":
                        replica.store.publish_from_engine(
                            replica.scheduler)
                        self._json(replica.store.snapshot_all())
                    elif self.path == "/metrics":
                        from .. import tracing
                        body = tracing.prometheus_text().encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as exc:  # noqa: BLE001 — answered as a 500
                    self._json({"error": f"{type(exc).__name__}: {exc}"},
                               500)

            def do_POST(self):
                try:
                    body = self._body()
                    if self.path == "/sql":
                        # grpc-free query path: SQL in, pydict out
                        from ..serving import AdmissionRejected
                        try:
                            self._json(replica.run_sql(
                                str(body.get("sql", "")),
                                session=str(body.get("session", "http")),
                                timeout_s=float(
                                    body.get("timeout_s", 120.0))))
                        except AdmissionRejected as exc:
                            self._json({"rejected": exc.kind,
                                        "error": str(exc)}, 503)
                    elif self.path == "/fleet/state":
                        applied = replica.store.ingest_all(body)
                        replica.store.publish_from_engine(
                            replica.scheduler)
                        out = replica.store.snapshot_all()
                        out["applied"] = applied
                        self._json(out)
                    elif self.path == "/drain":
                        stats = replica.scheduler.drain(
                            float(body.get("timeout_s", 10.0)))
                        self._json(stats)
                    elif self.path == "/release_session":
                        self._json({"released": replica.release_session(
                            str(body.get("session", "")))})
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as exc:  # noqa: BLE001 — answered as a 500
                    self._json({"error": f"{type(exc).__name__}: {exc}"},
                               500)

        self._httpd = cache_tier.http_server(
            ("127.0.0.1", self._control_port), Handler)
        self._control_port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever,
                             name=f"daft-torch-fleet-ctl-{self.replica_id}",
                             daemon=True)
        t.start()
        return self.control_address

    # ------------------------------------------------------------- views
    def health(self) -> dict:
        return {"ok": True, "replica": self.replica_id,
                "draining": self.scheduler.draining,
                "connect": self.connect_address,
                "connect_error": (None if self.connect_server is not None
                                  else self.connect_error)}

    def status(self) -> dict:
        """pid, the device this replica's queries run on (``cuda``,
        ``cpu`` or ``host``) and its process's kernel launch counts, as
        a remote worker's ``/status`` gives them, and the link profile
        it measured at start-up (None where it shares host memory)."""
        import math

        from ..distributed.remote_worker import worker_status
        out = worker_status()
        out["replica"] = self.replica_id
        lp = self.link
        out["link"] = None if math.isinf(lp.up_bps) else dict(
            rtt_s=lp.rtt_s, up_bps=lp.up_bps, down_bps=lp.down_bps)
        return out

    def sessions(self) -> List[str]:
        out = set()
        with self.scheduler._cond:
            out.update(self.scheduler._sessions)
        if self.connect_server is not None:
            out.update(self.connect_server.sessions())
        return sorted(out)

    def counters(self) -> dict:
        from ..analysis import lock_sanitizer
        out = dict(self.scheduler.counters_snapshot())
        out["session_count"] = len(self.sessions())
        out["state_gen"] = self.store.generation()
        out["lock_graph_cycles"] = \
            lock_sanitizer.counters_snapshot().get("graph_cycles", 0)
        for k, v in state_sync.counters_snapshot().items():
            out[f"fleet_{k}"] = v
        return out

    def run_sql(self, sql: str, session: str = "http",
                timeout_s: float = 120.0) -> dict:
        """Plan + schedule one SQL statement through this replica's
        scheduler; returns the materialized result as a pydict plus the
        serving block (cache outcomes, admitted bytes)."""
        from ..sql import sql as plan_sql
        df = plan_sql(sql)
        h = self.scheduler.submit(df, session=session)
        ps = h.result(timeout=timeout_s)
        out = {"data": ps.to_recordbatch().to_pydict()}
        serving = getattr(h.stats, "serving", None) if h.stats else None
        if serving:
            out["serving"] = {
                k: serving[k] for k in
                ("plan_cache", "result_cache", "admitted_bytes")
                if k in serving}
        return out

    def release_session(self, session: str) -> bool:
        if self.connect_server is not None:
            # also releases the scheduler's session queue via the
            # process-shared scheduler
            return self.connect_server.release_session(session)
        return self.scheduler.release_session(session)

    # ------------------------------------------------------------ gossip
    def start_gossip(self) -> None:
        peers = _peers()
        if not peers:
            return
        interval = _gossip_interval_s()

        def loop():
            import urllib.request
            while not self._stop.wait(interval):
                self.store.publish_from_engine(self.scheduler)
                own = self.store.snapshot_all()
                data = json.dumps(own).encode()
                for peer in peers:
                    if peer == self.control_address:
                        continue
                    try:
                        req = urllib.request.Request(
                            f"http://{peer}/fleet/state", data=data,
                            method="POST",
                            headers={"Content-Type": "application/json"})
                        with urllib.request.urlopen(req, timeout=2.0) as r:
                            theirs = json.loads(r.read().decode())
                        self.store.ingest_all(theirs)
                    except OSError:  # a peer gone or slow: next round
                        state_sync.count("gossip_errors")
                state_sync.count("gossip_rounds")

        self._gossip_thread = threading.Thread(
            target=loop, name=f"daft-torch-fleet-gossip-{self.replica_id}",
            daemon=True)
        self._gossip_thread.start()

    # ---------------------------------------------------------- lifecycle
    def stop(self, drain_timeout_s: float = 5.0) -> None:
        self._stop.set()
        self.scheduler.drain(drain_timeout_s)
        if self.connect_server is not None:
            self.connect_server.stop(grace=1.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def _main() -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser()
    ap.add_argument("--replica-id",
                    default=knobs.env_str("DAFT_TORCH_FLEET_REPLICA_ID")
                    or "replica-0")
    ap.add_argument("--control-port", type=int, default=0)
    ap.add_argument("--connect-port", type=int, default=0)
    ap.add_argument("--no-connect", action="store_true")
    args = ap.parse_args()

    rp = ReplicaProcess(args.replica_id, control_port=args.control_port,
                        connect_port=args.connect_port,
                        with_connect=not args.no_connect)
    rp.start_control()
    rp.start_gossip()
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: done.set())
    signal.signal(signal.SIGINT, lambda *a: done.set())
    print(f"FLEET_REPLICA_READY control={rp.control_address} "
          f"connect={rp.connect_address or 'null'}", flush=True)
    done.wait()
    rp.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
