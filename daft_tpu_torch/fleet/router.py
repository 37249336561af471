"""Front-door router: session-affinity placement of Connect sessions.

The port's copy of ``daft_tpu/fleet/router.py``. One consistent-hash ring
(sha256 hashpoints, ``DAFT_TORCH_FLEET_VNODES``
virtual nodes per replica) maps session ids onto replicas; the first
route for a session is STICKY — an assignment map pins it so ring
changes (replicas joining) never migrate a live session, which is what
keeps its plan-cache / jitted-fragment warmth on one replica. A session
moves only when its replica stops admitting:

- **death** (``kill`` or a crashed subprocess): the session re-routes to
  the next admitting replica on the ring (counter ``reroute``), and the
  raised :class:`ReplicaUnavailable` carries ``retry_after_s`` so the
  Connect front door can return structured retryable UNAVAILABLE;
- **drain** (``drain``): the replica stops admitting (its scheduler
  rejects with kind ``draining``), finishes or cooperatively cancels
  in-flight queries via their ``CancelToken``s, and every session it
  held is handed off — the router re-pins them and fires
  ``release_session`` on the old replica so the 60s idle-TTL sweep's
  work happens NOW instead of leaking re-homed queues.

The router also aggregates per-replica queue-depth / admitted-bytes
gauges into a worker-pool scale signal (``scale_signal``), the
autoscaling hook the fleet bench reports.

Replica flavors: :class:`InProcessReplica` (own scheduler + state store,
shared process — tests and the embedded fleet) and
:class:`SubprocessReplica` (a real ``fleet/replica.py`` process with its
own Connect server and control HTTP plane — the bench/CI deployment).
All router state lives under one lock; every replica call (submit,
drain, HTTP control) happens outside it.

Where the port differs from the reference (each for a replica on a card,
whose start-up and queries take longer and whose libraries log):

- ``SubprocessReplica`` drains the replica's output on a reader thread
  for the replica's whole life, keeping a bounded tail (the reference
  stopped reading at ``FLEET_REPLICA_READY``, so a replica that logged
  64 KiB blocked in ``write``); the tail goes into the error when the
  replica dies or misses a deadline;
- a replica whose Connect server could not import (no ``grpcio`` or
  ``protobuf``) reports ``connect: null`` with the reason, and the
  router never hands out an empty Connect address
  (:meth:`FleetRouter.connect_address` raises :class:`ConnectUnavailable`
  with that reason; ``sql`` goes over ``POST /sql``);
- ``spawn``'s deadline and the control deadline keep the reference's
  defaults (60 s, 5 s) and are the caller's to raise; a drain waits its
  own grace plus the control deadline.
"""

from __future__ import annotations

import bisect
import hashlib
import http.client
import threading
from typing import Dict, List, Optional

from .. import knobs
from . import state_sync


#: a control call to a replica that died or is dying: refused, reset, or
#: an answer cut off mid-body (``http.client.IncompleteRead``)
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class ConnectUnavailable(RuntimeError):
    """The routed replica serves no Spark Connect endpoint (its server
    could not import); the message carries the replica's reason."""

    def __init__(self, message: str, replica: Optional[str] = None):
        super().__init__(message)
        self.replica = replica


class ReplicaUnavailable(RuntimeError):
    """A routed replica is dead/unreachable and no peer could take the
    query. Carries retry-info for the Connect front door's structured
    UNAVAILABLE mapping."""

    def __init__(self, message: str, replica: Optional[str] = None,
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.replica = replica
        self.retry_after_s = retry_after_s


def _hashpoint(s: str) -> int:
    return int(hashlib.sha256(s.encode()).hexdigest()[:16], 16)


class _Ring:
    """Consistent-hash ring with virtual nodes."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = max(int(vnodes), 1)
        self._points: List[int] = []       # sorted hashpoints
        self._owners: Dict[int, str] = {}  # hashpoint → replica name

    def add(self, name: str) -> None:
        for i in range(self.vnodes):
            hp = _hashpoint(f"{name}#{i}")
            if hp in self._owners:
                continue
            bisect.insort(self._points, hp)
            self._owners[hp] = name

    def remove(self, name: str) -> None:
        for i in range(self.vnodes):
            hp = _hashpoint(f"{name}#{i}")
            if self._owners.get(hp) == name:
                del self._owners[hp]
                idx = bisect.bisect_left(self._points, hp)
                if idx < len(self._points) and self._points[idx] == hp:
                    del self._points[idx]

    def route(self, session: str, eligible) -> Optional[str]:
        """First vnode clockwise of the session's hashpoint owned by an
        eligible replica; walks the whole ring before giving up."""
        if not self._points:
            return None
        start = bisect.bisect_right(self._points, _hashpoint(session))
        n = len(self._points)
        for off in range(n):
            owner = self._owners[self._points[(start + off) % n]]
            if owner in eligible:
                return owner
        return None


# ---------------------------------------------------------------- replicas

class InProcessReplica:
    """One replica inside this process: its own QueryScheduler and
    StateStore (optionally a shared cache tier). GIL-bound — the unit
    the fleet tests exercise; real scale-out is SubprocessReplica."""

    def __init__(self, name: str, cache_tier=None, **scheduler_kwargs):
        from ..serving.scheduler import QueryScheduler
        self.name = name
        self.store = state_sync.StateStore(origin=name)
        self.scheduler = QueryScheduler(
            fleet_state=self.store, cache_tier=cache_tier, name=name,
            **scheduler_kwargs)
        self._alive = True

    def alive(self) -> bool:
        return self._alive

    def admitting(self) -> bool:
        return self._alive and not self.scheduler.draining

    def submit(self, query, session: str, **kw):
        if not self._alive:
            raise ReplicaUnavailable(
                f"replica {self.name!r} is dead", replica=self.name)
        return self.scheduler.submit(query, session=session, **kw)

    def sql(self, sql: str, session: str = "default",
            timeout_s: float = 120.0) -> dict:
        """SQL round-trip through this replica's scheduler — the same
        shape ``SubprocessReplica.sql`` answers over HTTP."""
        if not self._alive:
            raise ReplicaUnavailable(
                f"replica {self.name!r} is dead", replica=self.name)
        from ..sql import sql as run_sql
        h = self.scheduler.submit(run_sql(sql), session=session)
        ps = h.result(timeout=timeout_s)
        out = {"data": ps.to_recordbatch().to_pydict()}
        serving = getattr(h.stats, "serving", None) if h.stats else None
        if serving:
            out["serving"] = {
                k: serving[k] for k in
                ("plan_cache", "result_cache", "admitted_bytes")
                if k in serving}
        return out

    def kill(self) -> int:
        """Simulated crash: stop admitting, cooperatively cancel every
        queued and in-flight query. Returns handles signalled."""
        self._alive = False
        return self.scheduler.cancel_all("replica killed")

    def drain(self, timeout_s: float = 10.0) -> Dict[str, object]:
        return self.scheduler.drain(timeout_s)

    def release_session(self, session: str) -> bool:
        return self.scheduler.release_session(session)

    def sessions(self) -> List[str]:
        with self.scheduler._cond:
            return list(self.scheduler._sessions)

    def state_snapshot(self) -> dict:
        self.store.publish_from_engine(self.scheduler)
        return self.store.snapshot_all()

    def ingest_state(self, state: dict) -> int:
        return self.store.ingest_all(state)

    def gauges(self) -> Dict[str, float]:
        return self.scheduler.gauges()

    def counters(self) -> Dict[str, float]:
        return self.scheduler.counters_snapshot()

    def shutdown(self) -> None:
        self._alive = False
        self.scheduler.shutdown()


class _OutputDrain:
    """Reads a replica's combined stdout and stderr on a daemon thread
    from spawn to exit, so the replica never blocks on a full pipe. The
    ``FLEET_REPLICA_READY`` line is queued for :meth:`ready_line`; every
    line lands in a tail of at most ``TAIL_BYTES``."""

    TAIL_BYTES = 64 << 10

    def __init__(self, name: str, stream):
        import collections
        import queue
        self._stream = stream
        self._tail = collections.deque()
        self._tail_size = 0
        self._lock = threading.Lock()
        self._ready: "queue.Queue[Optional[str]]" = queue.Queue()
        self._seen_ready = False
        self.bytes = 0
        self._thread = threading.Thread(
            target=self._run, name=f"daft-torch-fleet-drain-{name}",
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        for line in self._stream:
            with self._lock:
                self.bytes += len(line)
                self._tail.append(line)
                self._tail_size += len(line)
                while self._tail_size > self.TAIL_BYTES \
                        and len(self._tail) > 1:
                    self._tail_size -= len(self._tail.popleft())
            if not self._seen_ready and \
                    line.startswith("FLEET_REPLICA_READY"):
                self._seen_ready = True
                self._ready.put(line)
        self._ready.put(None)  # EOF: the replica closed its output

    def ready_line(self, timeout_s: float) -> Optional[str]:
        """The READY line; None at EOF; raises ``queue.Empty`` when the
        deadline passes first."""
        return self._ready.get(timeout=max(timeout_s, 0.0))

    def tail(self) -> str:
        with self._lock:
            return "".join(self._tail)

    def join(self, timeout_s: float) -> None:
        self._thread.join(timeout_s)


class SubprocessReplica:
    """A real replica process (``python -m daft_tpu_torch.fleet.replica``):
    own interpreter, scheduler, Spark Connect server, control HTTP
    plane. The router drives control (drain / release / gossip / gauges)
    over HTTP; query traffic goes to ``connect_address`` via the Connect
    client (None when the replica's Connect could not import, with the
    reason in ``connect_error``) or over ``POST /sql``."""

    def __init__(self, name: str, proc, control_address: str,
                 connect_address: Optional[str], timeout_s: float = 5.0,
                 connect_error: Optional[str] = None, output=None,
                 start_s: float = 0.0):
        self.name = name
        self.proc = proc
        self.control_address = control_address
        self.connect_address = connect_address or None
        self.connect_error = connect_error
        self.timeout_s = timeout_s
        self.output = output
        self.start_s = start_s
        self._killed = False

    @classmethod
    def spawn(cls, name: str, env: Optional[Dict[str, str]] = None,
              timeout_s: float = 60.0, control_timeout_s: float = 5.0
              ) -> "SubprocessReplica":
        """Start one replica (this interpreter running
        ``daft_tpu_torch.fleet.replica``) and wait up to ``timeout_s`` for
        its READY line; ``control_timeout_s`` is the deadline of each
        control call (``/sql`` waits its own timeout on top of it)."""
        import os
        import queue
        import subprocess
        import sys
        import time
        cmd = [sys.executable, "-m", "daft_tpu_torch.fleet.replica",
               "--replica-id", name]
        e = dict(os.environ)
        e.update(env or {})
        t0 = time.monotonic()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, env=e)
        drain = _OutputDrain(name, proc.stdout)
        try:
            line = drain.ready_line(timeout_s)
        except queue.Empty:
            line = ""
        if not line:
            died = proc.poll() is not None
            proc.kill()
            proc.wait()
            drain.join(5.0)
            why = (f"exited rc={proc.returncode} before READY" if died
                   else f"not ready within {timeout_s:.1f} s")
            raise RuntimeError(f"replica {name!r} {why}; its output "
                               f"ends:\n{drain.tail()}")
        start_s = time.monotonic() - t0
        fields = dict(tok.split("=", 1) for tok in line.split()[1:]
                      if "=" in tok)
        connect = fields.get("connect", "")
        connect = None if connect in ("", "null") else connect
        rep = cls(name, proc, fields.get("control", ""), connect,
                  timeout_s=control_timeout_s, output=drain,
                  start_s=start_s)
        if connect is None:
            rep.connect_error = rep.health().get("connect_error") \
                or "the replica started no Connect server"
        return rep

    def _died(self, what: str) -> str:
        tail = self.output.tail() if self.output is not None else ""
        return (f"replica {self.name!r} {what}"
                + (f"; its output ends:\n{tail}" if tail else ""))

    # -- control-plane HTTP -------------------------------------------
    def _url(self, path: str) -> str:
        return f"http://{self.control_address}{path}"

    def _get(self, path: str):
        import json
        import urllib.request
        with urllib.request.urlopen(self._url(path),
                                    timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def _post(self, path: str, obj=None, timeout_s: Optional[float] = None):
        import json
        import urllib.request
        data = json.dumps(obj or {}).encode()
        req = urllib.request.Request(
            self._url(path), data=data, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(
                req, timeout=timeout_s or self.timeout_s) as r:
            body = r.read().decode()
            return json.loads(body) if body else None

    def health(self) -> dict:
        """``/health``: ok, draining, and the Connect address or its
        reason (``connect: null``, ``connect_error``)."""
        return self._get("/health")

    def status(self) -> dict:
        """``/status``: pid, the device queries run on and the kernel
        launches of this replica's process."""
        return self._get("/status")

    def alive(self) -> bool:
        if self._killed or self.proc.poll() is not None:
            return False
        try:
            return bool(self.health().get("ok"))
        except TRANSPORT_ERRORS:
            return False

    def admitting(self) -> bool:
        if self._killed or self.proc.poll() is not None:
            return False
        try:
            h = self.health()
        except TRANSPORT_ERRORS:
            return False
        return bool(h.get("ok")) and not h.get("draining")

    def submit(self, query, session: str, **kw):
        raise ReplicaUnavailable(
            "subprocess replicas take traffic over Spark Connect "
            f"(address {self.connect_address!r}) or ``.sql()``, not "
            "router.submit", replica=self.name)

    def sql(self, sql: str, session: str = "default",
            timeout_s: float = 120.0) -> dict:
        """Run one SQL statement on the replica over the (grpc-free)
        control plane. ``draining``/``shutdown`` rejections and transport
        failures surface as :class:`ReplicaUnavailable` so the router
        re-routes; other admission rejections stay structured."""
        import json as _json
        import urllib.error
        import urllib.request
        if self._killed or self.proc.poll() is not None:
            raise ReplicaUnavailable(
                self._died("is dead"), replica=self.name)
        data = _json.dumps({"sql": sql, "session": session,
                            "timeout_s": timeout_s}).encode()
        req = urllib.request.Request(
            self._url("/sql"), data=data, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_s + self.timeout_s) as r:
                return _json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            try:
                body = e.read().decode(errors="replace")
            except TRANSPORT_ERRORS:
                body = ""
            try:
                kind = _json.loads(body).get("rejected", "unavailable")
            except ValueError:
                kind = "unavailable"
            if e.code == 503 and kind in ("draining", "shutdown"):
                raise ReplicaUnavailable(
                    f"replica {self.name!r} rejected: {kind}",
                    replica=self.name) from None
            from ..serving.scheduler import AdmissionRejected
            if e.code == 503:
                raise AdmissionRejected(
                    kind, f"replica {self.name!r} rejected: {kind}") \
                    from None
            raise RuntimeError(f"replica {self.name!r} /sql failed "
                               f"({e.code}): {body}") from None
        except TRANSPORT_ERRORS as e:  # URLError is an OSError
            # refused, reset or cut mid-answer: the replica is gone
            raise ReplicaUnavailable(
                self._died(f"unreachable: {type(e).__name__}: {e}"),
                replica=self.name) from None

    def _reap(self) -> None:
        import subprocess
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        if self.output is not None:
            self.output.join(5.0)

    def kill(self) -> int:
        self._killed = True
        if self.proc.poll() is None:
            self.proc.kill()
        self._reap()
        return 0

    def drain(self, timeout_s: float = 10.0) -> Dict[str, object]:
        # the replica answers once its drain ends: its grace, then the
        # control deadline
        return self._post("/drain", {"timeout_s": timeout_s},
                          timeout_s=timeout_s + self.timeout_s) or {}

    def release_session(self, session: str) -> bool:
        try:
            r = self._post("/release_session", {"session": session})
        except TRANSPORT_ERRORS:
            return False
        return bool(r and r.get("released"))

    def sessions(self) -> List[str]:
        try:
            return list(self._get("/sessions").get("sessions") or [])
        except TRANSPORT_ERRORS:
            return []

    def state_snapshot(self) -> dict:
        return self._get("/fleet/state")

    def ingest_state(self, state: dict) -> int:
        r = self._post("/fleet/state", state)
        return int((r or {}).get("applied", 0))

    def gauges(self) -> Dict[str, float]:
        try:
            return self._get("/gauges")
        except TRANSPORT_ERRORS:
            return {}

    def counters(self) -> Dict[str, float]:
        try:
            return self._get("/counters")
        except TRANSPORT_ERRORS:
            return {}

    def shutdown(self) -> None:
        self._killed = True
        if self.proc.poll() is None:
            self.proc.terminate()
        self._reap()


# ------------------------------------------------------------------ router

class FleetRouter:
    """Session-affinity router over N replicas (see module docstring)."""

    def __init__(self, replicas=None, vnodes: Optional[int] = None):
        if vnodes is None:
            vnodes = knobs.env_opt_int("DAFT_TORCH_FLEET_VNODES")
        if vnodes is None:
            from ..context import get_context
            vnodes = get_context().execution_config.fleet_vnodes
        self._lock = threading.Lock()
        self._ring = _Ring(vnodes=max(int(vnodes), 1))
        self._replicas: Dict[str, object] = {}
        self._assignments: Dict[str, str] = {}  # session → replica name
        for r in (replicas or []):
            self.add_replica(r)

    # -- membership ----------------------------------------------------
    def add_replica(self, replica) -> None:
        with self._lock:
            self._replicas[replica.name] = replica
            self._ring.add(replica.name)

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)
            self._ring.remove(name)
            for sess, owner in list(self._assignments.items()):
                if owner == name:
                    del self._assignments[sess]

    def replicas(self) -> List[object]:
        with self._lock:
            return list(self._replicas.values())

    def replica(self, name: str):
        with self._lock:
            return self._replicas.get(name)

    # -- routing -------------------------------------------------------
    def _admitting_names(self) -> set:
        # liveness probes may do IO (subprocess health checks) — never
        # under the router lock
        with self._lock:
            reps = list(self._replicas.values())
        return {r.name for r in reps if r.admitting()}

    def owner(self, session: str) -> Optional[str]:
        """The replica ``session`` is pinned to, else the one the ring
        maps it to among the admitting replicas, without pinning it."""
        eligible = self._admitting_names()
        with self._lock:
            owner = self._assignments.get(session)
            if owner is not None and owner in eligible:
                return owner
            return self._ring.route(session, eligible)

    def route(self, session: str):
        """The replica owning ``session`` — sticky while its replica
        admits, re-pinned (counter ``reroute``) when it doesn't."""
        eligible = self._admitting_names()
        with self._lock:
            owner = self._assignments.get(session)
            if owner is not None and owner in eligible:
                return self._replicas[owner]
            target = self._ring.route(session, eligible)
            if target is None:
                raise ReplicaUnavailable(
                    "no admitting replica in the fleet",
                    replica=owner, retry_after_s=1.0)
            self._assignments[session] = target
            rep = self._replicas[target]
        state_sync.count("route")
        if owner is not None and owner != target:
            state_sync.count("reroute")
        return rep

    def submit(self, query, session: str = "default", **kw):
        """Route + submit with one re-route retry: a replica that died
        or began draining between the route and the submit hands the
        query to the next admitting peer."""
        from .. import tracing
        from ..serving.scheduler import AdmissionRejected
        last: Optional[BaseException] = None
        for _attempt in range(2):
            rep = self.route(session)  # raises when the fleet is empty
            try:
                with tracing.span("fleet:route", lane="serving"):
                    h = rep.submit(query, session=session, **kw)
            except ReplicaUnavailable as exc:
                last = exc
                self._forget(session, rep.name)
                continue
            err = h._error if h.done() and h.state == "rejected" else None
            if isinstance(err, AdmissionRejected) \
                    and err.kind in ("draining", "shutdown"):
                last = err
                self._forget(session, rep.name)
                continue
            return h
        raise last if isinstance(last, ReplicaUnavailable) else \
            ReplicaUnavailable(f"submit failed after re-route: {last}",
                               retry_after_s=1.0)

    def sql(self, sql: str, session: str = "default",
            timeout_s: float = 120.0) -> dict:
        """Route + run one SQL statement (the grpc-free traffic path the
        fleet bench/smoke drive), with the same one-retry re-route as
        :meth:`submit` on a replica that died or began draining."""
        from .. import tracing
        last: Optional[BaseException] = None
        for _attempt in range(2):
            rep = self.route(session)
            try:
                with tracing.span("fleet:route", lane="serving"):
                    return rep.sql(sql, session=session,
                                   timeout_s=timeout_s)
            except ReplicaUnavailable as exc:
                last = exc
                self._forget(session, rep.name)
        raise last if last is not None else ReplicaUnavailable(
            "sql failed after re-route", retry_after_s=1.0)

    def _forget(self, session: str, owner: str) -> None:
        with self._lock:
            if self._assignments.get(session) == owner:
                del self._assignments[session]
        state_sync.count("reroute")

    def connect_address(self, session: str) -> str:
        """The Spark Connect address of the replica owning ``session``
        (routed as :meth:`route` does). Raises :class:`ConnectUnavailable`
        with the replica's reason when it serves no Connect endpoint: an
        empty address is never handed out."""
        rep = self.route(session)
        addr = getattr(rep, "connect_address", None)
        if not addr:
            why = getattr(rep, "connect_error", None) \
                or "an in-process replica serves no Connect endpoint"
            raise ConnectUnavailable(
                f"replica {rep.name!r} has no Spark Connect server: {why}",
                replica=rep.name)
        return addr

    def assignments(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._assignments)

    # -- lifecycle -----------------------------------------------------
    def kill(self, name: str) -> Dict[str, object]:
        """Replica death: cancel its in-flight queries, re-home its
        sessions (they re-route on their next submit)."""
        rep = self.replica(name)
        if rep is None:
            return {"killed": False}
        cancelled = rep.kill()
        moved = self._handoff(name)
        state_sync.count("kill")
        return {"killed": True, "cancelled": cancelled,
                "sessions_moved": moved}

    def drain(self, name: str, timeout_s: Optional[float] = None
              ) -> Dict[str, object]:
        """Graceful drain: the replica stops admitting, finishes or
        cancels in-flight work, and hands its sessions off — with an
        immediate ``release_session`` on the old replica so re-homed
        sessions don't wait out the 60s idle TTL."""
        from .. import tracing
        if timeout_s is None:
            timeout_s = knobs.env_opt_float("DAFT_TORCH_FLEET_DRAIN_TIMEOUT")
        if timeout_s is None:
            from ..context import get_context
            timeout_s = get_context().execution_config.fleet_drain_timeout
        rep = self.replica(name)
        if rep is None:
            return {"drained": False}
        with tracing.span("fleet:drain", lane="serving"):
            sessions = rep.sessions()
            stats = rep.drain(float(timeout_s))
            moved = self._handoff(name, sessions=sessions, release=rep)
        state_sync.count("drain")
        out = {"drained": True, "sessions_moved": moved}
        out.update(stats or {})
        return out

    def _handoff(self, name: str, sessions: Optional[List[str]] = None,
                 release=None) -> int:
        """Unpin every session assigned to ``name`` (next submit
        re-routes); optionally fire release_session on the old replica."""
        with self._lock:
            doomed = [s for s, o in self._assignments.items() if o == name]
            for s in doomed:
                del self._assignments[s]
        for s in set(doomed) | set(sessions or []):
            if release is not None:
                release.release_session(s)
            state_sync.count("handoff_sessions")
        return len(doomed)

    # -- learned-state gossip ------------------------------------------
    def gossip_round(self) -> int:
        """One anti-entropy round: pull every live replica's full state,
        keep the newest snapshot per origin, push the union back.
        Returns origin snapshots applied across the fleet."""
        with self._lock:
            reps = list(self._replicas.values())
        reps = [r for r in reps if r.alive()]
        merged: Dict[str, dict] = {}
        for r in reps:
            try:
                snaps = (r.state_snapshot() or {}).get("origins") or {}
            except TRANSPORT_ERRORS:  # died since the liveness probe
                state_sync.count("gossip_errors")
                continue
            for origin, snap in snaps.items():
                cur = merged.get(origin)
                if cur is None or int(snap.get("gen", 0)) \
                        > int(cur.get("gen", 0)):
                    merged[origin] = snap
        applied = 0
        for r in reps:
            try:
                applied += r.ingest_state({"origins": merged})
            except TRANSPORT_ERRORS:
                state_sync.count("gossip_errors")
        state_sync.count("gossip_rounds")
        return applied

    # -- observability + autoscaling hooks -----------------------------
    def gauges(self) -> Dict[str, object]:
        """Per-replica gauges + fleet aggregates (the /api/fleet view)."""
        with self._lock:
            reps = list(self._replicas.values())
        per: Dict[str, Dict[str, float]] = {}
        for r in reps:
            per[r.name] = dict(r.gauges() or {})
            per[r.name]["alive"] = 1.0 if r.alive() else 0.0
        agg = {k: sum(g.get(k, 0.0) for g in per.values())
               for k in ("queued", "running", "admitted_bytes",
                         "concurrency", "sessions")}
        agg["replicas"] = float(len(per))
        agg["replicas_admitting"] = float(
            sum(1 for g in per.values()
                if g.get("alive") and not g.get("draining")))
        return {"replicas": per, "aggregate": agg,
                "assignments": len(self.assignments()),
                "scale_signal": self._scale_signal(agg)}

    @staticmethod
    def _scale_signal(agg: Dict[str, float]) -> Dict[str, float]:
        """Worker-pool scale signal: desired replica count from demand
        (queued + running) vs per-replica concurrency, with a ±1
        hysteresis band so a transient queue blip doesn't flap the pool."""
        admitting = max(agg.get("replicas_admitting", 0.0), 1.0)
        per_replica = max(
            agg.get("concurrency", 0.0) / max(agg.get("replicas", 1.0), 1.0),
            1.0)
        demand = agg.get("queued", 0.0) + agg.get("running", 0.0)
        desired = max(1.0, float(-(-demand // per_replica)))  # ceil
        if abs(desired - admitting) <= 1.0:
            desired = admitting
        return {"demand": demand, "per_replica_slots": per_replica,
                "desired_replicas": desired,
                "utilization": demand / (admitting * per_replica)}

    def scale_signal(self) -> Dict[str, float]:
        return self.gauges()["scale_signal"]

    def shutdown(self) -> None:
        with self._lock:
            reps = list(self._replicas.values())
        for r in reps:
            r.shutdown()
