"""Multi-tenant query scheduler: the serving plane's control loop.

The port's copy of ``daft_tpu/serving/scheduler.py``. One process, N
concurrent queries, shared engine resources. The pieces:

- **bounded worker pool** — ``DAFT_TORCH_SERVE_CONCURRENCY`` workers drain
  a multi-session queue; everything else (executor thread pools, the
  card, the device column cache, spill dirs) is the same shared engine
  the single-query path uses. Queries execute on the card unless the
  caller asks for the CPU (``backend.resolve_device``).
- **fair queuing** — weighted round-robin across sessions via stride
  scheduling (each dispatch advances the session's virtual ``pass`` by
  ``1/weight``; the non-empty session with the smallest pass goes next),
  FIFO within a session, higher ``priority`` classes always first.
- **admission control** — each query declares an estimated footprint from
  the cost model (``logical/stats.estimate``) and is admitted against a
  shared :class:`~daft_tpu_torch.execution.memory.MemoryManager` byte
  budget (``DAFT_TORCH_SERVE_MEMORY``, default: the engine memory limit,
  else the
  breaker budget) so concurrent queries can't OOM each other: it runs
  when admitted, waits while others drain, and fails with a structured
  :class:`AdmissionRejected` when the queue is full, the queue timeout
  passes, or it could never fit.
- **plan/result caches** — see ``serving/caches.py``; consulted per
  submission, keyed by the logical-plan fingerprint.
- **cooperative cancellation** — every query carries a
  :class:`~daft_tpu_torch.execution.cancellation.CancelToken` threaded
  into the executor pipelines; ``QueryHandle.cancel()`` unwinds it at the
  next morsel boundary and releases its admission.

The fleet wiring (both optional, ``fleet/``): ``fleet_state`` is this
replica's gossiped state store (its merged admission history seeds a
cold replica's estimates, counter ``est_seeded_fleet``), ``cache_tier``
the cross-replica cache layer consulted on a local result-cache miss
(``result_cache: fleet_hit``, promoted into the local cache). Unset,
each falls back to the process-installed one (``state_sync.install``,
``cache_tier.install``); a bare scheduler touches neither.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from .. import knobs
from ..execution.cancellation import CancelToken, QueryCancelled, cancel_scope
from ..execution.memory import MemoryManager, breaker_budget_bytes, \
    memory_limit_bytes
from .caches import PlanCache, ResultCache

_DEFAULT_EST_BYTES = 64 << 20  # footprint guess when the cost model is blind
_MIN_EST_BYTES = 1 << 20

#: per-fingerprint admission-history EWMA weight and retained entries:
#: repeat queries admit their OBSERVED result bytes instead of the cost
#: model's guess, seeded from this process's history and from
#: flight-recorder records of earlier processes
_HIST_ALPHA = 0.3
_HIST_MAX_ENTRIES = 1024


def _history_fingerprint(builder) -> Optional[str]:
    """Stable per-query history key: the literal-inclusive structure
    hash plus the source PATHS — but WITHOUT the size/mtime version
    tokens (a repeat query over refreshed data is still the same
    workload for admission purposes). The paths must participate: the
    canonical structure names sources positionally, so without them a
    same-shape query over a DIFFERENT (much larger) dataset would seed
    its admission estimate from the small one's history and bypass the
    memory gate. None when the plan is unfingerprintable (in-memory
    sources, sinks)."""
    from ..context import get_context
    from ..logical.fingerprint import fingerprint
    return _history_key_from_fp(
        fingerprint(builder.plan, get_context().execution_config))


def _history_key_from_fp(fp) -> Optional[str]:
    import hashlib
    if fp is None:
        return None
    # version tuples are (path, *token): local stat and remote etag
    # tokens have different arities, only the path matters here
    paths = tuple(v[0] for (_t, vers) in fp.sources for v in vers)
    # history_structure, NOT structure: the calibration-generation token
    # must not fragment admission history across self-tuning flips
    structure = fp.history_structure or fp.structure
    return hashlib.sha256(
        (structure + "\x00" + repr(fp.params) + "\x00" + repr(paths))
        .encode()).hexdigest()[:16]


class AdmissionRejected(RuntimeError):
    """Structured admission failure. ``kind`` is one of ``queue_full``,
    ``queue_timeout``, ``memory``, ``shutdown``, ``draining`` (a router
    treats the last two as re-routable: the replica is leaving, the
    query belongs on a peer)."""

    def __init__(self, kind: str, message: str,
                 est_bytes: Optional[int] = None,
                 budget: Optional[int] = None,
                 waited_s: float = 0.0):
        super().__init__(message)
        self.kind = kind
        self.est_bytes = est_bytes
        self.budget = budget
        self.waited_s = waited_s


# ------------------------------------------------------------------ knobs
#
# Each knob wins when set; unset, its ``ExecutionConfig`` field decides.

def _cfg(field: str):
    from ..context import get_context
    return getattr(get_context().execution_config, field)


def _env_bytes(name: str) -> Optional[int]:
    from ..execution.memory import parse_bytes
    v = knobs.env_raw(name)
    return None if v is None else parse_bytes(v)


def serve_concurrency() -> int:
    v = knobs.env_opt_int("DAFT_TORCH_SERVE_CONCURRENCY")
    return max(v if v is not None else int(_cfg("serve_concurrency")), 1)


def serve_queue_depth() -> int:
    v = knobs.env_opt_int("DAFT_TORCH_SERVE_QUEUE_DEPTH")
    return max(v if v is not None else int(_cfg("serve_queue_depth")), 1)


def serve_queue_timeout_s() -> float:
    v = knobs.env_opt_float("DAFT_TORCH_SERVE_QUEUE_TIMEOUT")
    return v if v is not None else float(_cfg("serve_queue_timeout"))


def serve_plan_cache_bytes() -> int:
    v = _env_bytes("DAFT_TORCH_SERVE_PLAN_CACHE_BYTES")
    return v if v is not None else int(_cfg("serve_plan_cache_bytes"))


def serve_result_cache_bytes() -> int:
    v = _env_bytes("DAFT_TORCH_SERVE_RESULT_CACHE_BYTES")
    return v if v is not None else int(_cfg("serve_result_cache_bytes"))


def serve_memory_budget() -> Optional[int]:
    v = _env_bytes("DAFT_TORCH_SERVE_MEMORY")
    if v is not None:
        return v or None  # 0 = unbudgeted admission
    lim = memory_limit_bytes()
    if lim is not None:
        return lim
    return breaker_budget_bytes()


# ------------------------------------------------------------------ handle

class QueryHandle:
    """Client-side view of one submitted query."""

    def __init__(self, scheduler: "QueryScheduler", session: str,
                 priority: int):
        self._scheduler = scheduler
        self.session = session
        self.priority = priority
        self.token = CancelToken()
        self._done = threading.Event()
        self._state_lock = threading.Lock()
        self.state = "queued"      # queued|running|done|failed|cancelled|
        #                            rejected
        self._result = None        # PartitionSet on success
        self._error: Optional[BaseException] = None
        self.stats = None          # RuntimeStatsContext (when executed)
        self.submitted_at = time.monotonic()
        self.submitted_at_us = int(time.time() * 1e6)
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # per-fingerprint admission-history key, set only when the cost
        # model was blind at submit (the history's trigger condition)
        self._fp_hist_key: Optional[str] = None
        # tracing: the query's trace starts at SUBMIT so queue wait is
        # on the timeline; None when tracing is off / sampled out
        from .. import tracing
        self.trace_ctx = tracing.maybe_start_trace("serve")

    # -- completion (scheduler-side) -----------------------------------
    def _finish(self, state: str, result=None,
                error: Optional[BaseException] = None, stats=None) -> None:
        with self._state_lock:
            if self._done.is_set():
                return
            self.state = state
            self._result = result
            self._error = error
            if stats is not None:
                self.stats = stats
            self.finished_at = time.monotonic()
            self._done.set()
        if state in ("rejected", "cancelled"):
            # rejected/cancelled queries never executed — close their
            # trace here so the recorder can't leak ("failed" queries DO
            # export: the run worker finalizes them with error status,
            # they're exactly the traces an operator needs)
            self._end_trace(state)

    def _mark_running(self) -> None:
        with self._state_lock:
            if not self._done.is_set():
                self.state = "running"
                self.started_at = time.monotonic()

    # -- client api ----------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def queue_wait_s(self) -> float:
        start = self.started_at if self.started_at is not None \
            else self.finished_at
        if start is None:
            return time.monotonic() - self.submitted_at
        return max(start - self.submitted_at, 0.0)

    def cancel(self, reason: Optional[str] = None) -> None:
        """Cooperative cancel: a queued query leaves the queue now; a
        running one unwinds at its next morsel boundary."""
        from .. import tracing
        tracing.event("serve:cancel", key="serve:cancel",
                      attrs={"reason": reason or "cancelled by client"},
                      lane="serving", ctx=self.trace_ctx)
        self.token.set(reason or "cancelled by client")
        self._scheduler._cancel_queued(self)

    def _end_trace(self, status: str) -> None:
        """Close and drop a trace that will never reach the per-query
        export path (rejections, cancellations)."""
        if self.trace_ctx is None:
            return
        from .. import tracing
        rec = self.trace_ctx.recorder
        if not rec.exported:
            rec.exported = True
            rec.finish(status)
            tracing.unregister_recorder(rec.trace_id)

    def result(self, timeout: Optional[float] = None):
        """The query's PartitionSet; raises the query's failure,
        AdmissionRejected, or QueryCancelled."""
        if not self._done.wait(timeout):
            raise TimeoutError("query still pending")
        if self.state == "done":
            return self._result
        if self._error is not None:
            raise self._error
        raise QueryCancelled(self.token.reason or "query cancelled")


#: seconds an EMPTY session queue survives before the sweep drops it.
#: Sessions are keyed by client-supplied names (a front door may mint a
#: fresh UUID per client session), so without a bound the scheduler's
#: session dict grows for the life of the process; pass/weight memory
#: older than this horizon is fairness-irrelevant (a re-entering session
#: starts at the current minimum pass either way).
_SESSION_IDLE_TTL_S = 60.0


class _SessionQ:
    __slots__ = ("weight", "pass_", "queues", "idle_since")

    def __init__(self, weight: float):
        self.weight = max(float(weight), 1e-6)
        self.pass_ = 0.0
        self.idle_since: Optional[float] = None
        # priority → FIFO of QueryHandle (higher priority served first)
        self.queues: Dict[int, collections.deque] = {}

    def depth(self) -> int:
        return sum(len(d) for d in self.queues.values())


# ---------------------------------------------------------------- scheduler

class QueryScheduler:
    """Admits N concurrent queries against shared engine resources."""

    def __init__(self, concurrency: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 queue_timeout_s: Optional[float] = None,
                 memory_budget: Optional[int] = None,
                 plan_cache_bytes: Optional[int] = None,
                 result_cache_bytes: Optional[int] = None,
                 fleet_state=None, cache_tier=None,
                 name: Optional[str] = None):
        # fleet wiring (both optional): ``fleet_state`` is this replica's
        # fleet/state_sync.StateStore (falls back to the process-installed
        # one), ``cache_tier`` the cross-replica cache layer
        # (fleet/cache_tier); a bare scheduler never touches either
        self.fleet_state = fleet_state
        self.cache_tier = cache_tier
        self.name = name or "local"
        self.concurrency = concurrency or serve_concurrency()
        self.queue_depth = queue_depth or serve_queue_depth()
        self.queue_timeout_s = queue_timeout_s \
            if queue_timeout_s is not None else serve_queue_timeout_s()
        budget = memory_budget if memory_budget is not None \
            else serve_memory_budget()
        self.admission = MemoryManager(budget)
        if not budget:
            # an explicit 0/None means admission is DISABLED — don't let
            # MemoryManager's own default fall back to the engine limit
            self.admission.budget = None
        self.plan_cache = PlanCache(
            plan_cache_bytes if plan_cache_bytes is not None
            else serve_plan_cache_bytes())
        self.result_cache = ResultCache(
            result_cache_bytes if result_cache_bytes is not None
            else serve_result_cache_bytes())
        self._cond = threading.Condition()
        self._sessions: "collections.OrderedDict[str, _SessionQ]" = \
            collections.OrderedDict()
        self._deadlines: Dict[QueryHandle, Optional[float]] = {}
        self._est: Dict[QueryHandle, int] = {}
        self._builders: Dict[QueryHandle, object] = {}
        self._n_queued = 0
        self._n_running = 0
        self._running: set = set()   # running handles (drain/kill target)
        self._shutdown = False
        self._draining = False
        self._counts_lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        # per-fingerprint admission history: key → (ewma result bytes,
        # ewma wall us, samples); consulted before the cost model's
        # estimate, seeded lazily from the flight recorder so it survives
        # restarts
        self._hist_lock = threading.Lock()
        self._fp_hist: Dict[str, tuple] = {}
        self._flight_seeded = False
        # submit-thread side channel: _estimate_bytes keeps its
        # (self, builder) signature — tests monkeypatch it — so the
        # history key travels per-thread instead of per-call
        self._tl_est = threading.local()
        self._threads: List[threading.Thread] = []
        for i in range(self.concurrency):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"daft-torch-serve-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        # daft-lint: allow(unattributed-worker) -- the sweep thread only
        # expires queued handles and idle sessions under the scheduler
        # condition; it never executes query work or touches plane
        # counters, so there is no attribution to thread through
        t = threading.Thread(target=self._sweep_loop,
                             name="daft-torch-serve-sweep", daemon=True)
        t.start()
        self._threads.append(t)
        # the warm-up (``device/warmup.py``, knob-gated, once per
        # process) runs BEFORE traffic arrives, so first queries re-enter
        # warm programs; its stats land in the counters
        from ..device import warmup as _warmup
        w = _warmup.maybe_warmup_session()
        if w:
            self._count("aot_warmup_programs",
                        sum(d.get("programs", 0) for d in w.values()
                            if isinstance(d, dict)))
            self._count("aot_warmup_seconds", float(w.get("seconds", 0.0)))

    # ------------------------------------------------------------ counters
    def _count(self, name: str, n: float = 1) -> None:
        with self._counts_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters_snapshot(self) -> Dict[str, float]:
        with self._counts_lock:
            out = dict(self._counters)
        out.update({f"plan_cache_{k}": v
                    for k, v in self.plan_cache.stats().items()})
        out.update({f"result_cache_{k}": v
                    for k, v in self.result_cache.stats().items()})
        out["admitted_bytes_outstanding"] = self.admission.outstanding
        return out

    def live_view(self) -> Dict[str, object]:
        """Current queue/admission state for the dashboard."""
        with self._cond:
            sessions = {name: {"queued": s.depth(),
                               "weight": s.weight,
                               "pass": round(s.pass_, 3)}
                        for name, s in self._sessions.items() if s.depth()}
            queued, running = self._n_queued, self._n_running
        return {"queued": queued, "running": running,
                "concurrency": self.concurrency,
                "sessions": sessions,
                "draining": self._draining,
                "admitted_bytes": self.admission.outstanding,
                "admission_budget": self.admission.budget,
                "counters": self.counters_snapshot()}

    def gauges(self) -> Dict[str, float]:
        """Per-replica scale-signal gauges (queue depth and admitted bytes
        are a router's autoscaling inputs)."""
        with self._cond:
            queued, running = self._n_queued, self._n_running
            sessions = len(self._sessions)
            draining = self._draining
        return {"queued": float(queued), "running": float(running),
                "concurrency": float(self.concurrency),
                "sessions": float(sessions),
                "admitted_bytes": float(self.admission.outstanding),
                "draining": 1.0 if draining else 0.0}

    # --------------------------------------------------------------- fleet
    def _fleet_store(self):
        if self.fleet_state is not None:
            return self.fleet_state
        from ..fleet import state_sync
        return state_sync.installed()

    def _fleet_cache_tier(self):
        if self.cache_tier is not None:
            return self.cache_tier
        from ..fleet import cache_tier as _ct
        return _ct.installed()

    # ------------------------------------------------------- lifecycle
    def admission_history_snapshot(self) -> Dict[str, tuple]:
        """Copy of the per-fingerprint admission history, the gossip
        export ``fleet/state_sync`` consumes (key → (ewma bytes, ewma
        wall us, samples))."""
        with self._hist_lock:
            return dict(self._fp_hist)

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, timeout_s: float = 10.0,
              cancel: bool = True) -> Dict[str, object]:
        """Graceful drain: stop admitting NOW, let queued+running work
        finish within ``timeout_s``, then cooperatively cancel the
        stragglers via their CancelTokens. The scheduler object stays
        alive (caches and counters keep serving): only admission is
        closed."""
        deadline = time.monotonic() + max(float(timeout_s), 0.0)
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._n_queued or self._n_running:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(min(left, 0.1))
            finished_in_time = not (self._n_queued or self._n_running)
            stragglers: List[QueryHandle] = []
            if cancel and not finished_in_time:
                stragglers = list(self._running)
                stragglers += [h for s in self._sessions.values()
                               for dq in s.queues.values() for h in dq]
        for h in stragglers:  # outside the condition: cancel() re-takes it
            h.cancel("replica draining")
        if stragglers:
            with self._cond:
                grace = time.monotonic() + 5.0
                while self._n_running and time.monotonic() < grace:
                    self._cond.wait(0.1)
        with self._cond:
            remaining = self._n_queued + self._n_running
        self._count("drained")
        return {"finished_in_time": finished_in_time,
                "cancelled": len(stragglers), "remaining": remaining}

    def cancel_all(self, reason: str = "replica killed") -> int:
        """Cooperatively cancel every queued and running query (the
        replica-kill path). Returns the number of handles signalled."""
        with self._cond:
            handles = [h for s in self._sessions.values()
                       for dq in s.queues.values() for h in dq]
            handles += list(self._running)
        for h in handles:
            h.cancel(reason)
        return len(handles)

    def release_session(self, session: str) -> bool:
        """Drop a session's scheduler state NOW (a session handed to
        another replica): the idle-TTL sweep that would reclaim it after
        60s fires at once. Still-queued queries (possible on a hard kill,
        none after a graceful drain) are cancelled. True when it
        existed."""
        with self._cond:
            s = self._sessions.pop(session, None)
            if s is None:
                return False
            for dq in s.queues.values():
                for h in dq:
                    h._finish("cancelled")
                    self._count("cancelled")
                    self._cleanup(h)
                dq.clear()
            self._n_queued = sum(t.depth()
                                 for t in self._sessions.values())
            self._count("sessions_released")
            self._cond.notify_all()
        return True

    # -------------------------------------------------------------- submit
    def submit(self, query, session: str = "default", priority: int = 0,
               weight: Optional[float] = None,
               timeout_s: Optional[float] = None,
               est_bytes: Optional[int] = None) -> QueryHandle:
        """Enqueue a DataFrame / LogicalPlanBuilder. Always returns a
        handle; a rejection (queue full / timeout / too big) completes
        the handle with :class:`AdmissionRejected`."""
        builder = getattr(query, "_builder", None) or query
        h = QueryHandle(self, session, priority)
        if timeout_s is None:
            timeout_s = self.queue_timeout_s
        deadline = (time.monotonic() + timeout_s) if timeout_s and \
            timeout_s > 0 else None
        # the cost-model estimate may do real IO (remote parquet footer
        # reads materializing scan tasks) — it must never run under the
        # scheduler condition, which every worker/sweep/dashboard pull
        # also needs
        if est_bytes is None:
            est_bytes = self._estimate_bytes(builder)
            # the estimator flags a blind (history-keyed) estimate on
            # the submitting thread; adopt it onto the handle so the
            # completion path can close the loop
            h._fp_hist_key = getattr(self._tl_est, "hist_key", None)
            self._tl_est.hist_key = None
        with self._cond:
            self._count("submitted")
            if self._shutdown:
                h._finish("rejected", error=AdmissionRejected(
                    "shutdown", "scheduler is shut down"))
                self._count("rejected_shutdown")
                return h
            if self._draining:
                # a router treats this as re-routable: the session
                # belongs on a peer replica now
                h._finish("rejected", error=AdmissionRejected(
                    "draining", "replica is draining"))
                self._count("rejected_draining")
                return h
            if self._n_queued >= self.queue_depth:
                h._finish("rejected", error=AdmissionRejected(
                    "queue_full",
                    f"serving queue is full ({self.queue_depth} deep)"))
                self._count("rejected_queue_full")
                return h
            s = self._sessions.get(session)
            if s is None:
                s = self._sessions[session] = _SessionQ(weight or 1.0)
            if weight is not None:
                s.weight = max(float(weight), 1e-6)
            if s.depth() == 0:
                # re-entering session starts at the current minimum pass:
                # idle time must not bank a burst of turns
                active = [t.pass_ for t in self._sessions.values()
                          if t.depth() > 0]
                if active:
                    s.pass_ = max(s.pass_, min(active))
            s.idle_since = None
            s.queues.setdefault(priority, collections.deque()).append(h)
            self._deadlines[h] = deadline
            self._est[h] = est_bytes
            self._builders[h] = builder
            self._n_queued += 1
            # notify_all, not notify: the sweep thread waits on the same
            # condition — waking only it would leave the query undispatched
            # until a worker's 1s timed wait expires
            self._cond.notify_all()
        return h

    def _estimate_bytes(self, builder) -> int:
        # observed history outranks the heuristic model: for a repeat
        # query (same structure + params + source paths) the recorded
        # result bytes of past executions (this process's completions, the
        # flight recorder's, or the fleet's gossiped history on a cold
        # replica) are strictly better information than a selectivity
        # guess, so repeats stop over- and under-admitting
        from ..logical import stats as lstats
        key = _history_fingerprint(builder)
        self._tl_est.hist_key = key
        if key is not None:
            seeded = self._history_estimate(key)
            if seeded is not None:
                self._count("est_seeded_history")
                return seeded
            seeded = self._fleet_history_estimate(key)
            if seeded is not None:
                self._count("est_seeded_fleet")
                return seeded
        est = lstats.estimate(builder.plan).size_bytes
        if est is None:
            return _DEFAULT_EST_BYTES
        return max(int(est), _MIN_EST_BYTES)

    # ----------------------------------------------- admission history
    def _history_estimate(self, key: str) -> Optional[int]:
        self._seed_history_from_flight()
        with self._hist_lock:
            e = self._fp_hist.get(key)
        if e is None:
            return None
        return max(int(e[0]), _MIN_EST_BYTES)

    def _fleet_history_estimate(self, key: str) -> Optional[int]:
        """Gossiped fleet admission history for ``key`` (sample-weighted
        over replica origins): a cold replica's first repeat query admits
        from the fleet's observations instead of the cost model's guess.
        None when no fleet store is installed or it is blind."""
        st = self._fleet_store()
        if st is None:
            return None
        e = st.merged_admission(key)
        if e is None:
            return None
        return max(int(e[0]), _MIN_EST_BYTES)

    def _record_history(self, key: Optional[str], result_bytes: int,
                        wall_us: int) -> None:
        if key is None or result_bytes < 0:
            return
        with self._hist_lock:
            e = self._fp_hist.get(key)
            if e is None:
                self._fp_hist[key] = (float(result_bytes),
                                      float(wall_us), 1)
            else:
                b, w, n = e
                self._fp_hist[key] = (
                    b + _HIST_ALPHA * (result_bytes - b),
                    w + _HIST_ALPHA * (wall_us - w), n + 1)
            while len(self._fp_hist) > _HIST_MAX_ENTRIES:
                self._fp_hist.pop(next(iter(self._fp_hist)))

    def _seed_history_from_flight(self) -> None:
        """One-time seed from flight-recorder records
        (``DAFT_TORCH_QUERY_LOG``): serving blocks of past queries carry
        the history key and the observed result bytes and latency, so a
        fresh process admits repeat queries from evidence at once."""
        from .. import tracing
        with self._hist_lock:
            if self._flight_seeded:
                return
            self._flight_seeded = True
        entries = tracing.flight_history()
        for entry in reversed(entries):  # oldest-first into the EWMA
            sv = entry.get("serving")
            if not isinstance(sv, dict):
                continue
            key = sv.get("fp_hist_key")
            rb = sv.get("result_bytes")
            if key and isinstance(rb, (int, float)):
                self._record_history(str(key), int(rb),
                                     int(sv.get("run_us", 0) or 0))

    # ----------------------------------------------------------- dispatch
    def _pick_locked(self) -> Optional[QueryHandle]:
        best_prio = None
        for s in self._sessions.values():
            for prio, dq in s.queues.items():
                if dq and (best_prio is None or prio > best_prio):
                    best_prio = prio
        if best_prio is None:
            return None
        best_s = None
        for s in self._sessions.values():
            dq = s.queues.get(best_prio)
            if dq and (best_s is None or s.pass_ < best_s.pass_):
                best_s = s
        h = best_s.queues[best_prio].popleft()
        best_s.pass_ += 1.0 / best_s.weight
        self._n_queued -= 1
        return h

    def _sweep_expired_locked(self) -> None:
        now = time.monotonic()
        for s in self._sessions.values():
            for dq in s.queues.values():
                kept = [h for h in dq
                        if not self._expire_locked(h, now)]
                if len(kept) != len(dq):
                    dq.clear()
                    dq.extend(kept)
        self._n_queued = sum(s.depth() for s in self._sessions.values())
        # drop sessions that have sat empty past the idle TTL — session
        # names are client-minted (one UUID per client session), so an
        # unbounded dict here is a slow leak on the process-shared
        # scheduler and a linear cost on every dispatch
        drop = []
        for name, s in self._sessions.items():
            if s.depth() > 0:
                s.idle_since = None
            elif s.idle_since is None:
                s.idle_since = now
            elif now - s.idle_since > _SESSION_IDLE_TTL_S:
                drop.append(name)
        for name in drop:
            del self._sessions[name]

    def _expire_locked(self, h: QueryHandle, now: float) -> bool:
        if h.token.is_set():
            h._finish("cancelled")
            self._count("cancelled")
            self._cleanup(h)
            return True
        dl = self._deadlines.get(h)
        if dl is not None and now > dl:
            h._finish("rejected", error=AdmissionRejected(
                "queue_timeout",
                f"queued {now - h.submitted_at:.1f}s > queue timeout",
                waited_s=now - h.submitted_at))
            self._count("rejected_queue_timeout")
            self._cleanup(h)
            return True
        return False

    def _earliest_wait_locked(self) -> Optional[float]:
        dls = [self._deadlines[h]
               for s in self._sessions.values()
               for dq in s.queues.values() for h in dq
               if self._deadlines.get(h) is not None]
        if not dls:
            return None
        return max(min(dls) - time.monotonic(), 0.05)

    def _cleanup(self, h: QueryHandle) -> None:
        self._deadlines.pop(h, None)
        self._est.pop(h, None)
        self._builders.pop(h, None)

    def _cancel_queued(self, h: QueryHandle) -> None:
        with self._cond:
            for s in self._sessions.values():
                dq = s.queues.get(h.priority)
                if dq and h in dq:
                    dq.remove(h)
                    self._n_queued -= 1
                    h._finish("cancelled")
                    self._count("cancelled")
                    self._cleanup(h)
                    self._cond.notify_all()
                    return

    def _next(self):
        with self._cond:
            while True:
                if self._shutdown:
                    return None
                self._sweep_expired_locked()
                h = self._pick_locked()
                if h is not None:
                    est = self._est.pop(h, _DEFAULT_EST_BYTES)
                    builder = self._builders.pop(h, None)
                    self._deadlines.pop(h, None)
                    return h, est, builder
                self._cond.wait(self._earliest_wait_locked() or 1.0)

    def _sweep_loop(self) -> None:
        """Expire queued entries even when every worker is busy — a
        queue timeout must fire on time, not at the next dispatch."""
        with self._cond:
            while not self._shutdown:
                self._sweep_expired_locked()
                self._cond.wait(self._earliest_wait_locked() or 1.0)

    # -------------------------------------------------------------- worker
    def _worker_loop(self) -> None:
        while True:
            item = self._next()
            if item is None:
                return
            h, est, builder = item
            self._run_query(h, est, builder)

    def _run_query(self, h: QueryHandle, est: int, builder) -> None:
        from .. import observability as obs
        if h.token.is_set():
            h._finish("cancelled")
            self._count("cancelled")
            return
        budget = self.admission.budget
        if budget is not None and est > budget:
            h._finish("rejected", error=AdmissionRejected(
                "memory",
                f"estimated footprint {est} exceeds the serving "
                f"admission budget {budget}", est_bytes=est, budget=budget))
            self._count("rejected_memory")
            return
        # block in admission until the footprint fits; the queue deadline
        # already elapsed into queue wait, so bound this by the same
        # timeout from NOW (a query admitted late should still run)
        adm_deadline = time.monotonic() + self.queue_timeout_s \
            if self.queue_timeout_s and self.queue_timeout_s > 0 else None
        if not self.admission.try_acquire(est, adm_deadline, h.token):
            if h.token.is_set():
                h._finish("cancelled")
                self._count("cancelled")
            else:
                h._finish("rejected", error=AdmissionRejected(
                    "queue_timeout",
                    f"admission wait exceeded the queue timeout "
                    f"({self.queue_timeout_s}s) for {est} bytes",
                    est_bytes=est, budget=budget,
                    waited_s=time.monotonic() - h.submitted_at))
                self._count("rejected_queue_timeout")
            return
        # EVERYTHING after a successful try_acquire runs under the
        # try/finally that releases it — the run-state bump, the handle
        # transition and the queue-wait span emission all make calls, and
        # an exception on any of them used to leak the admitted bytes
        # (and a worker slot: _n_running never decremented) for the
        # process lifetime. Found by daft-lint's memory-admission-leak
        # flow check.
        queue_wait_us = 0
        running = False
        try:
            with self._cond:
                self._n_running += 1
                self._running.add(h)
                running_at_admit = self._n_running
            running = True
            h._mark_running()
            queue_wait_us = int(h.queue_wait_s * 1e6)
            from .. import tracing
            if h.trace_ctx is not None:
                # the queue-wait span: submit → run start, on the timeline
                rec = h.trace_ctx.recorder
                rec.add("serve:queue", rec.unique_span_id("serve:queue"),
                        h.trace_ctx.span_id, h.submitted_at_us,
                        queue_wait_us,
                        attrs={"session": h.session,
                               "priority": h.priority,
                               "admitted_bytes": est},
                        lane="serving")
            # nested scope: the executor's set_last_stats must not fire
            # the per-query exports mid-flight — the serving info isn't
            # attached yet; finalize_query below is the single exporter
            with cancel_scope(h.token), obs.nested_scope(), \
                    tracing.attach(h.trace_ctx), \
                    tracing.span("serve:run", lane="serving"):
                ps, stats, info = self._execute(h, builder)
            info.update({
                "session": h.session, "priority": h.priority,
                "queue_wait_us": queue_wait_us, "admitted_bytes": est,
                "running_at_admit": running_at_admit})
            if h._fp_hist_key is not None:
                # close the admission loop: the OBSERVED result bytes +
                # wall feed the per-fingerprint history (and ride the
                # flight-recorder serving block for future processes)
                try:
                    result_bytes = int(ps.size_bytes()) \
                        if ps is not None else 0
                except Exception:
                    result_bytes = 0
                run_us = int((time.monotonic()
                              - (h.started_at or h.submitted_at)) * 1e6)
                self._record_history(h._fp_hist_key, result_bytes,
                                     run_us)
                info.update({"fp_hist_key": h._fp_hist_key,
                             "result_bytes": result_bytes,
                             "run_us": run_us})
            if stats is None:
                # result-cache hit: no execution happened — synthesize an
                # (attributed, hence plane-empty) context so
                # explain(analyze=True) still renders the serving block
                stats = obs.RuntimeStatsContext()
                stats.trace_ctx = h.trace_ctx
                stats._attributed = True
                stats.finish()
            stats.serving = info
            # finalize BEFORE completing the handle: a result() waiter
            # must be able to read the exported trace / flight record
            obs.finalize_query(stats)
            h._finish("done", result=ps, stats=stats)
            self._count("completed")
            self._count("queue_wait_us", queue_wait_us)
            self._count("run_us", int((time.monotonic()
                                       - (h.started_at or 0)) * 1e6))
        except QueryCancelled:
            h._finish("cancelled")
            self._count("cancelled")
        except BaseException as exc:  # noqa: BLE001 — surfaced via handle
            # a failed query is the one an operator most needs to see:
            # export its trace (error status) + flight-recorder entry
            # BEFORE completing the handle (result() waiters may read it)
            try:
                stats = obs.RuntimeStatsContext()
                stats.trace_ctx = h.trace_ctx
                stats._attributed = True
                stats.finish()
                stats.serving = {
                    "session": h.session, "priority": h.priority,
                    "queue_wait_us": queue_wait_us,
                    "admitted_bytes": est, "state": "failed",
                    "error": f"{type(exc).__name__}: {str(exc)[:200]}"}
                if h.trace_ctx is not None:
                    h.trace_ctx.recorder.status = "error"
                obs.finalize_query(stats)
            except Exception:
                pass  # export must never mask the query's real failure
            h._finish("failed", error=exc)
            self._count("failed")
        finally:
            self.admission.release(est)
            with self._cond:
                if running:
                    self._n_running -= 1
                self._running.discard(h)
                self._cond.notify_all()

    # ------------------------------------------------------------- execute
    def _execute(self, h: QueryHandle, builder):
        from .. import observability as obs
        from .. import tracing
        from ..context import get_context
        from ..device import backend
        from ..logical.fingerprint import fingerprint
        from ..physical.translate import translate
        from ..runners.native_runner import NativeRunner, make_local_executor
        from ..runners.runner import PartitionSet

        ctx = get_context()
        runner = ctx.get_or_create_runner()
        cfg = ctx.execution_config
        info: Dict[str, object] = {"plan_cache": "bypass",
                                   "result_cache": "bypass"}
        cacheable = isinstance(runner, NativeRunner) \
            and not cfg.enable_aqe
        with tracing.span("plan:fingerprint", lane="planner"):
            fp = fingerprint(builder.plan, cfg) if cacheable else None
        tier = self._fleet_cache_tier()
        if fp is not None and self.result_cache.enabled:
            ps = self.result_cache.get_result(fp)
            if ps is not None:
                info["result_cache"] = "hit"
                info["plan_cache"] = "skipped"
                tracing.event("cache:result_hit", lane="planner")
                return ps, None, info
            if tier is not None:
                # local miss → the fleet tier: a repeat query that last
                # ran on a peer replica still hits warm state (the tier
                # itself turns a transport failure into a miss); a hit is
                # promoted into the local cache so the next repeat is local
                ps = tier.get_result(fp)
                if ps is not None:
                    info["result_cache"] = "fleet_hit"
                    info["plan_cache"] = "skipped"
                    self._count("result_cache_fleet_hits")
                    tracing.event("cache:result_fleet_hit", lane="planner")
                    self.result_cache.put_result(fp, ps)
                    return ps, None, info
                self._count("result_cache_fleet_misses")
            info["result_cache"] = "miss"
        if not cacheable:
            # AQE / the distributed runner: the scheduler still provides
            # fairness and admission; the plan shape is dynamic, the caches
            # bypass. These runners don't thread the CancelToken into their
            # own workers, so check it at every partition boundary here:
            # a cancel must unwind (and release admission) between stages,
            # not silently run the query to completion
            parts = []
            for p in runner.run_iter(builder):
                h.token.check()
                parts.append(p)
            return (PartitionSet(parts, builder.schema()),
                    obs.last_query_stats_local(), info)
        # resolved before anything is read, as the native runner does: a
        # query asked to run on a card that is not there fails at once
        device = backend.resolve_device()
        if fp is not None and h._fp_hist_key is None:
            # every EXECUTED cacheable query feeds the per-fingerprint
            # admission history, not just blind-estimate ones (cache hits
            # returned above: their ~0 wall would pollute the EWMA): warm
            # replicas publish observed bytes and walls to the fleet store,
            # which a cold replica's estimates seed from
            h._fp_hist_key = _history_key_from_fp(fp)
        hit = self.plan_cache.get_plan(fp) if self.plan_cache.enabled \
            else None
        if hit is not None:
            _optimized, pplan = hit
            info["plan_cache"] = "hit"
            tracing.event("cache:plan_hit", lane="planner")
        else:
            tiered = None
            if fp is not None and self.plan_cache.enabled \
                    and tier is not None:
                tiered = tier.get_plan(fp)
            if tiered is not None:
                optimized_plan, pplan = tiered
                info["plan_cache"] = "fleet_hit"
                self._count("plan_cache_fleet_hits")
                tracing.event("cache:plan_fleet_hit", lane="planner")
                self.plan_cache.put_plan(fp, optimized_plan, pplan)
            else:
                with tracing.span("plan:optimize", lane="planner"):
                    optimized = builder.optimize()
                with tracing.span("plan:translate", lane="planner"):
                    pplan = translate(optimized.plan)
                if fp is not None and self.plan_cache.enabled:
                    self.plan_cache.put_plan(fp, optimized.plan, pplan)
                    if tier is not None:
                        tier.put_plan(fp, optimized.plan, pplan)
                    info["plan_cache"] = "miss"
        executor = make_local_executor(cfg, device)
        parts = list(executor.run(pplan))
        stats = obs.last_query_stats_local()
        ps = PartitionSet(parts, builder.schema())
        if fp is not None and self.result_cache.enabled:
            self.result_cache.put_result(fp, ps)
            if tier is not None:
                tier.put_result(fp, ps)
        return ps, stats, info

    # ------------------------------------------------------------ shutdown
    def shutdown(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._shutdown = True
            for s in self._sessions.values():
                for dq in s.queues.values():
                    for h in dq:
                        h._finish("rejected", error=AdmissionRejected(
                            "shutdown", "scheduler shut down while queued"))
                        self._count("rejected_shutdown")
                    dq.clear()
            self._n_queued = 0
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
