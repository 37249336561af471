"""Resilience plane for the distributed tier.

Four cooperating pieces, all driven from the stage runner's task
supervisor (reference: Exoshuffle's thesis that shuffle fault tolerance
belongs in the application-level scheduler as lineage-driven
re-execution, not in the transport):

1. **Deterministic fault injection** — ``FaultPlan`` parses
   ``DAFT_TORCH_FAULT_SPEC`` (seeded by ``DAFT_TORCH_FAULT_SEED``) and decides
   every injection by hashing ``(seed, site, key, attempt)``: a pure
   function of stable identifiers, so the same seed reproduces the same
   fault set bit-identically regardless of thread interleaving. Hooks sit
   at the three real failure sites: task execution (``worker.run_task``,
   site ``task``), partition fetch (``shuffle_service.fetch_partition``,
   sites ``fetch`` and ``crash`` — ``crash`` additionally destroys the
   served shuffle data, simulating a dead map worker), and remote-worker
   RPC (``remote_worker.RemoteWorker._post``, site ``rpc``).

2. **Retry/health policy** — ``RetryPolicy``: bounded retries with
   exponential backoff + deterministic jitter, per-worker
   consecutive-failure quarantine (circuit breaker with timed
   re-admission), and fail-fast classification (a task failing with the
   same signature on two distinct workers raises instead of looping).

3. **Lineage-based shuffle recovery** — ``ShuffleLineage`` records which
   map task produced each shuffle receipt; when a reduce-side fetch fails
   because the serving worker is gone, the supervisor re-executes only
   the lost map task, registers the new (address, shuffle_id) as a
   translation of the old one, and redispatches the reduce task with
   translated fetch specs. Recovery composes recursively (a recomputed
   map task whose own inputs were cleaned up recovers them the same way),
   depth-bounded. Collective (mesh) exchange stages are
   ALL-OR-NOTHING lineage units: a per-mesh stream's registered producer
   is the whole exchange group (``topology.CollectiveExchangeGroup``),
   so losing it re-executes every member map task plus the intra-mesh
   collective as one unit — never a single map task.

4. **Speculative execution** — when a task's runtime exceeds a multiple
   of the median of its completed siblings, the supervisor launches a
   backup on a quarantine-free worker; the first finisher wins and the
   loser's shuffle output is discarded idempotently.

All recovery events are counted in a process-wide registry (mirroring the
device-kernel dispatch ledger) that ``observability.RuntimeStatsContext``
snapshots per query and renders in ``explain_analyze`` / the dashboard.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

# --------------------------------------------------------------- errors


class InjectedFault(RuntimeError):
    """A deterministically injected failure (``DAFT_TORCH_FAULT_SPEC``)."""

    def __init__(self, site: str, key: str):
        super().__init__(f"injected fault at {site}:{key}")
        self.site = site
        self.key = key

    def __reduce__(self):  # picklable across the remote-worker wire
        return (InjectedFault, (self.site, self.key))


class ShuffleFetchError(RuntimeError):
    """A reduce-side partition fetch failed: the serving worker is gone,
    the shuffle was unregistered, or the transport broke. Carries the
    (address, shuffle_id) identity lineage recovery keys on."""

    def __init__(self, address: str, shuffle_id: str, partition: int,
                 detail: str = "", injected: bool = False):
        super().__init__(
            f"shuffle fetch failed: {address}/{shuffle_id}/p{partition}"
            + (f" ({detail})" if detail else ""))
        self.address = address
        self.shuffle_id = shuffle_id
        self.partition = partition
        self.detail = detail
        self.injected = injected

    def __reduce__(self):
        return (ShuffleFetchError, (self.address, self.shuffle_id,
                                    self.partition, self.detail,
                                    self.injected))


class FailFastError(RuntimeError):
    """The same failure signature on two distinct workers: the task is
    the problem, not the worker — retrying would loop forever."""


class TaskTimeout(RuntimeError):
    """A task attempt exceeded ``DAFT_TORCH_TASK_TIMEOUT`` (treated as a
    retryable failure; the stale attempt's result is discarded)."""


# ----------------------------------------------------- recovery counters
# Process-wide, like the device-kernel dispatch ledger: RuntimeStatsContext
# snapshots at query start and diffs at finish() for per-query numbers.

_counters_lock = threading.Lock()
_counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n
    # context-local attribution for the serving plane (overlapping
    # queries each see only their own recovery events)
    from .. import observability as obs
    obs.bump_plane("recovery", name, n)


def counters_snapshot() -> Dict[str, int]:
    with _counters_lock:
        return dict(_counters)


def counters_delta(before: Dict[str, int],
                   after: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    if after is None:
        after = counters_snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


# -------------------------------------------------------- fault plan


def _hash01(*parts) -> float:
    """Uniform [0, 1) from stable identifiers — injection decisions are a
    pure function of these, never of shared RNG state, so chaos runs
    replay bit-identically under any thread interleaving."""
    h = hashlib.sha256("\x1f".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2 ** 64


class FaultPlan:
    """Parsed ``DAFT_TORCH_FAULT_SPEC``: comma-separated
    ``site:rate[:N][:sticky]`` entries.

    - ``site`` — one of ``task`` / ``fetch`` / ``rpc`` / ``crash``.
    - ``rate`` — injection probability per decision (default 1.0).
    - ``N`` — optional cap on total injections at that site.
    - ``sticky`` — the decision ignores the attempt number, so the same
      task fails the same way on every worker (exercises fail-fast
      classification); default faults are transient (a retry re-rolls).

    Example: ``task:0.3,fetch:0.2,crash:1:1`` — 30% of task executions
    fail, 20% of fetches fail transiently, and exactly the first
    crash-eligible fetch destroys its serving shuffle data.
    """

    SITES = ("task", "fetch", "rpc", "crash")

    def __init__(self, spec: str, seed: str = "0"):
        self.spec = spec
        self.seed = seed
        self._sites: Dict[str, Tuple[float, Optional[int], bool]] = {}
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            site = parts[0].strip()
            if site not in self.SITES:
                raise ValueError(
                    f"DAFT_TORCH_FAULT_SPEC: unknown site {site!r} "
                    f"(expected one of {self.SITES})")
            rate = float(parts[1]) if len(parts) > 1 else 1.0
            cap: Optional[int] = None
            sticky = False
            for p in parts[2:]:
                if p.strip() == "sticky":
                    sticky = True
                elif p.strip():
                    cap = int(p)
            self._sites[site] = (rate, cap, sticky)
        self._lock = threading.Lock()
        self._attempt: Dict[Tuple[str, str], int] = defaultdict(int)
        self._fired: Dict[str, int] = defaultdict(int)
        self.events: List[str] = []

    def _decide(self, site: str, key: str, attempt: Optional[int]
                ) -> Tuple[bool, int, bool]:
        """→ (fired, attempt_used, sticky)."""
        ent = self._sites.get(site)
        if ent is None:
            return False, 0, False
        rate, cap, sticky = ent
        with self._lock:
            if attempt is None:
                attempt = self._attempt[(site, key)]
                self._attempt[(site, key)] += 1
            if cap is not None and self._fired[site] >= cap:
                return False, attempt, sticky
            if _hash01(self.seed, site, key,
                       0 if sticky else attempt) >= rate:
                return False, attempt, sticky
            self._fired[site] += 1
            self.events.append(f"{site}:{key}#{attempt}")
        count(f"injected_{site}")
        return True, attempt, sticky

    def decide(self, site: str, key: str,
               attempt: Optional[int] = None) -> bool:
        return self._decide(site, key, attempt)[0]

    def maybe_fail(self, site: str, key: str,
                   attempt: Optional[int] = None) -> None:
        fired, used, sticky = self._decide(site, key, attempt)
        if fired:
            # transient faults carry the attempt in their identity so the
            # fail-fast classifier doesn't mistake two independent blips
            # on different workers for a deterministic task failure;
            # sticky faults keep one identity ON PURPOSE — failing the
            # same way on two distinct workers must fail fast
            raise InjectedFault(site,
                                key if sticky else f"{key}#a{used}")


_plan_lock = threading.Lock()
_plan: Optional[FaultPlan] = None


def active_fault_plan() -> Optional[FaultPlan]:
    """The process fault plan, re-parsed whenever the env spec/seed
    change (so tests flip scenarios with monkeypatch.setenv alone)."""
    from .. import knobs
    spec = knobs.env_str("DAFT_TORCH_FAULT_SPEC")
    if not spec:
        return None
    seed = knobs.env_str("DAFT_TORCH_FAULT_SEED")
    global _plan
    with _plan_lock:
        if _plan is None or _plan.spec != spec or _plan.seed != seed:
            _plan = FaultPlan(spec, seed)
        return _plan


def fault_events() -> List[str]:
    """Injected-fault event log of the active plan (``site:key#attempt``
    strings; the replay-determinism contract is over this log)."""
    with _plan_lock:
        return list(_plan.events) if _plan is not None else []


def reset_for_tests() -> None:
    global _plan
    with _plan_lock:
        _plan = None
    with _counters_lock:
        _counters.clear()


# -------------------------------------------------------- retry policy


class RetryPolicy:
    """Bounded retries + per-worker circuit breaker.

    Env knobs (read at construction): ``DAFT_TORCH_MAX_RETRIES`` (default
    3), ``DAFT_TORCH_RETRY_BACKOFF`` (base seconds, default 0.05),
    ``DAFT_TORCH_RETRY_BACKOFF_CAP`` (default 2.0),
    ``DAFT_TORCH_QUARANTINE_AFTER`` (consecutive failures, default 3),
    ``DAFT_TORCH_QUARANTINE_S`` (default 30),
    ``DAFT_TORCH_TASK_TIMEOUT`` (seconds, 0 = off),
    ``DAFT_TORCH_SPECULATIVE_MULTIPLIER`` (0 = off, default 4),
    ``DAFT_TORCH_SPECULATIVE_MIN_S`` (default 0.5)."""

    def __init__(self, max_retries: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_cap: Optional[float] = None,
                 quarantine_after: Optional[int] = None,
                 quarantine_s: Optional[float] = None,
                 task_timeout: Optional[float] = None,
                 speculative_multiplier: Optional[float] = None,
                 speculative_min_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 seed: Optional[str] = None):
        from .. import knobs

        def _f(val, name):
            return knobs.env_float(name) if val is None else val

        self.max_retries = knobs.env_int("DAFT_TORCH_MAX_RETRIES") \
            if max_retries is None else max_retries
        self.backoff_base = _f(backoff_base, "DAFT_TORCH_RETRY_BACKOFF")
        self.backoff_cap = _f(backoff_cap, "DAFT_TORCH_RETRY_BACKOFF_CAP")
        self.quarantine_after = knobs.env_int("DAFT_TORCH_QUARANTINE_AFTER") \
            if quarantine_after is None else quarantine_after
        self.quarantine_s = _f(quarantine_s, "DAFT_TORCH_QUARANTINE_S")
        self.task_timeout = _f(task_timeout, "DAFT_TORCH_TASK_TIMEOUT")
        self.speculative_multiplier = _f(
            speculative_multiplier, "DAFT_TORCH_SPECULATIVE_MULTIPLIER")
        self.speculative_min_s = _f(
            speculative_min_s, "DAFT_TORCH_SPECULATIVE_MIN_S")
        self.clock = clock
        self.seed = knobs.env_str("DAFT_TORCH_FAULT_SEED") \
            if seed is None else seed
        self._lock = threading.Lock()
        self._fails: Dict[str, int] = defaultdict(int)
        self._quarantined_until: Dict[str, float] = {}

    # ---- circuit breaker -------------------------------------------
    def record_failure(self, worker_id: str) -> bool:
        """→ True when this failure opened the worker's quarantine."""
        with self._lock:
            self._fails[worker_id] += 1
            if self._fails[worker_id] >= self.quarantine_after \
                    and worker_id not in self._quarantined_until:
                self._quarantined_until[worker_id] = \
                    self.clock() + self.quarantine_s
                self._fails[worker_id] = 0
                count("quarantined")
                return True
        return False

    def record_success(self, worker_id: str) -> None:
        with self._lock:
            self._fails[worker_id] = 0

    def is_quarantined(self, worker_id: str) -> bool:
        """Timed re-admission happens here: an expired quarantine is
        lifted (and counted) on the next eligibility check."""
        with self._lock:
            until = self._quarantined_until.get(worker_id)
            if until is None:
                return False
            if until <= self.clock():
                del self._quarantined_until[worker_id]
                count("readmitted")
                return False
            return True

    def eligible(self, states: list, exclude: Optional[str] = None) -> list:
        """Quarantine-free placement candidates. Degrades gracefully:
        never returns an empty list (with every worker quarantined or
        excluded, refusing to place would deadlock the query)."""
        out = [s for s in states
               if s.worker.id != exclude
               and not self.is_quarantined(s.worker.id)]
        if not out:
            out = [s for s in states if s.worker.id != exclude] or \
                list(states)
        return out

    # ---- backoff ---------------------------------------------------
    def backoff_s(self, key: str, attempt: int) -> float:
        """Exponential backoff with deterministic jitter (0.5–1.5×,
        hashed from the seed + task key + attempt, so chaos replays pace
        identically)."""
        base = min(self.backoff_base * (2 ** max(attempt - 1, 0)),
                   self.backoff_cap)
        return base * (0.5 + _hash01(self.seed, "backoff", key, attempt))


# ------------------------------------------------------ shuffle lineage


class ShuffleLineage:
    """Receipt → producing-map-task registry plus the old→new address
    translation built up by recoveries (Exoshuffle-style lineage: the
    scheduler re-executes only the lost map task and rewrites downstream
    fetch specs)."""

    def __init__(self):
        # RLock: a recompute's own fetch failures recover recursively on
        # the same thread; the lock also dedups concurrent recoveries of
        # the same source. NOTE the lock-order sanitizer
        # (DAFT_TORCH_SANITIZE=1) reports recover()'s retry-backoff sleeps
        # as blocking-while-held — intentional: holding the lock across
        # the recompute is what makes N consumers of a lost source wait
        # for ONE recompute instead of racing N. Per-source locks would
        # unserialize recoveries of unrelated sources; revisit if that
        # ever shows up as real contention.
        self._lock = threading.RLock()
        self._producer: Dict[Tuple[str, str], object] = {}
        self._translation: Dict[Tuple[str, str], Tuple[str, str]] = {}

    def register(self, receipt, task) -> None:
        with self._lock:
            self._producer[(receipt.address, receipt.shuffle_id)] = task

    def resolve(self, src: Tuple[str, str]) -> Tuple[str, str]:
        with self._lock:
            seen = set()
            while src in self._translation and src not in seen:
                seen.add(src)
                src = self._translation[src]
        return src

    def chain(self, src: Tuple[str, str]) -> List[Tuple[str, str]]:
        """``src`` plus every translated successor (for cleanup: all
        generations of a recovered output get unregistered)."""
        out = [src]
        with self._lock:
            seen = {src}
            while src in self._translation:
                src = self._translation[src]
                if src in seen:
                    break
                seen.add(src)
                out.append(src)
        return out

    def translate_spec(self, spec):
        from .worker import FetchSpec
        sources = [self.resolve(tuple(s)) for s in spec.sources]
        if sources == [tuple(s) for s in spec.sources]:
            return spec
        return FetchSpec(sources, spec.partition, keys=spec.keys)

    def translate_inputs(self, stage_inputs: Dict[int, object]
                         ) -> Dict[int, object]:
        from .worker import FetchSpec
        if not any(isinstance(v, FetchSpec) for v in stage_inputs.values()):
            return stage_inputs
        return {k: (self.translate_spec(v) if isinstance(v, FetchSpec)
                    else v)
                for k, v in stage_inputs.items()}

    def recover(self, src: Tuple[str, str],
                rerun: Callable[[object], object]) -> bool:
        """Recompute the map task that produced ``src`` and record the
        translation. → True when the source is recovered (or someone
        already recovered it); False when no lineage exists for it."""
        with self._lock:
            if self.resolve(src) != src:
                return True  # concurrent recovery already replaced it
            task = self._producer.get(src)
            if task is None:
                return False
            receipt = rerun(task)
            if receipt is None or not hasattr(receipt, "shuffle_id"):
                return False
            self._producer[(receipt.address, receipt.shuffle_id)] = task
            self._translation[src] = (receipt.address, receipt.shuffle_id)
        count("recomputed_map_tasks")
        return True


# ---------------------------------------------- fetch-retry bookkeeping


class FetchRetryState:
    """Shared fetch-failure bookkeeping for one consumer (a reduce task
    attempt series, or one driver-fetched partition). Progress-aware: a
    recovered source restarts its count under the recomputed shuffle id,
    so only a source failing repeatedly with NO progress (or a
    pathological total) exhausts the budget — a multi-source consumer
    may legitimately recover several sources in sequence."""

    def __init__(self, policy: "RetryPolicy"):
        self.policy = policy
        self.fails: Dict[Tuple[str, str], int] = defaultdict(int)
        self.attempts = 0

    def should_recover(self, exc: "ShuffleFetchError") -> bool:
        """Record one fetch failure. Raises ``exc`` when the budget is
        out; → True when the source failed again after a plain refetch
        (its data is gone — recompute via lineage)."""
        count("fetch_failures")
        self.attempts += 1
        src = (exc.address, exc.shuffle_id)
        self.fails[src] += 1
        if self.fails[src] > self.policy.max_retries + 2 \
                or self.attempts > 10 * (self.policy.max_retries + 1):
            raise exc
        return self.fails[src] >= 2


# -------------------------------------------------- resilience context


class ResilienceContext:
    """Per-query bundle: policy state (quarantines persist across
    stages), lineage registry, and recovery recursion depth."""

    MAX_RECOVERY_DEPTH = 8

    def __init__(self, policy: Optional[RetryPolicy] = None):
        self.policy = policy or RetryPolicy()
        self.lineage = ShuffleLineage()
        self.depth = 0  # mutated only under the lineage lock


# ------------------------------------------------------ task supervisor


@dataclasses.dataclass
class _Run:
    idx: int
    worker_id: str
    t0: float
    attempt: int
    backup: bool


_TICK = 0.05


class TaskSupervisor:
    """Drives one batch of StageTasks to completion under the retry /
    quarantine / lineage-recovery / speculation policy. Results come back
    in task order; fatal failures (retries exhausted, fail-fast,
    unrecoverable fetch) raise."""

    def __init__(self, ctx: ResilienceContext, manager, scheduler):
        self.ctx = ctx
        self.manager = manager
        self.scheduler = scheduler

    # ---- main loop -------------------------------------------------
    def run(self, tasks: List, speculate: bool = True) -> List:
        import concurrent.futures as cf
        from .. import knobs
        if len(tasks) > 1 and knobs.env_bool("DAFT_TORCH_CHAOS_SERIALIZE"):
            # exact-replay mode: one task (with all its retries and
            # recoveries) at a time, so every injection decision happens
            # in a deterministic total order — concurrent recovery of a
            # crashed shared source otherwise advances other consumers'
            # attempt counters in interleaving-dependent ways
            out: List = []
            for t in tasks:
                out.extend(self.run([t], speculate=False))
            return out
        pol = self.ctx.policy
        n = len(tasks)
        results: List = [None] * n
        done = [False] * n
        attempts = [0] * n           # compute-failure retries used
        fetch_states = [FetchRetryState(pol) for _ in range(n)]
        sig_workers: List[Dict] = [defaultdict(set) for _ in range(n)]
        has_backup = [False] * n
        live = [0] * n               # in-flight runs per task
        runs: Dict = {}              # future -> _Run
        abandoned: Dict = {}         # future -> _Run (discard on arrival)
        delayed: List = []           # (due_time, idx, attempt, exclude)

        # tracing: one parent span per TASK (stable fault-key id), child
        # attempt/retry/speculation/recompute spans hang off it; all ids
        # hash planner-minted identities, so chaos replays mint the same
        from .. import tracing as _tr
        tctx = _tr.current()
        trec = tctx.recorder if tctx is not None else None
        t_span: List = [None] * n    # (span_id, start_unix_us) per task
        self._trace = (trec, tctx.span_id if tctx is not None else None)

        def task_span(idx: int):
            if trec is None:
                return None
            if t_span[idx] is None:
                key = tasks[idx].fault_key \
                    or f"s{tasks[idx].stage_id}.t{tasks[idx].task_idx}"
                t_span[idx] = (trec.unique_span_id(f"task:{key}"),
                               _tr._now_us())
            return t_span[idx][0]

        def end_task_span(idx: int, status: str = "ok") -> None:
            if trec is None or t_span[idx] is None:
                return
            sid, t0 = t_span[idx]
            key = tasks[idx].fault_key or str(idx)
            trec.add("task", sid, tctx.span_id, t0,
                     _tr._now_us() - t0, attrs={"task": key},
                     status=status)

        def launch(idx: int, attempt: int, exclude: Optional[str] = None,
                   backup: bool = False) -> None:
            task = tasks[idx]
            fkey = task.fault_key or f"s{task.stage_id}.t{task.task_idx}"
            trace_ctx = None
            if trec is not None:
                parent = task_span(idx)
                run_id = trec.unique_span_id(
                    f"run:{fkey}#a{attempt}{'b' if backup else ''}")
                trace_ctx = (trec.trace_id, run_id, parent)
            dtask = dataclasses.replace(
                task,
                stage_inputs=self.ctx.lineage.translate_inputs(
                    task.stage_inputs),
                fault_key=fkey,
                attempt=attempt + (500 if backup else 0),
                trace_ctx=trace_ctx)
            states = pol.eligible(self.manager.snapshot(), exclude=exclude)
            wid = self.scheduler.pick(dtask, states)
            if backup and trec is not None:
                _tr.event("task:speculative", key=f"spec:{fkey}",
                          attrs={"worker": wid},
                          ctx=_tr.SpanContext(trec, task_span(idx)))
            fut = self.manager.dispatch(dtask, wid)
            live[idx] += 1
            if backup:
                has_backup[idx] = True
                count("speculative_launched")
            runs[fut] = _Run(idx, wid, pol.clock(), attempt, backup)

        durations: List[float] = []
        for i in range(n):
            launch(i, 0)

        try:
            self._run_loop(tasks, pol, results, done, attempts,
                           fetch_states, sig_workers, has_backup, live,
                           runs, abandoned, delayed, durations, launch,
                           task_span, end_task_span, speculate)
        except BaseException:
            # fatal failure (retries exhausted / fail-fast / recovery
            # dead end): still close every started task span so no
            # recorded child span is left orphaned
            for i in range(n):
                if not done[i]:
                    end_task_span(i, status="error")
            raise
        return results

    def _run_loop(self, tasks, pol, results, done, attempts, fetch_states,
                  sig_workers, has_backup, live, runs, abandoned, delayed,
                  durations, launch, task_span, end_task_span,
                  speculate) -> None:
        import concurrent.futures as cf

        while not all(done):
            if runs:
                ready, _ = cf.wait(list(runs), timeout=_TICK,
                                   return_when=cf.FIRST_COMPLETED)
            else:
                ready = ()
                if not delayed:  # defensive: nothing in flight or queued
                    raise RuntimeError("task supervisor stalled with "
                                       "unfinished tasks")
                time.sleep(_TICK)

            for fut in ready:
                run = runs.pop(fut)
                live[run.idx] -= 1
                if done[run.idx]:
                    self._discard(fut)  # losing twin: idempotent discard
                    continue
                exc = fut.exception()
                if exc is None:
                    res = fut.result()
                    results[run.idx] = res
                    done[run.idx] = True
                    durations.append(pol.clock() - run.t0)
                    pol.record_success(run.worker_id)
                    end_task_span(run.idx)
                    if has_backup[run.idx]:
                        count("speculative_wins" if run.backup
                              else "speculative_losses")
                    if hasattr(res, "shuffle_id"):  # map receipt
                        self.ctx.lineage.register(res, tasks[run.idx])
                    continue
                if live[run.idx] > 0:
                    # a twin is still running — it IS the retry; only
                    # charge the worker's health record (never for a
                    # fetch failure: the worker is healthy, its INPUT
                    # is gone)
                    if not isinstance(exc, ShuffleFetchError):
                        pol.record_failure(run.worker_id)
                    continue
                # the last twin died: this speculation cycle is over — a
                # relaunched attempt is a fresh primary (counts no
                # speculative win/loss, may speculate again)
                has_backup[run.idx] = False
                self._handle_failure(run, exc, tasks, attempts,
                                     fetch_states, sig_workers, delayed,
                                     task_span_id=task_span(run.idx))

            now = pol.clock()
            for item in [d for d in delayed if d[0] <= now]:
                delayed.remove(item)
                launch(item[1], item[2], exclude=item[3])

            # deadlines + speculation over still-running attempts
            for fut, run in list(runs.items()):
                if done[run.idx]:
                    continue
                elapsed = now - run.t0
                if pol.task_timeout > 0 and elapsed > pol.task_timeout:
                    runs.pop(fut)
                    live[run.idx] -= 1
                    abandoned[fut] = run
                    count("task_timeouts")
                    if live[run.idx] > 0:
                        pol.record_failure(run.worker_id)
                        continue
                    has_backup[run.idx] = False  # cycle over, see above
                    self._handle_failure(
                        run,
                        TaskTimeout(
                            f"task exceeded DAFT_TORCH_TASK_TIMEOUT="
                            f"{pol.task_timeout}s"),
                        tasks, attempts, fetch_states, sig_workers,
                        delayed, task_span_id=task_span(run.idx))
                    continue
                if (speculate and pol.speculative_multiplier > 0
                        and not run.backup and not has_backup[run.idx]
                        and live[run.idx] == 1 and len(durations) >= 2):
                    med = sorted(durations)[len(durations) // 2]
                    if elapsed > max(pol.speculative_multiplier * med,
                                     pol.speculative_min_s):
                        launch(run.idx, run.attempt,
                               exclude=run.worker_id, backup=True)

            for fut in [f for f in abandoned if f.done()]:
                abandoned.pop(fut)
                self._discard(fut)

    # ---- failure classification ------------------------------------
    def _handle_failure(self, run: _Run, exc: BaseException, tasks,
                        attempts, fetch_states, sig_workers,
                        delayed, task_span_id: Optional[str] = None
                        ) -> None:
        from .. import tracing as _tr
        pol = self.ctx.policy
        idx = run.idx
        trec, _root = getattr(self, "_trace", (None, None))
        tspan_ctx = _tr.SpanContext(trec, task_span_id) \
            if trec is not None and task_span_id else None
        fkey = tasks[idx].fault_key or str(idx)
        if isinstance(exc, ShuffleFetchError):
            # the executing worker is healthy — its INPUT is gone; don't
            # charge its circuit breaker or the fail-fast classifier
            if fetch_states[idx].should_recover(exc):
                # failed again after a plain refetch: the data is gone —
                # recompute only the producing map task (lineage);
                # attach the failing task's span so the recompute chain
                # nests under it in the merged trace
                with _tr.attach(tspan_ctx):
                    if not self.recover_source(
                            (exc.address, exc.shuffle_id), exc):
                        raise exc
            count("retries")
            if tspan_ctx is not None:
                _tr.event("task:retry",
                          key=f"retry:{fkey}#f{fetch_states[idx].attempts}",
                          attrs={"error": type(exc).__name__,
                                 "detail": str(exc)[:120]},
                          ctx=tspan_ctx)
            delayed.append((pol.clock()
                            + pol.backoff_s(tasks[idx].fault_key or str(idx),
                                            fetch_states[idx].attempts),
                            idx, run.attempt + 1, None))
            return
        if tspan_ctx is not None:
            _tr.event("task:retry", key=f"retry:{fkey}#a{run.attempt}",
                      attrs={"error": type(exc).__name__,
                             "detail": str(exc)[:120]}, ctx=tspan_ctx)
        if not isinstance(exc, TaskTimeout):
            # fail-fast classification — timeouts are exempt: their
            # signature is timing-dependent, not task-deterministic, so
            # they stay on the plain retry budget
            sig = f"{type(exc).__name__}: {str(exc)[:160]}"
            sig_workers[idx][sig].add(run.worker_id)
            if len(sig_workers[idx][sig]) >= 2:
                count("fail_fast")
                raise FailFastError(
                    f"task {tasks[idx].fault_key or idx} failed "
                    f"identically on workers "
                    f"{sorted(sig_workers[idx][sig])}: {sig}") from exc
        pol.record_failure(run.worker_id)
        attempts[idx] += 1
        if attempts[idx] > pol.max_retries:
            raise exc
        count("retries")
        delayed.append((pol.clock()
                        + pol.backoff_s(tasks[idx].fault_key or str(idx),
                                        attempts[idx]),
                        idx, run.attempt + 1, run.worker_id))

    # ---- lineage recovery ------------------------------------------
    def recover_source(self, src: Tuple[str, str],
                       exc: BaseException) -> bool:
        if self.ctx.depth >= ResilienceContext.MAX_RECOVERY_DEPTH:
            raise RuntimeError(
                "lineage recovery recursion limit reached") from exc

        def rerun(map_task):
            from .. import tracing as _tr
            self.ctx.depth += 1  # serialized under the lineage lock
            try:
                # recompute span: child of whatever span context the
                # caller attached (the consuming task's span); the child
                # supervisor's own task spans nest under it
                with _tr.span("lineage:recompute",
                              key=f"recompute:{map_task.fault_key or 'map'}",
                              attrs={"task": map_task.fault_key}):
                    child = TaskSupervisor(self.ctx, self.manager,
                                           self.scheduler)
                    group = getattr(map_task, "group_tasks", None)
                    if group is not None:
                        # collective stage: ALL-OR-NOTHING. The lost
                        # stream is one fused artifact of every member
                        # map task plus the intra-mesh collective — no
                        # per-map-task receipt exists to recover, so the
                        # whole exchange group re-executes and the merged
                        # receipt is rebuilt
                        # (topology.CollectiveExchangeGroup)
                        outs = child.run(list(group), speculate=False)
                        receipt = map_task.rebuild(outs)
                        count("collective_group_recoveries")
                        return receipt
                    return child.run([map_task], speculate=False)[0]
            finally:
                self.ctx.depth -= 1

        return self.ctx.lineage.recover(src, rerun)

    # ---- idempotent discard ----------------------------------------
    @staticmethod
    def _discard(fut) -> None:
        """Discard a duplicate/stale result: a losing speculative twin's
        (or timed-out attempt's) shuffle output is unregistered so it
        can't leak or be fetched."""
        try:
            if fut.cancelled() or fut.exception() is not None:
                return
            res = fut.result()
            if hasattr(res, "shuffle_id"):
                from .shuffle_service import unregister_remote
                unregister_remote(res.address, res.shuffle_id)
        except Exception:
            pass
