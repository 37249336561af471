"""Per-operator runtime stats, per-query plane attribution, exports and
the per-query torch.profiler capture.

The port's copy of ``daft_tpu/observability.py`` (itself modelled on the
reference engine's ``runtime_stats.rs``, ``common/tracing`` and
``explain_analyze``):

- per-operator rows / batches / wall (:class:`RuntimeStatsContext`,
  rendered by ``DataFrame.explain(analyze=True)``);
- per-query blocks of the shared planes — ``device kernels`` (the
  costmodel ledger), ``io`` (the scan plane), ``spill``, ``adaptive`` and
  ``governor`` — credited through thread attribution (:func:`attributed`,
  :func:`bump_plane`), so two overlapping queries never read each
  other's counters;
- ``DAFT_TORCH_CHROME_TRACE``: a chrome://tracing JSON of the last
  execution's per-operator batches;
- ``DAFT_TORCH_PROFILE_DIR``: a ``torch.profiler`` capture per query (CPU
  activity, plus CUDA when the query runs on a card), exported as a
  Kineto chrome trace — the kernel times that the ledger's host-wall
  ``seconds`` do not give;
- ``DAFT_TORCH_PROGRESS``: a tqdm partition-progress bar;
- the per-query exports (OTLP metrics and spans, the trace file, the
  flight recorder) in :func:`finalize_query`;
- the sanitizers' per-query blocks when they are armed: ``sanitizer``
  (the lock-order graph and this query's acquisitions), ``retrace`` (new
  device memory at the declared dispatch sites, and kernel launches) and
  ``plansan`` (plan-contract checks and violations).

Blocks of the reference that wait for the modules they read: ``recovery``,
``shuffle`` and ``exchange`` (the distributed tier, ROADMAP A7);
``serving`` (the serving plane, A8).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from . import knobs

_START_TS = time.perf_counter()


# ------------------------------------------------------------ attribution
#
# The shared planes (scan io, spill, governor, adaptive, the device-kernel
# ledger) are process-wide counters; diffing them per query breaks the
# moment two queries overlap (both diffs see the union). So the counter
# chokepoints ALSO bump the thread's *attributed* RuntimeStatsContext:
# executors install their stats context on every thread that does work
# for the query (the consumer loop, pool workers, pipeline stages, scan
# producers, IO fan-out), and ``finish()`` prefers the context-local tally
# over the process diff whenever the context was attributed at all.

_attr_tl = threading.local()


def current_attribution() -> Optional["RuntimeStatsContext"]:
    return getattr(_attr_tl, "ctx", None)


@contextlib.contextmanager
def attributed(ctx: Optional["RuntimeStatsContext"]):
    """Install ``ctx`` as this thread's stats-attribution target (and,
    when the context belongs to a traced query, its span context — the
    tracing plane rides the same propagation: pool workers, pipeline
    stage threads and prefetch producers all come through here). Both
    are restored on exit, so a thread kept across queries (the stage
    threads, the pools) carries nothing of one query into the next."""
    from . import tracing  # hot path: resolved from sys.modules
    prev = getattr(_attr_tl, "ctx", None)
    _attr_tl.ctx = ctx
    tctx = ctx.trace_ctx if ctx is not None else None
    tprev = tracing._set_current(tctx)
    if ctx is not None:
        ctx._attributed = True
    try:
        yield
    finally:
        tracing._set_current(tprev)
        _attr_tl.ctx = prev


# nested-execution marker: an execution inside another query's (the AQE
# loop's join-input materializations) records its own stats, but the
# per-query EXPORTS (otlp, trace files, flight recorder) fire once per
# top-level query: nested scopes suppress them.

_nested_tl = threading.local()


@contextlib.contextmanager
def nested_scope():
    prev = getattr(_nested_tl, "n", 0)
    _nested_tl.n = prev + 1
    try:
        yield
    finally:
        _nested_tl.n = prev


def in_nested_scope() -> bool:
    return getattr(_nested_tl, "n", 0) > 0


def run_attributed(ctx, fn, *args, **kwargs):
    """Run ``fn`` with ``ctx`` attributed — the shape pool-submit sites
    use to carry the submitting thread's attribution onto the worker."""
    with attributed(ctx):
        return fn(*args, **kwargs)


def bump_plane(plane: str, key: str, n: float = 1) -> None:
    """Credit ``n`` to the attributed context's plane tally (no-op when
    the thread is unattributed — the process-wide counter the caller
    already bumped remains the only record)."""
    ctx = getattr(_attr_tl, "ctx", None)
    if ctx is not None:
        ctx._bump(plane, key, n)


def _now_us() -> int:
    return int((time.perf_counter() - _START_TS) * 1_000_000)


def _ledger_raw() -> Dict[str, dict]:
    from .device import costmodel
    return costmodel.ledger_snapshot(raw=True)


def _spill_raw() -> Dict[str, float]:
    from .execution import memory
    return memory.spill_counters_snapshot()


def _scan_io_raw() -> Dict[str, float]:
    from .io import read_planner
    return read_planner.scan_counters_snapshot()


def _adaptive_raw() -> Dict[str, float]:
    from .physical import adaptive
    return adaptive.counters_snapshot()


def _governor_raw() -> Dict[str, float]:
    from .execution import governor
    return governor.counters_snapshot()


def _sanitizer_raw() -> Dict[str, float]:
    """The lock-order sanitizer's counters (empty unless armed)."""
    from .analysis import lock_sanitizer
    return lock_sanitizer.counters_snapshot()


def _retrace_raw() -> Dict[str, float]:
    """The retrace sanitizer's counters (empty unless armed)."""
    from .analysis import retrace_sanitizer
    return retrace_sanitizer.counters_snapshot()


def _plansan_raw() -> Dict[str, float]:
    """The plan sanitizer's counters (empty unless armed)."""
    from .analysis import plan_sanitizer
    return plan_sanitizer.counters_snapshot()


class OperatorStats:
    """Counters for one physical operator (reference:
    ``RuntimeStatsContext`` counters)."""

    __slots__ = ("name", "rows_out", "batches_out", "inclusive_us",
                 "morsel_rows_min", "morsel_rows_max", "workers", "lock")

    def __init__(self, name: str):
        self.name = name
        self.rows_out = 0
        self.batches_out = 0
        self.inclusive_us = 0
        self.morsel_rows_min = None
        self.morsel_rows_max = None
        #: worker threads of the operator's pipeline stage (None = one)
        self.workers = None
        self.lock = threading.Lock()

    def record(self, nrows: int, dur_us: int):
        with self.lock:
            self.rows_out += nrows
            self.batches_out += 1
            self.inclusive_us += dur_us
            if self.morsel_rows_min is None or nrows < self.morsel_rows_min:
                self.morsel_rows_min = nrows
            if self.morsel_rows_max is None or nrows > self.morsel_rows_max:
                self.morsel_rows_max = nrows


class ChromeTracer:
    """Collects chrome://tracing 'X' (complete) events; flushed per query."""

    def __init__(self):
        self._events: List[dict] = []
        self._lock = threading.Lock()

    def add(self, name: str, ts_us: int, dur_us: int):
        tid = threading.get_ident() & 0xFFFF
        with self._lock:
            self._events.append({"name": name, "ph": "X", "ts": ts_us,
                                 "dur": dur_us, "pid": os.getpid(),
                                 "tid": tid})

    def dump(self, path: str):
        with self._lock:
            events = list(self._events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)


class RuntimeStatsContext:
    """Per-query stats: one ``OperatorStats`` per physical-plan node.

    Timing semantics: ``inclusive_us`` is wall time spent producing each
    batch at that operator's output boundary (upstream pulls included);
    ``exclusive_us`` subtracts the children's inclusive time at render.
    The operators of a push-pipeline map chain (one stage running several
    operators' kernels per morsel) count the kernel's own time each.
    """

    def __init__(self, tracer: Optional[ChromeTracer] = None):
        from . import tracing
        self._ops: Dict[int, OperatorStats] = {}
        self._children: Dict[int, List[int]] = {}
        self._lock = threading.Lock()
        self.tracer = tracer
        self.wall_us: Optional[int] = None
        self.plan = None  # physical plan root, set by the executor
        #: the exported torch.profiler trace of this query, if captured
        self.profile_path: Optional[str] = None
        self._t0 = time.perf_counter()
        self._t0_unix_us = int(time.time() * 1e6)
        # tracing plane: adopt the thread's current span context (the
        # runner started the trace before building this context); None =
        # this query is untraced — every span site guard-checks that
        self.trace_ctx = tracing.current()
        self.trace_summary: Dict[str, object] = {}
        # process-wide snapshots, diffed at finish() for a context no
        # thread was ever attributed to
        self._ledger0 = _ledger_raw()
        self.device_kernels: Dict[str, dict] = {}
        self._io0 = _scan_io_raw()
        self.io: Dict[str, float] = {}
        self._spill0 = _spill_raw()
        self.spill: Dict[str, float] = {}
        self._adaptive0 = _adaptive_raw()
        self.adaptive: Dict[str, float] = {}
        self._governor0 = _governor_raw()
        self.governor: Dict[str, float] = {}
        # the sanitizers' counters are process state (a lock-order graph,
        # the allocator, the plan contracts): diffed, never attributed
        self._sanitizer0 = _sanitizer_raw()
        self.sanitizer: Dict[str, float] = {}
        self._retrace0 = _retrace_raw()
        self.retrace: Dict[str, float] = {}
        self._plansan0 = _plansan_raw()
        self.plansan: Dict[str, float] = {}
        # context-local plane tallies: the counter chokepoints bump these
        # through the thread attribution the executors install
        self._plane_lock = threading.Lock()
        self._planes: Dict[str, Dict[str, float]] = {}
        self._attributed = False

    def _bump(self, plane: str, key: str, n: float) -> None:
        with self._plane_lock:
            d = self._planes.setdefault(plane, {})
            d[key] = d.get(key, 0) + n

    def _plane(self, plane: str) -> Dict[str, float]:
        with self._plane_lock:
            return dict(self._planes.get(plane, {}))

    def register(self, node) -> OperatorStats:
        key = id(node)
        with self._lock:
            st = self._ops.get(key)
            if st is None:
                st = OperatorStats(type(node).__name__)
                self._ops[key] = st
                self._children[key] = [id(c) for c in node.children]
            return st

    def instrument(self, node, it):
        """Wrap a node's output iterator with rows/time accounting."""
        st = self.register(node)
        tracer = self.tracer

        def gen():
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                dur = int((time.perf_counter() - t0) * 1_000_000)
                st.record(len(item), dur)
                if tracer is not None:
                    tracer.add(st.name, _now_us() - dur, dur)
                yield item
        return gen()

    def instrument_kernel(self, node, kernel):
        """Wrap a per-morsel kernel with the rows/time accounting of
        ``node`` (the inner operators of a push-pipeline map chain, whose
        outputs never cross a channel)."""
        st = self.register(node)
        tracer = self.tracer

        def run(p):
            t0 = time.perf_counter()
            out = kernel(p)
            dur = int((time.perf_counter() - t0) * 1_000_000)
            st.record(len(out), dur)
            if tracer is not None:
                tracer.add(st.name, _now_us() - dur, dur)
            return out
        return run

    def finish(self):
        from .device import costmodel
        from .execution import governor, memory
        from .io import read_planner
        from .physical import adaptive
        self.wall_us = int((time.perf_counter() - self._t0) * 1_000_000)
        # scoped attribution beats the process-wide diff: an attributed
        # context's tallies hold exactly this query's events even when
        # other queries ran concurrently
        if self._attributed:
            self.device_kernels = costmodel.ledger_from_tallies(
                self._plane("device_kernels"))
            self.io = self._plane("io")
            self.spill = self._plane("spill")
            self.adaptive = self._plane("adaptive")
            self.governor = self._plane("governor")
        else:
            self.device_kernels = costmodel.ledger_delta(
                self._ledger0, _ledger_raw())
            self.io = read_planner.scan_counters_delta(
                self._io0, _scan_io_raw())
            self.spill = memory.spill_counters_delta(
                self._spill0, _spill_raw())
            self.adaptive = adaptive.counters_delta(
                self._adaptive0, _adaptive_raw())
            self.governor = governor.counters_delta(
                self._governor0, _governor_raw())
        # the RSS gauges ride the governor block regardless of
        # attribution: peak RSS is process state, not traffic
        self.governor["rss_peak_bytes"] = float(governor.peak_rss_bytes())
        lim = governor.limit_bytes()
        if lim:
            self.governor["rss_limit_bytes"] = float(lim)
        from .analysis import lock_sanitizer, plan_sanitizer, \
            retrace_sanitizer
        self.sanitizer = lock_sanitizer.counters_delta(
            self._sanitizer0, _sanitizer_raw())
        self.retrace = retrace_sanitizer.counters_delta(
            self._retrace0, _retrace_raw())
        self.plansan = plan_sanitizer.counters_delta(
            self._plansan0, _plansan_raw())
        self._emit_trace_spans()

    def _emit_trace_spans(self) -> None:
        """Fold the per-operator timings into the query trace as one span
        per physical operator (children of the span context this executor
        ran under: the query root)."""
        ctx = self.trace_ctx
        if ctx is None:
            return
        rec = ctx.recorder
        for key, st in list(self._ops.items()):
            rec.add(f"op:{st.name}",
                    rec.unique_span_id(f"op:{st.name}"),
                    ctx.span_id, self._t0_unix_us, st.inclusive_us,
                    attrs={"rows_out": st.rows_out,
                           "batches": st.batches_out,
                           "self_us": self.exclusive_us(key)},
                    lane="pipeline")
        self.trace_summary = rec.summary()

    # ---- reporting ---------------------------------------------------
    def exclusive_us(self, key: int) -> int:
        st = self._ops[key]
        child_incl = sum(self._ops[c].inclusive_us
                         for c in self._children.get(key, [])
                         if c in self._ops)
        return max(st.inclusive_us - child_incl, 0)

    def render(self, plan=None) -> str:
        """ASCII explain-analyze tree (annotated like the reference's
        ``explain_analyze``)."""
        if plan is None:
            plan = self.plan
        lines = []
        if self.wall_us is not None:
            lines.append(f"query wall time: {self.wall_us / 1e6:.3f}s")

        def walk(node, depth):
            key = id(node)
            st = self._ops.get(key)
            pad = "  " * depth
            if st is None:
                lines.append(f"{pad}{type(node).__name__}")
            else:
                wk = f" workers={st.workers}" if st.workers else ""
                lines.append(
                    f"{pad}{st.name}: rows_out={st.rows_out} "
                    f"batches={st.batches_out} "
                    f"total={st.inclusive_us / 1e6:.3f}s "
                    f"self={self.exclusive_us(key) / 1e6:.3f}s{wk}")
            for c in node.children:
                walk(c, depth + 1)

        if plan is not None:
            walk(plan, 0)
        else:
            for st in self._ops.values():
                lines.append(f"{st.name}: rows_out={st.rows_out} "
                             f"batches={st.batches_out} "
                             f"total={st.inclusive_us / 1e6:.3f}s")
        lines.extend(render_device_kernels_block(self.device_kernels))
        lines.extend(render_adaptive_block(self.adaptive))
        lines.extend(render_io_block(self.io))
        lines.extend(render_spill_block(self.spill))
        lines.extend(render_governor_block(self.governor))
        lines.extend(render_sanitizer_block(self.sanitizer))
        lines.extend(render_retrace_block(self.retrace))
        lines.extend(render_plansan_block(self.plansan))
        if self.trace_summary:
            t = self.trace_summary
            lines.append(f"trace: id={t.get('trace_id')} "
                         f"spans={t.get('spans')} "
                         f"dropped={t.get('dropped', 0)}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, dict]:
        out = {}
        for key, st in self._ops.items():
            name = st.name
            i = 2
            while name in out:
                name = f"{st.name}#{i}"
                i += 1
            out[name] = {"rows_out": st.rows_out,
                         "morsel_rows_min": st.morsel_rows_min,
                         "morsel_rows_max": st.morsel_rows_max,
                         "workers": st.workers,
                         "batches_out": st.batches_out,
                         "inclusive_us": st.inclusive_us,
                         "exclusive_us": self.exclusive_us(key)}
        return out


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GB"


def render_device_kernels_block(dk: Dict[str, dict]) -> List[str]:
    """Human lines for one query's device-kernel ledger (shared by
    ``explain(analyze=True)`` and the dashboard): per family, dispatches,
    rows and the dispatches' host wall (``seconds``: each dispatch's wall
    up to its result, the link included — not kernel time, which the
    profiler capture gives), achieved GB/s against the card's roofline,
    MFU, and the grouped-agg strategy with its table load."""
    if not dk:
        return []
    lines = ["device kernels (per-dispatch ledger, "
             "end-to-end incl. link):"]
    for kind, d in sorted(dk.items()):
        extra = ""
        if "achieved_gbps" in d:
            extra = (f" {round(d['achieved_gbps'], 3)} GB/s"
                     f" ({round(d.get('roofline_pct', 0), 4)}% roofline)")
        if "mfu_pct" in d:
            extra += f" {round(d['mfu_pct'], 4)}% MFU"
        if "strategy" in d:
            extra += f" strategy={d['strategy']}"
            if "load_factor" in d:
                extra += f" load={round(d['load_factor'], 3)}"
        if "overlap_x" in d:
            extra += f" overlap={round(d['overlap_x'], 3)}x"
        if "fused_ops" in d:
            extra += (f" fused_ops={d['fused_ops']}"
                      f" rt_saved={d.get('round_trips_saved', 0)}")
        if "fusion_x" in d:
            extra += f" fusion={round(d['fusion_x'], 3)}x"
        lines.append(
            f"  {kind}: dispatches={d['dispatches']} "
            f"rows={d['rows']} time={d['seconds']:.3f}s{extra}")
    return lines


def render_adaptive_block(d: Dict[str, float]) -> List[str]:
    """Human lines for one query's self-tuning delta (shared by
    ``explain(analyze=True)`` and the dashboard): the re-plan decisions
    it made, the calibration observations it fed, plus which learned
    cost-model constants override their defaults right now."""
    from .device import calibration
    cal_names = calibration.calibrated_names() \
        if calibration.enabled() else []
    if not d and not cal_names:
        return []
    lines = ["adaptive (self-tuning):"]
    decisions = {k: int(v) for k, v in sorted(d.items())
                 if k != "calibration_observations" and v}
    if decisions:
        lines.append("  re-plan: " + ", ".join(
            f"{k}={v}" for k, v in decisions.items()))
    obs_n = int(d.get("calibration_observations", 0))
    if obs_n:
        lines.append(f"  calibration: {obs_n} observations fed")
    if cal_names:
        lines.append("  calibrated constants (overriding defaults): "
                     + ", ".join(cal_names))
    return lines


def render_spill_block(d: Dict[str, float]) -> List[str]:
    """Human lines for one query's out-of-core spill delta (shared by
    ``explain(analyze=True)`` and the dashboard): disk bytes the spill
    tier wrote/read, partitions that left RAM, grace-join/agg recursion
    evidence, and the summed per-store peak residency of the stores that
    spilled (an upper bound on what the spill tier held resident)."""
    if not d:
        return []
    lines = ["spill (out-of-core tier):"]
    written = d.get("bytes_written", 0)
    read = d.get("bytes_read", 0)
    if written or read:
        lines.append(f"  disk: {_fmt_bytes(written)} written / "
                     f"{_fmt_bytes(read)} read, "
                     f"{int(d.get('partitions_spilled', 0))} partitions "
                     f"spilled")
    jp, jg = int(d.get("joins_partitioned", 0)), \
        int(d.get("joins_gathered", 0))
    if jp or jg:
        lines.append(f"  grace join: {jp} partitioned, {jg} gathered")
    rec = int(d.get("recursions", 0))
    if rec or d.get("depth_exhausted"):
        deepest = max((int(k.rsplit("_d", 1)[1]) for k in d
                       if k.startswith("recursions_d")), default=0)
        lines.append(
            f"  recursion: {rec} re-partitions (deepest level {deepest}),"
            f" {int(d.get('depth_exhausted', 0))} depth-bound exhaustions")
    if d.get("agg_buckets_merged"):
        lines.append(f"  agg: {int(d.get('agg_buckets_merged', 0))} "
                     f"state buckets merged on read")
    if d.get("stores"):
        ns = int(d.get("stores", 0))
        lines.append(
            f"  resident: ≤{_fmt_bytes(d.get('store_peak_bytes', 0))} "
            f"summed peak across {ns} spilling store(s)")
    disk_w = d.get("disk_bytes_written", 0)
    if disk_w and written:
        lines.append(
            f"  codec: {_fmt_bytes(disk_w)} on disk "
            f"({written / disk_w:.2f}x compression)")
    return lines


def render_governor_block(d: Dict[str, float]) -> List[str]:
    """Human lines for one query's memory-governor delta (shared by
    ``explain(analyze=True)`` and the dashboard): the backpressure
    actions taken while the query ran and the process peak RSS against
    the configured limit."""
    peak = d.get("rss_peak_bytes", 0)
    lim = d.get("rss_limit_bytes", 0)
    actions = {k: v for k, v in d.items()
               if k not in ("rss_peak_bytes", "rss_limit_bytes") and v}
    if not actions and not (peak and lim):
        return []
    lines = ["memory governor:"]
    if peak:
        vs = f" vs limit {_fmt_bytes(lim)}" if lim else ""
        lines.append(f"  rss: peak {_fmt_bytes(peak)}{vs}")
    if actions:
        waits = int(actions.pop("throttle_waits", 0))
        wait_us = actions.pop("throttle_wait_us", 0)
        if waits:
            lines.append(f"  throttle: {waits} bounded wait(s), "
                         f"{wait_us / 1e6:.2f}s total")
        rest = {k: int(v) for k, v in sorted(actions.items())
                if not k.startswith("throttle_")}
        if rest:
            lines.append("  actions: " + ", ".join(
                f"{k}={v}" for k, v in rest.items()))
    return lines


def render_sanitizer_block(s: Dict[str, float]) -> List[str]:
    """Human lines for one query's lock-sanitizer delta (shared by
    ``explain(analyze=True)`` and the dashboard; empty unless
    ``DAFT_TORCH_SANITIZE=1``): the lock-order graph's size and cycle
    count, and this query's acquisition/contention/blocking events."""
    if not s:
        return []
    cycles = int(s.get("graph_cycles", 0))
    lines = ["concurrency (lock sanitizer):"]
    lines.append(f"  graph: {int(s.get('graph_locks', 0))} lock sites, "
                 f"{int(s.get('graph_edges', 0))} order edges, "
                 f"{cycles} cycle{'s' if cycles != 1 else ''}"
                 + (" (POTENTIAL DEADLOCK)" if cycles else ""))
    lines.append(f"  this query: {int(s.get('acquisitions', 0))} "
                 f"acquisitions, {int(s.get('contended', 0))} contended, "
                 f"{int(s.get('blocking_while_held', 0))} "
                 f"blocking-while-held")
    return lines


def render_retrace_block(s: Dict[str, float]) -> List[str]:
    """Human lines for one query's retrace-sanitizer delta (empty unless
    armed): the new device memory it allocated at the declared dispatch
    sites and the kernel launches it made — a repeat of a query reads 0
    allocating events."""
    if not s:
        return []
    viol = int(s.get("violations", 0))
    lines = ["shape discipline (retrace sanitizer):"]
    lines.append(
        f"  this query: {int(s.get('events', 0))} allocating events "
        f"({int(s.get('segments', 0))} new segments, "
        f"{int(s.get('pinned', 0))} new pinned blocks), "
        f"{int(s.get('launches', 0))} kernel launches, "
        f"{int(s.get('unscoped_events', 0))} unscoped")
    lines.append(
        f"  budget violations: {viol} this query, "
        f"{int(s.get('total_violations', 0))} total"
        + (" (RETRACE TAX — see retrace_sanitizer.report())"
           if viol else ""))
    return lines


def render_plansan_block(s: Dict[str, float]) -> List[str]:
    """Human lines for one query's plan-sanitizer delta (empty unless
    armed): the contract checks this query paid and whether any plan
    invariant broke — a healthy query reads violations 0."""
    if not s:
        return []
    viol = int(s.get("violations", 0))
    lines = ["plan discipline (plan sanitizer):"]
    lines.append(
        f"  this query: {int(s.get('rule_checks', 0))} rule schema "
        f"checks, {int(s.get('membership_parts', 0))} partitions "
        f"({int(s.get('membership_rows', 0))} rows) membership-sampled, "
        f"{int(s.get('order_parts', 0))} order-checked, "
        f"{int(s.get('conservation_checks', 0))} conservation proofs")
    lines.append(
        f"  contract violations: {viol} this query, "
        f"{int(s.get('total_violations', 0))} total"
        + (" (PLAN CONTRACT BROKEN — see plan_sanitizer.report())"
           if viol else ""))
    return lines


def render_io_block(d: Dict[str, float]) -> List[str]:
    """Human lines for one query's scan-plane IO delta (shared by
    ``explain(analyze=True)`` and the dashboard): requests issued vs byte
    ranges needed pre-coalesce, bytes fetched vs bytes decoded, and the
    prefetch-pipelined wall vs the serial-equivalent sum of per-task load
    times."""
    if not d:
        return []
    lines = ["io (scan plane):"]
    gets = int(d.get("gets", 0))
    planned = int(d.get("ranges_planned", 0))
    reqs = int(d.get("range_requests", 0))
    if gets or planned:
        coal = f", {planned / reqs:.1f}x coalesced" if reqs else ""
        lines.append(f"  requests: {gets} GETs "
                     f"({planned} ranges needed -> {reqs} range "
                     f"requests{coal})")
    fetched = d.get("bytes_fetched", 0)
    used = d.get("bytes_used", 0)
    if fetched:
        eff = f" ({100.0 * used / fetched:.1f}% used)" if used else ""
        lines.append(f"  bytes: {_fmt_bytes(fetched)} fetched / "
                     f"{_fmt_bytes(used)} decoded{eff}")
    span = d.get("scan_span_us", 0) / 1e6
    serial = d.get("scan_task_us", 0) / 1e6
    if span or serial:
        tasks = int(d.get("prefetch_tasks", 0))
        overlap = f" ({serial / span:.1f}x overlap)" if span else ""
        lines.append(f"  prefetch: {tasks} tasks, wall {span:.3f}s vs "
                     f"serial-equivalent {serial:.3f}s{overlap}")
    misses = int(d.get("planner_miss_gets", 0))
    falls = int(d.get("planned_read_fallbacks", 0))
    if misses or falls:
        lines.append(f"  planner: {misses} miss GETs, "
                     f"{falls} whole-file fallbacks")
    return lines


# ---------------------------------------------------------------------------
# per-query torch.profiler capture


def profile_dir() -> Optional[str]:
    """``DAFT_TORCH_PROFILE_DIR=<dir>``: a torch.profiler capture per
    query, exported as a Kineto chrome trace (open it in perfetto or
    chrome://tracing) — the card's kernel timeline, the hand-written
    kernels by name among them."""
    return knobs.env_raw("DAFT_TORCH_PROFILE_DIR")


_profile_lock = threading.Lock()
_profile_owner: Optional[object] = None
_profile_seq = itertools.count(1)


def _new_profiler(activities):
    from torch.profiler import profile
    try:
        # the engine's kernels launch from pipeline stage threads: record
        # every thread's CPU ops, where this torch build can
        import torch._C._profiler as _p
        cfg = _p._ExperimentalConfig(profile_all_threads=True)
        return profile(activities=activities, experimental_config=cfg)
    except (AttributeError, TypeError):
        return profile(activities=activities)


class ProfileCapture:
    """One query's torch.profiler session. The profiler is process-wide,
    so only one query owns the capture at a time: a query that starts
    while another holds it runs without a capture (``active`` False).
    Never takes the query down on failure (counted in
    ``profile_errors``)."""

    def __init__(self, out_dir: str, device=None):
        global _profile_owner
        self.active = False
        self.path: Optional[str] = None
        self._out_dir = out_dir
        self._cuda = False
        with _profile_lock:
            if _profile_owner is not None:
                return  # another query is profiling this process
            _profile_owner = self
        try:
            import torch
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CPU]
            if device is not None and torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
                self._cuda = True
            self._prof = _new_profiler(acts)
            self._prof.start()
            self.active = True
        except Exception:
            obs_count("profile_errors")
            with _profile_lock:
                _profile_owner = None

    def stop(self) -> Optional[str]:
        """End the capture and export it; returns the trace's path."""
        global _profile_owner
        if not self.active:
            return None
        self.active = False
        try:
            if self._cuda:
                # the query's last kernels finish inside the capture
                import torch
                torch.cuda.synchronize()
            self._prof.stop()
            os.makedirs(self._out_dir, exist_ok=True)
            path = os.path.join(
                self._out_dir,
                f"profile_{os.getpid()}_{next(_profile_seq)}.json")
            self._prof.export_chrome_trace(path)
            self.path = path
        except Exception:
            obs_count("profile_errors")
        finally:
            with _profile_lock:
                if _profile_owner is self:
                    _profile_owner = None
        return self.path


_NO_RANGE = contextlib.nullcontext()


def kernel_range(name: str):
    """A ``torch.profiler.record_function`` range ``daft_torch::<name>``
    around one call of a hand-written kernel's entry while a capture is
    on: the trace then ties each wrapper call to its launches, one whose
    kernel record the profiler drops included. A shared no-op
    otherwise."""
    if _profile_owner is None:
        return _NO_RANGE
    import torch
    return torch.profiler.record_function(f"daft_torch::{name}")


def chrome_trace_path() -> Optional[str]:
    v = knobs.env_raw("DAFT_TORCH_CHROME_TRACE")
    if not v:
        return None
    low = v.lower()
    if low in ("0", "false", "no", "off"):
        return None
    if low in ("1", "true", "yes", "on"):
        return os.path.join(tempfile.gettempdir(),
                            f"daft_torch_trace_{os.getpid()}.json")
    return v


def progress_enabled() -> bool:
    return knobs.env_bool("DAFT_TORCH_PROGRESS")


# ---------------------------------------------------------------------------
# the query lifecycle: start, finish, the "last query" registry


def new_query_stats() -> RuntimeStatsContext:
    from . import tracing
    tracer = ChromeTracer() if chrome_trace_path() else None
    ctx = RuntimeStatsContext(tracer)
    # fallback trace start for executors driven without a runner (the
    # runner normally starts the trace earlier, so the planner spans land
    # too); nested scopes never start traces
    if ctx.trace_ctx is None and not in_nested_scope() \
            and tracing.trace_enabled():
        ctx.trace_ctx = tracing.maybe_start_trace("query")
    return ctx


def profile_capture(device=None) -> Optional[ProfileCapture]:
    """The query's profiler capture under ``DAFT_TORCH_PROFILE_DIR``
    (None when the knob is unset)."""
    pdir = profile_dir()
    return ProfileCapture(pdir, device) if pdir else None


def end_query(stats: RuntimeStatsContext, capture=None) -> None:
    """Close a query (the executors' stream ends here): stop and export
    the capture, finish the stats, publish them and run the exports."""
    if capture is not None:
        stats.profile_path = capture.stop()
    stats.finish()
    set_last_stats(stats)
    path = chrome_trace_path()
    if path and stats.tracer is not None:
        stats.tracer.dump(path)


_last_stats: Optional[RuntimeStatsContext] = None
_last_lock = threading.Lock()
_tl_last = threading.local()


def set_last_stats(ctx: RuntimeStatsContext):
    global _last_stats
    with _last_lock:
        _last_stats = ctx
    # per-thread record too: queries finishing concurrently each read
    # their own context back (the stats finish on the consumer thread)
    _tl_last.stats = ctx
    from . import dashboard
    if dashboard._server is not None:
        dashboard.broadcast_query(ctx)
    if not in_nested_scope():
        finalize_query(ctx)


def last_query_stats() -> Optional[RuntimeStatsContext]:
    """Stats of the most recent execution in this process."""
    with _last_lock:
        return _last_stats


def last_query_stats_local() -> Optional[RuntimeStatsContext]:
    """Stats of the most recent execution drained on THIS thread."""
    return getattr(_tl_last, "stats", None)


# ------------------------------------------------- observability counters
# Export-plane accounting (otlp_export_errors & co): process-wide, served
# through the /metrics scrape.

_obs_counters_lock = threading.Lock()
_obs_counters: Dict[str, float] = {}


def obs_count(name: str, n: float = 1) -> None:
    with _obs_counters_lock:
        _obs_counters[name] = _obs_counters.get(name, 0) + n


def obs_counters_snapshot() -> Dict[str, float]:
    with _obs_counters_lock:
        return dict(_obs_counters)


def finalize_query(ctx: RuntimeStatsContext) -> None:
    """One top-level query's export hooks: OTLP metrics (+spans for
    traced queries), the Chrome trace file, and the flight recorder.
    Idempotent per trace; never raises into the query path."""
    from . import tracing
    endpoint = knobs.env_raw("DAFT_TORCH_OTLP_ENDPOINT")
    if endpoint:
        export_otlp(ctx, endpoint)
    try:
        tctx = ctx.trace_ctx
        rec = tctx.recorder if tctx is not None else None
        if rec is not None and not rec.exported:
            rec.exported = True
            rec.finish()
            ctx.trace_summary = rec.summary()
            tracing.unregister_recorder(rec.trace_id)
            out_dir = knobs.env_raw("DAFT_TORCH_TRACE_DIR")
            if out_dir:
                try:
                    os.makedirs(out_dir, exist_ok=True)
                    path = os.path.join(out_dir,
                                        f"trace_{rec.trace_id}.json")
                    with open(path, "w") as f:
                        json.dump(tracing.chrome_trace_json(rec), f)
                except Exception:
                    obs_count("trace_export_errors")
            if endpoint:
                _post_otlp_async(endpoint, "/v1/traces",
                                 tracing.otlp_spans_payload(rec))
        if tracing._flight_path():  # don't build entries nobody records
            tracing.flight_record(flight_entry(ctx))
    except Exception:
        obs_count("finalize_errors")


def flight_entry(ctx: RuntimeStatsContext) -> dict:
    """One flight-recorder record: the query's stat blocks, trace
    summary and slow-query flag."""
    from . import tracing
    wall_us = ctx.wall_us or 0
    slow_ms = tracing.slow_query_ms()
    entry = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "wall_us": wall_us,
        "slow": bool(slow_ms and slow_ms > 0
                     and wall_us / 1e3 > slow_ms),
        "operators": ctx.as_dict(),
    }
    for block in ("io", "spill", "governor", "adaptive", "device_kernels",
                  "sanitizer", "retrace", "plansan"):
        v = getattr(ctx, block, None)
        if v:
            entry[block] = dict(v)
    if ctx.trace_summary:
        entry["trace"] = dict(ctx.trace_summary)
    return entry


# ------------------------------------------------------------------ OTLP

def otlp_payload(ctx: RuntimeStatsContext) -> dict:
    """Per-operator counters as an OTLP/HTTP JSON
    ExportMetricsServiceRequest. DELTA temporality: each export carries
    one query's contribution, keyed only by operator name — bounded
    series cardinality, and collectors sum deltas across queries."""
    now_ns = int(time.time() * 1e9)
    start_ns = now_ns - (ctx.wall_us or 0) * 1000

    def sum_metric(name: str, unit: str, points):
        return {"name": name, "unit": unit, "sum": {
            "aggregationTemporality": 1,  # DELTA
            "isMonotonic": True,
            "dataPoints": points}}

    def point(value: int, op_name: str):
        return {"asInt": str(int(value)),
                "startTimeUnixNano": str(start_ns),
                "timeUnixNano": str(now_ns),
                "attributes": [
                    {"key": "operator",
                     "value": {"stringValue": op_name}}]}

    per_op = ctx.as_dict()
    metrics = [
        sum_metric("daft_torch.operator.rows_out", "{row}",
                   [point(st["rows_out"], nm)
                    for nm, st in per_op.items()]),
        sum_metric("daft_torch.operator.batches_out", "{batch}",
                   [point(st["batches_out"], nm)
                    for nm, st in per_op.items()]),
        sum_metric("daft_torch.operator.cpu_us", "us",
                   [point(st["exclusive_us"], nm)
                    for nm, st in per_op.items()]),
    ]
    return {"resourceMetrics": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": "daft_tpu_torch"}}]},
        "scopeMetrics": [{
            "scope": {"name": "daft_tpu_torch.observability"},
            "metrics": metrics}]}]}


def _post_otlp_async(endpoint: str, route: str, payload_obj: dict) -> None:
    """Fire-and-forget OTLP/HTTP POST on a daemon thread with a bounded
    timeout (``DAFT_TORCH_OTLP_TIMEOUT``). A hung or erroring collector
    can neither stall nor fail the query — every failure (a non-2xx
    status, a read that outlives the timeout, a thread spawn at
    interpreter shutdown) is swallowed and counted in
    ``otlp_export_errors``."""
    import urllib.request

    try:
        timeout = knobs.env_float("DAFT_TORCH_OTLP_TIMEOUT")
        payload = json.dumps(payload_obj).encode()
        url = endpoint.rstrip("/") + route

        def post():
            try:
                req = urllib.request.Request(
                    url, data=payload,
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=timeout).read()
            except Exception:
                obs_count("otlp_export_errors")

        threading.Thread(target=post, name="daft-torch-otlp",
                         daemon=True).start()
    except Exception:
        obs_count("otlp_export_errors")


def export_otlp(ctx: RuntimeStatsContext, endpoint: str) -> None:
    """Fire-and-forget POST of the query's operator counters to an
    OTLP/HTTP collector (``<endpoint>/v1/metrics``); traced queries also
    export their span tree to ``/v1/traces`` (see
    :func:`finalize_query`). Never fails or blocks the query."""
    try:
        _post_otlp_async(endpoint, "/v1/metrics", otlp_payload(ctx))
    except Exception:
        obs_count("otlp_export_errors")


def wrap_progress(it, desc: str = "partitions"):
    """tqdm progress over a partition stream when DAFT_TORCH_PROGRESS=1."""
    if not progress_enabled():
        return it
    try:
        from tqdm import tqdm
    except ImportError:
        return it

    def gen():
        rows = 0
        with tqdm(desc=desc, unit="part") as bar:
            for p in it:
                rows += len(p)
                bar.set_postfix_str(f"{rows} rows")
                bar.update(1)
                yield p
    return gen()
