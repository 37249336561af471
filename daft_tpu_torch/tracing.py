"""Query-wide tracing plane: span propagation and exports.

The port's copy of ``daft_tpu/tracing.py``. One query = one trace. An
explicit span context (trace id, span id, parent id) threads through the
layers that carry stats hooks:

- the planner (``plan:optimize`` / ``plan:translate``, lane ``planner``),
- the device tier: one ``device:<kind>`` span per real dispatch, annotated
  with the kernel ledger's strategy, bytes, flops and roofline share
  (``device/costmodel.py:ledger_record``, lane ``device``), and the fused
  agg pipeline's ``device:upload`` / ``device:compute`` /
  ``device:download`` slot spans (lanes ``dev:*``),
- push-pipeline stages (``pipeline:stage``) and the per-operator ``op:*``
  spans, and the scan's ``scan:prefetch`` producers (lane ``scan``),
  riding the thread-attribution machinery of ``observability``.

The wire helpers (:func:`wire_headers`, :func:`context_from_headers`,
:func:`remote_context`, ``SpanRecorder.add_remote``'s clock-offset merge)
carry spans across the distributed tier's process boundaries: the
shuffle fetch headers and the remote worker's shipped spans
(``distributed/remote_worker.py``).

Exports: a Chrome trace JSON (perfetto-loadable) per query
(``DAFT_TORCH_TRACE_DIR``), OTLP spans (``DAFT_TORCH_OTLP_ENDPOINT``,
``/v1/traces`` beside the metrics export), a Prometheus text-format
``/metrics`` scrape on the dashboard, and a bounded flight recorder
(``DAFT_TORCH_QUERY_LOG`` JSONL with size-capped rotation) served at
``/api/history``.

Design contracts:

- **near-free when off** — span creation guards on the thread's current
  span context (one ``getattr``); no dicts, no ids, no timestamps are
  built for untraced queries. The per-query enable decision
  (``DAFT_TORCH_TRACE`` × ``DAFT_TORCH_TRACE_SAMPLE``) happens once at
  trace creation.
- **deterministic ids** — span ids are minted by hashing stable
  identities (operator and stage names, task indices, repeat counts),
  never RNG.
- **bounded** — ``DAFT_TORCH_TRACE_MAX_SPANS`` caps the per-query buffer
  (drops counted), the recorder registry is size-capped, and the flight
  recorder rotates at ``DAFT_TORCH_QUERY_LOG_BYTES``.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------- ids

#: spans whose trace buffer is full are counted, never stored; the
#: registry holds at most this many ACTIVE (unexported) recorders —
#: an abandoned trace must not leak its spans forever
_MAX_ACTIVE_RECORDERS = 64

_WIRE_TRACE_HEADER = "X-Daft-Trace-Id"
_WIRE_PARENT_HEADER = "X-Daft-Parent-Span"


def span_id_from(key: str) -> str:
    """16-hex span id from a stable key. Pure function of the key — the
    same planner-minted identity yields the same id run after run."""
    return hashlib.sha256(b"daft-span\x1f"
                          + key.encode()).hexdigest()[:16]


def _hash01(key: str) -> float:
    h = hashlib.sha256(b"daft-trace\x1f" + key.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2 ** 64


def _now_us() -> int:
    return int(time.time() * 1e6)


# ----------------------------------------------------------- recorder


class SpanRecorder:
    """One query's span buffer. Bounded; thread-safe; ids deterministic."""

    def __init__(self, trace_id: str, max_spans: Optional[int] = None):
        if max_spans is None:
            from . import knobs
            max_spans = knobs.env_int("DAFT_TORCH_TRACE_MAX_SPANS")
        self.trace_id = trace_id
        self.max_spans = max(int(max_spans), 1)
        self._lock = threading.Lock()
        self._spans: List[dict] = []
        self.dropped = 0
        self._key_seq: Dict[str, int] = {}
        self.clock_offsets_us: Dict[str, int] = {}
        self.root_id = span_id_from("query")
        self._root_t0 = _now_us()
        self._finished = False
        self.exported = False
        self.status = "ok"

    # -- id minting ---------------------------------------------------
    def unique_key(self, key: str) -> str:
        """``key``, suffixed ``~N`` on repeats — a recomputed map task
        reuses its stable fault key; its spans must still be distinct.
        The counter is deterministic whenever execution order is
        (as the order of a serialized run is)."""
        with self._lock:
            n = self._key_seq.get(key, 0)
            self._key_seq[key] = n + 1
        return key if n == 0 else f"{key}~{n}"

    def unique_span_id(self, key: str) -> str:
        return span_id_from(self.unique_key(key))

    # -- recording ----------------------------------------------------
    def add(self, name: str, span_id: str, parent_id: Optional[str],
            ts_us: int, dur_us: int, attrs: Optional[dict] = None,
            lane: str = "driver", status: str = "ok") -> None:
        span = {"name": name, "span_id": span_id,
                "parent_id": parent_id or self.root_id,
                "ts_us": int(ts_us), "dur_us": max(int(dur_us), 0),
                "lane": lane}
        if attrs:
            span["attrs"] = attrs
        if status != "ok":
            span["status"] = status
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return
            self._spans.append(span)

    def add_remote(self, spans: List[dict], offset_us: int,
                   worker: str) -> None:
        """Merge spans shipped back from another process, correcting
        their wall clock by the measured offset."""
        with self._lock:
            self.clock_offsets_us[worker] = int(offset_us)
        for s in spans:
            try:
                self.add(s["name"], s["span_id"], s.get("parent_id"),
                         int(s["ts_us"]) + int(offset_us), s["dur_us"],
                         attrs=s.get("attrs"),
                         lane=s.get("lane") or f"worker:{worker}",
                         status=s.get("status", "ok"))
            except (KeyError, TypeError, ValueError):
                self.dropped += 1

    def finish(self, status: Optional[str] = None) -> None:
        """Close the root span (idempotent). ``None`` keeps whatever
        status was pre-set on the recorder (a failed query marks it
        ``error`` before the export path finishes the root)."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
        if status is not None:
            self.status = status
        self.add("query", self.root_id, None, self._root_t0,
                 _now_us() - self._root_t0, lane="driver",
                 status=self.status)

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def drain(self) -> List[dict]:
        """Remove and return the buffered spans (ship-back path: each
        remote task response carries the spans recorded so far, so
        concurrent tasks of one trace never double-ship)."""
        with self._lock:
            out = self._spans
            self._spans = []
            return out

    def span_ids(self) -> set:
        with self._lock:
            return {s["span_id"] for s in self._spans}

    def summary(self) -> dict:
        with self._lock:
            n = len(self._spans)
            offsets = dict(self.clock_offsets_us)
        out = {"trace_id": self.trace_id, "spans": n,
               "dropped": self.dropped}
        if offsets:
            out["clock_offsets_us"] = offsets
        return out


class SpanContext:
    """(recorder, current span id) — the unit that travels across
    threads and the wire."""

    __slots__ = ("recorder", "span_id")

    def __init__(self, recorder: SpanRecorder, span_id: str):
        self.recorder = recorder
        self.span_id = span_id

    def wire(self) -> Tuple[str, str]:
        """(trace_id, span_id) for header / RPC propagation."""
        return self.recorder.trace_id, self.span_id


# -------------------------------------------------- thread propagation

_tl = threading.local()


def current() -> Optional[SpanContext]:
    return getattr(_tl, "ctx", None)


def _set_current(ctx: Optional[SpanContext]) -> Optional[SpanContext]:
    """Raw swap for hot paths (``observability.attributed``); returns
    the previous context so the caller can restore it."""
    prev = getattr(_tl, "ctx", None)
    _tl.ctx = ctx
    return prev


@contextlib.contextmanager
def attach(ctx: Optional[SpanContext]):
    """Install ``ctx`` as this thread's span context. ``None`` is a
    no-op (the current context, if any, stays installed)."""
    if ctx is None:
        yield None
        return
    prev = _set_current(ctx)
    try:
        yield ctx
    finally:
        _set_current(prev)


def run_attached(ctx: Optional[SpanContext], fn, *args, **kwargs):
    """Run ``fn`` under ``ctx`` — the shape pool-submit sites use to
    carry the submitting thread's span context onto a worker thread."""
    with attach(ctx):
        return fn(*args, **kwargs)


# ---------------------------------------------------------- live spans


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        pass


_NOOP = _NoopSpan()


class _LiveSpan:
    __slots__ = ("_ctx", "_name", "_key", "_attrs", "_lane", "_t0",
                 "_id", "_prev")

    def __init__(self, ctx: SpanContext, name: str, key: Optional[str],
                 attrs: Optional[dict], lane: str):
        self._ctx = ctx
        self._name = name
        self._key = key or name
        self._attrs = dict(attrs) if attrs else None
        self._lane = lane

    def set(self, key, value) -> None:
        if self._attrs is None:
            self._attrs = {}
        self._attrs[key] = value

    def __enter__(self):
        rec = self._ctx.recorder
        self._id = rec.unique_span_id(self._key)
        self._t0 = _now_us()
        self._prev = _set_current(SpanContext(rec, self._id))
        return self

    def __exit__(self, exc_type, exc, tb):
        _set_current(self._prev)
        self._ctx.recorder.add(
            self._name, self._id, self._ctx.span_id, self._t0,
            _now_us() - self._t0, attrs=self._attrs, lane=self._lane,
            status="error" if exc_type is not None else "ok")
        return False


def span(name: str, key: Optional[str] = None,
         attrs: Optional[dict] = None, lane: str = "driver"):
    """Context manager recording one span under the thread's current
    context; a cheap no-op singleton when the thread is untraced (the
    sampling gate: no ids, no dicts, no clock reads)."""
    ctx = current()
    if ctx is None:
        return _NOOP
    return _LiveSpan(ctx, name, key, attrs, lane)


def event(name: str, key: Optional[str] = None,
          attrs: Optional[dict] = None, lane: str = "driver",
          ctx: Optional[SpanContext] = None,
          parent_id: Optional[str] = None) -> None:
    """Zero-duration span (cancellations, retries, speculation marks)."""
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        return
    rec = ctx.recorder
    rec.add(name, rec.unique_span_id(key or name),
            parent_id or ctx.span_id, _now_us(), 0, attrs=attrs,
            lane=lane)


# ------------------------------------------------------ trace registry

_reg_lock = threading.Lock()
_recorders: "Dict[str, SpanRecorder]" = {}
_trace_seq = itertools.count(1)


def trace_enabled() -> bool:
    from . import knobs
    return bool(knobs.env_bool("DAFT_TORCH_TRACE"))


def recorder_for(trace_id: str) -> Optional[SpanRecorder]:
    with _reg_lock:
        return _recorders.get(trace_id)


def register_recorder(rec: SpanRecorder) -> None:
    with _reg_lock:
        while len(_recorders) >= _MAX_ACTIVE_RECORDERS:
            _recorders.pop(next(iter(_recorders)))
        _recorders[rec.trace_id] = rec


def unregister_recorder(trace_id: str) -> None:
    with _reg_lock:
        _recorders.pop(trace_id, None)


def maybe_start_trace(kind: str = "query") -> Optional[SpanContext]:
    """Start (and register) a trace for a new top-level query — or
    return ``None`` when tracing is off, the query loses the sampling
    draw, or the thread is already inside a trace (the query joins it).
    The sampling decision hashes the deterministic per-process trace
    key, never RNG."""
    if current() is not None:
        return None
    if not trace_enabled():
        return None
    from . import knobs
    seq = next(_trace_seq)
    trace_key = f"{kind}:{seq}"
    rate = knobs.env_float("DAFT_TORCH_TRACE_SAMPLE")
    if rate < 1.0 and _hash01(trace_key) >= max(rate, 0.0):
        return None
    trace_id = hashlib.sha256(
        f"daft-trace\x1f{os.getpid()}\x1f{trace_key}".encode()
    ).hexdigest()[:32]
    rec = SpanRecorder(trace_id)
    register_recorder(rec)
    return SpanContext(rec, rec.root_id)


def abort_trace(ctx: Optional[SpanContext],
                status: str = "error") -> None:
    """Close and unregister a trace whose query died before anything
    could adopt it (a planner failure between :func:`maybe_start_trace`
    and the executor's stats context taking ownership). Idempotent and
    no-op for None / already-exported contexts — safe to call from any
    error path. Without this, every failed optimize/translate left its
    recorder registered for the process lifetime (the registry cap made
    it a rotation of leaks rather than growth, but the trace itself was
    silently lost)."""
    if ctx is None:
        return
    rec = ctx.recorder
    if rec is None or getattr(rec, "exported", False):
        return
    rec.exported = True
    rec.finish(status)
    unregister_recorder(rec.trace_id)


def remote_context(trace_id: str, span_id: str,
                   parent_id: Optional[str] = None
                   ) -> Optional[SpanContext]:
    """Rebuild a span context from wire identifiers. In-process workers
    find the driver's live recorder in the registry; a foreign process
    (remote worker) gets ``None`` from here and must buffer its own
    spans for ship-back (``WorkerServer`` does)."""
    rec = recorder_for(trace_id)
    if rec is None:
        return None
    return SpanContext(rec, span_id)


def wire_headers(ctx: Optional[SpanContext] = None) -> Dict[str, str]:
    """Span-context HTTP headers for the shuffle wire (empty when
    untraced)."""
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        return {}
    trace_id, span_id = ctx.wire()
    return {_WIRE_TRACE_HEADER: trace_id, _WIRE_PARENT_HEADER: span_id}


def context_from_headers(headers) -> Optional[SpanContext]:
    """Span context from incoming shuffle-wire headers (None when the
    request is untraced or the trace lives in another process)."""
    try:
        trace_id = headers.get(_WIRE_TRACE_HEADER)
        span_id = headers.get(_WIRE_PARENT_HEADER)
    except Exception:
        return None
    if not trace_id or not span_id:
        return None
    return remote_context(trace_id, span_id)


# ------------------------------------------------------- chrome export

#: lane order for the chrome export's tid assignment: driver layers
#: first, then device, then workers in first-seen order
_LANE_PRIORITY = ("driver", "serving", "planner", "pipeline", "scan",
                  "device", "dev:upload", "dev:compute", "dev:download")


def chrome_trace_events(rec: SpanRecorder) -> List[dict]:
    """Perfetto-loadable event list: one ``X`` (complete) event per
    span on a per-lane tid, plus ``M`` thread-name metadata events.
    Timestamps are rebased to the earliest span and sorted monotonic."""
    spans = sorted(rec.spans(), key=lambda s: (s["ts_us"], s["span_id"]))
    if not spans:
        return []
    base = min(s["ts_us"] for s in spans)
    lanes: Dict[str, int] = {}
    for lane in _LANE_PRIORITY:
        lanes[lane] = len(lanes)
    for s in spans:
        lanes.setdefault(s["lane"], len(lanes))
    pid = os.getpid()
    events: List[dict] = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": lane}}
        for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1])]
    for s in spans:
        args = {"span_id": s["span_id"], "parent_id": s["parent_id"]}
        if s.get("attrs"):
            args.update({k: v for k, v in s["attrs"].items()})
        if s.get("status", "ok") != "ok":
            args["status"] = s["status"]
        events.append({"name": s["name"], "ph": "X",
                       "ts": s["ts_us"] - base, "dur": s["dur_us"],
                       "pid": pid, "tid": lanes[s["lane"]],
                       "args": args})
    return events


def chrome_trace_json(rec: SpanRecorder) -> dict:
    return {"traceEvents": chrome_trace_events(rec),
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": rec.trace_id,
                          "dropped_spans": rec.dropped}}


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema check for an exported Chrome trace (the ``obs-smoke``
    gate): required event fields, non-negative monotonic timestamps,
    only ``X``/``M``/``B``/``E`` phases with ``B``/``E`` matched per
    (pid, tid). Returns human-readable problems (empty = valid)."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    last_ts: Dict[tuple, float] = {}
    open_b: Dict[tuple, int] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M", "B", "E"):
            problems.append(f"event {i}: unsupported phase {ph!r}")
            continue
        for field in ("name", "pid", "tid"):
            if field not in e:
                problems.append(f"event {i}: missing {field!r}")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        key = (e.get("pid"), e.get("tid"))
        if ts < last_ts.get(key, 0):
            problems.append(
                f"event {i}: non-monotonic ts on lane {key}")
        last_ts[key] = ts
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
        elif ph == "B":
            open_b[key] = open_b.get(key, 0) + 1
        elif ph == "E":
            if open_b.get(key, 0) <= 0:
                problems.append(f"event {i}: E without matching B")
            else:
                open_b[key] -= 1
    for key, n in open_b.items():
        if n:
            problems.append(f"lane {key}: {n} unmatched B event(s)")
    return problems


def orphan_spans(rec: SpanRecorder) -> List[dict]:
    """Spans whose parent id resolves to no recorded span (and is not
    the root). The contract: always empty."""
    ids = rec.span_ids() | {rec.root_id}
    return [s for s in rec.spans()
            if s["parent_id"] not in ids]


# --------------------------------------------------------- OTLP export


def otlp_spans_payload(rec: SpanRecorder) -> dict:
    """The trace as an OTLP/HTTP JSON ExportTraceServiceRequest
    (``/v1/traces``), extending the metrics-only export in
    ``observability.export_otlp``."""
    def _span(s: dict) -> dict:
        out = {
            "traceId": rec.trace_id,
            "spanId": s["span_id"],
            "name": s["name"],
            "kind": 1,  # INTERNAL
            "startTimeUnixNano": str(s["ts_us"] * 1000),
            "endTimeUnixNano": str((s["ts_us"] + s["dur_us"]) * 1000),
            "attributes": [
                {"key": "lane", "value": {"stringValue": s["lane"]}}],
        }
        if s["parent_id"] != s["span_id"]:
            out["parentSpanId"] = s["parent_id"]
        for k, v in (s.get("attrs") or {}).items():
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            out["attributes"].append({"key": str(k), "value": val})
        if s.get("status", "ok") != "ok":
            out["status"] = {"code": 2}  # ERROR
        return out

    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": "daft_tpu_torch"}}]},
        "scopeSpans": [{
            "scope": {"name": "daft_tpu_torch.tracing"},
            "spans": [_span(s) for s in rec.spans()]}]}]}


# ------------------------------------------------- prometheus /metrics


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _prom_name(prefix: str, raw: str) -> str:
    out = []
    for ch in raw:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    name = "".join(out).strip("_").lower()
    return f"daft_torch_{prefix}_{name}"


def prometheus_text() -> str:
    """Process-wide counters and gauges in Prometheus text exposition
    format: the shuffle, scan-io, spill, governor (with the RSS gauges),
    recovery, adaptive, calibration, exchange (with the memoized-program
    and in-flight collective gauges), observability-export and
    device-kernel planes, plus the active-trace and flight-recorder
    gauges.

    The ``retrace`` and ``plansan`` planes carry the sanitizers' counters
    (empty unless armed), the ``fleet`` plane the serving fleet's (routes,
    gossip, the cache tier; ``fleet/state_sync``). The ``serving`` gauges
    and counters are those of the shared scheduler when one runs."""
    from . import observability as obs
    from . import serving
    from .analysis import plan_sanitizer, retrace_sanitizer
    from .device import calibration, costmodel
    from .distributed import resilience, shuffle_service, topology
    from .execution import governor, memory
    from .fleet import state_sync
    from .io import read_planner
    from .parallel import exchange
    from .physical import adaptive

    lines: List[str] = []

    def emit(name: str, value, kind: str = "counter",
             help_: str = "") -> None:
        if not isinstance(value, (int, float)):
            return
        lines.append(f"# HELP {name} {help_ or name}")
        lines.append(f"# TYPE {name} {kind}")
        if isinstance(value, float) and value == int(value):
            value = int(value)
        lines.append(f"{name} {value}")

    def plane(prefix: str, counters: Dict[str, float],
              help_: str) -> None:
        for k in sorted(counters):
            emit(_prom_name(prefix, k) + "_total", counters[k],
                 "counter", f"{help_} ({k})")

    plane("shuffle", shuffle_service.shuffle_counters_snapshot(),
          "shuffle data-plane counter")
    plane("io", read_planner.scan_counters_snapshot(),
          "scan-plane io counter")
    plane("spill", memory.spill_counters_snapshot(),
          "out-of-core spill-tier counter")
    plane("governor", governor.counters_snapshot(),
          "memory-governor backpressure action counter")
    snap = governor.snapshot()
    emit("daft_torch_rss_bytes", snap["rss_bytes"], "gauge",
         "current process resident set size")
    emit("daft_torch_rss_peak_bytes", snap["rss_peak_bytes"], "gauge",
         "peak process resident set size since start/reset")
    if snap["limit_bytes"]:
        emit("daft_torch_memory_limit_bytes", snap["limit_bytes"],
             "gauge", "configured DAFT_TORCH_MEMORY_LIMIT budget")
    emit("daft_torch_governor_pressured", snap["pressured"], "gauge",
         "1 while RSS sits inside the governor's hysteresis band")
    plane("recovery", resilience.counters_snapshot(),
          "resilience recovery counter")
    plane("adaptive", adaptive.counters_snapshot(),
          "self-tuning feedback counter")
    if calibration.enabled():
        emit("daft_torch_calibration_constants_active",
             len(calibration.calibrated_names()), "gauge",
             "cost-model constants currently overridden by the "
             "calibrated profile")
    ex = exchange.exchange_cache_counters()
    emit("daft_torch_exchange_programs", ex.pop("entries", 0), "gauge",
         "memoized mesh exchange programs resident")
    plane("exchange", ex, "mesh exchange program-memo counter")
    emit("daft_torch_exchange_collective_inflight",
         topology.collective_inflight(), "gauge",
         "collective exchange groups currently in flight")
    plane("obs", obs.obs_counters_snapshot(),
          "observability export counter")
    plane("fleet", state_sync.counters_snapshot(),
          "serving-fleet counter (routing, gossip, cache tier)")
    plane("retrace", retrace_sanitizer.counters_snapshot(),
          "retrace sanitizer counter")
    plane("plansan", plan_sanitizer.counters_snapshot(),
          "plan sanitizer contract-check counter")
    for kind, d in sorted(costmodel.ledger_snapshot(raw=True).items()):
        emit(_prom_name("kernel", f"{kind}_dispatches") + "_total",
             d.get("dispatches", 0), "counter",
             f"device dispatches ({kind})")
        emit(_prom_name("kernel", f"{kind}_seconds") + "_total",
             round(d.get("seconds", 0.0), 6), "counter",
             f"device kernel seconds ({kind})")
    sched = serving.shared_scheduler_if_running()
    if sched is not None:
        view = sched.live_view()
        emit("daft_torch_serving_queue_depth", view["queued"], "gauge",
             "queries queued in the serving scheduler")
        emit("daft_torch_serving_running", view["running"], "gauge",
             "queries currently running")
        emit("daft_torch_serving_admitted_bytes", view["admitted_bytes"],
             "gauge", "admission-controller outstanding bytes")
        counters = view["counters"]
        for k in sorted(counters):
            if k.startswith(("plan_cache_", "result_cache_")) \
                    or k in ("submitted", "completed", "failed",
                             "cancelled") \
                    or k.startswith("rejected_"):
                emit(_prom_name("serving", k) + "_total", counters[k],
                     "counter", f"serving scheduler counter ({k})")
        for cache in ("plan_cache", "result_cache"):
            hits = counters.get(f"{cache}_hits", 0)
            misses = counters.get(f"{cache}_misses", 0)
            if hits + misses:
                emit(f"daft_torch_serving_{cache}_hit_rate",
                     round(hits / (hits + misses), 6), "gauge",
                     f"{cache} hit rate since process start")
    emit("daft_torch_traces_active", len(_recorders), "gauge",
         "span recorders currently registered")
    with _flight_lock:
        emit("daft_torch_flight_recorder_queries_total", _flight_written,
             "counter", "queries persisted to the flight recorder")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Strict parser for the text exposition format (the scrape gate in
    ``obs-smoke``): every line must be a comment, blank, or
    ``name[{labels}] value [timestamp]`` with a valid metric name and a
    float value. Raises ``ValueError`` on any malformed line."""
    out: Dict[str, float] = {}
    typed: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                if parts[1] == "TYPE":
                    if len(parts) < 4 or parts[3] not in (
                            "counter", "gauge", "histogram", "summary",
                            "untyped"):
                        raise ValueError(
                            f"line {lineno}: bad TYPE line {line!r}")
                    typed[parts[2]] = parts[3]
                continue
            raise ValueError(f"line {lineno}: bad comment {line!r}")
        name = line.split("{")[0].split()[0]
        if not name or not (name[0].isalpha() or name[0] in "_:"):
            raise ValueError(f"line {lineno}: bad metric name {line!r}")
        if not all(c.isalnum() or c in "_:" for c in name):
            raise ValueError(f"line {lineno}: bad metric name {line!r}")
        rest = line[len(name):].strip()
        if rest.startswith("{"):
            close = rest.find("}")
            if close < 0:
                raise ValueError(f"line {lineno}: unclosed labels")
            rest = rest[close + 1:].strip()
        fields = rest.split()
        if not fields:
            raise ValueError(f"line {lineno}: missing value")
        try:
            value = float(fields[0])
        except ValueError:
            raise ValueError(
                f"line {lineno}: non-numeric value {fields[0]!r}")
        if len(fields) > 2:
            raise ValueError(f"line {lineno}: trailing garbage")
        out[name] = value
    return out


# ------------------------------------------------------ flight recorder

_flight_lock = threading.Lock()
_flight_written = 0


def _flight_path() -> Optional[str]:
    from . import knobs
    return knobs.env_raw("DAFT_TORCH_QUERY_LOG")


def flight_record(entry: dict) -> None:
    """Append one query record to the flight-recorder JSONL
    (``DAFT_TORCH_QUERY_LOG``); rotates the file to ``<path>.1`` when it
    exceeds ``DAFT_TORCH_QUERY_LOG_BYTES``. Never raises into the query
    path."""
    global _flight_written
    path = _flight_path()
    if not path:
        return
    from . import knobs
    cap = knobs.env_bytes("DAFT_TORCH_QUERY_LOG_BYTES")
    try:
        line = json.dumps(entry, default=str) + "\n"
    except Exception:
        return
    with _flight_lock:
        try:
            if cap and cap > 0:
                try:
                    if os.path.getsize(path) + len(line) > cap:
                        os.replace(path, path + ".1")
                except OSError:
                    pass  # no current file yet
            # daft-lint: allow(blocking-under-lock) -- the size check,
            # rotation and append are one atomic unit against concurrent
            # query-finish writers (a local file, one line per query)
            with open(path, "a") as f:
                f.write(line)
            _flight_written += 1
        except Exception:
            pass


#: bytes read from the END of each flight-recorder generation per
#: history call — the wanted entries are by construction at the tail;
#: reading whole 16MiB logs per dashboard poll is the alternative
_FLIGHT_TAIL_BYTES = 512 << 10


def flight_history(limit: int = 200) -> List[dict]:
    """Most-recent-first flight-recorder entries (current file, then
    the rotated generation), read from a bounded tail window of each.
    Tolerates torn/partial head lines."""
    path = _flight_path()
    if not path:
        return []
    out: List[dict] = []
    for p in (path, path + ".1"):
        try:
            with open(p, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                start = max(size - _FLIGHT_TAIL_BYTES, 0)
                f.seek(start)
                data = f.read()
        except OSError:
            continue
        lines = data.splitlines()
        if start > 0 and lines:
            lines = lines[1:]  # first line is mid-record: drop it
        for line in reversed(lines):
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
            if len(out) >= limit:
                return out
    return out


def slow_query_ms() -> float:
    from . import knobs
    return knobs.env_float("DAFT_TORCH_SLOW_QUERY_MS")


def reset_for_tests() -> None:
    global _flight_written
    with _reg_lock:
        _recorders.clear()
    with _flight_lock:
        _flight_written = 0
